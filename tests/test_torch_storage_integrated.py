"""The port's integrated USC + molten-salt storage plant
(``case_studies/fossil/storage_integrated.py``) held to the JAX package
on the CPU, in float64.

* ``tests/test_storage_integrated.py``'s ``test_build_square`` and
  ``test_initialized_state`` on the port (``main`` from the JAX
  package's checkpoint ``tests/data/integrated_storage_usc_init``).
* One JAX fixture, ``main(load_from_file=INIT, solve=False)`` and its
  compile (no JAX Newton solve): the layouts are equal (n = 792), the
  port's residual and inequality rows at the checkpoint x are within
  1e-10 of each row's term size, ``sum_j |dr_i/dx_j x_j|``, of JAX's, and
  the port's square solve takes 1 Newton iteration, as JAX's does.
* ``model_analysis``' NLP (hot_empty, warm-started as below), compiled in
  both packages and stopped before the solve: equal layouts and
  decisions; its inequality rows and objective at the solution file's x
  within 1e-10 of each row's terms of JAX's.
* Checkpoints both ways: the port loads JAX's files; the port's
  ``save_initialized`` and ``save_analysis_solution`` write files that
  JAX's ``load_state`` reads back equal.
* ``model_analysis``' guards: the ``fix_power`` mode switch and a bad
  ``tank_scenario`` raise ``ValueError``, as in JAX.
* Slow: ``model_analysis`` hot_empty warm-started from ``WARM_U`` and the
  solution file (the anchors of ``tests/test_storage_integrated.py``'s
  ``test_main_function``), with each variable's gap to JAX's solution
  file printed; ~6 min of this CPU.
* The device rule of ``main`` and ``model_analysis``.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dispatches_tpu.case_studies.fossil import storage_integrated as jisp  # noqa: E402
from dispatches_tpu.utils.checkpoint import load_state as j_load_state  # noqa: E402

from dispatches_tpu_torch.case_studies.fossil import storage_integrated as isp  # noqa: E402
from dispatches_tpu_torch.interop import x_from_numpy  # noqa: E402
from torch_storage_cases import layout  # noqa: E402

CPU = "cpu"
DATA = Path(__file__).parent / "data"
INIT = DATA / "integrated_storage_usc_init"
SOLUTION = DATA / "integrated_storage_usc_solution"

# tests/test_storage_integrated.py's converged hot_empty decisions
WARM_U = isp.HOT_EMPTY_WARM_U


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one intra-op thread, as the other test_torch_* modules."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(scope="module")
def model():
    return isp.main(max_power=436, load_from_file=INIT, device=CPU)


@pytest.fixture(scope="module")
def jax_plant():
    m = jisp.main(max_power=436, load_from_file=INIT, solve=False)
    nlp = m.fs.compile()
    p = nlp.default_params()
    r0 = np.asarray(jax.jit(lambda xx: jnp.concatenate([nlp.eq(xx, p), nlp.ineq(xx, p)]))(
        jnp.asarray(nlp.x0)))
    return m, nlp, r0


class _Built(Exception):
    """Raised in place of building the reduced-space solver: carries the
    analysis NLP that ``model_analysis`` compiled and its decisions."""

    def __init__(self, nlp, decisions):
        super().__init__("built")
        self.nlp, self.decisions = nlp, list(decisions)


def _raise_built(nlp, decisions, *_, **__):
    raise _Built(nlp, decisions)


def _analysis_nlp(reduced, analysis, m, **kw):
    """The NLP ``analysis`` (a package's ``model_analysis``) compiles on
    ``m`` (hot_empty, the warm start and the solution file of
    ``test_main_function``), stopped before its solve by replacing the
    package's ``ReducedSpaceNLP`` (in its module ``reduced``) with
    ``_raise_built``."""
    mp = pytest.MonkeyPatch()
    mp.setattr(reduced, "ReducedSpaceNLP", _raise_built)
    try:
        analysis(m, power=460, max_power=436, tank_scenario="hot_empty", fix_power=False,
                 warm_start=WARM_U, load_solution=SOLUTION, **kw)
    except _Built as built:
        return built
    finally:
        mp.undo()
    raise AssertionError("model_analysis did not build its reduced-space solver")


@pytest.fixture(scope="module")
def analysis_nlps():
    """model_analysis' NLP in both packages, no solve: (port's, JAX's)."""
    import dispatches_tpu.solvers.reduced as j_reduced

    import dispatches_tpu_torch.solvers.reduced as t_reduced

    port = _analysis_nlp(t_reduced, isp.model_analysis,
                         isp.main(max_power=436, load_from_file=INIT, solve=False, device=CPU),
                         device=CPU)
    jx = _analysis_nlp(j_reduced, jisp.model_analysis,
                       jisp.main(max_power=436, load_from_file=INIT, solve=False))
    return port, jx


def test_build_square(model):
    nlp, res = model.init_nlp, model.init_res
    assert nlp.eq(torch.as_tensor(nlp.x0), nlp.default_params()).shape[-1] == nlp.n == 792
    assert bool(res.converged)
    assert float(res.max_residual) < 1e-7


def test_initialized_state(model):
    sol = model.init_nlp.unravel(model.init_res.x)
    f_rh1 = sol["reheater_1.outlet.flow_mol"][0]
    assert sol["hxc.shell_inlet.flow_mol"][0] == pytest.approx(0.1 * f_rh1, rel=1e-6)
    assert sol["condenser_mix.makeup.flow_mol"][0] == pytest.approx(
        sol["es_turbine.outlet.flow_mol"][0], rel=1e-6)
    assert sol["es_turbine.work_mechanical"][0] < -1e6
    assert sol["hx_pump.work_mechanical"][0] > 0.0
    assert sol["coal_heat_duty"][0] > sol["plant_heat_duty"][0]


def test_layout_residual_and_square_solve_match_jax(model, jax_plant):
    _, jn, jr0 = jax_plant
    nlp, res = model.init_nlp, model.init_res
    x = x_from_numpy(np.asarray(jn.x0), jn, nlp, CPU)  # checks the layout
    assert list(nlp.free_names) == list(jn.free_names) and nlp.n == jn.n == 792
    assert dict(nlp.eq_slices) == dict(jn.eq_slices)
    assert dict(nlp.ineq_slices) == dict(jn.ineq_slices)
    for a in ("var_scale", "lb", "ub"):
        np.testing.assert_array_equal(np.asarray(getattr(nlp, a)), np.asarray(getattr(jn, a)))
    # both packages start from the checkpoint: the same x0
    np.testing.assert_array_equal(_np(x), np.asarray(nlp.x0))
    p = nlp.default_params()
    # the residual and the inequality rows, each within 1e-10 of its terms
    rows = lambda xx: torch.cat([nlp.eq(xx, p), nlp.ineq(xx, p)])  # noqa: E731
    J = torch.func.jacfwd(rows)(x)
    terms = np.maximum(1.0, _np((J.abs() * x.abs()).sum(1)))
    assert len(jr0) == nlp.n + sum(b - a for a, b in dict(nlp.ineq_slices).values()) > nlp.n
    err = np.abs(_np(rows(x)) - jr0) / terms
    assert err.max() <= 1e-10, (float(err.max()), int(err.argmax()))
    # the checkpoint is JAX's converged state: one Newton step in both
    # packages (JAX: 1 iteration to 5.225e-09 on this CPU)
    assert int(res.iterations) == 1


def test_checkpoints_cross_both_ways(model, tmp_path):
    # the port loaded JAX's file: every free variable it holds came from it
    ck = j_load_state(INIT)["inits"]
    fs = model.fs
    spec = fs.var_specs["hxd.tube_outlet.enth_mol"]
    assert not spec.fixed
    # the port writes; JAX reads back the same values
    isp.save_initialized(model, tmp_path / "port_init")
    back = j_load_state(tmp_path / "port_init")["inits"]
    assert set(back) == set(fs.var_specs)
    for name, s in fs.var_specs.items():
        val = s.fixed_value if s.fixed else s.init
        np.testing.assert_array_equal(
            back[name], np.broadcast_to(np.asarray(val, dtype=np.float64), s.shape))
    # after the square solve the written inits are the solved state, which
    # the checkpoint was: within the solve's one step of it
    for name in ("hxd.area", "hxc.heat_duty", "plant_power_out"):
        a, b = np.asarray(back[name], dtype=np.float64), np.asarray(ck[name], dtype=np.float64)
        assert np.allclose(a, b, rtol=1e-6, atol=0.0), name
    # and the port reads its own file as it reads JAX's
    m2 = isp.main(max_power=436, load_from_file=tmp_path / "port_init", solve=False, device=CPU)
    assert np.array_equal(m2.fs.compile().x0, model.fs.compile().x0)
    # an analysis solution checkpoint, read by JAX
    sol = model.init_nlp.unravel(model.init_res.x)
    isp.save_analysis_solution({"sol": sol}, tmp_path / "port_sol")
    back = j_load_state(tmp_path / "port_sol")["inits"]
    assert set(back) == set(sol)
    for k, v in sol.items():
        np.testing.assert_array_equal(back[k], np.asarray(v, dtype=np.float64))


def test_analysis_guards_raise_as_in_jax():
    m = isp.main(max_power=436, load_from_file=INIT, solve=False, device=CPU)
    with pytest.raises(ValueError, match="requires a power demand"):
        isp.model_analysis(m, fix_power=True, device=CPU)
    with pytest.raises(ValueError, match="rebuild the model to switch modes"):
        isp.model_analysis(m, fix_power=False, device=CPU)
    m = isp.main(max_power=436, load_from_file=INIT, solve=False, device=CPU)
    with pytest.raises(ValueError, match="tank_scenario"):
        isp.model_analysis(m, tank_scenario="cold_full", device=CPU)


def test_analysis_nlp_matches_jax(analysis_nlps):
    """model_analysis' compiled NLP (its scenario params, outer
    inequalities, envelope rows, cooler row and objective), built the same
    way in both packages without a solve: equal layouts and decisions, and
    at the saved solution's x the inequality rows and the objective within
    1e-10 of each row's terms of JAX's."""
    port, jx = analysis_nlps
    nlp, jn = port.nlp, jx.nlp
    assert layout(nlp) == layout(jn)
    assert port.decisions == jx.decisions
    jp = jn.default_params()
    x = jnp.asarray(jn.x0)
    g_j, f_j = jax.jit(lambda xx: (jn.ineq(xx, jp), jn.objective(xx, jp)))(x)
    xt = x_from_numpy(np.asarray(jn.x0), jn, nlp, CPU)
    p = nlp.default_params()
    g = nlp.ineq(xt, p)
    G = torch.func.jacfwd(lambda xx: nlp.ineq(xx, p))(xt)
    g_terms = np.maximum(1.0, _np((G.abs() * xt.abs()).sum(1)))
    assert g.shape[0] == len(np.asarray(g_j)) >= 20
    assert np.max(np.abs(_np(g) - np.asarray(g_j)) / g_terms) <= 1e-10
    f = nlp.objective(xt, p)
    df = torch.func.grad(lambda xx: nlp.objective(xx, p))(xt)
    f_terms = max(1.0, float((df.abs() * xt.abs()).sum()))
    assert abs(float(f) - float(f_j)) <= 1e-10 * f_terms
    assert nlp.sense == jn.sense == "max"


@pytest.mark.slow  # ~6 min of this CPU: 37 outer iterations, 33 evaluations of the 792-state plant
def test_main_function(model):
    out = isp.model_analysis(
        model, power=460, max_power=436, tank_scenario="hot_empty",
        fix_power=False, maxiter=150, warm_start=WARM_U,
        load_solution=SOLUTION, device=CPU,
    )
    res = out["res"]
    assert res.converged, res.message
    assert out["revenue"] == pytest.approx(9649.22, abs=1e-1)
    assert out["obj"] == pytest.approx(5.386, abs=1e-1)
    assert out["hxd_area"] == pytest.approx(2204.88, abs=0.5)
    sol = out["sol"]
    assert sol["plant_power_out"][0] == pytest.approx(436.0, abs=1e-2)
    assert sol["hxd.shell_inlet.flow_mass"][0] == pytest.approx(75000.0 / 3600.0, rel=1e-3)
    assert out["salt_inventory_hot"] + out["salt_inventory_cold"] == (
        pytest.approx(isp.SALT_AMOUNT, rel=1e-9))
    # each variable's gap to JAX's saved solution (relative to max(1, |v|))
    saved = j_load_state(SOLUTION)["inits"]
    gaps = {k: float(np.max(np.abs(np.asarray(sol[k]) - saved[k])
                            / np.maximum(1.0, np.abs(saved[k]))))
            for k in saved if k in sol and np.shape(sol[k]) == np.shape(saved[k])}
    worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    print("largest gaps to the JAX solution file:", worst)
    assert len(gaps) >= 700


@pytest.mark.skipif(torch.cuda.is_available(), reason="the CPU-only rule")
def test_entry_points_follow_the_device_rule():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        isp.main(max_power=436, load_from_file=INIT, solve=False)
    m = isp.main(max_power=436, load_from_file=INIT, solve=False, device=CPU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        isp.model_analysis(m)
