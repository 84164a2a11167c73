"""The port's lane-batched Newton and reduced-space solver
(``solvers/newton.py:make_batched_newton_solver``, ``solvers/reduced.py``)
held to the JAX package on the CPU, in float64, on the discharge-HX
flowsheet of ``tests/torch_storage_cases.py`` (14 states; decisions the
salt flow and the area; one outer inequality).

* The batched Newton at T = 3 against three single-lane port solves and
  against ``jax.vmap`` of JAX's Newton: equal iterations per lane, x
  within 1e-10 (relative to max(1, |x|)).  The lanes take 1, 3 and 9
  steps, so the freeze of finished lanes is exercised; a lane whose solve
  fails stays failed.  JAX's vmapped Newton compiles for minutes, so its
  results are recorded (``reduced_vmap_newton_jax`` in
  tests/torch_records.py; a ``slow`` test holds the record to JAX).
* ``ReducedSpaceNLP``'s evaluation against JAX's ``_evaluate`` at 3
  seeded u within 1e-9 relative; ``df`` and ``dG`` against central
  differences of the port; ``solve`` against JAX's (u within 1e-6, the
  objective within 1e-8, the same ``converged``).
* ``BatchedReducedSpaceNLP``'s evaluations and solves are in
  ``tests/test_torch_reduced_batched.py`` (a second file, so that two
  test workers share the JAX compiles).
* An inner failure is sanitised and counted as in JAX.
* The device rule, and ``interop.u_from_numpy``'s layout check.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_records  # noqa: E402
import torch_storage_cases as cases  # noqa: E402

from dispatches_tpu.solvers.newton import make_newton_solver as j_make_newton  # noqa: E402
from dispatches_tpu.solvers.reduced import BatchedReducedSpaceNLP as JBatched  # noqa: E402
from dispatches_tpu.solvers.reduced import ReducedSpaceNLP as JReduced  # noqa: E402

from dispatches_tpu_torch.interop import u_from_numpy  # noqa: E402
from dispatches_tpu_torch.solvers.newton import (  # noqa: E402
    make_batched_newton_solver,
    make_newton_solver,
)
from dispatches_tpu_torch.solvers.reduced import (  # noqa: E402
    BatchedReducedSpaceNLP,
    ReducedSpaceNLP,
)

CPU = "cpu"
T = 3
#: three (salt flow kg/s, area m2) operating points: 1, 3 and 9 Newton
#: steps from the warm start
LANES = np.array([[200.0, 2000.0], [240.0, 1200.0], [150.0, 2500.0]])
U_BOUNDS = {"salt": (10.0, 400.0), "area": (500.0, 6000.0)}
SOLVE_KW = dict(maxiter=60, gtol=1e-8, xtol=1e-10)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one intra-op thread, as the other test_torch_* modules."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol, what=""):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert (err.max() if err.size else 0.0) <= rtol, (what, float(err.max()))


@pytest.fixture(scope="module")
def problems():
    return _problems()


def _problems():
    # the JAX flowsheet takes the port's warm start (tests/test_torch_salt_hx.py
    # holds the two packages' _hx_sweep to each other)
    tn, tdec = cases.reduced_problem(cases.torch_modules(), torch)
    jn, jdec = cases.reduced_problem(cases.jax_modules(), jnp, inits_from=tn.fs)
    assert cases.layout(tn) == cases.layout(jn) and tdec == jdec
    np.testing.assert_array_equal(np.asarray(jn.x0), tn.x0)
    return jn, tn, tdec


FAILED_LANES = LANES.copy()
FAILED_LANES[1] = [-10.0, 2000.0]  # negative salt flow: a non-finite residual
NEWTON_RECORD = "reduced_vmap_newton_jax"


def jax_record():
    """JAX's ``jax.vmap`` of its Newton solver on the lanes of the two
    batched-Newton tests (its compile takes minutes, so tier 1 reads this
    record; test_vmap_newton_jax_record_is_current holds it to JAX)."""
    jn, tn, dec = _problems()
    _, axes = _lane_params(tn, dec, LANES)
    fn = jax.jit(jax.vmap(j_make_newton(jn), in_axes=(axes, 0)))
    X0 = jnp.asarray(np.tile(np.asarray(tn.x0), (T, 1)))
    out = {}
    for key, lanes in (("lanes", LANES), ("failed_lane", FAILED_LANES)):
        params, _ = _lane_params(tn, dec, lanes)
        r = fn(jax.tree_util.tree_map(jnp.asarray, params), X0)
        out[key] = {f: np.asarray(getattr(r, f))
                    for f in ("iterations", "converged", "x", "max_residual")}
    return out


@pytest.fixture(scope="module")
def jax_vmap_newton():
    """JAX's vmapped Newton results by case, from the record."""
    rec = torch_records.read(NEWTON_RECORD)
    return {k: type("JRes", (), v) for k, v in rec.items()}


@pytest.mark.slow
def test_vmap_newton_jax_record_is_current():
    assert torch_records.matches(NEWTON_RECORD, jax_record())


def _scales(dec):
    return {dec[0]: 100.0, dec[1]: 1e3}


def _bounds(dec):
    return {dec[0]: U_BOUNDS["salt"], dec[1]: U_BOUNDS["area"]}


# ---------------------------------------------------------------------------
# the lane-batched Newton
# ---------------------------------------------------------------------------


def _lane_params(nlp, dec, lanes):
    p = nlp.default_params()
    fixed = dict(p["fixed"])
    for j, d in enumerate(dec):
        fixed[d] = lanes[:, j].reshape((len(lanes),) + np.shape(p["fixed"][d]))
    return {"p": p["p"], "fixed": fixed}, {
        "p": {k: None for k in p["p"]},
        "fixed": {k: (0 if k in dec else None) for k in p["fixed"]}}


def test_batched_newton_matches_single_lanes_and_jax_vmap(problems, jax_vmap_newton):
    jn, tn, dec = problems
    params, axes = _lane_params(tn, dec, LANES)
    X0 = np.tile(np.asarray(tn.x0), (T, 1))
    res = make_batched_newton_solver(tn, None, axes, device=CPU)(params, X0)
    single = make_newton_solver(tn, device=CPU)
    its = []
    for t in range(T):
        p_t = {"p": params["p"], "fixed": {k: (v[t] if axes["fixed"][k] == 0 else v)
                                           for k, v in params["fixed"].items()}}
        r = single(p_t, X0[t])
        its.append(int(r.iterations))
        assert bool(r.converged) == bool(res.converged[t])
        _close(res.x[t], r.x, 1e-10, f"lane {t} vs single")
    assert _np(res.iterations).tolist() == its
    assert its == [1, 3, 9], its  # the frozen lanes waited
    jres = jax_vmap_newton["lanes"]
    assert np.asarray(jres.iterations).tolist() == its
    assert np.asarray(jres.converged).tolist() == _np(res.converged).tolist() == [True] * T
    _close(res.x, jres.x, 1e-10, "batched vs jax.vmap")
    _close(res.max_residual, jres.max_residual, 1e-10, "max residual")


def test_batched_newton_keeps_a_failed_lane_failed(problems, jax_vmap_newton):
    jn, tn, dec = problems
    params, axes = _lane_params(tn, dec, FAILED_LANES)
    X0 = np.tile(np.asarray(tn.x0), (T, 1))
    res = make_batched_newton_solver(tn, None, axes, device=CPU)(params, X0)
    jres = jax_vmap_newton["failed_lane"]
    assert _np(res.converged).tolist() == np.asarray(jres.converged).tolist() == [True, False, True]
    assert _np(res.iterations).tolist() == np.asarray(jres.iterations).tolist()
    assert int(res.iterations[1]) == 1 and not bool(torch.isfinite(res.max_residual[1]))
    _close(res.x[[0, 2]], np.asarray(jres.x)[[0, 2]], 1e-10, "converged lanes")


# ---------------------------------------------------------------------------
# ReducedSpaceNLP
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reduced(problems):
    jn, tn, dec = problems
    return (JReduced(jn, dec, u_scales=_scales(dec)),
            ReducedSpaceNLP(tn, dec, u_scales=_scales(dec), device=CPU))


def _seeded_u(k):
    rng = np.random.default_rng(k)
    return np.array([rng.uniform(1.6, 2.4), rng.uniform(1.4, 2.6)])


def test_reduced_layout_and_evaluation_match_jax(reduced, problems):
    jrs, trs = reduced
    jn, tn, _ = problems
    for a in ("u0", "u_lb", "u_ub"):
        np.testing.assert_array_equal(getattr(trs, a), getattr(jrs, a))
    assert trs._u_layout == jrs._u_layout and trs.m_u == jrs.m_u == 2
    for k in range(3):
        u = _seeded_u(k)
        want = [np.asarray(o) for o in jrs._evaluate(jnp.asarray(u), jnp.asarray(jn.x0))]
        got = trs._evaluate(u, tn.x0)
        assert bool(got[5]) and bool(want[5])
        for i, what in enumerate(("x", "f", "g", "df", "dG")):
            scale = max(1.0, float(np.max(np.abs(want[i]))))
            assert np.max(np.abs(got[i] - want[i])) <= 1e-9 * scale, (k, what)


#: df and dG against central differences of the port at step FD_H (scaled
#: u): the truncation error is O(h^2), ~1.5e-5 relative here, and the inner
#: Newton's stop at max|F| <= 1e-8 adds ~1e-8 / h
FD_H, FD_RTOL = 1e-3, 1e-4


def test_reduced_gradients_match_central_differences(reduced, problems):
    _, trs = reduced
    _, tn, _ = problems
    u = _seeded_u(0)
    base = trs._evaluate(u, tn.x0)
    assert bool(base[5])
    for j in range(trs.m_u):
        e = np.zeros(trs.m_u)
        e[j] = FD_H
        up_, dn = trs._evaluate(u + e, base[0]), trs._evaluate(u - e, base[0])
        assert bool(up_[5]) and bool(dn[5])
        fd_f = (up_[1] - dn[1]) / (2 * FD_H)
        fd_g = (up_[2] - dn[2]) / (2 * FD_H)
        assert abs(base[3][j] - fd_f) <= FD_RTOL * max(1.0, abs(fd_f)), (j, base[3][j], fd_f)
        assert np.max(np.abs(base[4][:, j] - fd_g)) <= FD_RTOL * max(1.0, np.max(np.abs(fd_g)))


def test_reduced_solve_matches_jax(reduced, problems):
    jrs, trs = reduced
    _, _, dec = problems
    jres = jrs.solve(u_bounds=_bounds(dec), **SOLVE_KW)
    tres = trs.solve(u_bounds=_bounds(dec), **SOLVE_KW)
    assert tres.converged == jres.converged is True
    np.testing.assert_allclose(tres.u, jres.u, rtol=0, atol=1e-6)
    assert abs(tres.obj - jres.obj) <= 1e-8 * max(1.0, abs(jres.obj))
    assert tres.inner_failures == jres.inner_failures
    sol = trs.unravel(tres)
    assert set(sol) == set(jrs.unravel(jres))
    assert float(tres.g.max()) <= 1e-6


def test_inner_failure_is_sanitised_and_counted_as_in_jax(reduced, problems):
    """From u0 = -10 kg/s of salt the first inner solve fails at once (a
    negative Reynolds number to a fractional power; also after the cold
    restart): the evaluation is sanitised (f, g to 1e6 where not finite,
    gradients to 0) and counted, and the outer loop moves on."""
    jrs, trs = reduced
    _, _, dec = problems
    u0 = np.array([-0.1, 2.0])
    bounds = {dec[0]: (-50.0, 400.0), dec[1]: U_BOUNDS["area"]}
    jres = jrs.solve(u0=u0, u_bounds=bounds, maxiter=3)
    tres = trs.solve(u0=u0, u_bounds=bounds, maxiter=3)
    assert tres.inner_failures == jres.inner_failures >= 1
    assert tres.outer_iterations == jres.outer_iterations
    np.testing.assert_allclose(tres.u, jres.u, rtol=0, atol=1e-6)
    from dispatches_tpu_torch.solvers.reduced import _sanitize
    out = [np.zeros(3), np.asarray(np.nan), np.array([np.inf, 1.0]),
           np.array([np.nan, 2.0]), np.array([[np.inf, 3.0]])]
    _sanitize(out)
    assert float(out[1]) == 1e6 and out[2].tolist() == [1e6, 1.0]
    assert out[3].tolist() == [0.0, 2.0] and out[4].tolist() == [[0.0, 3.0]]


# ---------------------------------------------------------------------------
# the BatchedReducedSpaceNLP problem (its evaluations and solves: test_torch_reduced_batched.py)
# ---------------------------------------------------------------------------


def _batched(cls, nlp, dec, xp, **kw):
    Fname, Aname = dec
    tout = "hx.tube_outlet.eos.temperature"

    def objective(vb, p):
        return (xp.sum(p["w"] * (vb[tout][:, 0] - 830.0) ** 2) * 1e-2
                + xp.sum((vb[Aname] * 1e-3) ** 2) * 0.5
                + xp.sum((vb[Fname][:, 0] * 1e-2 - 1.8) ** 2) * 5.0)

    def salt_budget(vb, p):  # the three hours share 600 kg/s of salt
        return (xp.sum(vb[Fname][:, 0]) - 600.0) * 1e-2

    def one_area(vb, p):  # one design for every hour
        return (vb[Aname][1:] - vb[Aname][:-1]) * 1e-3

    return cls(nlp, dec, T, objective=objective, sense="min",
               coupling_ineqs=[("salt_budget", salt_budget)],
               coupling_eqs=[("one_area", one_area)],
               u_scales=_scales(dec),
               runtime_params={"w": np.array([1.0, 2.0, 0.5])}, **kw)


# ---------------------------------------------------------------------------
# device rule, interop
# ---------------------------------------------------------------------------


@pytest.mark.skipif(torch.cuda.is_available(), reason="the CPU-only rule")
def test_entry_points_follow_the_device_rule(problems):
    _, tn, dec = problems
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batched_newton_solver(tn, None, _lane_params(tn, dec, LANES)[1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReducedSpaceNLP(tn, dec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _batched(BatchedReducedSpaceNLP, tn, dec, torch)


def test_u_from_numpy_checks_the_layout(reduced, problems):
    jrs, trs = reduced
    jn, tn, dec = problems
    jb = _batched(JBatched, jn, dec, jnp)
    tb = _batched(BatchedReducedSpaceNLP, tn, dec, torch, device=CPU)
    u = _seeded_u(1)
    got = u_from_numpy(u, jrs, trs, CPU)
    assert got.dtype == torch.float64 and _np(got).tolist() == u.tolist()
    U = np.stack([_seeded_u(k) for k in range(T)])
    got = u_from_numpy(U, jb, tb, CPU)
    assert got.shape == (T, 2) and _np(got).tolist() == U.tolist()
    with pytest.raises(ValueError, match="shape"):
        u_from_numpy(U[:2], jb, tb, CPU)
    other = ReducedSpaceNLP(tn, dec[::-1], u_scales=_scales(dec), device=CPU)
    with pytest.raises(ValueError, match="decisions"):
        u_from_numpy(u, jrs, other, CPU)
    rescaled = ReducedSpaceNLP(tn, dec, u_scales={dec[0]: 1.0}, device=CPU)
    with pytest.raises(ValueError, match="scale"):
        u_from_numpy(u, jrs, rescaled, CPU)
