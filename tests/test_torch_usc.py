"""The port's Newton solver, IAPWS-95 steam-cycle units and the 437 MW
USC plant held to the JAX package on the CPU, in float64.

* ``solve_square`` against JAX's on a small bounded square system, from a
  start that needs backtracking and clipping, LU and ``refined_f32``:
  equal iterations, x within 1e-10, the ``trace`` record alike.
* One-unit steam flowsheets (a turbine stage with its isentropic state's
  entropy, a pump, an FWH with its wet shell states, a mixer, a splitter,
  a heater to a supercritical outlet) built by both packages: the layout exactly equal
  (names, order, shapes, bounds, scales, fixes, residual rows), the
  residuals and their Jacobians at x0 and at a seeded random x within
  1e-12 (``|got - want| <= 1e-12 * max(1, max|want|)``).
* The whole plant, built, initialized and solved ONCE per package in
  module fixtures (the JAX one only for the slow comparison): the layout exactly equal; ``initialize``'s x0 within
  1e-9 of JAX's per entry, relative to max(1, |x0|) (the scaled vector;
  the gap, 6.1e-10 at turbine 11's work, is the saturation solvers'
  pressure noise, see ``X0_RTOL``); the residual at JAX's x0 within
  1e-10 of the size of each row's terms (at the port's own x0 within
  1e-8: the x0 gap times the Jacobian);
  the solved x within 1e-8 (per entry, relative to max(1, |x|)); and tests/test_usc_plant.py's anchors
  (``test_usc_model``, ``test_solved_state_physics``,
  ``test_change_power``) on the port.
* The device rule of ``solve_square``, ``solve_plant`` and
  ``model_analysis``; ``interop.x_from_numpy``'s layout check.
* Slow: the whole-plant comparison with JAX (~350 s under the tier-1
  run's load), the 27 MPa case (as the JAX package marks its own), and the
  horizon-4 plant with per-period boiler flows held to JAX's solved x at
  1e-8 (~150 s of JAX on an idle CPU).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dispatches_tpu import Flowsheet as JFlowsheet  # noqa: E402
from dispatches_tpu.case_studies.fossil import usc_plant as jup  # noqa: E402
from dispatches_tpu.models import steam_cycle as jsc  # noqa: E402
from dispatches_tpu.solvers.newton import NewtonOptions as JNewtonOptions  # noqa: E402
from dispatches_tpu.solvers.newton import make_newton_solver as j_make_newton  # noqa: E402
from dispatches_tpu.solvers.newton import solve_square as j_solve_square  # noqa: E402

from dispatches_tpu_torch.case_studies.fossil import usc_plant as up  # noqa: E402
from dispatches_tpu_torch.core.graph import Flowsheet as TFlowsheet  # noqa: E402
from dispatches_tpu_torch.interop import x_from_numpy  # noqa: E402
from dispatches_tpu_torch.models import steam_cycle as tsc  # noqa: E402
from dispatches_tpu_torch.properties import iapws95 as w95  # noqa: E402
from dispatches_tpu_torch.solvers.newton import (  # noqa: E402
    NewtonOptions,
    make_newton_solver,
    solve_square,
)

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one intra-op thread, as the other test_torch_* modules."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_rel(got, want, rtol, what=""):
    """``max|got - want| <= rtol * max(1, max|want|)``; non-finite entries
    (an FWH's Underwood LMTD has an infinite slope where its two
    temperature differences vanish, as at x0) must sit at the same places
    in both."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bad = ~np.isfinite(want)
    np.testing.assert_array_equal(~np.isfinite(got), bad, err_msg=what)
    got, want = got[~bad], want[~bad]
    if not want.size:
        return
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * scale, (what, err, scale)


def _tparams(nlp):
    return nlp.default_params()


def _layout(nlp):
    """Everything a layout is: names, order, shapes, bounds, scales,
    fixed values and residual rows."""
    return {
        "free": list(nlp.free_names),
        "fixed": list(nlp.fixed_names),
        "slices": {k: (int(a), int(b), tuple(s)) for k, (a, b, s) in nlp._slices.items()},
        "scale": np.asarray(nlp.var_scale).tobytes(),
        "lb": np.asarray(nlp.lb).tobytes(),
        "ub": np.asarray(nlp.ub).tobytes(),
        "fixed_values": {k: np.asarray(v).tobytes()
                         for k, v in nlp.default_params()["fixed"].items()},
        "params": {k: np.asarray(v).tobytes() for k, v in nlp.default_params()["p"].items()},
        "eq": dict(nlp.eq_slices),
        "ineq": dict(nlp.ineq_slices),
    }


# ---------------------------------------------------------------------------
# solve_square on a small bounded system
# ---------------------------------------------------------------------------


def _square(Flowsheet, xp):
    fs = Flowsheet(horizon=3)
    fs.add_var("a", lb=0.0, ub=3.0, init=2.9, scale=2.0)
    fs.add_var("b", lb=-5.0, ub=5.0, init=-4.0)
    fs.add_var("c", lb=0.05, ub=10.0, init=9.0, scale=5.0)
    fs.add_param("k", np.array([1.0, 1.5, 2.0]))
    fs.add_eq("e1", lambda v, p: v["a"] ** 2 + v["b"] - 2.0 * p["k"])
    fs.add_eq("e2", lambda v, p: v["b"] * v["c"] - 1.5 + 0.1 * v["a"], scale=2.0)
    fs.add_eq("e3", lambda v, p: xp.exp(0.3 * v["a"]) + v["c"] - 3.0 * p["k"])
    return fs.compile()


@pytest.mark.parametrize("linear_solver", ["auto", "refined_f32"])
def test_solve_square_matches_jax(linear_solver):
    jn, tn = _square(JFlowsheet, jnp), _square(TFlowsheet, torch)
    assert _layout(jn) == _layout(tn)
    jopt, topt = JNewtonOptions(linear_solver=linear_solver), NewtonOptions(linear_solver=linear_solver)
    jres, jtr = jax.jit(j_make_newton(jn, jopt, trace=True))(jn.default_params())
    tres, ttr = make_newton_solver(tn, topt, trace=True, device=CPU)(tn.default_params())
    assert bool(tres.converged) and bool(jres.converged)
    assert int(tres.iterations) == int(jres.iterations) > 2
    assert_rel(tres.x, jres.x, 1e-10, "x")
    assert float(tres.max_residual) <= 1e-8
    assert ttr["max_residual"].shape == jtr["max_residual"].shape == (50,)
    # the trace agrees until the residual reaches rounding level
    jt, tt = np.asarray(jtr["max_residual"]), _np(ttr["max_residual"])
    big = jt > 1e-6
    np.testing.assert_allclose(tt[big], jt[big], rtol=1e-8)
    assert np.all(tt[~big] <= 1e-6)
    # solve_square: the same result from a given x0, jit accepted and ignored
    x0 = np.asarray(jn.x0) * 0.9
    j2 = j_solve_square(jn, x0=x0, options=jopt)
    t2 = solve_square(tn, x0=x0, options=topt, jit=False, device=CPU)
    assert int(t2.iterations) == int(j2.iterations)
    assert_rel(t2.x, j2.x, 1e-10, "x from x0")


def test_solve_square_rejects_non_square_and_follows_the_device_rule():
    fs = TFlowsheet(horizon=2)
    fs.add_var("a", init=1.0)
    fs.add_var("b", init=1.0)
    fs.add_eq("e", lambda v, p: v["a"] - v["b"])
    nlp = fs.compile()
    with pytest.raises(ValueError, match="n_eq == n_var"):
        make_newton_solver(nlp, device=CPU)
    with pytest.raises(ValueError, match="linear_solver"):
        make_newton_solver(_square(TFlowsheet, torch), NewtonOptions(linear_solver="qr"),
                           device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            solve_square(_square(TFlowsheet, torch))


# ---------------------------------------------------------------------------
# one-unit steam flowsheets
# ---------------------------------------------------------------------------


def _unit_flowsheet(Flowsheet, sc, kind):
    fs = Flowsheet(horizon=2)
    if kind == "turbine":
        u = sc.SteamTurbineStage(fs, "t", inlet_phase="vap", outlet_phase="vap")
        fs.fix(u.ratioP, 0.5)
        fs.fix(u.efficiency_isentropic, 0.9)
    elif kind == "pump":
        u = sc.SteamIsentropicCompressor(fs, "p")
        fs.fix(u.deltaP, 2e6)
    elif kind == "fwh":
        u = sc.SteamFWH(fs, "f", shell_inlet_phase="wet", turb_press_ratio=0.476,
                        reheater_press_diff=1e5)
        fs.fix(u.area, 200.0)
    elif kind == "mixer":
        u = sc.SteamMixer(fs, "m", inlet_list=["steam", "drain", "feed"],
                          inlet_phases={"drain": "wet", "feed": "liq"})
        t_out = u.outlet_state.temperature
        fs.add_eq("t_out", lambda v, p: v[t_out] - 400.0)
    elif kind == "splitter":
        u = sc.SteamSplitter(fs, "s", num_outlets=3)
        u.outlet_states[1].temperature  # noqa: B018
    elif kind == "heater":
        u = sc.SteamHeater(fs, "h", inlet_phase="liq", outlet_phase="sc")
        fs.fix(u.outlet_state.temperature, 866.15)
    else:
        raise ValueError(kind)
    return fs.compile()


def _random_x(nlp, seed):
    rng = np.random.default_rng(seed)
    lb, ub = np.asarray(nlp.lb), np.asarray(nlp.ub)
    x0 = np.asarray(nlp.x0)
    lo = np.where(np.isfinite(lb), lb, x0 - 1.0)
    hi = np.where(np.isfinite(ub), ub, x0 + 1.0)
    # within the box, away from its edges (delta > 0 for the EoS)
    return lo + (hi - lo) * rng.uniform(0.05, 0.95, x0.shape)


@pytest.mark.parametrize("kind", ["turbine", "pump", "fwh", "mixer", "splitter", "heater"])
def test_unit_flowsheets_match_jax(kind):
    jn = _unit_flowsheet(JFlowsheet, jsc, kind)
    tn = _unit_flowsheet(TFlowsheet, tsc, kind)
    assert _layout(tn) == _layout(jn)
    jp, tp = jn.default_params(), tn.default_params()
    j_eq = jax.jit(lambda xx: jn.eq(xx, jp))
    j_jac = jax.jit(jax.jacfwd(lambda xx: jn.eq(xx, jp)))
    for x in (np.asarray(jn.x0), _random_x(jn, 7)):
        xt = torch.as_tensor(x)
        assert_rel(tn.eq(xt, tp), j_eq(jnp.asarray(x)), 1e-12, f"{kind} eq")
        tj = torch.func.jacfwd(lambda xx: tn.eq(xx, tp))(xt)
        assert_rel(tj, j_jac(jnp.asarray(x)), 1e-12, f"{kind} jacobian")


# ---------------------------------------------------------------------------
# the whole plant, once per package
# ---------------------------------------------------------------------------


#: initialize's x0 against JAX's.  Not the 1e-10 of the fields: the
#: saturation pressure at a liquid density carries ~1e-5 Pa of rounding
#: noise in both packages (tests/test_torch_iapws95.py), sat_solve_P's
#: secant and h_ps carry it into the wet states, and turbine 11's work
#: (a difference of two enthalpies times the flow) shows it at 6.1e-10.
X0_RTOL = 1e-9


@pytest.fixture(scope="module")
def port_plant():
    m = up.build_plant_model()
    up.initialize(m)
    nlp = m.fs.compile()
    res = solve_square(nlp, device=CPU)
    return m, nlp, res


@pytest.fixture(scope="module")
def jax_plant():
    m = jup.build_plant_model()
    jup.initialize(m)
    nlp = m.fs.compile()
    r0 = np.asarray(nlp.eq(nlp.x0, nlp.default_params()))
    res = j_solve_square(nlp)
    return m, nlp, res, r0


@pytest.mark.slow  # ~350 s under the 6-worker tier-1 run (the JAX plant's initialize,
# compile and solve): with it the run took 1,273 s of its 1,470 s cap on an
# 8-core CPU host; the anchors, the unit flowsheets and the solver cases below
# keep the plant's path in tier 1
def test_plant_layout_x0_residual_and_solution_match_jax(port_plant, jax_plant):
    m, nlp, res = port_plant
    jm, jn, jres, jr0 = jax_plant
    assert _layout(nlp) == _layout(jn)
    assert nlp.n == 678
    # initialize: the scaled x0, per entry relative to max(1, |x0|)
    x0, jx0 = np.asarray(nlp.x0), np.asarray(jn.x0)
    assert np.max(np.abs(x0 - jx0) / np.maximum(1.0, np.abs(jx0))) <= X0_RTOL
    # the residual at that point, each row relative to the size of its
    # terms, sum_j |dr_i/dx_j x_j| (an EoS pressure row sums terms of ~300
    # to a residual of ~1); and at the port's own x0, which carries the x0
    # gap above through the Jacobian
    p = nlp.default_params()
    xj = x_from_numpy(jx0, jn, nlp, CPU)
    J = torch.func.jacfwd(lambda xx: nlp.eq(xx, p))(xj)
    terms = np.maximum(1.0, _np((J.abs() * xj.abs()).sum(1)))
    for x, rtol, what in ((xj, 1e-10, "at JAX's x0"), (torch.as_tensor(x0), 1e-8, "at the port's x0")):
        err = np.abs(_np(nlp.eq(x, p)) - jr0) / terms
        assert err.max() <= rtol, (what, float(err.max()), int(err.argmax()))
    # the solve
    assert bool(res.converged) and bool(jres.converged)
    assert int(res.iterations) == int(jres.iterations)
    assert float(res.max_residual) <= 1e-8
    x, jx = _np(res.x), np.asarray(jres.x)
    assert np.max(np.abs(x - jx) / np.maximum(1.0, np.abs(jx))) <= 1e-8


def test_interop_checks_the_layout(port_plant):
    jn, tn = _square(JFlowsheet, jnp), _square(TFlowsheet, torch)
    x = x_from_numpy(np.asarray(jn.x0), jn, tn, CPU)
    assert x.dtype == torch.float64 and x.shape == (tn.n,)
    np.testing.assert_array_equal(_np(x), np.asarray(jn.x0))
    _, nlp, _ = port_plant
    with pytest.raises(ValueError, match="free variables"):
        x_from_numpy(np.asarray(jn.x0), jn, nlp, CPU)


def test_square(port_plant):
    m, nlp, res = port_plant
    assert nlp.eq(torch.as_tensor(nlp.x0), nlp.default_params()).shape[-1] == nlp.n


def test_usc_model(port_plant):
    """tests/test_usc_plant.py::test_usc_model on the port."""
    m, nlp, res = port_plant
    assert bool(res.converged)
    sol = nlp.unravel(res.x)
    assert sol["plant_power_out"][0] == pytest.approx(436.466, abs=1e-2)
    works = sum(sol[f"{unit}.work_mechanical"][0]
                for unit in ("booster", "bfp", "bfpt", "cond_pump"))
    assert works == pytest.approx(0.0, abs=1e4)


def test_solved_state_physics(port_plant):
    """tests/test_usc_plant.py::test_solved_state_physics on the port."""
    m, nlp, res = port_plant
    sol = nlp.unravel(res.x)
    assert sol["condenser.outlet.pressure"][0] == pytest.approx(6895.5, rel=1e-3)
    assert sol["condenser.outlet.eos.temperature"][0] == pytest.approx(311.87, rel=1e-3)
    st = w95.flash_hp(sol["turbine_11.outlet.enth_mol"][0], sol["turbine_11.outlet.pressure"][0])
    assert st["phase"] == "two-phase"
    assert 0.9 < st["x"] < 1.0
    assert sol["condenser_mix.makeup.flow_mol"][0] == pytest.approx(0.0, abs=1e-3)
    assert sol["boiler.inlet.enth_mol"][0] == pytest.approx(23737, rel=2e-2)
    assert sol["boiler.inlet.pressure"][0] == pytest.approx(32216913, rel=1e-3)


def _carry_x0(nlp_old, nlp_new, x_old):
    """Map a solved x between compiles with different fixed sets
    (tests/test_usc_plant.py's helper)."""
    x_old = _np(x_old)
    x0 = np.array(nlp_new.x0)
    for name in nlp_new.free_names:
        if name in nlp_old._slices:
            a, b, _ = nlp_old._slices[name]
            lo, hi, _ = nlp_new._slices[name]
            x0[lo:hi] = x_old[a:b] * np.asarray(nlp_old.var_scale[a:b]) \
                / nlp_new.fs.var_specs[name].scale
    return x0


def test_change_power(port_plant):
    """tests/test_usc_plant.py::test_change_power on the port: fix 300 MW,
    free the boiler flow, warm from the solved plant."""
    m, nlp, res = port_plant
    fs = m.fs
    fs.fix("plant_power_out", 300.0)
    fs.unfix(m["boiler"].inlet_state.flow_mol)
    try:
        nlp2 = fs.compile()
        res2 = solve_square(nlp2, x0=_carry_x0(nlp, nlp2, res.x), device=CPU)
        assert bool(res2.converged)
        sol = nlp2.unravel(res2.x)
        assert sol["boiler.inlet.flow_mol"][0] == pytest.approx(12474.473, abs=2.0)
    finally:
        fs.unfix("plant_power_out")
        fs.fix(m["boiler"].inlet_state.flow_mol, up.MAIN_FLOW)


def test_plant_entry_points_follow_the_device_rule():
    m = up.build_plant_model()
    nlp = m.fs.compile()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_square(nlp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        up.solve_plant(m)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        up.model_analysis(m)


@pytest.mark.slow  # ~40 s on the port: re-initializes and re-solves at 27 MPa,
# as the JAX package marks its own
def test_change_pressure(port_plant):
    """tests/test_usc_plant.py::test_change_pressure on the port."""
    m, nlp, res = port_plant
    fs = m.fs
    fs.fix(m["boiler"].outlet_state.pressure, 27e6)
    try:
        up.initialize(m, main_pressure=27e6)
        nlp2 = fs.compile()
        res2 = solve_square(nlp2, device=CPU)
        assert bool(res2.converged)
        sol = nlp2.unravel(res2.x)
        assert sol["plant_power_out"][0] == pytest.approx(446.15, abs=0.2)
        assert sol["plant_heat_duty"][0] == pytest.approx(940.4, abs=0.5)
    finally:
        fs.fix(m["boiler"].outlet_state.pressure, up.MAIN_STEAM_PRESSURE)


HORIZON_FLOWS = np.array([1.0, 0.9, 0.8, 0.7])
HORIZON_POWERS = np.array([436.46443365, 390.78256508, 345.49945713, 300.58482839])


def _horizon_plant(pkg):
    m = pkg.build_plant_model(horizon=4)
    pkg.initialize(m)
    m.fs.fix(m["boiler"].inlet_state.flow_mol, HORIZON_FLOWS * pkg.MAIN_FLOW)
    return m, m.fs.compile()


@pytest.mark.slow  # ~150 s of JAX on an idle CPU (initialize, compile, solve at n = 2712)
def test_horizon_plant_matches_jax():
    """The horizon-vectorized plant with per-period boiler flows: layout
    equal, x0 and the solved x as the single-period plant's, each period's
    power within 1e-6 relative of the JAX run's."""
    m, nlp = _horizon_plant(up)
    jm, jn = _horizon_plant(jup)
    assert _layout(nlp) == _layout(jn) and nlp.n == 2712
    x0, jx0 = np.asarray(nlp.x0), np.asarray(jn.x0)
    assert np.max(np.abs(x0 - jx0) / np.maximum(1.0, np.abs(jx0))) <= X0_RTOL
    res, jres = solve_square(nlp, device=CPU), j_solve_square(jn)
    assert bool(res.converged) and bool(jres.converged)
    assert int(res.iterations) == int(jres.iterations)
    x, jx = _np(res.x), np.asarray(jres.x)
    assert np.max(np.abs(x - jx) / np.maximum(1.0, np.abs(jx))) <= 1e-8
    power = nlp.unravel(res.x)["plant_power_out"]
    np.testing.assert_allclose(power, HORIZON_POWERS, rtol=1e-6)
