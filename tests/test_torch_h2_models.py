"""The PyTorch port's hydrogen property packages and unit models held to
the JAX package on the CPU, in float64.

- Properties (cp, h, s per component and for mixtures, ``mw_mix``,
  ``dens_mol``) at seeded random (T, P, y) within 1e-12 relative, plus the
  NIST anchors of tests/test_properties.py; the reaction package bitwise.
- Each unit (PEM, simple and detailed tank, translator, mixer, turbine,
  PV) in a one-unit flowsheet built by both packages: the layout equal,
  the objective, residuals and their Jacobians at x0 and at a seeded
  random x within 1e-12 relative (max-norm of the difference over
  max(1, max-norm of the JAX value)).
- The square solves of tests/test_models.py with their anchors, and the
  turbine's host-side ``initialize`` within 1e-12 of JAX's.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dispatches_tpu import Flowsheet as JFlowsheet  # noqa: E402
from dispatches_tpu import models as j_models  # noqa: E402
from dispatches_tpu import properties as j_props  # noqa: E402

from dispatches_tpu_torch import models as t_models  # noqa: E402
from dispatches_tpu_torch import properties as t_props  # noqa: E402
from dispatches_tpu_torch.core.graph import Flowsheet as TFlowsheet  # noqa: E402
from dispatches_tpu_torch.solvers import IPMOptions, solve_nlp  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

RTOL = 1e-12
PKG = {
    "jax": SimpleNamespace(Flowsheet=JFlowsheet, models=j_models, props=j_props, xp=jnp),
    "torch": SimpleNamespace(Flowsheet=TFlowsheet, models=t_models, props=t_props, xp=torch),
}
SLACK_Y = {"hydrogen": 0.99, "oxygen": 0.0025, "argon": 0.0025,
           "nitrogen": 0.0025, "water": 0.0025}
AIR_Y = {"oxygen": 0.2054, "argon": 0.0032, "nitrogen": 0.7672,
         "water": 0.0240, "hydrogen": 2e-4}


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_rel(got, want, rtol=RTOL, what=""):
    """max|got - want| <= rtol * max(1, max|want|): relative to the JAX
    value's max-norm, absolute below 1 (residuals at a feasible point are
    rounding noise around zero)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not want.size:
        return
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * scale, (what, err, scale)


# ---------------------------------------------------------------------------
# properties
# ---------------------------------------------------------------------------


def _state(seed, n=64, C=5):
    rng = np.random.default_rng(seed)
    T = rng.uniform(273.15, 2000.0, n)
    P = rng.uniform(5e4, 1e8, n)
    y = rng.dirichlet(np.ones(C), n)
    if C > 2:
        y[:4, 2] = 0.0  # a component burned out entirely: the y log y guard
    return T, P, y / y.sum(-1, keepdims=True)


@pytest.mark.parametrize("pkg", ["h2_ideal_vap", "hturbine_ideal_vap"])
def test_property_functions_match_jax(pkg):
    jp, tp = getattr(j_props, pkg), getattr(t_props, pkg)
    T, P, y = _state(1, C=jp.n_comp)
    tT, tP, ty = (torch.as_tensor(a) for a in (T, P, y))
    for fn in ("cp_mol_comp", "enth_mol_comp", "entr_mol_comp"):
        assert_rel(getattr(tp, fn)(tT), getattr(jp, fn)(T), what=fn)
    ym = None if jp.n_comp == 1 else y
    tym = None if jp.n_comp == 1 else ty
    assert_rel(tp.cp_mol(tT, tym), jp.cp_mol(T, ym), what="cp_mol")
    assert_rel(tp.enth_mol(tT, tym), jp.enth_mol(T, ym), what="enth_mol")
    assert_rel(tp.entr_mol(tT, tP, tym), jp.entr_mol(T, P, ym), what="entr_mol")
    assert_rel(np.asarray(tp.mw_mix(tym)), np.asarray(jp.mw_mix(ym)), what="mw_mix")
    assert_rel(tp.dens_mol(tT, tP), jp.dens_mol(T, P), what="dens_mol")
    # numpy inputs (host-side callers) give the same values
    assert_rel(tp.entr_mol(T, P, ym), jp.entr_mol(T, P, ym), what="entr_mol numpy")
    np.testing.assert_array_equal(tp.shomate, jp.shomate)
    np.testing.assert_array_equal(tp.mw, jp.mw)
    assert (tp.components, tp.flow_bounds, tp.temperature_bounds, tp.pressure_bounds) == (
        jp.components, jp.flow_bounds, jp.temperature_bounds, jp.pressure_bounds)


def test_property_gradients_match_jax():
    """d s / d(T, P, y) of the mixture: the AD path the turbine's
    residuals take."""
    T, P, y = _state(2)
    jg = jax.grad(lambda a, b, c: jnp.sum(j_props.hturbine_ideal_vap.entr_mol(a, b, c)),
                  argnums=(0, 1, 2))(T, P, y)
    tg = torch.func.grad(lambda a, b, c: torch.sum(t_props.hturbine_ideal_vap.entr_mol(a, b, c)),
                         argnums=(0, 1, 2))(*(torch.as_tensor(a) for a in (T, P, y)))
    for g, w in zip(tg, jg):
        assert_rel(g, w)


@pytest.mark.parametrize(
    "T,cp,h,s",
    [
        (300.0, 28.85, 53.51, 130.9),
        (500.0, 29.26, 5880.0, 145.7),
        (900.0, 29.88, 17680.0, 163.1),
    ],
)
def test_h2_ideal_vap_nist(T, cp, h, s):
    pkg = t_props.h2_ideal_vap
    assert float(pkg.cp_mol(T)) == pytest.approx(cp, rel=1e-2)
    assert float(pkg.enth_mol(T)) == pytest.approx(h, rel=1e-2)
    assert float(pkg.entr_mol(T, 101325.0)) == pytest.approx(s, rel=1e-2)


def test_enthalpy_zero_at_ref_and_mixing_entropy():
    for pkg in (t_props.h2_ideal_vap, t_props.hturbine_ideal_vap):
        np.testing.assert_allclose(_np(pkg.enth_mol_comp(298.15)), 0.0, atol=1e-8)
    y = np.array([0.5, 0.2, 0.1, 0.1, 0.1])
    pkg = t_props.hturbine_ideal_vap
    s_mix = float(pkg.entr_mol(400.0, 101325.0, y))
    assert s_mix > float(np.sum(y * _np(pkg.entr_mol_comp(400.0))))


def test_constants_cached_per_device_and_dtype():
    pkg = t_props.IdealGasPackage(name="h2", components=("hydrogen",),
                                  mw=t_props.h2_ideal_vap.mw,
                                  shomate=t_props.h2_ideal_vap.shomate)
    T = torch.full((3,), 400.0, dtype=torch.float64)
    pkg.cp_mol(T)
    first = pkg._consts(T)
    pkg.entr_mol(T, 2e5)
    assert pkg._consts(T) is first and len(pkg._cache) == 1
    pkg.cp_mol(T.float())
    assert len(pkg._cache) == 2


def test_reaction_bitwise():
    rng = np.random.default_rng(3)
    fc = rng.uniform(0.0, 1000.0, (6, 5))
    conv = 0.87
    jr, tr = j_props.H2CombustionReaction(), t_props.H2CombustionReaction()
    np.testing.assert_array_equal(tr.nu(), jr.nu())
    tfc = torch.as_tensor(fc)
    for fn in ("extent", "outlet_flows", "heat_of_reaction"):
        got = _np(getattr(tr, fn)(tfc, torch.tensor(conv, dtype=torch.float64)))
        np.testing.assert_array_equal(got, np.asarray(getattr(jr, fn)(fc, conv)), err_msg=fn)
    got = _np(tr.outlet_flows(fc, 0.5))  # numpy inputs
    got = dict(zip(tr.props.components, got[0]))
    assert got["water"] == pytest.approx(fc[0, 3] + fc[0, 0] * 0.5)


# ---------------------------------------------------------------------------
# one-unit flowsheets built by both packages
# ---------------------------------------------------------------------------

H = 3  # horizon of the one-unit flowsheets


def _pem(P):
    fs = P.Flowsheet(horizon=H)
    pem = P.models.PEMElectrolyzer(fs)
    fs.fix(pem.outlet_state.temperature, 300.0)
    fs.fix(pem.outlet_state.pressure, 101325.0)
    return fs, lambda v, p: P.xp.sum(v["pem.outlet.flow_mol"])


def _simple_tank(P):
    fs = P.Flowsheet(horizon=H)
    tank = P.models.SimpleHydrogenTank(fs)
    tank.inlet_state.fix_state(temperature=300, pressure=101325)
    fs.fix(tank.v("tank_holdup_previous"), 0)
    return fs, lambda v, p: P.xp.sum(v["h2_tank.tank_holdup"])


def _detailed_tank(P):
    fs = P.Flowsheet(horizon=H)
    tank = P.models.HydrogenTank(fs, name="unit")
    fs.fix(tank.v("tank_diameter"), 0.1)
    fs.fix(tank.v("tank_length"), 0.3)
    fs.fix(tank.v("previous_temperature"), 300)
    fs.fix(tank.v("previous_pressure"), 1e5)
    tank.inlet_state.fix_state(temperature=300, pressure=3e6)
    fs.set_init(tank.v("material_holdup"), 3600.0)
    fs.set_init(tank.v("pressure"), 3e9)
    return fs, lambda v, p: P.xp.sum(v["unit.material_holdup"] * v["unit.temperature"])


def _translator(P):
    fs = P.Flowsheet(horizon=H)
    tr = P.models.Translator(fs, inlet_props=P.props.h2_ideal_vap,
                             outlet_props=P.props.hturbine_ideal_vap,
                             outlet_mole_fracs=SLACK_Y)
    fs.fix(tr.inlet_state.temperature, 300.0)
    return fs, lambda v, p: P.xp.sum(v["translator.outlet.flow_mol"])


def _mixer(P):
    fs = P.Flowsheet(horizon=H)
    mx = P.models.Mixer(fs, props=P.props.hturbine_ideal_vap,
                        inlet_list=["air_feed", "hydrogen_feed", "purchased_hydrogen_feed"])
    mx.fix_feed_composition("air_feed", AIR_Y)
    mx.fix_feed_composition("purchased_hydrogen_feed", SLACK_Y)
    fs.fix(mx.inlet_states["air_feed"].temperature, 300.0)
    return fs, lambda v, p: P.xp.sum(v["mixer.mixed.temperature"])


def _turbine(P, init=True):
    fs = P.Flowsheet(horizon=1)
    turb = P.models.HydrogenTurbine(fs)
    y_in = {"oxygen": 0.188, "argon": 0.003, "nitrogen": 0.702,
            "water": 0.022, "hydrogen": 0.085}
    fc = np.array([[y_in[c] * 4135.2 for c in turb.props.components]])
    fs.fix(turb.inlet_state.flow_mol_comp, fc)
    fs.fix(turb.inlet_state.temperature, 288.15)
    fs.fix(turb.inlet_state.pressure, 101325)
    fs.fix(turb.v("compressor.deltaP"), 2.401e6)
    fs.fix(turb.v("compressor.efficiency_isentropic"), 0.86)
    fs.fix(turb.v("reactor.conversion"), 0.99)
    fs.fix(turb.v("turbine.deltaP"), -2.401e6)
    fs.fix(turb.v("turbine.efficiency_isentropic"), 0.89)
    if init:
        turb.initialize()
    return fs, lambda v, p: P.xp.sum(v["h2_turbine.turbine.work_mechanical"]
                                     + v["h2_turbine.compressor.work_mechanical"])


def _pv(P):
    fs = P.Flowsheet(horizon=H)
    pv = P.models.SolarPV(fs, capacity_factors=[0.6, 0.3, 0.0])
    fs.fix(pv.v("system_capacity"), 50.0)
    return fs, lambda v, p: P.xp.sum(v["pv.electricity"])


UNITS = {"pem": _pem, "simple_tank": _simple_tank, "detailed_tank": _detailed_tank,
         "translator": _translator, "mixer": _mixer, "turbine": _turbine, "pv": _pv}


def _compile(make_unit, P):
    fs, obj = make_unit(P)
    return fs.compile(objective=obj, sense="max")


def assert_same_layout(tn, jn, x0_rtol=0.0):
    """Exactly the JAX layout; ``x0_rtol`` where the inits come from a
    host-side bisection (last bits of ``log`` may differ)."""
    assert (tn.n, tn.m_eq, tn.m_ineq) == (jn.n, jn.m_eq, jn.m_ineq)
    assert tn.free_names == jn.free_names and tn.fixed_names == jn.fixed_names
    assert tn._slices == jn._slices
    assert tn.eq_slices == jn.eq_slices and tn.ineq_slices == jn.ineq_slices
    for attr in ("lb", "ub", "var_scale"):
        np.testing.assert_array_equal(getattr(tn, attr), np.asarray(getattr(jn, attr)), err_msg=attr)
    if x0_rtol:
        np.testing.assert_allclose(tn.x0, np.asarray(jn.x0), rtol=x0_rtol, atol=0)
    else:
        np.testing.assert_array_equal(tn.x0, np.asarray(jn.x0))


def random_x(nlp, seed):
    """x0 moved by up to 10% and nudged off zero: inside the property
    domain (positive temperatures, pressures and flows)."""
    rng = np.random.default_rng(seed)
    x0 = np.asarray(nlp.x0)
    return x0 * (1.0 + 0.2 * (rng.random(x0.shape) - 0.5)) + 0.05 * rng.random(x0.shape)


def assert_callables_match(tn, jn, seed, rtol=RTOL):
    """objective, eq, ineq and their Jacobians at x0 and at a random x."""
    jp, tp = jn.default_params(), tn.default_params()
    for x in (np.asarray(jn.x0), random_x(jn, seed)):
        tx = torch.as_tensor(x)
        for fn in ("objective", "eq", "ineq"):
            jf = getattr(jn, fn)
            tf = getattr(tn, fn)
            assert_rel(tf(tx, tp), jf(x, jp), rtol, what=fn)
            want = jax.jacfwd(lambda y: jf(y, jp))(jnp.asarray(x))
            got = torch.func.jacrev(lambda y: tf(y, tp))(tx)
            assert_rel(got, want, rtol, what=f"jacobian of {fn}")


@pytest.mark.parametrize("unit", sorted(UNITS))
def test_unit_layout_and_derivatives_match_jax(unit):
    jn = _compile(UNITS[unit], PKG["jax"])
    tn = _compile(UNITS[unit], PKG["torch"])
    # the turbine's inits come from initialize()'s bisections
    assert_same_layout(tn, jn, x0_rtol=RTOL if unit == "turbine" else 0.0)
    assert tn.n > 0 and tn.m_eq + tn.m_ineq > 0
    assert_callables_match(tn, jn, seed=sorted(UNITS).index(unit))


def test_turbine_initialize_matches_jax():
    """The stagewise bisections (80 halvings per scalar) on the host: every
    init of the unit within 1e-12 relative of JAX's, from the fixed inlet
    and from a nominal feed passed in (the full hybrid's warm start)."""
    for kwargs in ({}, {"flow_mol_comp": np.array([0.01, 0.08, 0.02, 0.003, 0.0003]),
                        "temperature": 300.0, "pressure": 101325.0}):
        fss = {}
        for name, P in PKG.items():
            fs, _ = _turbine(P, init=False)
            fs.units["h2_turbine"].initialize(**kwargs)
            fss[name] = fs
        for var, js in fss["jax"].var_specs.items():
            ts = fss["torch"].var_specs[var]
            assert_rel(np.asarray(ts.init, dtype=float), np.asarray(js.init, dtype=float),
                       what=var)


# ---------------------------------------------------------------------------
# square solves of tests/test_models.py on the port
# ---------------------------------------------------------------------------


def _solve(fs, objective=None, sense="min", **opts):
    nlp = fs.compile(objective=objective, sense=sense)
    res = solve_nlp(nlp, options=IPMOptions(**opts) if opts else None, device="cpu")
    return nlp, res


def test_pem_electrolyzer_solve():
    fs = TFlowsheet(horizon=1)
    pem = t_models.PEMElectrolyzer(fs)
    fs.fix(pem.v("electricity"), 5000.0)
    fs.fix(pem.outlet_state.temperature, 300.0)
    fs.fix(pem.outlet_state.pressure, 101325.0)
    nlp, res = _solve(fs)
    assert bool(res.converged)
    assert nlp.unravel(res.x)["pem.outlet.flow_mol"][0] == pytest.approx(5000 * 0.002527406, rel=1e-8)


def test_simple_hydrogen_tank_solve():
    fs = TFlowsheet(horizon=1)
    tank = t_models.SimpleHydrogenTank(fs)
    tank.inlet_state.fix_state(flow_mol=25, temperature=300, pressure=101325)
    fs.fix(tank.v("tank_holdup_previous"), 0)
    fs.fix(tank.pipeline_state.flow_mol, 10)
    fs.fix(tank.turbine_state.flow_mol, 10)
    nlp, res = _solve(fs)
    assert bool(res.converged)
    sol = nlp.unravel(res.x)
    assert sol["h2_tank.tank_holdup"][0] == pytest.approx(3600 * 5, rel=1e-6)
    assert sol["h2_tank.outlet_to_pipeline.temperature"][0] == pytest.approx(300)
    assert sol["h2_tank.outlet_to_turbine.pressure"][0] == pytest.approx(101325)


def _tank_square(out_flow):
    fs = TFlowsheet(horizon=1)
    tank = t_models.HydrogenTank(fs, name="unit")
    fs.fix(tank.v("tank_diameter"), 0.1)
    fs.fix(tank.v("tank_length"), 0.3)
    fs.fix(tank.v("previous_temperature"), 300)
    fs.fix(tank.v("previous_pressure"), 1e5)
    tank.inlet_state.fix_state(flow_mol=1, temperature=300, pressure=3e6)
    fs.fix(tank.outlet_state.flow_mol, out_flow)
    fs.set_init(tank.v("material_holdup"), 3600 * (1 - out_flow))
    fs.set_init(tank.v("pressure"), 3e9 * max(1 - out_flow, 0.1))
    return fs


@pytest.mark.parametrize("out_flow,holdup,temp,pres", [
    (0.0, 3600.0945, 300.749, 3820683416.393),
    (0.9, 360.0945, 300.055, 381276651.957),
], ids=["filling", "emptying"])
def test_hydrogen_tank_solve(out_flow, holdup, temp, pres):
    nlp, res = _solve(_tank_square(out_flow))
    assert bool(res.converged)
    sol = nlp.unravel(res.x)
    assert sol["unit.material_holdup"][0] == pytest.approx(holdup, rel=1e-3)
    assert sol["unit.temperature"][0] == pytest.approx(temp, rel=1e-3)
    assert sol["unit.pressure"][0] == pytest.approx(pres, rel=1e-2)


def test_hydrogen_turbine_solve():
    fs, _ = _turbine(PKG["torch"])
    nlp, res = _solve(fs, max_iter=300)
    assert bool(res.converged)
    sol = nlp.unravel(res.x)
    comps = t_props.hturbine_ideal_vap.components
    assert sol["h2_turbine.compressor.outlet.temperature"][0] == pytest.approx(763.25, rel=2e-2)
    fc_out = sol["h2_turbine.reactor.outlet.flow_mol_comp"][0]
    y_map = dict(zip(comps, fc_out / fc_out.sum()))
    assert y_map["hydrogen"] == pytest.approx(0.00085, rel=5e-2)
    assert y_map["nitrogen"] == pytest.approx(0.73285, rel=1e-2)
    assert y_map["oxygen"] == pytest.approx(0.15232, rel=1e-2)
    assert y_map["water"] == pytest.approx(0.11085, rel=1e-2)
    assert y_map["argon"] == pytest.approx(0.0031318, rel=1e-2)
    assert sol["h2_turbine.reactor.outlet.temperature"][0] == pytest.approx(1426.3, rel=2e-2)
    assert sol["h2_turbine.outlet.temperature"][0] == pytest.approx(726.44, rel=2e-2)
    assert sol["h2_turbine.turbine.work_mechanical"][0] < 0
    assert (sol["h2_turbine.compressor.work_mechanical"][0]
            + sol["h2_turbine.turbine.work_mechanical"][0]) < 0


def test_solar_pv_solve():
    fs = TFlowsheet(horizon=1)
    pv = t_models.SolarPV(fs, capacity_factors=[0.6])
    fs.fix(pv.v("system_capacity"), 50.0)
    nlp, res = _solve(fs, objective=lambda v, p: torch.sum(v["pv.electricity"]), sense="max")
    assert float(res.obj) == pytest.approx(30.0, abs=1e-5)
    with pytest.raises(ValueError, match="cover the horizon"):
        t_models.SolarPV(TFlowsheet(horizon=2), capacity_factors=[0.5])
