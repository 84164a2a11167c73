"""The port's IAPWS-95 property layer, its transport properties and the
liquid-salt packages held to the published tables and to the JAX
package on the CPU, in float64.

* Table 7 (single-phase P, cv, w, s) and Table 8 (saturation p, rho',
  rho'') of the IAPWS-95 release, and the IAPWS 2008/2011 viscosity and
  conductivity check points, at tests/test_iapws95.py's tolerances (1e-7
  and 1e-6 relative).
* ``phi0``, ``phir`` and every property on (delta, T) against JAX on a
  seeded grid over stable liquid, vapor, supercritical and near-critical
  states: per point ``|got - want| <= 1e-12 * max(1, |want|)``, the
  properties taken in the release's dimensionless form (p / (rho R T),
  h / (R T), s / R, cv / R, cp / R, w / sqrt(R T)) so that a liquid
  pressure that cancels to a few bar is held at the scale of its terms;
  the fields and their first and second partials (JAX takes them by
  ``jax.grad``, the port in closed form) within 1e-12 and 1e-10, the
  critical point itself (delta = 1, T = TC) included; cp alone in the
  near-critical band (TC + 1 to 660 K) at 1e-11, because its
  denominator vanishes at the critical point and amplifies rounding
  (measured up to 5.7e-12 over six seeds); the port's closed-form second
  partials equal ``torch.func`` derivatives of its first ones.
* The host solvers (``sat_solve_T``, ``sat_solve_P``, ``rho_tp``,
  ``props_tp``, ``flash_hp``, ``h_ps``) within 1e-10 relative of JAX's,
  including the phase tags, except where the solvers' own stopping rules
  leave more noise (each case says which and why).
* ``SolarSalt``, ``HitecSalt`` and ``ThermalOil`` at
  tests/test_properties.py's closed forms and within 1e-14 of JAX's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dispatches_tpu.properties import iapws95 as jw  # noqa: E402
from dispatches_tpu.properties import iapws_transport as jtr  # noqa: E402
from dispatches_tpu.properties import salts as jsalts  # noqa: E402

from dispatches_tpu_torch.properties import iapws95 as w  # noqa: E402
from dispatches_tpu_torch.properties import iapws_transport as tr  # noqa: E402
from dispatches_tpu_torch.properties import salts  # noqa: E402
from test_torch_stacked import one_torch_thread  # noqa: E402,F401

# (T [K], rho [kg/m3], P [MPa], cv [kJ/kg/K], w [m/s], s [kJ/kg/K])
TABLE7 = [
    (300.0, 0.9965560e3, 0.992418352e-1, 4.13018112, 1501.51914, 0.393062643),
    (300.0, 0.1005308e4, 0.200022515e2, 4.06798347, 1534.92501, 0.387405401),
    (300.0, 0.1188202e4, 0.700004704e3, 3.46135580, 2443.57992, 0.132609616),
    (500.0, 0.435000e0, 0.999679423e-1, 1.50817541, 548.314253, 7.94488271),
    (500.0, 0.453200e1, 0.999938125e0, 1.66991025, 535.739001, 6.82502725),
    (500.0, 0.838025e3, 0.100003858e2, 3.22106219, 1271.28441, 2.56690919),
    (500.0, 0.1084564e4, 0.700000405e3, 3.07437693, 2412.00877, 2.03237509),
    (647.0, 0.358000e3, 0.220384756e2, 6.18315728, 252.145078, 4.32092307),
    (900.0, 0.241000e0, 0.100062559e0, 1.75890657, 724.027147, 9.16653194),
    (900.0, 0.526150e2, 0.200000690e2, 1.93510526, 698.445674, 6.59070225),
    (900.0, 0.870769e3, 0.700000006e3, 2.66422350, 2019.33608, 4.17223802),
]
# (T [K], p [MPa], rho_liq [kg/m3], rho_vap [kg/m3])
TABLE8 = [
    (275.0, 0.698451167e-3, 0.999887406e3, 0.550664919e-2),
    (450.0, 0.932203564e0, 0.890341250e3, 0.481200360e1),
    (625.0, 0.169082693e2, 0.567090385e3, 0.118290280e3),
]
# (T [K], rho [kg/m3], mu [uPa s]) — 2008 release check table
VISC_PTS = [
    (298.15, 998.0, 889.735100), (298.15, 1200.0, 1437.649467),
    (373.15, 1000.0, 307.883622), (433.15, 1.0, 14.538324),
    (433.15, 1000.0, 217.685358), (873.15, 1.0, 32.619287),
    (873.15, 100.0, 35.802262), (873.15, 600.0, 77.430195),
    (1173.15, 1.0, 44.217245), (1173.15, 100.0, 47.640433),
    (1173.15, 400.0, 64.154608),
]
# (T, rho, k [mW/m/K]) — 2011 release check table (no critical enh.)
COND_PTS = [
    (298.15, 0.0, 18.4341883), (298.15, 998.0, 607.712868),
    (298.15, 1200.0, 799.038144), (873.15, 0.0, 79.1034659),
]


@pytest.mark.parametrize("T,rho,P,cv,ww,s", TABLE7)
def test_single_phase_points(T, rho, P, cv, ww, s):
    d = rho / w.RHOC
    assert float(w.p_dT(d, T)) / 1e6 == pytest.approx(P, rel=1e-7)
    assert float(w.cv_dT(d, T)) / w.MW / 1e3 == pytest.approx(cv, rel=1e-7)
    assert float(w.w_dT(d, T)) == pytest.approx(ww, rel=1e-7)
    assert float(w.s_dT(d, T)) / w.MW / 1e3 == pytest.approx(s, rel=1e-7)


@pytest.mark.parametrize("T,p,rl,rv", TABLE8)
def test_saturation_points(T, p, rl, rv):
    ps, dl, dv = w.sat_solve_T(T)
    assert ps / 1e6 == pytest.approx(p, rel=1e-7)
    assert dl * w.RHOC == pytest.approx(rl, rel=1e-7)
    assert dv * w.RHOC == pytest.approx(rv, rel=1e-7)


@pytest.mark.parametrize("T,rho,mu", VISC_PTS)
def test_viscosity_points(T, rho, mu):
    assert float(tr.visc_d(rho, T)) * 1e6 == pytest.approx(mu, rel=1e-6)


@pytest.mark.parametrize("T,rho,k", COND_PTS)
def test_conductivity_points(T, rho, k):
    assert float(tr.therm_cond(rho, T)) * 1e3 == pytest.approx(k, rel=1e-6)


# ---------------------------------------------------------------------------
# the fields and properties against JAX on a seeded grid
# ---------------------------------------------------------------------------


def _grid(seed=0, n=48, critical=True):
    """(delta, T) over stable liquid (compressed past the saturated
    liquid), vapor (below the saturated vapor), supercritical and
    near-critical (just above TC) states; with ``critical``, the critical
    point itself and its neighbours (delta = 1 and T = TC), where only the
    fields and their partials are defined."""
    rng = np.random.default_rng(seed)
    Tl = rng.uniform(275.0, 620.0, n)
    Tv = rng.uniform(300.0, 1250.0, n)
    dv_max = np.where(Tv < w.TC, 0.9 * w.sat_rhov_aux(np.minimum(Tv, w.TC - 1.0)) / w.RHOC, 0.3)
    parts = [
        (w.sat_rhol_aux(Tl) / w.RHOC * rng.uniform(1.0, 1.12, n), Tl),          # liquid
        (dv_max * 10 ** rng.uniform(-4, 0, n), Tv),                             # vapor
        (rng.uniform(0.05, 3.2, n), rng.uniform(700.0, 1300.0, n)),              # supercritical
        (rng.uniform(0.8, 1.2, n), rng.uniform(w.TC + 1.0, 660.0, n)),          # near-critical
    ]
    if critical:
        parts.append((np.array([1.0, 1.0, 1.0 + 1e-9, 0.999]),
                      np.array([w.TC, 650.0, w.TC, w.TC])))
    return (np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts]))


def _close(got, want, rtol, what, scale=1.0):
    """``|got - want| <= rtol * max(1, |want|)`` per point, both divided by
    ``scale`` first."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    got, want = got / scale, np.asarray(want) / scale
    assert got.shape == want.shape, what
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert np.all(np.isfinite(got)), what
    assert err.max() <= rtol, (what, float(err.max()), int(err.argmax()))


def _jgrad2(fn, d, t, wrt):
    """JAX's partial of an elementwise field by ``jax.grad`` of its sum."""
    d, t = jnp.asarray(d), jnp.asarray(t)
    if wrt == "d":
        return jax.grad(lambda dd: jnp.sum(fn(dd, t)))(d)
    return jax.grad(lambda tt: jnp.sum(fn(d, tt)))(t)


@pytest.mark.parametrize("seed", [0, 1])
def test_fields_and_properties_match_jax(seed):
    """Properties in the release's dimensionless form (p / (rho R T),
    h / (R T), s / R, ...), the scale of each state's ideal-gas part,
    within 1e-12; the fields and partials also at the critical point."""
    d, T = _grid(seed)
    tau = w.TC / T
    dt_, taut = torch.as_tensor(d), torch.as_tensor(tau)
    for name in ("phi0", "phir"):
        _close(getattr(w, name)(dt_, taut), getattr(jw, name)(d, tau), 1e-12, name)
    # first partials: closed form vs JAX's jax.grad
    for name in ("phir_d", "phir_t", "phi0_t"):
        _close(getattr(w, name)(dt_, taut), getattr(jw, name)(d, tau), 1e-10, name)
    # second partials: closed form vs JAX's grad of grad
    dd, tt, dtau = w.phir_second(dt_, taut)
    _close(dd, _jgrad2(jw.phir_d, d, tau, "d"), 1e-10, "phir_dd")
    _close(tt, _jgrad2(jw.phir_t, d, tau, "t"), 1e-10, "phir_tt")
    _close(dtau, _jgrad2(jw.phir_d, d, tau, "t"), 1e-10, "phir_dt")
    _close(w.phi0_tt(dt_, taut), _jgrad2(jw.phi0_t, d, tau, "t"), 1e-10, "phi0_tt")

    d, T = _grid(seed, critical=False)
    R = w.R_MOL
    scales = {"p_dT": d * w.RHOC * w.R_MASS * T, "h_dT": R * T, "s_dT": R, "u_dT": R * T,
              "g_dT": R * T, "cv_dT": R, "cp_dT": R, "w_dT": np.sqrt(w.R_MASS * T)}
    near = slice(3 * 48, 4 * 48)  # the near-critical band of _grid
    for name, sc in scales.items():
        got = getattr(w, name)(torch.as_tensor(d), torch.as_tensor(T))
        want = np.asarray(getattr(jw, name)(d, T))
        if name == "cp_dT":
            # cp's denominator 1 + 2 d phir_d + d^2 phir_dd vanishes at the
            # critical point: within 13 K above it, rounding in the two
            # packages' phir_dd moves cp by up to ~6e-12 relative
            far = np.ones(d.shape, bool)
            far[near] = False
            _close(got[near], want[near], 1e-11, name, scale=sc)
            got, want, sc = got[far], want[far], sc
        _close(got, want, 1e-12, name, scale=sc)


def test_closed_form_partials_equal_autograd():
    """What ``torch.func.jacfwd`` of a flowsheet residual sees: the
    derivatives of the closed-form first partials are the closed-form
    second partials."""
    d, T = _grid(2, n=16)
    dt_, taut = torch.as_tensor(d), torch.as_tensor(w.TC / T)
    dd, tt, dtau = w.phir_second(dt_, taut)

    def g(fn, wrt):
        if wrt == "d":
            return torch.func.grad(lambda x: fn(x, taut).sum())(dt_)
        return torch.func.grad(lambda x: fn(dt_, x).sum())(taut)

    _close(g(w.phir, "d"), w.phir_d(dt_, taut), 1e-11, "phir_d")
    _close(g(w.phir, "t"), w.phir_t(dt_, taut), 1e-11, "phir_t")
    _close(g(w.phi0, "t"), w.phi0_t(dt_, taut), 1e-11, "phi0_t")
    _close(g(w.phir_d, "d"), dd, 1e-10, "phir_dd")
    _close(g(w.phir_t, "t"), tt, 1e-10, "phir_tt")
    _close(g(w.phir_d, "t"), dtau, 1e-10, "phir_dt")
    _close(g(w.phir_t, "d"), dtau, 1e-10, "phir_td")
    _close(g(w.phi0_t, "t"), w.phi0_tt(dt_, taut), 1e-10, "phi0_tt")
    # the pressure's delta-derivative through jacfwd, critical point
    # included, in units of its terms' scale rho_c R T
    dp = torch.func.vmap(torch.func.jacfwd(lambda x, t: w.p_dT(x, t)))(
        dt_, torch.as_tensor(T))
    _close(dp, _jgrad2(jw.p_dT, d, T, "d"), 1e-10, "dp/ddelta", scale=w.RHOC * w.R_MASS * T)


def test_auxiliary_curves_match_jax():
    T = np.linspace(274.0, 646.0, 40)
    for name in ("sat_p_aux", "sat_rhol_aux", "sat_rhov_aux"):
        _close(getattr(w, name)(T), getattr(jw, name)(T), 1e-13, name)
        _close(getattr(w, name)(torch.as_tensor(T)), getattr(jw, name)(T), 1e-13, name)


def test_transport_matches_jax():
    rng = np.random.default_rng(5)
    rho, T = rng.uniform(0.5, 1200.0, 64), rng.uniform(280.0, 1200.0, 64)
    _close(tr.visc_d(torch.as_tensor(rho), torch.as_tensor(T)), jtr.visc_d(rho, T), 1e-12, "mu")
    _close(tr.therm_cond(torch.as_tensor(rho), torch.as_tensor(T)),
           jtr.therm_cond(rho, T), 1e-12, "k")


# ---------------------------------------------------------------------------
# host solvers against JAX's
# ---------------------------------------------------------------------------


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def test_saturation_solvers_match_jax():
    """The densities at 1e-10.  The saturation pressure is p at the liquid
    density, where dp/ddelta is ~1e9 Pa: one ulp of delta moves it ~1e-5
    Pa, and sat_solve_T itself stops at |p_l - p_v| < 1e-6 Pa, so it is
    held to 1e-5 Pa (5.7e-9 relative at 275 K, 1e-12 from 450 K up).
    sat_solve_P's secant on that pressure carries the same noise into
    T_sat and the vapor density: held at 1e-10 and 1e-9."""
    for T in (275.0, 311.87, 350.0, 450.0, 600.0, 640.0):
        (ps, dl, dv), (jps, jdl, jdv) = w.sat_solve_T(T), jw.sat_solve_T(T)
        assert abs(float(ps) - float(jps)) <= 1e-5, T
        assert max(_rel(dl, jdl), _rel(dv, jdv)) <= 1e-10, T
    for P in (6895.5, 3e4, 1.0e5, 1.0e6, 1.0e7, 2.1e7):
        (T, dl, dv), (jT, jdl, jdv) = w.sat_solve_P(P), jw.sat_solve_P(P)
        assert max(_rel(T, jT), _rel(dl, jdl)) <= 1e-10, P
        assert _rel(dv, jdv) <= 1e-9, P


def test_rho_tp_and_props_tp_match_jax():
    cases = [(300.0, 1e5, "liq"), (570.0, 32.2e6, "liq"), (600.0, 3e6, "vap"),
             (866.15, 31125980.0, "vap"), (700.0, 25e6, "liq"), (700.0, 25e6, "vap")]
    for T, P, ph in cases:
        assert _rel(w.rho_tp(T, P, ph), jw.rho_tp(T, P, ph)) <= 1e-10, (T, P, ph)
        got, want = w.props_tp(T, P, ph), jw.props_tp(T, P, ph)
        for k in ("delta", "rho", "h", "s", "g"):
            assert _rel(got[k], want[k]) <= 1e-10, (T, P, ph, k)
    T = np.array([300.0, 350.0, 500.0])
    assert _rel(w.rho_tp(T, 1e7, "liq"), jw.rho_tp(T, 1e7, "liq")) <= 1e-10


def test_flash_and_isentropic_inverse_match_jax():
    points = [(30000.0, 1e5), (61493.0, 31125980.0), (45000.0, 6896.0), (3000.0, 1e6),
              (23737.0, 32216913.0), (52000.0, 5e6), (20000.0, 2.5e7)]
    for h, P in points:
        got, want = w.flash_hp(h, P), jw.flash_hp(h, P)
        assert got["phase"] == want["phase"], (h, P)
        for k in ("T", "x", "delta_l", "delta_v", "s"):
            assert abs(got[k] - want[k]) <= 1e-10 * max(abs(want[k]), 1e-12), (h, P, k)
    vec = w.flash_hp(np.array([30000.0, 45000.0]), np.array([1e5, 6896.0]))
    assert list(vec["phase"]) == ["two-phase", "two-phase"]
    for P, s, ph in [(12076881.0, 111.417, "vap"), (6896.0, 100.0, "vap"),
                     (3e7, 40.0, "liq"), (2.5e7, 90.0, "vap")]:
        assert _rel(w.h_ps(P, s, ph), jw.h_ps(P, s, ph)) <= 1e-10, (P, s, ph)


def test_flash_round_trips():
    """tests/test_iapws95.py's flash cases on the port."""
    st = w.flash_hp(30000.0, 1.0e5)
    assert st["phase"] == "two-phase"
    assert st["T"] == pytest.approx(372.7559, rel=1e-4)
    hl = float(w.h_dT(st["delta_l"], st["T"]))
    hv = float(w.h_dT(st["delta_v"], st["T"]))
    assert (1 - st["x"]) * hl + st["x"] * hv == pytest.approx(30000.0, rel=1e-9)
    for (T, P, phase) in [(866.15, 31125980.0, "vap"), (600.0, 3.0e6, "vap"),
                          (310.0, 1.0e6, "liq"), (570.0, 32.2e6, "liq")]:
        pr = w.props_tp(T, P, phase)
        st = w.flash_hp(pr["h"], P)
        assert st["phase"] == phase and st["T"] == pytest.approx(T, rel=1e-6)
    pr = w.props_tp(866.15, 31125980.0, "vap")
    P2 = 0.388 * 31125980.0
    assert w.flash_hp(w.h_ps(P2, pr["s"], "vap"), P2)["s"] == pytest.approx(pr["s"], rel=1e-8)
    for P in (6896.0, 1.0e5, 1.0e6, 1.0e7):
        T, _, _ = w.sat_solve_P(P)
        assert w.sat_solve_T(T)[0] == pytest.approx(P, rel=1e-6)


# ---------------------------------------------------------------------------
# liquid salts and thermal oil
# ---------------------------------------------------------------------------


def test_salt_correlations():
    """tests/test_properties.py's closed forms, on the port."""
    T = 550.0
    dT = T - 273.15
    assert float(salts.SolarSalt.cp_mass(T)) == pytest.approx(1443 + 0.172 * dT)
    assert float(salts.SolarSalt.dens_mass(T)) == pytest.approx(2090 - 0.636 * dT)
    assert float(salts.SolarSalt.enth_mass(T)) == pytest.approx(1443 * dT + 0.086 * dT**2)
    assert float(salts.SolarSalt.therm_cond(T)) == pytest.approx(0.443 + 1.9e-4 * dT)
    T = 600.0
    assert float(salts.HitecSalt.cp_mass(T)) == pytest.approx(5806 - 10.833 * T + 7.2413e-3 * T**2)
    assert float(salts.HitecSalt.enth_mass(T)) == pytest.approx(
        5806 * T - 10.833 * T**2 + 7.2413e-3 * T**3)
    T = 523.0
    dT = T - 273.15
    assert float(salts.ThermalOil.cp_mass(T)) == pytest.approx(
        1496.005 + 3.313 * dT + 0.0008970785 * dT**2)
    nu = float(salts.ThermalOil.visc_d(T)) / float(salts.ThermalOil.dens_mass(T))
    assert nu == pytest.approx(1e-6 * np.exp(586.375 / (dT + 62.5) - 2.2809))


@pytest.mark.parametrize("pkg", ["SolarSalt", "HitecSalt", "ThermalOil"])
def test_salt_packages_match_jax(pkg):
    tp, jp = getattr(salts, pkg), getattr(jsalts, pkg)
    lo, _, hi = jp.temperature_bounds
    T = np.random.default_rng(3).uniform(lo, hi, 32)
    assert tp.name == jp.name and tp.temperature_bounds == jp.temperature_bounds
    assert tp.ref_temperature == jp.ref_temperature
    for fn in ("cp_mass", "dens_mass", "enth_mass", "visc_d", "therm_cond"):
        _close(getattr(tp, fn)(torch.as_tensor(T)), getattr(jp, fn)(T), 1e-14, fn)
