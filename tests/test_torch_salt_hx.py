"""The port's molten-salt / steam heat exchanger (``models/salt_hx.py``)
held to the JAX package on the CPU, in float64.

* ``salt_nusselt``, ``film_coefficients`` and ``ohtc_terms`` against
  JAX's on a seeded grid, within 1e-12 relative: the three salts, the
  charge (cold salt, superheated steam) and discharge (hot salt,
  compressed feedwater) ranges, and both water-film phases.
* One-unit flowsheets built the same way in both packages
  (``tests/torch_storage_cases.py``): the charge HX (salt in the tubes,
  steam condensing from vapor to a wet state), the discharge HX (salt on
  the shell, liquid to supercritical water).  The layouts are equal (names,
  order, shapes, bounds, scales, fixes, rows; ``interop.x_from_numpy``'s
  check); the residual at JAX's x0 is within 1e-10 of each row's term
  size; the Newton solutions agree within 1e-9 relative to max(1, |x|)
  with equal iterations; the salt duty equals the steam duty (1e-9).
* ``storage_integrated._hx_sweep``'s host warm start against JAX's on the
  discharge HX, within ``SWEEP_RTOL`` of each written value (JAX's charge
  sweep takes ~20 s of eager flashes; the unit flowsheets' JAX side takes
  the port's warm start).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_storage_cases as cases  # noqa: E402

from dispatches_tpu.models import salt_hx as jhx  # noqa: E402
from dispatches_tpu.properties import iapws95 as jw95  # noqa: E402
from dispatches_tpu.properties import salts as jsalts  # noqa: E402
from dispatches_tpu.solvers.newton import solve_square as j_solve_square  # noqa: E402

from dispatches_tpu_torch.interop import x_from_numpy  # noqa: E402
from dispatches_tpu_torch.models import salt_hx as thx  # noqa: E402
from dispatches_tpu_torch.properties import iapws95 as tw95  # noqa: E402
from dispatches_tpu_torch.properties import salts as tsalts  # noqa: E402
from dispatches_tpu_torch.solvers import solve_square  # noqa: E402

CPU = "cpu"

#: _hx_sweep against JAX's: brentq to xtol 1e-8 K over the packages' host
#: flashes, whose pressures carry rounding noise (ROADMAP.md §3,
#: "Saturation noise"); held at 1e-9 relative.
SWEEP_RTOL = 1e-9

UNIT_CASES = [("charge", "inlet"), ("discharge", "inlet")]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one intra-op thread, as the other test_torch_* modules."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.max(np.abs(got - want) / np.maximum(1e-300, np.abs(want))))


# ---------------------------------------------------------------------------
# correlation functions
# ---------------------------------------------------------------------------


def _grid(seed, n, lo, hi):
    return np.random.default_rng(seed).uniform(lo, hi, n)


@pytest.mark.parametrize("salt", ["solar_salt", "hitec_salt", "thermal_oil"])
def test_salt_nusselt_matches_jax(salt):
    re, pr, prw = _grid(1, 16, 50.0, 5e4), _grid(2, 16, 1.0, 30.0), _grid(3, 16, 1.0, 30.0)
    mu_in, mu_out = _grid(4, 16, 1e-3, 5e-3), _grid(5, 16, 1e-3, 5e-3)
    want = jhx.salt_nusselt(salt, *(jnp.asarray(a) for a in (re, pr, prw, mu_in, mu_out)))
    got = thx.salt_nusselt(salt, *(torch.as_tensor(a) for a in (re, pr, prw, mu_in, mu_out)))
    assert _rel(got, want) <= 1e-12


#: (side, salt T in, salt T out, water rho in, water T in, film phase)
FILM_CASES = {
    "charge": ((513.15, 540.0), (800.0, 860.0), (18.0, 26.0), (850.0, 870.0), "inlet"),
    "discharge": ((820.0, 853.15), (520.0, 560.0), (860.0, 890.0), (470.0, 500.0), "inlet"),
    "discharge-vap": ((820.0, 853.15), (520.0, 560.0), (860.0, 890.0), (470.0, 500.0), "vap"),
}


@pytest.mark.parametrize("case", list(FILM_CASES))
@pytest.mark.parametrize("salt", ["SolarSalt", "HitecSalt", "ThermalOil"])
def test_film_coefficients_and_ohtc_match_jax(case, salt):
    (tsi, tso, rho, tw, film) = FILM_CASES[case]
    n = 12
    F_salt, F_w = _grid(11, n, 1.0, 300.0), _grid(12, n, 100.0, 3000.0)
    T_in, T_out = _grid(13, n, *tsi), _grid(14, n, *tso)
    rho_w, T_w = _grid(15, n, *rho), _grid(16, n, *tw)
    mu_out = _grid(17, n, 9e-5, 1.1e-4)
    g = jhx.HXGeometry()
    assert thx.HXGeometry() == thx.HXGeometry(**g.__dict__)
    jfilm = jw95.sat_rhov_aux(jnp.minimum(jnp.asarray(T_w), 0.9999 * jw95.TC)) \
        if film == "vap" else None
    tfilm = tw95.sat_rhov_aux(torch.clamp(torch.as_tensor(T_w), max=0.9999 * tw95.TC)) \
        if film == "vap" else None
    js = getattr(jsalts, salt)
    ts = getattr(tsalts, salt)
    jh = jhx.film_coefficients(g, js, *(jnp.asarray(a) for a in
                                        (F_salt, T_in, T_out, F_w, rho_w, T_w, mu_out)),
                               rho_w_film=jfilm)
    th = thx.film_coefficients(thx.HXGeometry(), ts, *(torch.as_tensor(a) for a in
                                                     (F_salt, T_in, T_out, F_w, rho_w, T_w,
                                                      mu_out)),
                               rho_w_film=tfilm)
    for got, want in zip(th, jh):
        assert _rel(got, want) <= 1e-12
    for got, want in zip(thx.ohtc_terms(thx.HXGeometry(), *th),
                         jhx.ohtc_terms(g, *jh)):
        assert _rel(got, want) <= 1e-12
    # and on plain numbers, as the host sweep calls them
    hs = thx.film_coefficients(thx.HXGeometry(), ts, F_salt[0], T_in[0], T_out[0], F_w[0],
                               rho_w[0], T_w[0], mu_out[0],
                               rho_w_film=None if tfilm is None else float(tfilm[0]))
    assert abs(float(hs[0]) - float(jh[0][0])) <= 1e-12 * abs(float(jh[0][0]))
    assert abs(float(hs[1]) - float(jh[1][0])) <= 1e-12 * abs(float(jh[1][0]))


def test_bad_options_raise():
    fs = cases.torch_modules().Flowsheet()
    with pytest.raises(ValueError, match="salt_side"):
        thx.SaltSteamHX(fs, "a", salt_side="middle")
    with pytest.raises(ValueError, match="water_film_phase"):
        thx.SaltSteamHX(fs, "b", water_film_phase="liq")


# ---------------------------------------------------------------------------
# one-unit flowsheets
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=UNIT_CASES, ids=lambda c: "-".join(c))
def unit_pair(request):
    case, film = request.param
    tfs, thx_u, _ = cases.hx_flowsheet(cases.torch_modules(), case, film=film)
    # the JAX flowsheet takes the port's warm start (JAX's host sweep of the
    # charge HX is ~20 s of eager flashes; test_hx_sweep_matches_jax holds
    # the two sweeps to each other), so both start from one x0
    jfs, jhx_u, _ = cases.hx_flowsheet(cases.jax_modules(), case, film=film, inits_from=tfs)
    jn, tn = jfs.compile(), tfs.compile()
    jres = j_solve_square(jn)
    tres = solve_square(tn, device=CPU)
    return case, (jfs, jhx_u, jn, jres), (tfs, thx_u, tn, tres)


def test_unit_layout_and_ports_match_jax(unit_pair):
    case, (_, jh, jn, _), (_, th, tn, _) = unit_pair
    assert cases.layout(tn) == cases.layout(jn)
    x = x_from_numpy(np.asarray(jn.x0), jn, tn, CPU)
    np.testing.assert_array_equal(_np(x), np.asarray(jn.x0))
    for port in ("shell_inlet", "shell_outlet", "tube_inlet", "tube_outlet"):
        assert getattr(th, port).keys == getattr(jh, port).keys
    assert th.water_hot == jh.water_hot == (case == "charge")


def test_unit_residual_at_jax_x0(unit_pair):
    _, (_, _, jn, _), (_, _, tn, _) = unit_pair
    jp, tp = jn.default_params(), tn.default_params()
    x = x_from_numpy(np.asarray(jn.x0), jn, tn, CPU)
    want = np.asarray(jax.jit(lambda xx: jn.eq(xx, jp))(jnp.asarray(jn.x0)))
    J = torch.func.jacfwd(lambda xx: tn.eq(xx, tp))(x)
    terms = np.maximum(1.0, _np((J.abs() * x.abs()).sum(1)))
    err = np.abs(_np(tn.eq(x, tp)) - want) / terms
    assert err.max() <= 1e-10, (float(err.max()), int(err.argmax()))


def test_unit_newton_solution_matches_jax(unit_pair):
    case, (_, _, jn, jres), (_, th, tn, tres) = unit_pair
    assert bool(tres.converged) and bool(jres.converged)
    assert int(tres.iterations) == int(jres.iterations)
    x, jx = _np(tres.x), np.asarray(jres.x)
    assert np.max(np.abs(x - jx) / np.maximum(1.0, np.abs(jx))) <= 1e-9
    # the salt takes what the water gives
    sol = tn.unravel(tres.x)
    salt = th.salt
    q_salt = float(sol[th.salt_in.flow_mass][0]) * float(
        salt.enth_mass(torch.as_tensor(sol[th.salt_out.temperature][0]))
        - salt.enth_mass(torch.as_tensor(sol[th.salt_in.temperature][0])))
    q_w = float(sol[th.water_in.flow_mol][0]) * (
        float(sol[th.water_out.enth_mol][0]) - float(sol[th.water_in.enth_mol][0]))
    assert abs(abs(q_salt) - abs(q_w)) <= 1e-9 * abs(q_w)
    assert (q_salt > 0) == (case == "charge")
    assert abs(float(sol[th.heat_duty][0]) - abs(q_w)) <= 1e-9 * abs(q_w)


def test_hx_sweep_matches_jax():
    """The discharge HX's host warm start in both packages: the returned
    outlet state and every variable's init."""
    jfs, _, jout = cases.hx_flowsheet(cases.jax_modules(), "discharge")
    tfs, _, tout = cases.hx_flowsheet(cases.torch_modules(), "discharge")
    assert set(tout) == set(jout)
    for k in ("F", "h", "P", "Q", "Ts_out"):
        assert abs(float(tout[k]) - float(jout[k])) <= SWEEP_RTOL * max(1.0, abs(float(jout[k]))), k
    assert list(tfs.var_specs) == list(jfs.var_specs)
    for name, js in jfs.var_specs.items():
        got = np.asarray(tfs.var_specs[name].init, dtype=np.float64)
        want = np.asarray(js.init, dtype=np.float64)
        assert np.all(np.abs(got - want) <= SWEEP_RTOL * np.maximum(1.0, np.abs(want))), name
