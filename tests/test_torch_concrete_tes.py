"""The port's concrete TES (``models/concrete_tes.py``) held to the JAX
package on the CPU, in float64.

* ``smooth_max``, ``smooth_min``, ``u_tes`` and ``htc_from_data`` against
  JAX's on seeded inputs, within 1e-12 relative (tensors and numbers).
* ``_SatConstants`` at the reference's three tube pressures, within
  ``SAT_RTOL``: the two packages' saturation solves stop at |p_l - p_v| <
  1e-6 Pa (ROADMAP.md §3, "Saturation noise"), so Tsat, h_l and h_v agree
  to ~1e-12 relative (the largest gap, h_l at 1 atm, 8.5e-12).
* The charge, discharge and combined units of ``tests/test_concrete_tes.py``
  built in both packages: the same layout (bounds and fixed values within
  ``SAT_RTOL``, which the saturation constants set), ``initialize``'s x0
  within ``X0_RTOL``, and the residual rows at JAX's x0 within 1e-10 of
  each row's terms.
* The port's solves on the CPU: the reference test's wall and fluid
  profiles within 1 K; the heat-rate profiles within 1 W and, for the
  combined unit, wall temperatures and heat rates within 5 of JAX's
  solution (``tests/data/concrete_tes_profiles.json``, reproduced by the
  slow ``test_profiles_file_matches_jax_solves``); the charge unit's
  energy balance (fluid vs wall) within 1e-8 relative.
* The device rule of the units' solve path.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dispatches_tpu.core.graph import Flowsheet as JFlowsheet  # noqa: E402
from dispatches_tpu.models import concrete_tes as jct  # noqa: E402
from dispatches_tpu.solvers.newton import solve_square as j_solve_square  # noqa: E402

from dispatches_tpu_torch.core.graph import Flowsheet as TFlowsheet  # noqa: E402
from dispatches_tpu_torch.interop import x_from_numpy  # noqa: E402
from dispatches_tpu_torch.models import concrete_tes as tct  # noqa: E402
from dispatches_tpu_torch.solvers import solve_square  # noqa: E402
from test_concrete_tes import (  # noqa: E402
    CHARGE_CONC_TEMP_P1,
    CHARGE_FLUID_TEMP_P2,
    DIS_CONC_TEMP_P1,
    DIS_FLUID_TEMP_P1,
    tes_data,
)
from torch_fossil_cases import (  # noqa: E402
    CPU,
    assert_rows_match,
    assert_same_layout,
    jax_rows,
    np_,
    tes_flowsheet,
    x0_gap,
)

PROFILES = Path(__file__).parent / "data" / "concrete_tes_profiles.json"
MODES = ("charge", "discharge", "combined")
PRESSURES = (19600000.0, 8.5e5, 101325.0)   # charge, discharge, the tube's 1 atm
SAT_RTOL = 1e-10      # _SatConstants, bounds and fixed enthalpies between packages
X0_RTOL = 1e-9        # initialize's x0, per entry relative to max(1, |x0|)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one intra-op thread, as the other test_torch_* modules."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(got, want):
    got, want = np_(got), np_(want)
    return float(np.max(np.abs(got - want) / np.maximum(1e-300, np.abs(want))))


# ---------------------------------------------------------------------------
# unit functions
# ---------------------------------------------------------------------------


def test_smooth_max_and_min_match_jax():
    rng = np.random.default_rng(7)
    a, b = rng.uniform(100.0, 9e4, 64), rng.uniform(100.0, 9e4, 64)
    a[:8] = b[:8] + rng.uniform(-30.0, 30.0, 8)   # inside the blend width
    for fn in ("smooth_max", "smooth_min"):
        want = getattr(jct, fn)(jnp.asarray(a), jnp.asarray(b))
        assert _rel(getattr(tct, fn)(torch.as_tensor(a), torch.as_tensor(b)), want) <= 1e-12
        assert _rel(getattr(tct, fn)(a, b), want) <= 1e-12
        assert _rel(getattr(tct, fn)(a, b, eps=3.0), getattr(jct, fn)(a, b, eps=3.0)) <= 1e-12


def test_u_tes_and_htc_from_data_match_jax():
    rng = np.random.default_rng(8)
    for r, k, a, db in zip(rng.uniform(1e-5, 1e-3, 8), rng.uniform(0.5, 2.0, 8),
                           rng.uniform(2e-3, 2e-2, 8), rng.uniform(0.01, 0.1, 8)):
        want = jct.u_tes(r, k, a, a + db)
        assert abs(tct.u_tes(r, k, a, a + db) - want) <= 1e-12 * abs(want)
    for scale in (0.8, 1.0, 1.3):
        data = dict(tes_data(), face_area=0.00847 * scale, tube_diameter=0.0105664 / scale)
        want = jct.htc_from_data(data)
        assert abs(tct.htc_from_data(data) - want) <= 1e-12 * want


@pytest.mark.parametrize("P", PRESSURES)
def test_sat_constants_match_jax(P):
    j, t = jct._SatConstants(P), tct._SatConstants(P)
    assert t.P == j.P
    for k in ("Tsat", "delta_l", "delta_v", "h_l", "h_v"):
        assert abs(getattr(t, k) - getattr(j, k)) <= SAT_RTOL * abs(getattr(j, k)), k
    # and the port's constants are saturated states of its own EoS
    from dispatches_tpu_torch.properties import iapws95 as tw95
    pl = float(tw95.p_dT(torch.tensor(t.delta_l, dtype=torch.float64),
                         torch.tensor(t.Tsat, dtype=torch.float64)))
    assert abs(pl - P) <= 1e-7 * P


# ---------------------------------------------------------------------------
# layouts and residual rows at JAX's x0
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def built():
    """The three units built and initialized in both packages:
    {mode: (port fs, port tes, JAX fs, JAX tes)}."""
    out = {}
    for mode in MODES:
        tfs, ttes = tes_flowsheet(TFlowsheet, tct, mode)
        jfs, jtes = tes_flowsheet(JFlowsheet, jct, mode)
        out[mode] = (tfs, ttes, jfs, jtes)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_layout_x0_and_rows_match_jax(built, mode):
    tfs, ttes, jfs, jtes = built[mode]
    nlp, jn = tfs.compile(), jfs.compile()
    assert_same_layout(nlp, jn, rtol=SAT_RTOL)
    assert nlp.n == jn.n == (365 if mode != "combined" else 610)
    gap = x0_gap(nlp, jn)
    assert gap <= X0_RTOL, gap
    x = x_from_numpy(np.asarray(jn.x0), jn, nlp, CPU)
    assert_rows_match(nlp, x, jax_rows(jn, jn.x0)[0])
    # the units carry the same build-time constants
    assert ttes.htc == jtes.htc
    assert (ttes.n_seg, ttes.n_periods) == (jtes.n_seg, jtes.n_periods) == (20, 2)


def test_fix_inlet_rejects_off_design_pressure():
    _, tes = tes_flowsheet(TFlowsheet, tct, "charge", initialize=False)
    with pytest.raises(ValueError, match="from the design pressure"):
        tes.fix_inlet("charge", pressure=1.05 * 19600000.0)
    with pytest.raises(ValueError, match="bad operating_mode"):
        tct.ConcreteTES(TFlowsheet(horizon=1), "t", tes_data(), operating_mode="idle")
    with pytest.raises(KeyError, match="face_area"):
        data = tes_data()
        del data["face_area"]
        tct.ConcreteTES(TFlowsheet(horizon=1), "t", data)


# ---------------------------------------------------------------------------
# solves on the port's CPU
# ---------------------------------------------------------------------------


def _profiles(nlp, res, tes):
    """Per-side fluid temperatures, wall temperatures and heat rates of a
    solution, as nested lists (the JSON file's form)."""
    sol = nlp.unravel(res.x)
    out = {"wall_temperature": sol["tes.wall_temperature"][0].tolist(),
           "heat_rate": sol["tes.heat_rate"][0].tolist()}
    for side in ("charge", "discharge"):
        s = getattr(tes, side)
        if s is not None:
            out[f"{side}_fluid_temperature"] = (
                sol[f"tes.{side}.T_liq"][0] + sol[f"tes.{side}.T_vap"][0] - s.sat.Tsat).tolist()
            out[f"{side}_segment_heat"] = sol[f"tes.{side}.segment_heat"][0].tolist()
    return out


@pytest.fixture(scope="module")
def solved():
    out = {}
    for mode in MODES:
        fs, tes = tes_flowsheet(TFlowsheet, tct, mode)
        nlp = fs.compile()
        res = solve_square(nlp, device=CPU)
        assert bool(res.converged), mode
        out[mode] = (nlp, res, tes, _profiles(nlp, res, tes))
    return out


def _file():
    return json.loads(PROFILES.read_text())


def test_charge_profiles(solved):
    nlp, res, tes, prof = solved["charge"]
    np.testing.assert_allclose(prof["wall_temperature"][0], CHARGE_CONC_TEMP_P1, atol=1.0)
    np.testing.assert_allclose(prof["charge_fluid_temperature"][1], CHARGE_FLUID_TEMP_P2,
                               atol=1.0)
    np.testing.assert_allclose(prof["heat_rate"], _file()["jax"]["charge"]["heat_rate"],
                               rtol=0, atol=1.0)


def test_charge_energy_conservation(solved):
    nlp, res, tes, _ = solved["charge"]
    sol = nlp.unravel(res.x)
    q_fluid = sol["tes.charge.segment_heat"][0].sum(axis=-1)
    q_wall = sol["tes.heat_rate"][0].sum(axis=-1)
    np.testing.assert_allclose(q_wall, -q_fluid, rtol=1e-8)


def test_discharge_profiles(solved):
    nlp, res, tes, prof = solved["discharge"]
    np.testing.assert_allclose(prof["wall_temperature"][0], DIS_CONC_TEMP_P1, atol=1.0)
    # flow order j=0 meets segment S-1: the reference lists segment order
    np.testing.assert_allclose(prof["discharge_fluid_temperature"][0][::-1],
                               DIS_FLUID_TEMP_P1, atol=1.0)
    np.testing.assert_allclose(prof["heat_rate"], _file()["jax"]["discharge"]["heat_rate"],
                               rtol=0, atol=1.0)


def test_combined_profiles(solved):
    nlp, res, tes, prof = solved["combined"]
    sol = nlp.unravel(res.x)
    assert np.all(sol["tes.wall_temperature"] < 900.0)
    assert np.all(sol["tes.wall_temperature"] > 300.0)
    want = _file()["jax"]["combined"]
    for k in ("wall_temperature", "heat_rate"):
        np.testing.assert_allclose(prof[k], want[k], rtol=0, atol=5.0)


def jax_profiles():
    """JAX's solves of the three units, in the JSON file's form (the
    ``jax`` part of ``tests/data/concrete_tes_profiles.json``)."""
    out = {}
    for mode in MODES:
        fs, tes = tes_flowsheet(JFlowsheet, jct, mode)
        nlp = fs.compile()
        res = j_solve_square(nlp)
        assert bool(res.converged), mode

        class _R:
            x = np.asarray(res.x)
        out[mode] = _profiles(nlp, _R, tes)
    return out


@pytest.mark.slow  # ~55 s: JAX's three Newton compiles and solves
def test_profiles_file_matches_jax_solves(solved):
    want = jax_profiles()
    got = _file()["jax"]
    for mode in MODES:
        for k, v in want[mode].items():
            np.testing.assert_allclose(got[mode][k], v, rtol=1e-9, atol=1e-6)
            # and the port's CPU solve lands on JAX's
            np.testing.assert_allclose(solved[mode][3][k], v, rtol=1e-8, atol=1e-6)


@pytest.mark.skipif(torch.cuda.is_available(), reason="the CPU-only rule")
def test_solve_follows_the_device_rule():
    fs, _ = tes_flowsheet(TFlowsheet, tct, "discharge", initialize=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_square(fs.compile())


def test_fluid_state_helpers(solved):
    nlp, res, tes, _ = solved["charge"]
    v = nlp._vals(torch.as_tensor(res.x), nlp.default_params())
    T = tes.charge.T_fluid(v)
    x = tes.charge.x_fluid(v)
    assert T.shape == x.shape == (1, 2, 20)
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    # the inlet cell is superheated vapor; the steam condenses along the tube
    assert float(x[0, 0, 0]) == 1.0 and float(x[0, 1, -1]) < 1.0
    assert abs(float(T[0, 1, 0]) - CHARGE_FLUID_TEMP_P2[0]) <= 1.0
