"""The port's charge storage-design study
(``case_studies/fossil/storage_charge_design.py``) held to the JAX
package on the CPU, in float64.

* The host-side functions: the design data equal to JAX's; the costing
  functions (``hx_capital_cost``, ``water_pump_capital_cost``,
  ``salt_pump_cost_per_year``, ``tank_cost``) on seeded inputs, numbers
  and tensors, within ``COST_RTOL`` of JAX's (not bitwise: XLA's CPU exp,
  log and pow differ from glibc's, which numpy and torch call, in the
  last bits; the worst measured gap is 1.7e-15 relative); and the port's
  versions of ``tests/test_storage_charge_design.py``'s
  ``test_correlation_dispatch`` and ``test_seider_costing_shapes``.
* The solar-salt / HP design NLP (the reference's winner) and, slow, the
  Hitec-salt / VHP one (the other salt and the other source: the
  supercritical tap, whose condensing states are "sc" and whose
  subcooling margin is taken to the critical temperature), built in both
  packages from the JAX package's checkpoint and stopped before their
  solves (``torch_fossil_cases.stop_design``): the same layout and
  decisions, the decisions' starting values within 1e-12, and the
  residual rows, the inequality rows and the objective at x0 within
  1e-10 of their terms.  JAX's first design NLP takes ~70 s of eager
  compile probing here (the second ~30 s in the same process): the
  tier-1 clock holds one.
* Slow: the Therminol-66 / HP square initialization in both packages
  (``test_thermal_oil_square_init_matches_jax``).
* The port's own design NLPs of all six combinations, each built and
  evaluated once: square inner system, the three decisions, finite rows
  and objective.
* ``isolated_json_call``'s child process: it imports the port and no
  JAX, runs on the caller's device, returns the summary it prints, and a
  child that dies or cannot start becomes an error summary that is not
  feasible; ``run_design_study``'s selection over summaries; and the
  five new modules imported in a fresh interpreter import neither
  ``jax`` nor ``dispatches_tpu``.
* Slow: ``test_solar_hp_design`` (``design_optimize`` at maxiter 150 on
  the port's CPU, the anchors of ``test_solar_hp_design``).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dispatches_tpu.case_studies.fossil import storage_charge_design as jcd  # noqa: E402

from dispatches_tpu_torch.case_studies.fossil import storage_charge_design as cd  # noqa: E402
from dispatches_tpu_torch.interop import x_from_numpy  # noqa: E402
from torch_fossil_cases import (  # noqa: E402
    CPU,
    assert_rows_match,
    assert_same_layout,
    decision_values,
    jax_rows,
    np_,
    stop_design,
)

DATA = Path(__file__).parent / "data"
INIT = DATA / "integrated_storage_usc_init"
COST_RTOL = 4e-15      # the costing functions vs JAX's (XLA's transcendental rounding)
START_RTOL = 1e-12     # the design decisions' starting values vs JAX's
OIL_RES_RTOL = 1e-9    # Therminol-66's square solve: final max residual vs JAX's
ROOT = Path(__file__).resolve().parents[1]

PORT_COMBOS = tuple((s, src) for s in cd.SALTS for src in cd.SOURCES)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one intra-op thread, as the other test_torch_* modules."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# host-side functions
# ---------------------------------------------------------------------------


def test_design_data_matches_jax():
    names = ["CE_INDEX", "HOURS_PER_DAY", "NUM_OF_YEARS", "COAL_PRICE", "COOLING_PRICE",
             "SALT_PRICE", "SALT_T_IN", "SALT_T_MAX", "SALT_FLOW_INIT", "AREA_INIT",
             "DT_BOUNDS", "AREA_MAX", "SALT_FLOW_MAX", "TANK_LBYD", "TANK_THICKNESS",
             "TANK_MATERIAL_DENSITY", "TANK_MATERIAL_COST", "TANK_INSULATION_COST",
             "TANK_FOUNDATION_COST", "NO_OF_TANKS", "SPUMP_FT", "SPUMP_FM", "SPUMP_HEAD_FT",
             "SPUMP_MOTOR_FT", "SPUMP_NM", "SEIDER_CE_BASE", "CE_2018", "SOURCES",
             "POWER_FIXED", "HEAT_DUTY_FIXED", "M2_TO_FT2", "M3S_TO_GPM", "KGM3_TO_LBFT3",
             "HX_COST_BASIS", "OBJ_SCALE"]
    for n in names:
        assert getattr(cd, n) == getattr(jcd, n), n
    assert list(cd.SALTS) == list(jcd.SALTS)
    assert [s.name for s in cd.SALTS.values()] == [s.name for s in jcd.SALTS.values()]


def _seeded(seed):
    rng = np.random.default_rng(seed)
    return {
        "hx": (rng.uniform(100.0, 8000.0, 64), rng.uniform(1.2e5, 3.5e7, 64)),
        "wp": (rng.uniform(50.0, 5000.0, 64), rng.uniform(700.0, 1000.0, 64),
               rng.uniform(1e5, 3e7, 64)),
        "sp": (rng.uniform(1.0, 1000.0, 64), rng.uniform(700.0, 1950.0, 64)),
        "tank": (rng.uniform(1e4, 2e7, 64), rng.uniform(700.0, 1950.0, 64)),
    }


FUNCS = {"hx": "hx_capital_cost", "wp": "water_pump_capital_cost",
         "sp": "salt_pump_cost_per_year", "tank": "tank_cost"}


@pytest.mark.parametrize("key", list(FUNCS))
def test_costing_functions_match_jax(key):
    args = _seeded(3)[key]
    want = np.asarray(getattr(jcd, FUNCS[key])(*(jnp.asarray(a) for a in args)))
    fn = getattr(cd, FUNCS[key])
    for got in (fn(*args), np_(fn(*(torch.as_tensor(a) for a in args)))):
        got = np.asarray(got)
        assert got.dtype == np.float64 and got.shape == want.shape
        assert np.max(np.abs(got - want) / np.abs(want)) <= COST_RTOL
    # one number at a time, as the JAX package's tests call them
    scalar = [float(a[0]) for a in args]
    w = float(getattr(jcd, FUNCS[key])(*scalar))
    assert abs(float(fn(*scalar)) - w) <= COST_RTOL * abs(w)


def test_correlation_dispatch():
    from dispatches_tpu_torch.models.salt_hx import salt_nusselt

    re, pr, prw = 1000.0, 5.0, 6.0
    solar = salt_nusselt("solar_salt", re, pr, prw, 1.0, 1.2)
    hitec = salt_nusselt("hitec_salt", re, pr, prw, 1.0, 1.2)
    oil = salt_nusselt("thermal_oil", re, pr, prw, 1.0, 1.2)
    assert solar == pytest.approx(0.35 * re**0.6 * pr**0.4 * (pr / prw) ** 0.25 * 2**0.2)
    assert hitec == pytest.approx(1.61 * (re * pr * 0.009) ** 0.63 * (1.0 / 1.2) ** 0.25)
    assert oil == pytest.approx(0.36 * re**0.55 * pr**0.33 * (pr / prw) ** 0.14)


def test_seider_costing_shapes():
    a1 = float(cd.hx_capital_cost(1000.0, 8.6e6))
    a2 = float(cd.hx_capital_cost(2000.0, 8.6e6))
    assert 0 < a1 < a2
    p1 = float(cd.salt_pump_cost_per_year(100.0, 1800.0))
    p2 = float(cd.salt_pump_cost_per_year(300.0, 1800.0))
    assert 0 < p1 < p2
    t1 = cd.tank_cost(1e6, 1800.0)
    t2 = cd.tank_cost(3e6, 1800.0)
    assert 0 < t1 < t2
    w1 = float(cd.water_pump_capital_cost(1500.0, 850.0, 26e6))
    assert w1 > 0


# ---------------------------------------------------------------------------
# the design NLPs, stopped before their solves
# ---------------------------------------------------------------------------


def design_nlp_matches_jax(salt, source):
    """One combination's design NLP in both packages (the JAX package's
    checkpoint as the warm start): layouts, decisions, starting values,
    rows and objective at x0."""
    jb = stop_design(jcd, jcd.build_charge_model(salt, source, load_from_file=INIT))
    tb = stop_design(cd, cd.build_charge_model(salt, source, load_from_file=INIT), device=CPU)
    nlp, jn = tb.nlp, jb.nlp
    assert_same_layout(nlp, jn, rtol=START_RTOL)
    assert tb.decisions == jb.decisions == [
        "ess_split.split_fraction_2", "hxc.tube_inlet.flow_mass", "cooler.outlet.enth_mol"]
    t0, j0 = decision_values(nlp, tb.decisions), decision_values(jn, jb.decisions)
    assert np.all(np.abs(t0 - j0) <= START_RTOL * np.abs(j0)), (t0, j0)
    assert nlp.sense == jn.sense == "min"
    assert len(nlp.ineq_slices) == len(jn.ineq_slices) >= 9
    rows, obj = jax_rows(jn, jn.x0)
    x = x_from_numpy(np.asarray(jn.x0), jn, nlp, CPU)
    assert_rows_match(nlp, x, rows, obj)


def test_design_nlp_matches_jax_solar_hp():
    design_nlp_matches_jax("solar_salt", "hp")


@pytest.mark.slow  # ~30-70 s: the same, the other source and salt
def test_design_nlp_matches_jax_hitec_vhp():
    design_nlp_matches_jax("hitec_salt", "vhp")


@pytest.mark.slow  # ~6 min of this CPU: both packages' Newton on the 437 MW plant, 50 steps
def test_thermal_oil_square_init_matches_jax():
    """Therminol-66 / HP's square initialization (``design_optimize``'s
    first solve) from the JAX package's checkpoint in both packages: the
    same layout and rows at x0 (1e-10 of their terms), and the same
    outcome of Newton's solve, converged or not, with the final residuals
    within ``OIL_RES_RTOL``."""
    m = cd.build_charge_model("thermal_oil", "hp", load_from_file=INIT)
    jm = jcd.build_charge_model("thermal_oil", "hp", load_from_file=INIT)
    nlp, jn = m.fs.compile(), jm.fs.compile()
    assert_same_layout(nlp, jn, rtol=START_RTOL)
    x = x_from_numpy(np.asarray(jn.x0), jn, nlp, CPU)
    assert_rows_match(nlp, x, jax_rows(jn, jn.x0)[0])
    res, jres = cd.solve_square(nlp, device=CPU), jcd.solve_square(jn)
    r, jr = float(res.max_residual), float(jres.max_residual)
    print(f"port: converged {bool(res.converged)}, {int(res.iterations)} iterations, max "
          f"residual {r!r}; JAX: {bool(jres.converged)}, {int(jres.iterations)}, {jr!r}")
    assert bool(res.converged) == bool(jres.converged)
    assert int(res.iterations) == int(jres.iterations)
    assert abs(r - jr) <= OIL_RES_RTOL * max(1.0, abs(jr))


def port_design_nlp_builds(salt, source):
    """The port's design NLP of one combination, built and evaluated once
    at x0: the inner system square, the three decisions fixed, every row
    and the objective finite."""
    m = cd.build_charge_model(salt, source, load_from_file=INIT)
    b = stop_design(cd, m, device=CPU)
    nlp = b.nlp
    assert nlp.n == sum(hi - lo for lo, hi in dict(nlp.eq_slices).values())
    assert set(b.decisions) <= set(nlp.fixed_names)
    assert (m.salt_name, m.source) == (salt, source)
    x = torch.as_tensor(nlp.x0)
    p = nlp.default_params()
    r, g, f = nlp.eq(x, p), nlp.ineq(x, p), nlp.objective(x, p)
    assert r.shape == (nlp.n,) and g.shape[0] >= 9
    assert bool(torch.isfinite(r).all()) and bool(torch.isfinite(g).all())
    assert np.isfinite(float(f)) and 10.0 < float(f) < 1e3   # M$/yr
    sat = m.units["cooler"].sat_block
    assert (sat is None) == (source == "vhp")


@pytest.mark.parametrize("salt,source", PORT_COMBOS)
def test_port_design_nlp_builds(salt, source):
    port_design_nlp_builds(salt, source)


def test_build_guards():
    with pytest.raises(ValueError, match="storage fluid"):
        cd.build_charge_model("sand", "hp", load_from_file=INIT)
    with pytest.raises(ValueError, match="steam source"):
        cd.build_charge_model("solar_salt", "lp", load_from_file=INIT)


# ---------------------------------------------------------------------------
# the enumeration and its child processes
# ---------------------------------------------------------------------------


def test_isolated_child_runs_the_port_on_the_callers_device():
    call = ("import dispatches_tpu_torch.case_studies.fossil.storage_charge_design as cd\n"
            "print('chatter')\n"
            "print(json.dumps({'salt': 'solar_salt', 'device': device, "
            "'jax': 'jax' in sys.modules, 'ref': 'dispatches_tpu' in sys.modules}))")
    out = cd.isolated_json_call(call, {"salt": "solar_salt"}, torch.device(CPU))
    assert out == {"salt": "solar_salt", "device": "cpu", "jax": False, "ref": False}


def test_isolated_child_that_dies_or_hangs_is_not_a_result():
    died = cd.isolated_json_call("raise RuntimeError('init did not converge')",
                                 {"salt": "hitec_salt", "source": "vhp"}, CPU)
    assert died["converged"] is False and "init did not converge" in died["error"]
    assert died["error"].startswith("rc=1")
    assert (died["salt"], died["source"]) == ("hitec_salt", "vhp")
    assert not cd._feasible(died)
    hung = cd.isolated_json_call("import time\ntime.sleep(30)", {"source": "bfp"}, CPU,
                                 timeout_s=2.0)
    assert hung["converged"] is False and "timed out" in hung["error"]
    assert not cd._feasible(hung)


def test_isolated_child_that_cannot_start(monkeypatch):
    def no_start(*_, **__):
        raise OSError("no such interpreter")

    monkeypatch.setattr(subprocess, "run", no_start)
    out = cd.isolated_json_call("print(1)", {"source": "fwh4"}, CPU)
    assert out["converged"] is False and "could not start" in out["error"]
    assert not cd._feasible(out)


def test_run_design_study_selects_the_cheapest_feasible(monkeypatch):
    summaries = {
        ("solar_salt", "vhp"): {"cost": 80e6, "converged": False, "inner_failures": 3},
        ("solar_salt", "hp"): {"cost": 90e6, "converged": True, "inner_failures": 1},
        ("hitec_salt", "vhp"): {"cost": 70e6, "converged": False, "error": "rc=1: boom"},
        ("hitec_salt", "hp"): {"cost": 95e6, "converged": False, "inner_failures": 0},
        ("thermal_oil", "vhp"): {"cost": 99e6, "converged": True, "inner_failures": 0},
        ("thermal_oil", "hp"): {"cost": 91e6, "converged": True, "inner_failures": 0},
    }
    seen = []

    def fake(salt, source, load_from_file, maxiter, verbose=0, device=None):
        seen.append((salt, source, str(load_from_file), maxiter, str(device)))
        return {"salt": salt, "source": source, **summaries[(salt, source)]}

    monkeypatch.setattr(cd, "_run_combo_isolated", fake)
    ended = []
    out = cd.run_design_study(load_from_file=INIT, maxiter=7, isolate=True, device=CPU,
                              on_result=ended.append)
    assert sorted((r["salt"], r["source"]) for r in ended) == sorted(s[:2] for s in seen)
    assert sorted(s[:2] for s in seen) == sorted((s, src) for s in cd.SALTS for src in cd.SOURCES)
    assert all(s[2:] == (str(INIT), 7, "cpu") for s in seen)
    assert (out["best"]["salt"], out["best"]["source"]) == ("solar_salt", "hp")
    # the children ran at once; the results keep the enumeration's order
    assert [(r["salt"], r["source"]) for r in out["results"]] == [
        (s, src) for s in cd.SALTS for src in cd.SOURCES]


def test_combo_summary_keys_match_jax():
    class R:
        inner_failures = 2

    out = {"salt": "solar_salt", "source": "hp", "cost": np.float64(9e7), "hxc_area": 1838.0,
           "salt_flow": 300.0, "salt_T_out": 830.0, "converged": np.bool_(True), "res": R}
    got, want = cd._combo_summary(out), jcd._combo_summary(out)
    assert got == want and json.loads(json.dumps(got)) == got


def test_the_new_modules_import_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import dispatches_tpu_torch.case_studies.fossil.storage_charge_design\n"
        "import dispatches_tpu_torch.case_studies.fossil.storage_discharge_design\n"
        "import dispatches_tpu_torch.case_studies.fossil.scpc_plant\n"
        "import dispatches_tpu_torch.models.concrete_tes\n"
        "import dispatches_tpu_torch.models.heat_exchanger_tube\n"
        "import dispatches_tpu_torch.case_studies.fossil as f\n"
        "assert f.build_scpc_flowsheet is f.scpc_plant.build_scpc_flowsheet\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'dispatches_tpu' or m.startswith('dispatches_tpu.'))\n"
        "print(bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.skipif(torch.cuda.is_available(), reason="the CPU-only rule")
def test_entry_points_follow_the_device_rule():
    m = cd.build_charge_model("solar_salt", "hp", load_from_file=INIT)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cd.design_optimize(m)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cd.run_design_study(combos=(("solar_salt", "hp"),))


@pytest.mark.slow  # ~10 min of this CPU: maxiter 150 outer iterations over the 437 MW plant
def test_solar_hp_design():
    m = cd.build_charge_model("solar_salt", "hp", load_from_file=INIT)
    out = cd.design_optimize(m, maxiter=150, device=CPU)
    res = out["res"]
    print(f"converged {res.converged} ({res.message}), {res.outer_iterations} outer iterations, "
          f"{res.inner_failures} inner failures; area {out['hxc_area']!r} m2, cost "
          f"{out['cost']!r} $/yr, salt out {out['salt_T_out']!r} K")
    assert out["converged"] or res.inner_failures == 0
    assert out["hxc_area"] == pytest.approx(1838.2, rel=1e-2)
    assert out["salt_T_out"] < cd.SALT_T_MAX["solar_salt"] + 1e-6
    sol = out["sol"]
    assert sol["plant_power_out"][0] == pytest.approx(400.0, abs=1e-6)
    assert sol["hxc.heat_duty"][0] == pytest.approx(150e6, abs=1.0)
    assert out["cost"] == pytest.approx(90.56e6, rel=0.02)
