"""The port's discharge storage-design study
(``case_studies/fossil/storage_discharge_design.py``) held to the JAX
package on the CPU, in float64.

* The port's versions of ``tests/test_storage_discharge_design.py``'s
  ``test_source_census`` and ``test_cost_expression_data``, and the design
  data equal to JAX's.
* ``_es_turbine_host_solve`` (the storage turbine's saturated-exhaust
  warm start, a SciPy ``brentq`` on the host) against JAX's, within
  ``ES_RTOL``: not bitwise, because ``brentq`` stops at 1e-10 in ln P on a
  function that carries the two packages' saturation noise (ROADMAP.md §3),
  and JAX's flashes round their transcendental functions differently; the
  worst gap over seven inlet states is 1.6e-9 relative.  Slow: JAX's
  solve takes 20-40 s of eager flashes per state here.
* The condenser-pump design NLP (the reference's winner) built in both
  packages and stopped before its solves
  (``torch_fossil_cases.stop_design``).  JAX's eager ``initialize`` of the
  USC plant is skipped: the port's warm start (its ``initialize`` and the
  discharge train's ``_initialize``) is carried into JAX's flowsheet.  The
  same layout and decisions, the decisions' starting values within 1e-12,
  and the residual rows, the inequality rows and the objective at x0
  within 1e-10 of their terms.  Slow (~80 s of JAX's eager compile
  probing, more than the tier-1 clock holds beside the rest).
* The port's design NLPs of all five sources, each built and evaluated
  once: square inner system, the two decisions, finite rows and objective,
  the tap's phase.  The two taps above the critical pressure (bfp, fwh9)
  are slow: their host warm start spends ~2-3 min of this CPU in
  ``_es_turbine_host_solve``, whose ``h_ps`` Newton iterations (the JAX
  package's algorithm) run to their cap at the high exhaust pressures.
* ``run_design_study``'s selection and the device rule.
* Slow: ``test_condpump_design_anchor`` (``design_optimize`` at maxiter
  150 on the port's CPU, the anchors of ``test_condpump_design_anchor``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu.case_studies.fossil import storage_discharge_design as jdd  # noqa: E402

from dispatches_tpu_torch.case_studies.fossil import storage_discharge_design as dd  # noqa: E402
from dispatches_tpu_torch.interop import x_from_numpy  # noqa: E402
from dispatches_tpu_torch.properties import iapws95 as tw95  # noqa: E402
from torch_fossil_cases import (  # noqa: E402
    CPU,
    assert_rows_match,
    assert_same_layout,
    decision_values,
    jax_rows,
    stop_design,
)

ES_RTOL = 1e-8        # _es_turbine_host_solve vs JAX's (brentq over noisy saturation)
START_RTOL = 1e-12    # the design decisions' starting values vs JAX's


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one intra-op thread, as the other test_torch_* modules."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_source_census():
    assert dd.SOURCES == ("condpump", "fwh4", "booster", "bfp", "fwh9")
    assert dd.HEAT_DUTY_FIXED == 148.5
    assert dd.POWER_FIXED == 400.0
    assert dd.SALT_T_HOT == 831.15


def test_cost_expression_data():
    assert dd.SALT_PRICE == 0.49
    assert dd.ES_TURBINE_EFF == 0.8
    assert dd.AREA_MAX == 5000.0
    for n in ("SALT_PRICE", "SALT_T_HOT", "SALT_T_MIN", "HXD_AREA_INIT", "HXD_SALT_FLOW_INIT",
              "SPLIT_FRAC_INIT", "ES_TURBINE_EFF", "POWER_FIXED", "POWER_MAX",
              "HEAT_DUTY_FIXED", "AREA_MAX", "SALT_FLOW_MAX", "SOURCES", "OBJ_SCALE",
              "COAL_PRICE", "HOURS_PER_DAY", "NUM_OF_YEARS"):
        assert getattr(dd, n) == getattr(jdd, n), n


@pytest.mark.slow  # ~20-40 s of JAX's eager flashes (the tier-1 clock)
def test_es_turbine_host_solve_matches_jax():
    # a superheated inlet near 1 MPa: JAX's eager flashes take ~20 s there
    rng = np.random.default_rng(5)
    h_in, P_in = float(rng.uniform(61000.0, 62000.0)), float(rng.uniform(1.0e6, 1.2e6))
    got = np.array(dd._es_turbine_host_solve(h_in, P_in), dtype=np.float64)
    want = np.array(jdd._es_turbine_host_solve(h_in, P_in), dtype=np.float64)
    assert np.max(np.abs(got - want) / np.abs(want)) <= ES_RTOL, (got, want)
    # the landed state: 1 K above saturation at the outlet pressure
    P_out, h_iso, h_out, Ts = got[:4]
    T_out = float(tw95.flash_hp(h_out, P_out)["T"])
    assert abs(T_out - (Ts + 1.0)) <= 1e-6
    assert h_out == pytest.approx(h_in - dd.ES_TURBINE_EFF * (h_in - h_iso), rel=1e-14)


SUBCRITICAL = ("condpump", "fwh4", "booster")


@pytest.fixture(scope="module")
def port_models():
    """The port's discharge models, built (host initialization included)
    on first use and kept."""
    built = {}

    def get(source):
        if source not in built:
            built[source] = dd.build_discharge_model(source)
        return built[source]

    return get


def _carry(port_m):
    """Stand-ins for JAX's ``usc_plant.initialize`` and the discharge
    train's ``_initialize`` that set every variable JAX's flowsheet
    already has to the port's warm start."""
    inits = {n: np.array(s.init, dtype=np.float64) for n, s in port_m.fs.var_specs.items()}

    def carry(m):
        for name in m.fs.var_specs:
            if name in inits:
                m.fs.set_init(name, inits[name])
    return carry


@pytest.mark.slow  # ~80 s: JAX's eager compile probing of the design NLP (the tier-1 clock)
def test_design_nlp_matches_jax_condpump(port_models):
    port_m = port_models("condpump")
    carry = _carry(port_m)
    mp = pytest.MonkeyPatch()
    mp.setattr(jdd.up, "initialize", carry)
    mp.setattr(jdd, "_initialize", carry)
    try:
        jm = jdd.build_discharge_model("condpump")
    finally:
        mp.undo()
    assert jm.supercritical == port_m.supercritical is False
    jb = stop_design(jdd, jm)
    tb = stop_design(dd, port_m, device=CPU)
    nlp, jn = tb.nlp, jb.nlp
    np.testing.assert_array_equal(np.asarray(jn.x0), nlp.x0)
    assert_same_layout(nlp, jn, rtol=START_RTOL)
    assert tb.decisions == jb.decisions == ["es_split.split_fraction_2",
                                            "hxd.shell_inlet.flow_mass"]
    t0, j0 = decision_values(nlp, tb.decisions), decision_values(jn, jb.decisions)
    assert np.all(np.abs(t0 - j0) <= START_RTOL * np.abs(j0)), (t0, j0)
    assert nlp.sense == jn.sense == "min"
    rows, obj = jax_rows(jn, jn.x0)
    x = x_from_numpy(np.asarray(jn.x0), jn, nlp, CPU)
    assert_rows_match(nlp, x, rows, obj)


@pytest.mark.parametrize("source", [
    *SUBCRITICAL,
    *(pytest.param(s, marks=pytest.mark.slow) for s in ("bfp", "fwh9"))])
def test_port_design_nlp_builds(port_models, source):
    m = port_models(source)
    b = stop_design(dd, m, device=CPU)
    nlp = b.nlp
    assert nlp.n == sum(hi - lo for lo, hi in dict(nlp.eq_slices).values())
    assert b.decisions == ["es_split.split_fraction_2", "hxd.shell_inlet.flow_mass"]
    assert set(b.decisions) <= set(nlp.fixed_names)
    x = torch.as_tensor(nlp.x0)
    p = nlp.default_params()
    r, g, f = nlp.eq(x, p), nlp.ineq(x, p), nlp.objective(x, p)
    assert bool(torch.isfinite(r).all()) and bool(torch.isfinite(g).all())
    assert np.isfinite(float(f)) and 10.0 < float(f) < 1e3   # M$/yr
    # the taps above the critical pressure heat into a supercritical state
    assert m.supercritical == (source in ("bfp", "fwh9"))
    assert (m.units["es_turbine"].sat_in_block is None) == m.supercritical


def test_run_design_study_selects_the_cheapest_feasible(monkeypatch):
    costs = {"condpump": (50e6, True, 0), "fwh4": (48e6, False, 2), "booster": (55e6, True, 0),
             "bfp": (51e6, False, 0), "fwh9": (45e6, None, 0)}

    def fake(source, maxiter, verbose=0, device=None):
        c, conv, inner = costs[source]
        if conv is None:
            return {"source": source, "converged": False, "error": "rc=-9: killed"}
        return {"source": source, "cost": c, "converged": conv, "inner_failures": inner}

    monkeypatch.setattr(dd, "_run_source_isolated", fake)
    ended = []
    out = dd.run_design_study(maxiter=3, isolate=True, device=CPU, on_result=ended.append)
    assert out["best"]["source"] == "condpump"
    assert [r["source"] for r in out["results"]] == list(dd.SOURCES)
    # each source's result is handed on as its run ends
    assert sorted(r["source"] for r in ended) == sorted(dd.SOURCES)


def test_combo_summary_keys_match_jax():
    class R:
        inner_failures = 0

    out = {"source": "condpump", "cost": 5e7, "hxd_area": 1912.0, "salt_T_out": 513.2,
           "es_power_mw": 40.0, "converged": True, "res": R}
    assert dd._combo_summary(out) == jdd._combo_summary(out)


@pytest.mark.skipif(torch.cuda.is_available(), reason="the CPU-only rule")
def test_entry_points_follow_the_device_rule(port_models):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dd.design_optimize(port_models("fwh4"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dd.run_design_study(sources=("condpump",))
    with pytest.raises(ValueError, match="condensate source"):
        dd.build_discharge_model("economizer")


@pytest.mark.slow  # ~10 min of this CPU: the design NLP over the 437 MW plant at maxiter 150
def test_condpump_design_anchor():
    m = dd.build_discharge_model("condpump")
    out = dd.design_optimize(m, maxiter=150, device=CPU)
    res = out["res"]
    print(f"converged {out['converged']} ({res.message}), {res.outer_iterations} outer "
          f"iterations, {res.inner_failures} inner failures; area {out['hxd_area']!r} m2, salt "
          f"out {out['salt_T_out']!r} K, storage turbine {out['es_power_mw']!r} MW, cost "
          f"{out['cost']!r}")
    assert out["converged"] or res.inner_failures == 0
    assert out["hxd_area"] == pytest.approx(1912.2, rel=1e-2)
    assert out["salt_T_out"] == pytest.approx(513.15, abs=1.0)
    assert 20.0 < out["es_power_mw"] < 60.0
    sol = out["sol"]
    assert sol["plant_power_out"][0] == pytest.approx(400.0, abs=1e-6)
    assert sol["hxd.heat_duty"][0] == pytest.approx(148.5e6, abs=10.0)
