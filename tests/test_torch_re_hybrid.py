"""The PyTorch port's renewables hybrids held to the JAX package on the
CPU, in float64.

- ``create_model``: the compositions of tests/test_re_case.py (full hybrid
  and PV) and every branch (wind or PV; PEM; simple or detailed tank;
  turbine) with the JAX layout, exactly.
- ``wind_battery_pem_optimize`` at T = 24 with tests/test_re_pem_hybrid.py's
  params: NPV within 1e-6 relative of the JAX function's and within 1e-4 of
  an independent HiGHS LP (that test's formulation).
- The full hybrid (wind + battery + PEM + tank + turbine) at T = 4 with
  the same params in both packages: the NLP layout exactly, the
  objective, residuals and their Jacobians at x0 and at a seeded random x
  within 1e-12 relative, the Lagrangian Hessian at x0 against
  ``jax.hessian`` within 1e-10, ``_initialize_train``'s inits within
  1e-12, and the detected time structure equal to JAX's.  (Relative means
  the max-norm of the difference over max(1, max-norm of the JAX value).)
- Its first 15 interior-point iterations, both solvers traced
  (``make_ipm_solver(..., trace=True)``, ``max_iter=15``).  At T = 4 the
  hybrid has no detectable time structure (detection needs T >= 8), so
  both KKT options run the dense Cholesky condensation: the port's
  ``kkt="structured"`` run is bitwise its ``"dense"`` run, and the dense
  run is held to JAX's.  Its Schur complement is ill-conditioned, so the
  iterates depend on how the BLAS blocks its products (one BLAS thread
  against eight moves the traced KKT error by 1.2e-8 and the iterate by
  5.0e-9 relative on an 8-core x86 CPU; the file runs torch on one thread,
  as the other test_torch_* files do).  The barrier parameter is held
  bitwise, the traced KKT error and the iterate within 1e-6 relative.  JAX's trace compiles for minutes, so it is recorded
  (``tests/torch_records.py``, ``hybrid_ipm_jax_t4_dense``); the slow
  tests/test_torch_hybrid_ipm.py holds the record to JAX bitwise and runs
  the T = 8 structured comparison.  At T = 8 the structured path's first
  Newton step equals the dense path's in the primal.

The converged T = 24 full hybrid is the card's job (``chip_smoke.py``
phase 6) and the ``slow`` test at the end: JAX itself does not converge
the T = 4 hybrid in 500 iterations, and from T = 6 up a solve takes
minutes on this CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy.optimize import linprog  # noqa: E402

from dispatches_tpu.case_studies.renewables import flowsheet as j_flowsheet  # noqa: E402
from dispatches_tpu.case_studies.renewables import load_parameters as j_lp  # noqa: E402
from dispatches_tpu.case_studies.renewables import wind_battery_pem_lmp as j_pem  # noqa: E402
from dispatches_tpu.case_studies.renewables import (  # noqa: E402
    wind_battery_pem_tank_turbine_lmp as j_hyb,
)
from dispatches_tpu.solvers import IPMOptions as JIPMOptions  # noqa: E402
from dispatches_tpu.solvers import make_ipm_solver as j_make_ipm_solver  # noqa: E402
from dispatches_tpu.solvers import structured as j_st  # noqa: E402

from dispatches_tpu_torch.case_studies.renewables import flowsheet as t_flowsheet  # noqa: E402
from dispatches_tpu_torch.case_studies.renewables import load_parameters as lp  # noqa: E402
from dispatches_tpu_torch.case_studies.renewables import wind_battery_pem_lmp as t_pem  # noqa: E402
from dispatches_tpu_torch.case_studies.renewables import (  # noqa: E402
    wind_battery_pem_tank_turbine_lmp as t_hyb,
)
from dispatches_tpu_torch.solvers import IPMOptions, make_ipm_solver  # noqa: E402
from dispatches_tpu_torch.solvers import structured as t_st  # noqa: E402

import torch_records  # noqa: E402
from test_torch_h2_models import assert_callables_match, assert_rel, assert_same_layout  # noqa: E402
from test_torch_stacked import one_torch_thread  # noqa: E402,F401

T = 24
CFS = 0.3 + 0.3 * np.sin(2 * np.pi * np.arange(T) / 24) ** 2
LMPS = np.where(np.arange(T) % 24 < 12, 15.0, 60.0)
T_HYB = 4


def _params(horizon=T, **over):
    params = {
        "wind_mw": 100.0,
        "wind_mw_ub": 1000.0,
        "batt_mw": 10.0,
        "pem_mw": 20.0,
        "turb_mw": 1.0,
        "tank_size": 0.3,
        "tank_type": "simple",
        "capacity_factors": CFS[:horizon],
        "DA_LMPs": LMPS[:horizon],
        "h2_price_per_kg": 2.0,
        "design_opt": True,
        "extant_wind": True,
    }
    params.update(over)
    return params


def j_hybrid_nlp(horizon, params):
    """The JAX NLP, built exactly as ``wind_battery_pem_tank_turb_optimize``
    builds it, without its solve (the port's ``wind_battery_pem_tank_turb_nlp``
    is the same build factored out)."""
    captured = {}

    class _Built(Exception):
        pass

    def capture(nlp, options=None):
        captured["nlp"] = nlp
        raise _Built

    real = j_hyb.solve_nlp
    j_hyb.solve_nlp = capture
    try:
        j_hyb.wind_battery_pem_tank_turb_optimize(horizon, params)
    except _Built:
        pass
    finally:
        j_hyb.solve_nlp = real
    return captured["nlp"]


@pytest.fixture(scope="module")
def hybrid():
    """(JAX nlp, port model, port nlp) of the T = 4 full hybrid."""
    params = _params(T_HYB)
    m, tn = t_hyb.wind_battery_pem_tank_turb_nlp(T_HYB, params)
    return j_hybrid_nlp(T_HYB, params), m, tn


# ---------------------------------------------------------------------------
# create_model
# ---------------------------------------------------------------------------


def test_create_model_composition():
    m = t_flowsheet.create_model(
        re_mw=lp.fixed_wind_mw, pem_bar=lp.pem_bar, batt_mw=lp.fixed_batt_mw,
        tank_type="simple", tank_length_m=lp.fixed_tank_size,
        turb_inlet_bar=lp.pem_bar, horizon=1, capacity_factors=[0.5])
    for u in ("windpower", "splitter", "battery", "pem", "h2_tank",
              "translator", "mixer", "h2_turbine"):
        assert u in m.units, f"missing unit {u}"
    fs = m.fs
    assert fs.is_fixed("windpower.system_capacity")
    assert fs.is_fixed("battery.nameplate_power")
    assert fs.has_constraint("mixer.air_h2_ratio")
    assert fs.var_specs["h2_turbine.turbine.deltaP"].fixed_value == -2401000.0
    assert fs.var_specs["mixer.purchased_hydrogen_feed.flow_mol"].lb == lp.h2_turb_min_flow / 2


def test_create_model_pv():
    m = t_flowsheet.create_model(
        re_mw=800, pem_bar=lp.pem_bar, batt_mw=lp.fixed_batt_mw, tank_type="simple",
        tank_length_m=lp.fixed_tank_size, turb_inlet_bar=lp.pem_bar, horizon=1,
        capacity_factors=[0.5], re_type="pv")
    assert "pv" in m.units
    assert m.fs.is_fixed("pv.system_capacity")
    with pytest.raises(ValueError, match="unknown re_type"):
        t_flowsheet.create_model(1.0, None, None, None, None, None, re_type="hydro",
                                 capacity_factors=[0.5])
    with pytest.raises(ValueError, match="Unrecognized tank_type"):
        t_flowsheet.create_model(1.0, 1.0, None, "sphere", 0.3, None, capacity_factors=[0.5])


@pytest.mark.parametrize("re_type,pem,batt,tank,turb", [
    ("wind", None, 10.0, None, None),
    ("wind", 1.01325, None, None, None),
    ("pv", 1.01325, 10.0, "simple", None),
    ("wind", 1.01325, 10.0, "simple", 1.01325),
    ("wind", 1.01325, 10.0, "detailed", None),
    ("pv", 1.01325, 10.0, "detailed", 1.01325),
], ids=["wind-batt", "wind-pem", "pv-pem-batt-simple", "full-simple", "detailed",
        "pv-detailed-turbine"])
def test_create_model_branches_match_jax(re_type, pem, batt, tank, turb):
    kw = dict(re_mw=50.0, pem_bar=pem, batt_mw=batt, tank_type=tank, tank_length_m=0.3,
              turb_inlet_bar=turb, horizon=3, capacity_factors=[0.5, 0.2, 0.7], re_type=re_type)
    jm, tm = j_flowsheet.create_model(**kw), t_flowsheet.create_model(**kw)
    assert list(tm.units) == list(jm.units)
    assert [c.name for c in tm.fs.constraints] == [c.name for c in jm.fs.constraints]
    assert_same_layout(tm.fs.compile(), jm.fs.compile())


# ---------------------------------------------------------------------------
# wind + battery + PEM
# ---------------------------------------------------------------------------


def _highs_pem_npv():
    """tests/test_re_pem_hybrid.py's independent LP of the PEM case."""
    wind_kw = 100e3
    prices = LMPS * 1e-3
    mult = 52 / (T / 168) * lp.PA
    nv = 6 * T + 4
    ig = np.arange(T)
    ibi, ibo, iso = T + ig, 2 * T + ig, 3 * T + ig
    isoc0, itp, ipe = 4 * T, 4 * T + 1 + ig, 5 * T + 1 + ig
    iP, iE, iPp = 6 * T + 1, 6 * T + 2, 6 * T + 3
    Aeq, beq, Aub, bub = [], [], [], []

    def row():
        return np.zeros(nv)

    for t in range(T):
        r = row(); r[iso[t]] = 1; r[ibi[t]] = -0.95; r[ibo[t]] = 1 / 0.95  # noqa: E702
        r[iso[t - 1] if t else isoc0] = -1
        Aeq.append(r); beq.append(0)  # noqa: E702
        r = row(); r[itp[t]] = 1; r[ibi[t]] = -0.5; r[ibo[t]] = -0.5  # noqa: E702
        if t:
            r[itp[t - 1]] = -1
        Aeq.append(r); beq.append(0)  # noqa: E702
        r = row(); r[ig[t]] = 1; r[ibi[t]] = 1; r[ipe[t]] = 1  # noqa: E702
        Aub.append(r); bub.append(wind_kw * CFS[t])  # noqa: E702
        r = row(); r[ibi[t]] = 1; r[iP] = -1; Aub.append(r); bub.append(0)  # noqa: E702
        r = row(); r[ibo[t]] = 1; r[iP] = -1; Aub.append(r); bub.append(0)  # noqa: E702
        r = row(); r[iso[t]] = 1; r[iE] = -1; r[itp[t]] = 1e-4  # noqa: E702
        Aub.append(r); bub.append(0)  # noqa: E702
        r = row(); r[ipe[t]] = 1; r[iPp] = -1; Aub.append(r); bub.append(0)  # noqa: E702
    r = row(); r[iE] = 1; r[iP] = -4; Aeq.append(r); beq.append(0)  # noqa: E702
    r = row(); r[iso[T - 1]] = 1; r[isoc0] = -1; Aeq.append(r); beq.append(0)  # noqa: E702

    h2_per_kwh = 0.002527406 / lp.h2_mols_per_kg * 3600 * 2.0  # $ per kWh pem
    c = np.zeros(nv)
    c[ig] = -prices * mult
    c[ibo] = -prices * mult
    c[ipe] = -(h2_per_kwh - lp.pem_var_cost) * mult
    c[iP] = lp.batt_cap_cost
    c[iPp] = lp.pem_cap_cost + lp.pem_op_cost / 8760 * T * mult
    wind_om_const = wind_kw * lp.wind_op_cost / 8760 * T * mult
    ref = linprog(c, A_eq=np.array(Aeq), b_eq=np.array(beq), A_ub=np.array(Aub),
                  b_ub=np.array(bub), bounds=[(0, None)] * nv, method="highs")
    assert ref.status == 0
    return -ref.fun - wind_om_const


def test_wind_battery_pem_optimize_matches_jax_and_highs():
    want = j_pem.wind_battery_pem_optimize(T, _params())
    got = t_pem.wind_battery_pem_optimize(T, _params(), device="cpu")
    assert got.converged and want.converged
    assert got.npv == pytest.approx(want.npv, rel=1e-6)
    assert got.annual_revenue == pytest.approx(want.annual_revenue, rel=1e-6)
    for k in ("battery_power_kw", "wind_capacity_kw"):
        assert getattr(got, k) == pytest.approx(getattr(want, k), rel=1e-6, abs=1e-3)
    assert got.npv == pytest.approx(_highs_pem_npv(), rel=1e-4)
    sol = got.solution
    np.testing.assert_allclose(
        sol["splitter.grid_elec"] + sol["splitter.battery_elec"] + sol["splitter.pem_elec"],
        sol["windpower.electricity"], atol=1e-4)
    np.testing.assert_allclose(sol["pem.outlet.flow_mol"],
                               sol["pem.electricity"] * 0.002527406, atol=1e-5)
    assert got.npv > 0


def test_hybrid_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_pem.wind_battery_pem_optimize(T, _params())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_hyb.wind_battery_pem_tank_turb_optimize(T_HYB, _params(T_HYB))


# ---------------------------------------------------------------------------
# the full hybrid at T = 4
# ---------------------------------------------------------------------------


def test_hybrid_layout_matches_jax(hybrid):
    jn, _, tn = hybrid
    assert (jn.n, jn.m_eq, jn.m_ineq) == (399, 387, 28)
    # x0 holds the turbine's bisection results (last bits of log may differ)
    assert_same_layout(tn, jn, x0_rtol=1e-12)


def test_initialize_train_matches_jax(hybrid):
    jn, _, tn = hybrid
    for name, js in jn.fs.var_specs.items():
        assert_rel(np.asarray(tn.fs.var_specs[name].init, dtype=float),
                   np.asarray(js.init, dtype=float), what=name)


def test_hybrid_callables_and_jacobians_match_jax(hybrid):
    jn, _, tn = hybrid
    assert_callables_match(tn, jn, seed=11)


def test_hybrid_lagrangian_hessian_matches_jax(hybrid):
    """The Lagrangian's Hessian at x0 with seeded multipliers: the port's
    reverse-over-reverse ``jacrev(grad)`` (the dense KKT path's ``hess_l``)
    against ``jax.hessian``, within 1e-10.  The turbine's Shomate and
    y log y terms make it nonzero in every period."""
    jn, _, tn = hybrid
    rng = np.random.default_rng(5)
    lam_e, lam_i = rng.standard_normal(jn.m_eq), rng.standard_normal(jn.m_ineq)
    x0 = np.asarray(jn.x0)
    jp, tp = jn.default_params(), tn.default_params()

    def j_lag(x):
        return jn.objective(x, jp) + jn.eq(x, jp) @ lam_e + jn.ineq(x, jp) @ lam_i

    te, ti = torch.as_tensor(lam_e), torch.as_tensor(lam_i)

    def t_lag(x):
        return tn.objective(x, tp) + tn.eq(x, tp) @ te + tn.ineq(x, tp) @ ti

    want = np.asarray(jax.jit(jax.hessian(j_lag))(jnp.asarray(x0)))
    got = torch.func.jacrev(torch.func.grad(t_lag))(torch.as_tensor(x0))
    assert np.count_nonzero(want) > 0
    assert_rel(got, want, rtol=1e-10)
    np.testing.assert_allclose(got.numpy(), got.numpy().T, rtol=0, atol=1e-9 * np.abs(want).max())


def test_hybrid_time_structure_matches_jax(hybrid):
    """Structure detection needs T >= 8 by default (both packages find
    none at T = 4); at min_T = 4 the border holds the scalar design and
    initial-state variables, in JAX's order."""
    jn, _, tn = hybrid
    assert j_st.detect_time_structure(jn) is None
    assert t_st.detect_time_structure(tn, device="cpu") is None
    want = j_st.detect_time_structure(jn, min_T=4)
    got = t_st.detect_time_structure(tn, min_T=4, device="cpu")
    assert want is not None and got is not None
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f
    border = {name for name in tn.free_names
              if tn._slices[name][2] == ()}
    assert {"pem_system_capacity", "h2_tank_size", "turb_system_capacity",
            "h2_tank.tank_holdup_previous", "battery.initial_state_of_charge",
            "battery.nameplate_power"} <= border
    border_x = {int(i) for i in got.border_y_idx if i < tn.n}
    assert border_x == {tn._slices[name][0] for name in border}


# ---------------------------------------------------------------------------
# the first interior-point iterations (JAX's trace recorded)
# ---------------------------------------------------------------------------

N_ITER = 15
TRACE_RTOL = 1e-6
HYBRID_RECORD = "hybrid_ipm_jax_t4_dense"


def _jax_trace(horizon, kkt):
    """(JAX result, JAX trace) of N_ITER traced iterations from the
    default start."""
    jn = j_hybrid_nlp(horizon, _params(horizon))
    return jax.jit(j_make_ipm_solver(jn, JIPMOptions(max_iter=N_ITER, kkt=kkt),
                                     trace=True))(jn.default_params())


def jax_record():
    """The recorded fields of JAX's T = 4 dense trace."""
    jres, jtr = _jax_trace(4, "dense")
    return {"iterations": np.asarray(jres.iterations), "status": np.asarray(jres.status),
            "x": np.asarray(jres.x),
            **{f"trace_{k}": np.asarray(jtr[k]) for k in ("mu", "stall", "kkt_error")}}


def _recorded():
    """(JAX result, JAX trace) of the T = 4 dense run, from the record."""
    rec = torch_records.read(HYBRID_RECORD)
    res = type("JRes", (), {"iterations": rec["iterations"], "status": rec["status"],
                            "x": rec["x"]})
    return res, {k: rec[f"trace_{k}"] for k in ("mu", "stall", "kkt_error")}


def _traces(horizon, kkt):
    """(JAX result, JAX trace, port result, port trace) of N_ITER traced
    iterations from the default start; JAX's from the record at T = 4
    dense."""
    params = _params(horizon)
    _, tn = t_hyb.wind_battery_pem_tank_turb_nlp(horizon, params)
    if (horizon, kkt) == (4, "dense"):
        jres, jtr = _recorded()
    else:
        jres, jtr = _jax_trace(horizon, kkt)
    tres, ttr = make_ipm_solver(tn, IPMOptions(max_iter=N_ITER, kkt=kkt), trace=True,
                                device="cpu")(tn.default_params())
    return jres, jtr, tres, ttr, tn


def _rel(got, want):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300)))


def _assert_traces_match(jres, jtr, tres, ttr, label):
    np.testing.assert_array_equal(ttr["mu"].numpy(), np.asarray(jtr["mu"]))
    np.testing.assert_array_equal(ttr["stall"].numpy(), np.asarray(jtr["stall"]))
    assert int(tres.iterations) == int(jres.iterations) == N_ITER
    assert int(tres.status) == int(jres.status)
    err_rel = _rel(ttr["kkt_error"].numpy(), jtr["kkt_error"])
    jx = np.asarray(jres.x)
    x_rel = float(np.max(np.abs(tres.x.numpy() - jx)) / np.max(np.abs(jx)))
    print(f"{label}: traced KKT error max relative gap {err_rel:.3e}, "
          f"iterate {x_rel:.3e}")
    assert err_rel <= TRACE_RTOL
    assert x_rel <= TRACE_RTOL


def test_hybrid_ipm_first_iterations_match_jax():
    jres, jtr, tres, ttr, tn = _traces(4, "dense")
    _assert_traces_match(jres, jtr, tres, ttr, "T=4 dense")
    # "structured" finds no time structure at T = 4: the same solver
    assert t_st.detect_time_structure(tn, device="cpu") is None
    sres, strace = make_ipm_solver(tn, IPMOptions(max_iter=N_ITER, kkt="structured"),
                                   trace=True, device="cpu")(tn.default_params())
    assert torch.equal(sres.x, tres.x)
    for k in ("mu", "kkt_error", "alpha", "stall"):
        assert torch.equal(strace[k], ttr[k]), k


def test_hybrid_kkt_paths_take_the_same_first_step():
    """T = 8, where the structured path runs: its first Newton step (W by
    coloured Hessian-vector products) equals the dense path's (W by
    ``jacrev(grad)``) in the primal.  The multipliers differ in the null
    space of J, which is rank-deficient here; they enter W from the
    second iteration on, so the two paths part there."""
    _, tn = t_hyb.wind_battery_pem_tank_turb_nlp(8, _params(8))
    assert t_st.detect_time_structure(tn, device="cpu") is not None
    step = {kkt: make_ipm_solver(tn, IPMOptions(max_iter=1, kkt=kkt), device="cpu")(
        tn.default_params()) for kkt in ("structured", "dense")}
    s, d = step["structured"], step["dense"]
    assert int(s.iterations) == int(d.iterations) == 1
    assert float((d.x - s.x).abs().max() / s.x.abs().max()) <= TRACE_RTOL
    assert float((d.lam - s.lam).abs().max() / s.lam.abs().max()) > TRACE_RTOL



@pytest.mark.slow
def test_full_hybrid_converges_on_the_cpu():
    """The converged T = 24 full hybrid with test_full_hybrid_structural's
    checks, on the port alone."""
    out = t_hyb.wind_battery_pem_tank_turb_optimize(T, _params(), verbose=True, device="cpu")
    sol = out.solution
    net_in = (sol["h2_tank.inlet.flow_mol"] - sol["h2_tank.outlet_to_pipeline.flow_mol"]
              - sol["h2_tank.outlet_to_turbine.flow_mol"]) * 3600.0
    holdup = sol["h2_tank.tank_holdup"]
    prev = np.concatenate([[float(sol["h2_tank.tank_holdup_previous"])], holdup[:-1]])
    np.testing.assert_allclose(holdup - prev, net_in, atol=1e-3)
    np.testing.assert_allclose(
        sol["mixer.air_feed.flow_mol"],
        lp.air_h2_ratio * (sol["mixer.purchased_hydrogen_feed.flow_mol"]
                           + sol["mixer.hydrogen_feed.flow_mol"]), rtol=1e-5)
    assert np.all(sol["h2_turbine.compressor.work_mechanical"] >= -1e-6)
    assert np.all(sol["h2_turbine.turbine.work_mechanical"] <= 1e-6)
    assert out.res.converged
    assert j_lp.air_h2_ratio == lp.air_h2_ratio


@pytest.mark.slow
def test_jax_dense_path_stalls_on_the_full_hybrid():
    """Why ``chip_smoke.py``'s ``[hybrid]`` starts the dense KKT path from
    the structured optimum: from the default start the JAX package's own
    dense path ends unconverged after 500 iterations (~17 min here), at a
    design far from the structured optimum (PEM ~45 MW against ~0)."""
    out = j_hyb.wind_battery_pem_tank_turb_optimize(T, _params(kkt="dense"))
    print(f"JAX dense: status {int(out.res.status)}, {int(out.res.iterations)} iterations, "
          f"NPV {out.npv:.2f}, PEM {float(out.solution['pem_system_capacity']):.3f} kW")
    assert not out.converged and int(out.res.iterations) == 500
    assert float(out.solution["pem_system_capacity"]) > 1e4
