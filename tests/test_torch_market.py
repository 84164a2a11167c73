"""The PyTorch port's market co-simulator held to the JAX package on the
CPU, on the 5-bus synthetic RTS-GMLC-format case that ``chip_smoke.py``'s
writer makes from a seed (the card runs the same writer at 73 buses).

- ``load_rts_gmlc_case``: numpy on both sides, so bitwise, PTDF included;
- ``solve_unit_commitment``: host scipy on both sides, bitwise (MILP and
  the LP-relaxation fallback);
- a 4-hour ``_DispatchLP`` with a participant's bids and one binding
  line: LMPs within 1e-6 absolute of JAX's, the objective within 1e-8
  relative, and the dense IPM's affine shortcut and sparse Schur product
  equal to its generic path;
- one simulated day without a participant (RUC window 24 h): every CSV
  equal to JAX's, which compiles for minutes and is therefore recorded
  (``tests/torch_records.py``, ``market_day_jax_csvs``;
  tests/test_torch_market_day.py holds the record to JAX bitwise and
  compares ``run_double_loop``, both ``slow``).
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu.grid import market as jm  # noqa: E402

from dispatches_tpu_torch.case_studies.renewables import run_double_loop as t_rdl  # noqa: E402
from dispatches_tpu_torch.grid import market as tm  # noqa: E402
from dispatches_tpu_torch.solvers.ipm import IPMOptions, make_ipm_solver  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
import torch_records  # noqa: E402
from test_torch_stacked import one_torch_thread  # noqa: E402,F401

CPU = "cpu"
LMP_ATOL = 1e-6


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The 5-bus synthetic case (tests/test_torch_market_day.py uses it too)."""
    return chip_smoke.write_synthetic_rts(tmp_path_factory.mktemp("rts5"), n_bus=5,
                                          n_branch=7, n_thermal=5, n_renewable=2, seed=0)


def _uc_state(case):
    return {"on": np.array([t.initial_on for t in case.thermals]),
            "hours": np.array([max(int(round(t.min_up)), 1) if t.initial_on
                               else max(int(round(t.min_down)), 1) for t in case.thermals])}


def _assert_case_equal(tc, jc):
    assert tc.buses == jc.buses and tc.line_names == jc.line_names
    assert tc.start_timestamp == jc.start_timestamp
    for f in ("load_da", "load_rt", "ptdf", "line_limits"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f), err_msg=f)
    for tl, jl in ((tc.thermals, jc.thermals), (tc.renewables, jc.renewables)):
        assert len(tl) == len(jl)
        for a, b in zip(tl, jl):
            for f in dataclasses.fields(b):
                np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name),
                                              err_msg=f"{b.name}.{f.name}")


def test_synthetic_writer_counts(data):
    case = tm.load_rts_gmlc_case(data)
    assert len(case.buses) == 5 and case.ptdf.shape == (7, 5)
    assert len(case.thermals) == 5 and len(case.renewables) == 2
    assert "4_WIND" in [r.name for r in case.renewables]
    assert case.n_hours == 72 and str(case.start_timestamp.date()) == "2020-07-10"


def test_load_rts_gmlc_case_is_bitwise(data):
    _assert_case_equal(tm.load_rts_gmlc_case(data), jm.load_rts_gmlc_case(data))


@pytest.mark.parametrize("use_milp,reserve", [(True, 0.0), (True, 0.1), (False, 0.1)])
def test_unit_commitment_is_bitwise(data, use_milp, reserve):
    tc, jc = tm.load_rts_gmlc_case(data), jm.load_rts_gmlc_case(data)
    hours = np.arange(48)
    got = tm.solve_unit_commitment(tc, hours, reserve_factor=reserve, use_milp=use_milp,
                                   initial_state=_uc_state(tc))
    want = jm.solve_unit_commitment(jc, hours, reserve_factor=reserve, use_milp=use_milp,
                                    initial_state=_uc_state(jc))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (48, len(tc.thermals)) and got.sum() > 0


def _bids(H):
    return {t: {"4_WIND": {"p_cost": [(0.0, 0.0), (10.0 + 0.5 * t, 150.0), (40.0, 900.0)]}}
            for t in range(H)}


@pytest.fixture(scope="module")
def binding_case(data):
    """The case with one line tightened to 80% of its largest DA flow
    (HiGHS-checked feasible), so that the LMPs carry a congestion part."""
    tc, jc = tm.load_rts_gmlc_case(data), jm.load_rts_gmlc_case(data)
    hours = np.arange(24)
    u = tm.solve_unit_commitment(tm._case_for_uc(tc, "4_WIND"), hours,
                                 initial_state=_uc_state(tm._case_for_uc(tc, "4_WIND")))
    lp = tm._DispatchLP(tc, 24, "4_WIND", "4", device=CPU)
    p = lp.params_for(hours, u, rt=False, participant_bids=_bids(24))
    res, sol, _ = lp.solve(p)
    x = res.x
    flows = lp.nlp.ineq(x, p)[slice(*lp.nlp.ineq_slices["line_fwd"])].reshape(7, 24)
    flows = flows.numpy() + tc.line_limits[:, None]
    li = int(np.argmax(np.abs(flows).max(1)))
    h0 = min(max(int(np.argmax(np.abs(flows[li]))) - 1, 0), 20)
    for c in (tc, jc):
        c.line_limits = c.line_limits.copy()
        c.line_limits[li] = 0.8 * float(np.abs(flows[li]).max())
    return tc, jc, u, np.arange(h0, h0 + 4)


def test_dispatch_lp_lmps_match_jax(binding_case):
    """A 4-hour pricing LP over the hours where the tightened line
    carried its largest flow (4 hours keep the JAX side's compile short)."""
    tc, jc, u, hours = binding_case
    t_lp = tm._DispatchLP(tc, 4, "4_WIND", "4", device=CPU)
    j_lp = jm._DispatchLP(jc, 4, "4_WIND", "4")
    t_p = t_lp.params_for(hours, u[hours], rt=False, participant_bids=_bids(4))
    j_p = j_lp.params_for(hours, u[hours], rt=False, participant_bids=_bids(4))
    t_res, t_sol, t_lmp = t_lp.solve(t_p)
    j_res, j_sol, j_lmp = j_lp.solve(j_p)
    assert int(t_res.status) == 0 and int(j_res.status) == 0
    # the same layout as the JAX flowsheet: variables, rows and signs
    assert t_lp.nlp.free_names == j_lp.nlp.free_names
    assert t_lp.nlp._slices == j_lp.nlp._slices
    assert t_lp.nlp.eq_slices == j_lp.nlp.eq_slices
    assert t_lp.nlp.ineq_slices == j_lp.nlp.ineq_slices
    # the tightened line binds, so the LMPs differ across buses
    assert np.ptp(j_lmp, axis=1).max() > 1e-3
    np.testing.assert_allclose(t_lmp, j_lmp, rtol=0, atol=LMP_ATOL)
    assert abs(float(t_res.obj) - float(j_res.obj)) <= 1e-8 * abs(float(j_res.obj))
    for k in j_sol:
        np.testing.assert_allclose(t_sol[k], np.asarray(j_sol[k]), rtol=0, atol=1e-5, err_msg=k)


def test_affine_kkt_path_equals_the_generic_dense_path(binding_case):
    """The dispatch LP declares itself affine, so the dense IPM skips its
    (exactly zero) Hessian and solves the diagonal H by division; the
    generic dense path (Hessian by AD, Cholesky of H) gives the same
    iterations and the same solution."""
    tc, _, u, hours = binding_case
    lp = tm._DispatchLP(tc, 4, "4_WIND", "4", device=CPU)
    p = lp.params_for(hours, u[hours], rt=True, participant_bids=_bids(4))
    opts = IPMOptions(max_iter=200, autoscale=False, kkt="dense")
    fast = make_ipm_solver(lp.nlp, opts, device=CPU)(p)
    lp.nlp.affine = False
    try:
        slow = make_ipm_solver(lp.nlp, opts, device=CPU)(p)
    finally:
        del lp.nlp.affine
    assert int(fast.iterations) == int(slow.iterations) and int(fast.status) == 0
    np.testing.assert_allclose(fast.x.numpy(), slow.x.numpy(), rtol=0, atol=1e-9)
    lam_f, lam_s = fast.lam.numpy(), slow.lam.numpy()
    assert np.abs(lam_f - lam_s).max() <= 1e-8 * max(1.0, np.abs(lam_s).max())


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    assert t_rdl.DoubleLoopOptions(data_path="x").device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_rdl.run_double_loop(t_rdl.DoubleLoopOptions(data_path="does-not-matter"))


def test_market_mesh_raises_naming_item_7(data, tmp_path):
    """``simulate(mesh=)`` hands the mesh to each window's day-parallel
    prefetch, as the JAX simulator does (the bids over a mesh are held to
    the mesh-free batch in tests/test_torch_grid.py); a stub coordinator
    stops the day once the window's bids were asked for."""
    from dispatches_tpu_torch.parallel import scenario_mesh

    class Stop(Exception):
        pass

    calls = []

    class Coordinator:
        def prefetch_da_bids(self, dates, mesh=None):
            calls.append((list(dates), mesh))

        def request_da_bids(self, date):
            raise Stop(date)

    sim = tm.MarketSimulator(tm.load_rts_gmlc_case(data), tmp_path, device=CPU)
    sim.coordinator = Coordinator()
    mesh = scenario_mesh(2, device=CPU)
    with pytest.raises(Stop):
        sim.simulate("2020-07-10", 2, da_bid_window=2, mesh=mesh)
    assert calls == [(["2020-07-10", "2020-07-11"], mesh)]


def test_sparse_schur_product_equals_the_dense_one(binding_case, monkeypatch):
    """The affine path forms J H^-1 J^T as a sparse product once J is large
    and sparse (the 73-bus day-ahead LP on the card); forced here on the
    5-bus SCED LP, it gives the dense product's iterations and solution."""
    from dispatches_tpu_torch.solvers import ipm

    tc, _, u, hours = binding_case
    lp = tm._DispatchLP(tc, 4, "4_WIND", "4", device=CPU)
    p = lp.params_for(hours, u[hours], rt=True, participant_bids=_bids(4))
    opts = IPMOptions(max_iter=200, autoscale=False, kkt="dense")
    dense = make_ipm_solver(lp.nlp, opts, device=CPU)(p)
    monkeypatch.setattr(ipm, "_SPARSE_SCHUR_MIN", 0)
    sparse = make_ipm_solver(lp.nlp, opts, device=CPU)(p)
    assert int(sparse.iterations) == int(dense.iterations) and int(sparse.status) == 0
    np.testing.assert_allclose(sparse.x.numpy(), dense.x.numpy(), rtol=0, atol=1e-9)


# ---------------------------------------------------------------------------
# the simulated market day (JAX's CSVs recorded)
# ---------------------------------------------------------------------------

MARKET_DAY_RECORD = "market_day_jax_csvs"


def _csvs(d):
    return {p.name: p.read_text() for p in sorted(Path(d).glob("*.csv"))}


def test_one_day_without_participant_csvs_equal(data, tmp_path):
    tc = tm.load_rts_gmlc_case(data)
    # the shortest RUC window the market accepts (24 h; the card runs the
    # default 48 at 73 buses): the JAX side's compile grows with it
    t_out = tm.MarketSimulator(tc, tmp_path / "t", ruc_horizon=24,
                               device=CPU).simulate("2020-07-10", 1)
    got, want = _csvs(t_out["output_dir"]), torch_records.read(MARKET_DAY_RECORD)
    assert sorted(got) == sorted(want) == sorted([
        "bus_detail.csv", "hourly_summary.csv", "overall_simulation_output.csv",
        "renewables_detail.csv", "thermal_detail.csv"])
    for name in want:
        assert got[name] == want[name], name
    assert len(pd.read_csv(t_out["output_dir"] / "bus_detail.csv")) == 24 * 5
    assert pd.read_csv(t_out["output_dir"] / "hourly_summary.csv")["Shortfall"].max() == 0.0
