"""The PyTorch port's grid layer (bidders, tracker, coordinator,
forecaster) held to the JAX package on the CPU, in float64.

- tests/test_stacked_bidder.py's three recipes (SelfScheduler
  non-anticipativity over 3 scenarios, SelfScheduler optimality at S = 1,
  Bidder monotone curves) on both packages: the stacked solves (both
  couplings) with equal iterations and x within 1e-8, bids within 1e-6
  relative, and that file's optimality and non-anticipativity checks on
  the port.  JAX's side is recorded (``grid_bidders_jax`` in
  tests/torch_records.py; a ``slow`` test holds the record to JAX
  bitwise);
- a ``Tracker`` over 4 rolling hours: iterations equal, power output and
  realized state within 1e-8 (relative to max(1, |JAX's value|));
- the coordinator and backcaster cases of tests/test_double_loop.py that
  need no data, run against the port;
- ``compute_day_ahead_bids_batch`` at D = 3 (the day as the IPM's lane
  axis) equal to three sequential ``compute_day_ahead_bids`` calls on the
  same capacity-factor windows, and its errors;
- ``mesh=``: the day batch split over a 3-entry CPU mesh, one day per
  entry, within 1e-9 relative of the mesh-free batch (and the
  coordinator's prefetch over a 2-entry mesh).
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu.case_studies.renewables.wind_battery_double_loop import (  # noqa: E402
    MultiPeriodWindBattery as JMP,
)
from dispatches_tpu import grid as jgrid  # noqa: E402

from dispatches_tpu_torch.case_studies.renewables.wind_battery_double_loop import (  # noqa: E402
    MultiPeriodWindBattery as TMP,
)
from dispatches_tpu_torch import grid as tgrid  # noqa: E402

import torch_records  # noqa: E402
from test_torch_stacked import T_DA, make_bidder, one_torch_thread  # noqa: E402,F401

BID_RTOL = 1e-6
TRACK_RTOL = 1e-8


def _rel(a, b):
    return abs(a - b) / max(1.0, abs(b))


def assert_bids_match(got, want):
    assert sorted(got) == sorted(want)
    for t in want:
        g, w = got[t]["309_WIND_1"], want[t]["309_WIND_1"]
        assert sorted(g) == sorted(w)
        for k, wv in w.items():
            if k == "p_cost":
                assert len(g[k]) == len(wv), (t, g[k], wv)
                for (gp, gc), (wp, wc) in zip(g[k], wv):
                    assert _rel(gp, wp) <= BID_RTOL and _rel(gc, wc) <= BID_RTOL, (t, g[k], wv)
            else:
                assert _rel(float(g[k]), float(wv)) <= BID_RTOL, (t, k, g[k], wv)


def assert_stacked_solves_match(tb, t_res, j_res):
    """The stacked IPM solve against JAX's: status 0 and equal iterations,
    x within 1e-8, the objective within 1e-8 relative; one counted program
    per horizon, as graft_jit counts one compile."""
    assert int(t_res.status) == int(j_res.status) == 0
    assert int(t_res.iterations) == int(j_res.iterations)
    np.testing.assert_allclose(t_res.x.numpy(), np.asarray(j_res.x), rtol=0, atol=1e-8)
    assert abs(float(t_res.obj) - float(j_res.obj)) <= 1e-8 * abs(float(j_res.obj))
    counter = tb.day_ahead_model.solve._graft_counter
    assert counter.count == 1 and counter.label == f"bidder.solve[h={T_DA}]"


# ---------------------------------------------------------------------------
# tests/test_stacked_bidder.py's recipes on both packages
# ---------------------------------------------------------------------------


# JAX's bidders compile their stacked IPM for minutes, so their outputs on
# these recipes are recorded (tests/torch_records.py, ``grid_bidders_jax``);
# test_bidder_jax_record_is_current (slow) rebuilds them and holds them to
# the record bitwise.
BIDDER_RECORD = "grid_bidders_jax"
NON_ANTICIPATIVITY = 20.0 + 15.0 * np.random.default_rng(0).random((3, T_DA))
SINGLE_PRICE = 20.0 + 20.0 * np.random.default_rng(1).random(T_DA)
MONOTONE = np.sort(15.0 + 25.0 * np.random.default_rng(3).random((3, T_DA)), axis=0)


def _res_fields(res):
    return {k: np.asarray(getattr(res, k)) for k in ("status", "iterations", "x", "obj")}


def jax_record():
    """JAX's stacked solves and bids on the three recipes below."""
    jb = make_bidder("jax", "first_stage", NON_ANTICIPATIVITY)
    prices = jb._forecast("2020-01-02", 0, T_DA)
    j_powers, j_res = jb._scenario_solve(jb.day_ahead_model, prices)
    out = {"non_anticipativity": {
        "res": _res_fields(j_res), "powers": np.asarray(j_powers),
        "bids": jb.compute_day_ahead_bids(date="2020-01-02")}}
    jb = make_bidder("jax", "first_stage", SINGLE_PRICE[None, :], n_scenario=1)
    out["single_scenario"] = {"bids": jb.compute_day_ahead_bids(date="2020-01-02")}
    jb = make_bidder("jax", "monotone", MONOTONE)
    prices = jb._forecast("2020-01-02", 0, T_DA)
    out["monotone"] = {"res": _res_fields(jb._scenario_solve(jb.day_ahead_model, prices)[1]),
                       "bids": jb.compute_day_ahead_bids(date="2020-01-02")}
    return out


def _recorded(case):
    """One recipe's JAX outputs from the record: the result's fields as
    attributes, the bids keyed by hour again."""
    rec = torch_records.read(BIDDER_RECORD)[case]
    if "res" in rec:
        rec["res"] = type("JRes", (), rec["res"])
    if "bids" in rec:
        rec["bids"] = {int(t): v for t, v in rec["bids"].items()}
    return rec


@pytest.mark.slow
def test_bidder_jax_record_is_current():
    assert torch_records.matches(BIDDER_RECORD, jax_record())


def test_self_schedule_non_anticipativity_matches_jax():
    scenarios = NON_ANTICIPATIVITY
    tb = make_bidder("torch", "first_stage", scenarios)
    want = _recorded("non_anticipativity")
    prices = tb._forecast("2020-01-02", 0, T_DA)
    powers, res = tb._scenario_solve(tb.day_ahead_model, prices)
    assert bool(res.converged)
    e = tb.day_ahead_model.stacked.first_stage(res.x)
    for s in range(3):
        np.testing.assert_allclose(powers[s], e, atol=1e-3)
    j_powers, j_res = want["powers"], want["res"]
    assert_stacked_solves_match(tb, res, j_res)
    np.testing.assert_allclose(powers, j_powers, rtol=0, atol=BID_RTOL * 200.0)
    assert_bids_match(tb.compute_day_ahead_bids(date="2020-01-02"), want["bids"])


def test_self_schedule_optimality_single_scenario_matches_jax():
    price = SINGLE_PRICE
    tb = make_bidder("torch", "first_stage", price[None, :], n_scenario=1)
    bids = tb.compute_day_ahead_bids(date="2020-01-02")
    assert_bids_match(bids, _recorded("single_scenario")["bids"])
    sched = np.array([bids[t]["309_WIND_1"]["p_max"] for t in range(T_DA)])
    assert np.all(sched >= -1e-6) and np.all(sched <= 200.0 + 1e-6)
    blk = tb.day_ahead_model
    params = blk.stacked.default_params()
    params["p"]["energy_price"] = price[None, :]
    res = blk.solve(params)
    assert float(np.sum(price * sched)) >= float(res.obj) - 1e-6


def test_bidder_monotone_curves_match_jax():
    scenarios = MONOTONE
    tb = make_bidder("torch", "monotone", scenarios)
    prices = tb._forecast("2020-01-02", 0, T_DA)
    powers, res = tb._scenario_solve(tb.day_ahead_model, prices)
    assert bool(res.converged)
    assert_stacked_solves_match(tb, res, _recorded("monotone")["res"])
    for t in range(T_DA):
        order = np.argsort(prices[:, t])
        assert np.all(np.diff(powers[order, t]) >= -1e-3), f"hour {t}"
    bids = tb.compute_day_ahead_bids(date="2020-01-02")
    assert_bids_match(bids, _recorded("monotone")["bids"])
    for t in range(T_DA):
        curve = bids[t]["309_WIND_1"]["p_cost"]
        pows, costs = [p for p, _ in curve], [c for _, c in curve]
        assert all(np.diff(pows) > 0) and all(np.diff(costs) >= -1e-9)
        marg = np.diff(costs) / np.diff(pows)
        assert all(np.diff(marg) >= -1e-6), f"non-convex at hour {t}"
        assert curve[-1][0] == pytest.approx(200.0)


# ---------------------------------------------------------------------------
# Tracker
# ---------------------------------------------------------------------------


SIGNALS = ([0.0, 1.5, 15.0, 24.5], [40.0, 60.0, 80.0, 80.0], [120.0, 10.0, 0.0, 5.0],
           [75.0, 75.0, 75.0, 75.0])


def _tracker(pkg):
    g, MP = (jgrid, JMP) if pkg == "jax" else (tgrid, TMP)
    cfs = 0.2 + 0.6 * np.random.default_rng(5).random(96)
    md = g.RenewableGeneratorModelData(gen_name="309_WIND_1", bus="Carter", p_min=0,
                                       p_max=200, p_cost=0)
    mp = MP(model_data=md, wind_capacity_factors=cfs, wind_pmax_mw=200,
            battery_pmax_mw=25, battery_energy_capacity_mwh=100)
    kw = {"device": "cpu"} if pkg == "torch" else {}
    return g.Tracker(tracking_model_object=mp, tracking_horizon=4, n_tracking_hour=1, **kw)


def test_tracker_rolls_four_hours_like_jax(tmp_path):
    t, j = _tracker("torch"), _tracker("jax")
    for h, sig in enumerate(SIGNALS):
        t.track_market_dispatch(sig, date="2020-01-02", hour=h)
        j.track_market_dispatch(sig, date="2020-01-02", hour=h)
        assert int(t.res.iterations) == int(j.res.iterations) and int(t.res.status) == 0
        assert _rel(float(t.res.obj), float(j.res.obj)) <= TRACK_RTOL
        for a, b in zip(t.power_output, np.asarray(j.power_output)):
            assert _rel(a, b) <= TRACK_RTOL, (h, t.power_output, j.power_output)
        for k, v in j.implemented_stats[-1].items():
            assert _rel(float(t.implemented_stats[-1][k][0]), float(v[0])) <= TRACK_RTOL, k
        # the realized state rolled into the next solve's fixed values
        fs_t, fs_j = t.model.m.fs, j.model.m.fs
        for name in ("battery.initial_state_of_charge", "battery.initial_energy_throughput"):
            assert float(fs_t.var_specs[name].fixed_value) == float(fs_j.var_specs[name].fixed_value)
        np.testing.assert_array_equal(fs_t.params["windpower.capacity_factor"],
                                      np.asarray(fs_j.params["windpower.capacity_factor"]))
        assert _rel(t.get_last_delivered_power(), j.get_last_delivered_power()) <= TRACK_RTOL
    assert t._solve._graft_counter.count == 1
    t.write_results(tmp_path / "t.csv")
    j.write_results(tmp_path / "j.csv")
    assert (tmp_path / "t.csv").read_text().splitlines()[0] == \
        (tmp_path / "j.csv").read_text().splitlines()[0]


# ---------------------------------------------------------------------------
# tests/test_double_loop.py's coordinator and backcaster cases on the port
# ---------------------------------------------------------------------------

_SRC = (Path(__file__).resolve().parent / "test_double_loop.py").read_text()
_SRC = _SRC.replace("dispatches_tpu.", "dispatches_tpu_torch.")
_NS: dict = {}
exec(compile(_SRC, "test_double_loop.py (on dispatches_tpu_torch)", "exec"), _NS)
for _name, _fn in list(_NS.items()):
    if _name.startswith(("test_coordinator_", "test_backcaster_")) and callable(_fn):
        globals()[f"{_name}_on_the_port"] = _fn
del _name, _fn


def test_double_loop_cases_collected():
    assert len([k for k in globals() if k.endswith("_on_the_port")]) >= 4


# ---------------------------------------------------------------------------
# the day batch and the unported mesh
# ---------------------------------------------------------------------------


def _sequential_day_bids(bidder, dates):
    """``compute_day_ahead_bids`` for each date on the capacity-factor
    window ``batch_day_params`` gives that day (i implemented days on)."""
    blk, mo = bidder.day_ahead_model, bidder.bidding_model_object
    fs = blk.m.fs
    out = {}
    for i, d in enumerate(dates):
        fs.params["windpower.capacity_factor"] = mo._cf_window(blk._time_idx + 24 * i, blk.horizon)
        out[d] = bidder.compute_day_ahead_bids(date=d)
    fs.params["windpower.capacity_factor"] = mo._cf_window(blk._time_idx, blk.horizon)
    return out


@pytest.mark.parametrize("kind", ["first_stage", "monotone"])
def test_day_batch_equals_sequential_bids(kind):
    dates = ["2020-01-02", "2020-01-03", "2020-01-04"]
    bidder = make_bidder("torch", kind)
    batch = bidder.compute_day_ahead_bids_batch(dates)
    seq = _sequential_day_bids(bidder, dates)
    assert list(batch) == dates
    for d in dates:
        assert_bids_match(batch[d], seq[d])
    # the three days are different programs (their wind windows differ)
    key = "p_max" if kind == "first_stage" else "p_cost"
    assert batch[dates[0]][3]["309_WIND_1"][key] != batch[dates[1]][3]["309_WIND_1"][key]
    counter = bidder.day_ahead_model._batch_solvers[(3, ("windpower.capacity_factor",))]
    assert counter._graft_counter.label == "bidder.batch_solve[D=3]"


def test_day_batch_rejects_an_override_matching_no_key():
    bidder = make_bidder("torch", "first_stage")
    bidder.bidding_model_object.batch_day_params = lambda blk, n: {"nowhere.cf": np.zeros((n, T_DA))}
    with pytest.raises(ValueError, match="match no"):
        bidder.compute_day_ahead_bids_batch(["2020-01-02", "2020-01-03"])


MESH_RTOL = 1e-9


def _assert_bids_close(got, want, rtol):
    for d in want:
        for t in want[d]:
            for k, wv in want[d][t]["309_WIND_1"].items():
                gv = got[d][t]["309_WIND_1"][k]
                if k == "p_cost":
                    for (gp, gc), (wp, wc) in zip(gv, wv):
                        assert _rel(gp, wp) <= rtol and _rel(gc, wc) <= rtol, (d, t)
                else:
                    assert _rel(float(gv), float(wv)) <= rtol, (d, t, k)


def test_mesh_raises_naming_item_7():
    """The day axis over a mesh (each entry solves its own days, gathered
    in day order) equals the mesh-free day batch within 1e-9 relative."""
    from dispatches_tpu_torch.parallel import scenario_mesh

    dates = ["2020-01-02", "2020-01-03", "2020-01-04"]
    bidder = make_bidder("torch", "first_stage")
    want = bidder.compute_day_ahead_bids_batch(dates)
    got = bidder.compute_day_ahead_bids_batch(dates, mesh=scenario_mesh(3, device="cpu"))
    assert list(got) == dates
    _assert_bids_close(got, want, MESH_RTOL)
    tracker = _tracker("torch")
    coord = tgrid.DoubleLoopCoordinator(bidder, tracker, tracker)
    coord.prefetch_da_bids(dates[:2], mesh=scenario_mesh(2, device="cpu"))
    assert sorted(coord._da_prefetch) == dates[:2]
    # the IPM's lanes do not interact, so the first two days of the
    # 3-day batch are the 2-day batch's
    _assert_bids_close({d: coord._da_prefetch[d] for d in dates[:2]},
                       {d: want[d] for d in dates[:2]}, MESH_RTOL)


def test_grid_exports_match_jax():
    assert tgrid.__all__ == jgrid.__all__


def test_coordinator_prefetch_serves_the_day_batch():
    """``simulate(da_bid_window > 1)``'s hook without a mesh: the
    coordinator asks the bidder for the window's days in one batch and
    hands each day's bids out once, recording them as the sequential path
    does (the batch itself is held by test_day_batch_equals_sequential_bids)."""
    calls, recorded = [], []
    bids = {d: {0: {"G": {"p_max": float(i)}}} for i, d in enumerate(["d1", "d2"])}

    class Bidder:
        forecaster = object()
        bidding_model_object = type("M", (), {"model_data": type("D", (), {"gen_name": "G"})})

        def compute_day_ahead_bids_batch(self, dates, mesh=None):
            calls.append((list(dates), mesh))
            return {d: bids[d] for d in dates}

        def compute_day_ahead_bids(self, date):
            raise AssertionError("a prefetched day was solved again")

        def record_bids(self, b, date, hour, market):
            recorded.append((date, market))

    class Tracker:
        n_tracking_hour = 1

    coord = tgrid.DoubleLoopCoordinator(Bidder(), Tracker(), Tracker())
    coord.prefetch_da_bids(["d1", "d2"])
    assert calls == [(["d1", "d2"], None)]
    assert coord.request_da_bids("d1") == bids["d1"] and coord.request_da_bids("d2") == bids["d2"]
    assert coord._da_prefetch == {} and recorded == [("d1", "Day-ahead"), ("d2", "Day-ahead")]
