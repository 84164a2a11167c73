"""The port's fossil double-loop participant
(``case_studies/fossil/multiperiod_double_loop.py``) on the CPU.

* The three stub-block cases of ``tests/test_usc_double_loop.py`` on the
  port: protocol properties, carried-state updates and the profile
  readers, result recording.
* ``write_results`` of the port and of JAX on the same stub give equal
  frames; so do the self-scheduler's bid records.
* Slow: ``test_usc_bid_and_track_solves`` on the port (a DA bid at
  horizon 2 and one tracking hour at [400, 410], maxiter 25), with the
  blocks seeded at ``storage_multiperiod.FEASIBLE_DECISIONS`` (the
  default decisions have no inner solution).
* The 5-bus co-simulation skips as JAX's does: its data is not mounted.
* The device rule of ``MultiPeriodUsc``.
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu.case_studies.fossil import multiperiod_double_loop as jdl  # noqa: E402
from dispatches_tpu.grid.model_data import ThermalGeneratorModelData as JThermal  # noqa: E402

from dispatches_tpu_torch.case_studies.fossil import multiperiod_double_loop as tdl  # noqa: E402
from dispatches_tpu_torch.case_studies.fossil import storage_multiperiod as smp  # noqa: E402
from dispatches_tpu_torch.case_studies.fossil.multiperiod_double_loop import (  # noqa: E402
    PREVIOUS_POWER_INIT,
    TANK_MIN,
    MultiPeriodUsc,
    UscSelfScheduler,
    UscTracker,
)
from dispatches_tpu_torch.grid.model_data import ThermalGeneratorModelData  # noqa: E402


CPU = "cpu"
DATA = Path(__file__).parent / "data"
INIT = DATA / "integrated_storage_usc_init"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one intra-op thread, as the other test_torch_* modules."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def usc_model_data(cls=ThermalGeneratorModelData):
    return cls(
        gen_name="1_USC", bus="1", p_min=284.0, p_max=436.0,
        min_down_time=4, min_up_time=8, ramp_up_60min=60.0, ramp_down_60min=60.0,
        shutdown_capacity=300.0, startup_capacity=300.0,
        production_cost_bid_pairs=[(284.0, 22.1), (350.0, 23.5), (436.0, 25.0)],
    )


def _stub_blk(horizon=4):
    """A solved-looking block without the physics."""
    blk = SimpleNamespace()
    blk.horizon = horizon
    net = np.linspace(390.0, 420.0, horizon)
    blk.sol = {"net_power": net[:, None], "plant_power_out": (net - 10.0)[:, None]}
    blk.out = {
        "hot_tank_level": TANK_MIN + 3600.0 * np.arange(horizon) * 5.0,
        "hxc_duty": np.full(horizon, 150.0),
        "hxd_duty": np.full(horizon, 20.0),
    }
    blk.power_output_values = lambda sol: np.asarray(sol["net_power"][:, 0])
    blk.usc_mp = SimpleNamespace(previous_power=PREVIOUS_POWER_INIT,
                                 initial_hot_inventory=TANK_MIN)
    return blk


def test_protocol_properties():
    mp = MultiPeriodUsc(usc_model_data(), device=CPU)
    assert mp.power_output == "P_T"
    assert mp.total_cost == ("tot_cost", 1)
    assert mp.pmin == 284.0
    assert mp.model_data.generator_type == "thermal"
    assert (tdl.TANK_MIN, tdl.TANK_MAX, tdl.PREVIOUS_POWER_INIT) == (
        jdl.TANK_MIN, jdl.TANK_MAX, jdl.PREVIOUS_POWER_INIT)


def test_update_model_and_profiles():
    mp = MultiPeriodUsc(usc_model_data(), device=CPU)
    blk = _stub_blk(horizon=4)
    assert mp.get_last_delivered_power(blk, blk.sol, 0) == pytest.approx(390.0)
    profile = mp.get_implemented_profile(blk, blk.sol, 0)
    assert len(profile["implemented_power_output"]) == 1
    assert profile["realized_soc"][0] == pytest.approx(TANK_MIN)
    mp.update_model(blk, **profile)
    assert blk.usc_mp.previous_power == pytest.approx(390.0)
    assert blk.usc_mp.initial_hot_inventory == pytest.approx(TANK_MIN)


def test_record_and_write_results(tmp_path):
    mp = MultiPeriodUsc(usc_model_data(), device=CPU)
    blk = _stub_blk(horizon=3)
    mp.record_results(blk, date="2020-07-10", hour=5)
    out = tmp_path / "usc_results.csv"
    mp.write_results(out)
    df = pd.read_csv(out)
    assert len(df) == 3
    assert {"Generator", "Total Power Output [MW]", "Hot Tank Level [kg]"} <= set(df.columns)
    assert df["Generator"].unique().tolist() == ["1_USC"]
    assert df["Total Power Output [MW]"].iloc[0] == pytest.approx(390.0)


def test_write_results_equal_jax(tmp_path):
    frames = {}
    for tag, cls, md_cls in (("port", tdl.MultiPeriodUsc, ThermalGeneratorModelData),
                             ("jax", jdl.MultiPeriodUsc, JThermal)):
        kw = {"device": CPU} if tag == "port" else {}
        mp = cls(usc_model_data(md_cls), **kw)
        for hour, h in ((5, 3), (6, 4)):
            mp.record_results(_stub_blk(horizon=h), date="2020-07-10", hour=hour, Extra=hour)
        mp.write_results(tmp_path / f"{tag}.csv")
        empty = cls(usc_model_data(md_cls), **kw)
        empty.write_results(tmp_path / f"{tag}_empty.csv")
        frames[tag] = (pd.read_csv(tmp_path / f"{tag}.csv"),
                       (tmp_path / f"{tag}_empty.csv").read_text())
    pd.testing.assert_frame_equal(frames["port"][0], frames["jax"][0])
    assert len(frames["port"][0]) == 7
    assert frames["port"][1] == frames["jax"][1]


def test_bid_records_equal_jax(tmp_path):
    """``record_bids``/``write_results`` of the self-scheduler on the same
    bids (built without the physics: ``__new__`` and the record fields)."""
    bids = {t: {"1_USC": {"p_max": 400.0 + t, "p_min": 284.0}} for t in range(3)}
    texts = {}
    for tag, cls in (("port", UscSelfScheduler), ("jax", jdl.UscSelfScheduler)):
        s = cls.__new__(cls)
        s.generator, s.bids_result_list = "1_USC", []
        s.record_bids(bids, date="2020-07-10", hour=0)
        s.record_bids(bids, date="2020-07-10", hour=1, market="Real-time")
        s.write_results(tmp_path / f"{tag}.csv")
        texts[tag] = (tmp_path / f"{tag}.csv").read_text()
    assert texts["port"] == texts["jax"]
    assert len(pd.read_csv(tmp_path / "port.csv")) == 6


def _seed_feasible(blk):
    """Seed a populated block at the feasible decisions."""
    blk._U = smp.feasible_U(blk.usc_mp.brs, blk.horizon)


@pytest.mark.slow  # two 2-hour reduced-space solves of the 792-state plant, maxiter 25
def test_usc_bid_and_track_solves():
    from dispatches_tpu_torch.grid.forecaster import Backcaster

    md = usc_model_data()
    hist = list(22.0 + 3.0 * np.random.default_rng(0).random(24))
    bidder = UscSelfScheduler(
        bidding_model_object=MultiPeriodUsc(md, maxiter=25, load_from_file=INIT, device=CPU),
        day_ahead_horizon=2, real_time_horizon=2, n_scenario=1,
        forecaster=Backcaster({md.bus: hist}, {md.bus: list(hist)}))
    _seed_feasible(bidder.day_ahead_model)
    bids = bidder.compute_day_ahead_bids(date="2020-07-10")
    sched = [bids[t][md.gen_name]["p_max"] for t in range(2)]
    assert all(md.p_min - 1e-6 <= p <= md.p_max + 30.0 + 1e-6 for p in sched)

    tracker = UscTracker(MultiPeriodUsc(md, maxiter=25, load_from_file=INIT, device=CPU),
                         tracking_horizon=2)
    _seed_feasible(tracker.model)
    tracker.track_market_dispatch([400.0, 410.0], date="2020-07-10", hour=0)
    p0 = tracker.get_last_delivered_power()
    assert np.isfinite(p0) and md.p_min - 1e-6 <= p0 <= md.p_max + 30.0
    assert tracker.model.usc_mp.previous_power == pytest.approx(round(p0))


def test_usc_participant_cosim_data_not_mounted():
    from dispatches_tpu_torch.case_studies.renewables.load_parameters import data_dir

    if data_dir() is None or not (data_dir() / "prescient_5bus").is_dir():
        pytest.skip("5-bus dataset not mounted")


@pytest.mark.skipif(torch.cuda.is_available(), reason="the CPU-only rule")
def test_device_rule():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiPeriodUsc(usc_model_data())
