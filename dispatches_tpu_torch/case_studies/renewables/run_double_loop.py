"""Double-loop co-simulation entry script (counterpart of
``dispatches_tpu/case_studies/renewables/run_double_loop.py``).

CLI options, Thermal/Renewable generator model data, a Backcaster seeded
from historical DA/RT prices, Bidder or SelfScheduler participation
modes, tracking + projection Trackers, the DoubleLoopCoordinator, and
the market simulation — with the port's MarketSimulator over an
RTS-GMLC-format dataset.  Every IPM runs on ``--device`` (``cuda``
unless ``cpu`` is passed; without a card it raises).

Usage:
    python -m dispatches_tpu_torch.case_studies.renewables.run_double_loop \
        --data_path /path/to/rts_gmlc_or_5bus --sim_id 0 \
        --wind_pmax 120 --battery_pmax 15 --num_days 2 [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from dispatches_tpu_torch import resolve_device
from dispatches_tpu_torch.core.config import ConfigError, config, config_field

from dispatches_tpu_torch.case_studies.renewables.wind_battery_double_loop import (
    MultiPeriodWindBattery,
)
from dispatches_tpu_torch.grid import (
    Backcaster,
    Bidder,
    RenewableGeneratorModelData,
    SelfScheduler,
    ThermalGeneratorModelData,
    Tracker,
)
from dispatches_tpu_torch.grid.coordinator import DoubleLoopCoordinator
from dispatches_tpu_torch.grid.market import MarketSimulator, load_rts_gmlc_case


@config
class DoubleLoopOptions:
    """The script's options and the market options it forwards, as one
    validated config tier."""

    data_path: str = config_field(
        "", doc="RTS-GMLC-format dataset directory", required=True)
    sim_id: int = config_field(0, bounds=(0, None), doc="simulation index")
    wind_generator: str = config_field(
        "4_WIND", doc="participant generator name in the dataset")
    wind_pmax: float = config_field(
        120.0, bounds=(0.0, None), doc="wind capacity MW")
    battery_energy_capacity: float = config_field(
        60.0, bounds=(0.0, None), doc="battery energy MWh")
    battery_pmax: float = config_field(
        15.0, bounds=(0.0, None), doc="battery power MW")
    n_scenario: int = config_field(
        3, bounds=(1, None), doc="bidding price scenarios")
    participation_mode: str = config_field(
        "Bid", choices=("Bid", "SelfSchedule"),
        doc="market participation mode")
    reserve_factor: float = config_field(0.0, bounds=(0.0, 1.0),
                                         doc="market reserve factor")
    start_date: str = config_field("2020-07-10", doc="simulation start")
    num_days: int = config_field(2, bounds=(1, None),
                                 doc="days to simulate")
    day_ahead_horizon: int = config_field(
        48, bounds=(24, None), doc="bidder DA horizon (reference "
        "run_double_loop.py:228 uses 48)")
    real_time_horizon: int = config_field(
        4, bounds=(1, None), doc="bidder RT horizon (reference :229)")
    tracking_horizon: int = config_field(
        4, bounds=(1, None), doc="tracker horizon (reference :264-297)")
    output_dir: Optional[str] = config_field(
        None, doc="results directory (default sim_<id>_results)")
    device: str = config_field(
        "cuda", choices=("cuda", "cpu"),
        doc="where the bidder, tracker and market IPMs run (cuda raises "
        "without a card)")

    def __post_init__(self):
        if self.real_time_horizon > self.day_ahead_horizon:
            raise ConfigError(
                "real_time_horizon cannot exceed day_ahead_horizon")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    DoubleLoopOptions.add_cli_args(p)
    return p


def run_double_loop(options) -> dict:
    if isinstance(options, argparse.Namespace):
        options = DoubleLoopOptions.from_cli(options)  # validates, incl.
        # the required data_path
    device = resolve_device(options.device)
    case = load_rts_gmlc_case(options.data_path)
    gen = options.wind_generator
    wind_pmax = options.wind_pmax
    battery_pmax = options.battery_pmax

    # capacity factors for the participant from the dataset's own RT
    # series (reference: precompiled Prescient outputs, :116-120)
    ren = {r.name: r for r in case.renewables}
    if gen in ren:
        cfs = np.asarray(ren[gen].rt_cap) / max(ren[gen].rt_cap.max(), 1e-9)
        bus = ren[gen].bus
    else:
        rng = np.random.default_rng(options.sim_id)
        cfs = 0.3 + 0.4 * rng.random(case.n_hours)
        bus = case.buses[0]

    if options.participation_mode == "Bid":
        model_data = ThermalGeneratorModelData(
            gen_name=gen,
            bus=bus,
            p_min=0.0,
            p_max=wind_pmax,
            min_down_time=0,
            min_up_time=0,
            ramp_up_60min=wind_pmax + battery_pmax,
            ramp_down_60min=wind_pmax + battery_pmax,
            shutdown_capacity=wind_pmax + battery_pmax,
            startup_capacity=0.0,
            production_cost_bid_pairs=[(0.0, 0.0), (wind_pmax, 0.0)],
            startup_cost_pairs=[(0.0, 0.0)],
        )
        bidder_cls = Bidder
    else:
        model_data = RenewableGeneratorModelData(
            gen_name=gen, bus=bus, p_min=0.0, p_max=wind_pmax, p_cost=0.0
        )
        bidder_cls = SelfScheduler

    def make_mp():
        return MultiPeriodWindBattery(
            model_data=model_data,
            wind_capacity_factors=cfs,
            wind_pmax_mw=wind_pmax,
            battery_pmax_mw=battery_pmax,
            battery_energy_capacity_mwh=options.battery_energy_capacity,
        )

    # historical price seed (reference hardcodes 24h of Carter-bus
    # prices, :168-239; here: a flat-ish seed the backcaster updates
    # from realized LMPs as the simulation runs)
    rng = np.random.default_rng(42 + options.sim_id)
    hist = list(20.0 + 5.0 * rng.random(24))
    backcaster = Backcaster({bus: hist}, {bus: list(hist)})

    bidder = bidder_cls(
        bidding_model_object=make_mp(),
        day_ahead_horizon=options.day_ahead_horizon,
        real_time_horizon=options.real_time_horizon,
        n_scenario=options.n_scenario,
        forecaster=backcaster,
        device=device,
    )
    tracker = Tracker(tracking_model_object=make_mp(),
                      tracking_horizon=options.tracking_horizon,
                      device=device)
    projection_tracker = Tracker(
        tracking_model_object=make_mp(),
        tracking_horizon=options.tracking_horizon,
        device=device,
    )
    coordinator = DoubleLoopCoordinator(bidder, tracker, projection_tracker)

    output_dir = options.output_dir or f"sim_{options.sim_id}_results"
    sim = MarketSimulator(
        case,
        output_dir=output_dir,
        sced_horizon=options.real_time_horizon,
        ruc_horizon=options.day_ahead_horizon,
        reserve_factor=options.reserve_factor,
        coordinator=coordinator,
        device=device,
    )
    return sim.simulate(
        start_date=options.start_date, num_days=options.num_days
    )


def main(argv=None):
    options = build_parser().parse_args(argv)
    out = run_double_loop(options)
    print(
        f"double loop complete: total cost {out['total_cost']:,.0f}; "
        f"outputs in {out['output_dir']}"
    )
    return out


if __name__ == "__main__":
    main()
