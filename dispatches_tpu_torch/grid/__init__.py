"""Grid-integration layer of the port (counterpart of
``dispatches_tpu/grid``): generator model data, price forecasters, the
bidding/tracking protocol, Bidder / SelfScheduler / Tracker, the
double-loop coordinator and the RUC/SCED market co-simulator.

The operation model is built ONCE per horizon and every re-solve is a
call of the same float64 IPM with new params (capacity factors, initial
conditions, prices); the bidder's price scenarios are a vmap inside the
stacked program, and a batch of days is the IPM's lane axis.
"""

from dispatches_tpu_torch.grid.model_data import (
    RenewableGeneratorModelData,
    ThermalGeneratorModelData,
)
from dispatches_tpu_torch.grid.forecaster import Backcaster, PerfectForecaster
from dispatches_tpu_torch.grid.tracker import Tracker
from dispatches_tpu_torch.grid.bidder import Bidder, SelfScheduler
from dispatches_tpu_torch.grid.coordinator import (
    DoubleLoopCoordinator,
    convert_marginal_costs_to_actual_costs,
)
from dispatches_tpu_torch.grid.market import (
    MarketCase,
    MarketOptions,
    MarketSimulator,
    load_rts_gmlc_case,
    solve_unit_commitment,
)

__all__ = [
    "RenewableGeneratorModelData",
    "ThermalGeneratorModelData",
    "Backcaster",
    "PerfectForecaster",
    "Tracker",
    "Bidder",
    "SelfScheduler",
    "DoubleLoopCoordinator",
    "convert_marginal_costs_to_actual_costs",
    "MarketCase",
    "MarketOptions",
    "MarketSimulator",
    "load_rts_gmlc_case",
    "solve_unit_commitment",
]
