"""Tracker: dispatch-following re-solve of an operation model
(counterpart of ``dispatches_tpu/grid/tracker.py``).

Pin the operation model's power output to the market dispatch signal
(with penalized under/over-delivery slacks), minimize operating cost,
record the implemented profile, and roll the model forward.

The operation flowsheet is built ONCE; every rolling-horizon re-solve is
the same IPM with updated params (dispatch signal, capacity factors,
initial conditions).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import List, Optional, Sequence

import numpy as np
import torch

from dispatches_tpu_torch import resolve_device
from dispatches_tpu_torch.analysis.runtime import CountedProgram
from dispatches_tpu_torch.solvers.ipm import IPMOptions, make_ipm_solver


class Tracker:
    """``device``: where the tracking IPM runs (``cuda`` unless given)."""

    def __init__(
        self,
        tracking_model_object,
        tracking_horizon: int,
        n_tracking_hour: int = 1,
        solver=None,
        dispatch_penalty: float = 1000.0,
        max_iter: int = 300,
        device=None,
    ):
        self.device = resolve_device(device)
        self.tracking_model_object = tracking_model_object
        self.tracking_horizon = int(tracking_horizon)
        self.n_tracking_hour = int(n_tracking_hour)
        self.dispatch_penalty = float(dispatch_penalty)

        blk = SimpleNamespace()
        tracking_model_object.populate_model(blk, self.tracking_horizon)
        self.model = blk
        fs = blk.m.fs

        self._dispatch = fs.add_param(
            "market_dispatch", np.zeros(self.tracking_horizon)
        )
        # penalized deviation slacks (MW): P_T - dispatch = over - under
        fs.add_var("track_under", lb=0, scale=10.0)
        fs.add_var("track_over", lb=0, scale=10.0)
        fs.add_eq(
            "track_balance",
            lambda v, p: blk.power_output_expr(v, p)
            - p["market_dispatch"]
            - v["track_over"]
            + v["track_under"],
        )

        def objective(v, p):
            cost = torch.sum(blk.total_cost_expr(v, p))
            dev = torch.sum(v["track_under"] + v["track_over"])
            return cost + self.dispatch_penalty * dev

        self.nlp = fs.compile(objective=objective, sense="min")
        self._solver = make_ipm_solver(self.nlp, IPMOptions(max_iter=max_iter),
                                       device=self.device)
        self._solve = CountedProgram(
            self._solver, label=f"tracker.solve[h={self.tracking_horizon}]")

        self.power_output: Optional[np.ndarray] = None
        self.sol: Optional[dict] = None
        self.implemented_stats: List[dict] = []
        self.daily_stats: List[np.ndarray] = []

    # ------------------------------------------------------------------

    def track_market_dispatch(self, market_dispatch: Sequence[float],
                              date=None, hour=None) -> None:
        fs = self.model.m.fs
        dispatch = np.zeros(self.tracking_horizon)
        md = np.asarray(market_dispatch, dtype=float)
        dispatch[: len(md)] = md[: self.tracking_horizon]
        # default_params() reads fs.params afresh: the next solve sees it
        fs.params["market_dispatch"] = dispatch

        res = self._solve(self.nlp.default_params())
        self.res = res
        self.sol = self.nlp.unravel(res.x)
        self.power_output = np.asarray(
            self.model.power_output_values(self.sol)
        )
        self.tracking_model_object.record_results(
            self.model, self.sol, date=date, hour=hour
        )

        # implement the first n_tracking_hour steps and roll forward
        last = self.n_tracking_hour - 1
        profile = self.tracking_model_object.get_implemented_profile(
            self.model, self.sol, last
        )
        self.implemented_stats.append(profile)
        self.tracking_model_object.update_model(self.model, **profile)

    def get_last_delivered_power(self) -> float:
        return self.tracking_model_object.get_last_delivered_power(
            self.model, self.sol, self.n_tracking_hour - 1
        )

    def write_results(self, path) -> None:
        self.tracking_model_object.write_results(path)
