"""MultiPeriodUsc: the bidding/tracking protocol object of the
integrated USC + storage plant, and the reduced-space bidder and tracker
that drive it inside the market co-simulation (counterpart of
``dispatches_tpu/case_studies/fossil/multiperiod_double_loop.py``).

Counterpart of the reference's ``storage/multiperiod_double_loop_usc.py``:
``populate_model`` builds the multiperiod integrated-storage model with
the carried state pinned (initial hot inventory 76,000 kg, previous
power 380 MW), ``update_model`` advances the realized power and hot-tank
level, ``get_last_delivered_power`` and the implemented-profile readers,
``record_results``/``write_results`` and the ``power_output``/
``total_cost`` property protocol.

The operation model is one ``MultiPeriodUscModel`` whose hour-plants
solve along one lane axis; the hourly bidding and tracking re-solves
rebind its runtime parameters (LMP signal, dispatch target, carried
state).  The full-space USC NLP is too stiff for the generic
flowsheet-compiling ``grid.Bidder``/``grid.Tracker``, so this module
ships reduced-space equivalents, ``UscSelfScheduler`` and
``UscTracker``, with the surface ``grid.DoubleLoopCoordinator``
consumes.  ``MultiPeriodUsc(device=)`` picks the device of every model it
populates: ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence

import numpy as np

from dispatches_tpu_torch import resolve_device
from dispatches_tpu_torch.case_studies.fossil.storage_multiperiod import (
    MultiPeriodUscModel,
)

TANK_MIN = 76000.0        # kg (reference :95)
TANK_MAX = 6739292.0      # kg (:96)
PREVIOUS_POWER_INIT = 380.0  # MW (:109)


class MultiPeriodUsc:
    """The protocol object (reference class ``MultiPeriodUsc``,
    :68-403)."""

    def __init__(self, model_data, maxiter: int = 60,
                 load_from_file=None, device=None):
        self.device = resolve_device(device)
        self.model_data = model_data
        self.result_list: List = []
        self.result_listimp: List = []
        self._maxiter = int(maxiter)
        self._load_from_file = load_from_file

    # -- protocol ------------------------------------------------------

    def populate_model(self, blk, horizon: int) -> None:
        """Build the multiperiod integrated USC+TES operation model over
        ``horizon`` hours (reference :84-155)."""
        mp = MultiPeriodUscModel(
            n_time_points=horizon,
            pmin=self.model_data.p_min,
            pmax=self.model_data.p_max,
            periodic=False,
            previous_power=PREVIOUS_POWER_INIT,
            initial_hot_inventory=TANK_MIN,
            load_from_file=self._load_from_file,
            device=self.device,
        )
        blk.usc_mp = mp
        blk.horizon = horizon
        blk.sol = None
        blk.out = None
        blk._U = None
        blk._X = None

        def power_output_values(sol):
            return np.asarray(sol["net_power"][:, 0])

        blk.power_output_values = power_output_values

    def solve_block(self, blk, lmp=None, market_dispatch=None,
                    dispatch_penalty=None, maxiter: Optional[int] = None):
        """One rolling-horizon re-solve of the block's model, warm
        started from the previous hour's solution."""
        mp: MultiPeriodUscModel = blk.usc_mp
        out = mp.solve(
            U0=blk._U, X0=blk._X,
            lmp=lmp, market_dispatch=market_dispatch,
            dispatch_penalty=dispatch_penalty,
            # rebind the carried state advanced by update_model — the
            # runtime params would otherwise stay at their build-time
            # values
            previous_power=mp.previous_power,
            initial_hot_inventory=mp.initial_hot_inventory,
            maxiter=self._maxiter if maxiter is None else maxiter,
        )
        blk.out = out
        blk.sol = out["sol"]
        blk._U = out["res"].U
        blk._X = out["res"].X
        return out

    @staticmethod
    def update_model(blk, implemented_power_output, realized_soc) -> None:
        """Advance the carried state with the implemented profile
        (reference :158-181; ``realized_soc`` is the hot-tank level)."""
        mp: MultiPeriodUscModel = blk.usc_mp
        mp.previous_power = round(float(implemented_power_output[-1]))
        mp.initial_hot_inventory = round(float(realized_soc[-1]))

    @staticmethod
    def get_last_delivered_power(blk, sol, last_implemented_time_step: int):
        return float(
            blk.power_output_values(sol)[last_implemented_time_step])

    @staticmethod
    def get_implemented_profile(blk, sol, last_implemented_time_step: int):
        t = last_implemented_time_step + 1
        return {
            "implemented_power_output": list(
                np.asarray(sol["net_power"][:t, 0])),
            "realized_soc": list(np.asarray(blk.out["hot_tank_level"][:t])),
        }

    def record_results(self, blk, sol=None, date=None, hour=None, **kwargs):
        import pandas as pd

        sol = blk.sol if sol is None else sol
        out = blk.out
        rows = []
        for t in range(blk.horizon):
            rows.append({
                "Generator": self.model_data.gen_name,
                "Date": date,
                "Hour": hour,
                "Horizon [hr]": t,
                "Total Power Output [MW]": round(
                    float(sol["net_power"][t, 0]), 2),
                "Plant Power [MW]": round(
                    float(sol["plant_power_out"][t, 0]), 2),
                "Storage Power [MW]": round(
                    float(sol["net_power"][t, 0])
                    - float(sol["plant_power_out"][t, 0]), 2),
                "HXC Duty [MW]": round(float(out["hxc_duty"][t]), 2),
                "HXD Duty [MW]": round(float(out["hxd_duty"][t]), 2),
                "Hot Tank Level [kg]": round(
                    float(out["hot_tank_level"][t]), 1),
                **kwargs,
            })
        self.result_list.append(pd.DataFrame(rows))

    def write_results(self, path) -> None:
        import pandas as pd

        if self.result_list:
            pd.concat(self.result_list).to_csv(path, index=False)
        else:
            pd.DataFrame(columns=["Generator", "Date", "Hour"]).to_csv(
                path, index=False)

    @property
    def power_output(self):
        return "P_T"

    @property
    def total_cost(self):
        return ("tot_cost", 1)

    @property
    def pmin(self):
        return self.model_data.p_min


class UscSelfScheduler:
    """Self-scheduling bidder on the reduced-space USC model: solves the
    price-taker against the price forecast and offers the net-power
    profile as a self-schedule (the role the generic ``grid.SelfScheduler``
    plays for the RE participant)."""

    def __init__(self, bidding_model_object: MultiPeriodUsc,
                 day_ahead_horizon: int, real_time_horizon: int,
                 n_scenario: int = 1, forecaster=None):
        self.bidding_model_object = bidding_model_object
        self.day_ahead_horizon = int(day_ahead_horizon)
        self.real_time_horizon = int(real_time_horizon)
        self.n_scenario = int(n_scenario)
        self.forecaster = forecaster
        self.generator = bidding_model_object.model_data.gen_name
        self.bids_result_list: List = []

        self.day_ahead_model = SimpleNamespace()
        bidding_model_object.populate_model(
            self.day_ahead_model, self.day_ahead_horizon)
        self.real_time_model = SimpleNamespace()
        bidding_model_object.populate_model(
            self.real_time_model, self.real_time_horizon)

    def _forecast(self, date, hour, horizon):
        bus = self.bidding_model_object.model_data.bus
        return np.asarray(self.forecaster.forecast_day_ahead_prices(
            date, hour, bus, horizon, self.n_scenario))

    def _bids_from(self, blk, prices, horizon):
        """Solve against the MEAN price scenario (self-schedule mode)
        and offer the resulting net-power profile at p_max."""
        mean_prices = np.mean(prices, axis=0)
        out = self.bidding_model_object.solve_block(
            blk, lmp=mean_prices, dispatch_penalty=0.0,
            market_dispatch=np.zeros(horizon))
        powers = blk.power_output_values(blk.sol)
        md = self.bidding_model_object.model_data
        bids = {}
        for t in range(horizon):
            bids[t] = {self.generator: {
                "p_max": float(np.clip(powers[t], md.p_min, md.p_max)),
                "p_min": md.p_min,
            }}
        return bids

    def compute_day_ahead_bids(self, date, hour: int = 0) -> Dict:
        prices = self._forecast(date, hour, self.day_ahead_horizon)
        return self._bids_from(self.day_ahead_model, prices,
                               self.day_ahead_horizon)

    def compute_real_time_bids(self, date, hour,
                               realized_day_ahead_prices=None,
                               realized_day_ahead_dispatches=None) -> Dict:
        if realized_day_ahead_prices is not None:
            window = np.asarray(realized_day_ahead_prices)[
                hour:hour + self.real_time_horizon, 0]
            if len(window) < self.real_time_horizon:
                window = np.pad(window,
                                (0, self.real_time_horizon - len(window)),
                                mode="edge")
            prices = window[None, :]
        else:
            prices = self._forecast(date, hour, self.real_time_horizon)
        return self._bids_from(self.real_time_model, prices,
                               self.real_time_horizon)

    def update_day_ahead_model(self, **profiles):
        self.bidding_model_object.update_model(self.day_ahead_model,
                                               **profiles)

    def update_real_time_model(self, **profiles):
        self.bidding_model_object.update_model(self.real_time_model,
                                               **profiles)

    def record_bids(self, bids, date, hour, market="Day-ahead"):
        import pandas as pd

        rows = [
            {"Generator": self.generator, "Date": date, "Hour": hour,
             "Market": market, "HorizonHour": t,
             **{k: v for k, v in bids[t][self.generator].items()
                if not isinstance(v, list)}}
            for t in bids
        ]
        self.bids_result_list.append(pd.DataFrame(rows))

    def write_results(self, path):
        import pandas as pd

        if self.bids_result_list:
            pd.concat(self.bids_result_list).to_csv(path, index=False)
        else:
            pd.DataFrame(
                columns=["Generator", "Date", "Hour", "Market",
                         "HorizonHour"]).to_csv(path, index=False)


class UscTracker:
    """Dispatch-tracking re-solve on the reduced-space USC model (the
    role of ``grid.Tracker``): pin net power to the dispatch signal via
    the smooth penalized deviation term, implement the first hour, and
    roll the carried state forward."""

    def __init__(self, tracking_model_object: MultiPeriodUsc,
                 tracking_horizon: int, n_tracking_hour: int = 1,
                 dispatch_penalty: float = 1000.0):
        self.tracking_model_object = tracking_model_object
        self.tracking_horizon = int(tracking_horizon)
        self.n_tracking_hour = int(n_tracking_hour)
        self.dispatch_penalty = float(dispatch_penalty)

        self.model = SimpleNamespace()
        tracking_model_object.populate_model(self.model,
                                             self.tracking_horizon)
        self.sol = None
        self.power_output_vals: Optional[np.ndarray] = None
        self.implemented_stats: List[dict] = []

    def track_market_dispatch(self, market_dispatch: Sequence[float],
                              date=None, hour=None) -> None:
        dispatch = np.zeros(self.tracking_horizon)
        md = np.asarray(market_dispatch, dtype=float)
        dispatch[:len(md)] = md[:self.tracking_horizon]
        if len(md) < self.tracking_horizon:
            dispatch[len(md):] = md[-1] if len(md) else 0.0

        self.tracking_model_object.solve_block(
            self.model, lmp=np.zeros(self.tracking_horizon),
            market_dispatch=dispatch,
            dispatch_penalty=self.dispatch_penalty)
        self.sol = self.model.sol
        self.power_output_vals = np.asarray(
            self.model.power_output_values(self.sol))
        self.tracking_model_object.record_results(
            self.model, self.sol, date=date, hour=hour)

        last = self.n_tracking_hour - 1
        profile = self.tracking_model_object.get_implemented_profile(
            self.model, self.sol, last)
        self.implemented_stats.append(profile)
        self.tracking_model_object.update_model(self.model, **profile)

    def get_last_delivered_power(self) -> float:
        return self.tracking_model_object.get_last_delivered_power(
            self.model, self.sol, self.n_tracking_hour - 1)

    def write_results(self, path) -> None:
        self.tracking_model_object.write_results(path)
