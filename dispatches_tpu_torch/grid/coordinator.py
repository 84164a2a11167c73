"""DoubleLoopCoordinator: wires a bidder + trackers into the market
co-simulation (counterpart of ``dispatches_tpu/grid/coordinator.py``).

Method hooks the ``MarketSimulator`` calls at each market cycle — DA bids
before the RUC, RT bids before each SCED, tracking after each dispatch,
and static generator parameters pushed into the market's generator model
(``update_static_params`` with the marginal-to-actual cost-curve
conversion for thermal participants).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from dispatches_tpu_torch.obs import trace as obs_trace


def convert_marginal_costs_to_actual_costs(bid_pairs):
    """[(power, marginal $/MWh)...] -> [(power, cumulative $)] (the
    idaes helper consumed at reference ``run_double_loop.py:19-29``)."""
    out = []
    cost = 0.0
    prev = None
    for p, mc in bid_pairs:
        if prev is not None:
            cost += mc * (p - prev)
        out.append((p, cost))
        prev = p
    return out


class DoubleLoopCoordinator:
    def __init__(self, bidder, tracker, projection_tracker):
        self.bidder = bidder
        self.tracker = tracker
        self.projection_tracker = projection_tracker
        self._hour_in_day = 0
        # each push_rt_dispatch implements n_tracking_hour hours; the
        # day-boundary model update below consumes whole 24-h days, so
        # a non-divisor stride would smear day boundaries across pushes
        n_hr = int(getattr(tracker, "n_tracking_hour", 1))
        if n_hr < 1 or 24 % n_hr != 0:
            raise ValueError(
                f"tracker.n_tracking_hour={n_hr} must divide 24: the "
                "coordinator advances bidder models in whole-day "
                "(24 h) increments of implemented profiles"
            )
        self._pushes_per_day = 24 // n_hr

    # -- identity ------------------------------------------------------

    @property
    def generator_name(self) -> str:
        return self.bidder.bidding_model_object.model_data.gen_name

    def generator_bus(self, case) -> Optional[str]:
        """Resolve the participant's bus id in the market case (the
        model_data carries a bus NAME; RTS gen names prefix the id)."""
        md = self.bidder.bidding_model_object.model_data
        gen = md.gen_name
        prefix = gen.split("_")[0]
        if prefix in case.buses:
            return prefix
        return case.buses[0]

    # -- static params (reference :46-87) ------------------------------

    def update_static_params(self, gen_dict: Dict) -> None:
        """Overlay the participant's model_data onto the market's
        generator record (called by MarketSimulator at construction —
        the role of the reference coordinator's extra RUC/SCED
        callbacks).  Thermal marginal-cost bid pairs become a piecewise
        cumulative cost curve under ``p_cost``."""
        md = self.bidder.bidding_model_object.model_data
        for param, value in md.to_dict().items():
            if param == "gen_name" or value is None:
                continue
            if (param == "production_cost_bid_pairs"
                    and md.generator_type == "thermal"):
                gen_dict["p_cost"] = {
                    "data_type": "cost_curve",
                    "cost_curve_type": "piecewise",
                    "values": convert_marginal_costs_to_actual_costs(value),
                }
            else:
                gen_dict[param] = value

    # -- market-cycle hooks -------------------------------------------

    def prefetch_da_bids(self, dates, mesh=None) -> None:
        """Day-parallel DA bidding: solve the bid programs for a whole
        window of ``dates`` as one device batch, to be consumed by
        ``request_da_bids`` day by day.  Realized state still re-syncs
        sequentially through ``push_rt_dispatch``/``update_*_model`` at
        window boundaries.  ``mesh`` splits the day axis over a device
        mesh (``compute_day_ahead_bids_batch``)."""
        fc = self.bidder.forecaster
        if hasattr(fc, "record_day_ahead_price") or hasattr(
            fc, "fetch_hourly_stats_from_prescient"
        ):
            import warnings

            warnings.warn(
                "day-parallel DA bidding with a history-recording "
                "forecaster: days after the first use window-start "
                "price history, so bids can differ from the sequential "
                "loop (state-neutral preconditions in "
                "MarketSimulator.simulate's docstring)",
                stacklevel=2,
            )
        batch = self.bidder.compute_day_ahead_bids_batch(list(dates),
                                                         mesh=mesh)
        self._da_prefetch = dict(batch)

    def request_da_bids(self, date):
        pre = getattr(self, "_da_prefetch", None)
        with obs_trace.span("bid.da", date=date,
                            prefetched=bool(pre and date in pre)):
            if pre and date in pre:
                bids = pre.pop(date)
            else:
                bids = self.bidder.compute_day_ahead_bids(date=date)
            self.bidder.record_bids(bids, date, 0, market="Day-ahead")
        return bids

    def request_rt_bids(self, date, hour, da_lmp=None):
        with obs_trace.span("bid.rt", date=date, hour=hour):
            bids = self.bidder.compute_real_time_bids(
                date, hour, realized_day_ahead_prices=da_lmp
            )
            self.bidder.record_bids(bids, date, hour, market="Real-time")
        return bids

    def push_da_results(self, date, da_lmp, da_dispatch, bus_lmps):
        """Record realized DA prices into the forecaster's history and
        warm the projection tracker on the DA schedule."""
        bus = self.bidder.bidding_model_object.model_data.bus
        fc = self.bidder.forecaster
        if hasattr(fc, "record_day_ahead_price"):
            lmps = bus_lmps.get(bus)
            if lmps is None and bus_lmps:
                lmps = next(iter(bus_lmps.values()))
            fc.record_day_ahead_price(bus, list(np.asarray(lmps)[:24]))
        h = self.projection_tracker.tracking_horizon
        self.projection_tracker.track_market_dispatch(
            np.asarray(da_dispatch)[:h], date=date, hour=0
        )

    def push_rt_dispatch(self, date, hour, dispatch_mw, bus_lmps):
        """Track the cleared real-time dispatch; feed realized prices
        back to the forecaster (reference coordinator's hourly stats
        callback)."""
        with obs_trace.span("track.rt", date=date, hour=hour):
            return self._push_rt_dispatch(date, hour, dispatch_mw, bus_lmps)

    def _push_rt_dispatch(self, date, hour, dispatch_mw, bus_lmps):
        h = self.tracker.tracking_horizon
        signal = np.full(h, float(dispatch_mw))
        self.tracker.track_market_dispatch(signal, date=date, hour=hour)
        fc = self.bidder.forecaster
        if hasattr(fc, "fetch_hourly_stats_from_prescient"):
            bus = self.bidder.bidding_model_object.model_data.bus
            price = bus_lmps.get(bus)
            if price is None and bus_lmps:
                price = next(iter(bus_lmps.values()))
            fc.fetch_hourly_stats_from_prescient({bus: float(price)})
        # advance the bidder's operating models with the implemented
        # profiles every 24 implemented hours.  The whole day's hourly
        # profiles are concatenated: update_model advances the CF
        # window by the realized profile LENGTH, so passing only the
        # last tracked hour would roll the window 1 h/day instead of
        # 24 (a drift the day-parallel parity test caught — the batched
        # path's per-day windows exposed the sequential lag)
        self._hour_in_day += int(getattr(self.tracker, "n_tracking_hour", 1))
        if self._hour_in_day >= 24 and self.tracker.implemented_stats:
            self._hour_in_day = 0
            # each implemented_stats entry covers n_tracking_hour hours,
            # so one day is the last pushes_per_day ENTRIES (slicing 24
            # entries would reach n_tracking_hour days back)
            day = self.tracker.implemented_stats[-self._pushes_per_day:]
            profile = {k: [x for pr in day for x in pr[k]] for k in day[0]}
            self.bidder.update_day_ahead_model(**profile)
            self.bidder.update_real_time_model(**profile)
        return self.tracker.get_last_delivered_power()

    # -- results -------------------------------------------------------

    def write_results(self, path):
        from pathlib import Path

        path = Path(path)
        self.bidder.write_results(path / "bidder_detail.csv")
        self.tracker.write_results(path / "tracker_detail.csv")
        self.projection_tracker.write_results(
            path / "tracking_model_detail.csv"
        )
