"""Price forecasters for the bidding loop (counterpart of
``dispatches_tpu/grid/forecaster.py``, a copy: the module is numpy
only).

Forecasts are scenario sets sampled from a rolling pool of historical
daily price profiles.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


class Backcaster:
    """Backcasting forecaster: the last ``max_historical_days`` daily
    price profiles ARE the scenarios (most recent first), tiled to the
    requested horizon."""

    def __init__(
        self,
        historical_da_prices: Dict[str, Sequence[float]],
        historical_rt_prices: Dict[str, Sequence[float]],
        max_historical_days: int = 10,
    ):
        for name, data in (("DA", historical_da_prices), ("RT", historical_rt_prices)):
            for bus, prices in data.items():
                if len(prices) < 24:
                    raise ValueError(
                        f"{name} history for bus {bus!r} needs >= 24 hours"
                    )
        self._da = {k: list(v) for k, v in historical_da_prices.items()}
        self._rt = {k: list(v) for k, v in historical_rt_prices.items()}
        self.max_historical_days = int(max_historical_days)

    # -- internal ------------------------------------------------------

    @staticmethod
    def _day_profiles(prices: List[float]) -> np.ndarray:
        n_days = len(prices) // 24
        return np.asarray(prices[: n_days * 24]).reshape(n_days, 24)

    def _forecast(self, pool: List[float], horizon: int, n: int) -> np.ndarray:
        days = self._day_profiles(pool)[::-1]  # most recent first
        reps = int(np.ceil(n / len(days)))
        days = np.tile(days, (reps, 1))[:n]
        h_reps = int(np.ceil(horizon / 24))
        return np.tile(days, (1, h_reps))[:, :horizon]

    # -- public API (mirrors the consumed surface) ---------------------

    def forecast_day_ahead_prices(self, date, hour, bus, horizon, n_samples):
        return self._forecast(self._da[bus], horizon, n_samples)

    def forecast_real_time_prices(self, date, hour, bus, horizon, n_samples):
        return self._forecast(self._rt[bus], horizon, n_samples)

    def forecast_day_ahead_and_real_time_prices(
        self, date, hour, bus, horizon, n_samples
    ):
        return (
            self.forecast_day_ahead_prices(date, hour, bus, horizon, n_samples),
            self.forecast_real_time_prices(date, hour, bus, horizon, n_samples),
        )

    def fetch_hourly_stats_from_prescient(self, prescient_hourly_stats):
        """Append realized prices from a market-simulation step to the
        historical pools (the double-loop feedback path)."""
        for bus, price in prescient_hourly_stats.items():
            if bus in self._rt:
                self._rt[bus].append(price)
                cap = self.max_historical_days * 24
                if len(self._rt[bus]) > cap:
                    self._rt[bus] = self._rt[bus][-cap:]

    def record_day_ahead_price(self, bus, prices_24h):
        self._da[bus].extend(prices_24h)
        cap = self.max_historical_days * 24
        if len(self._da[bus]) > cap:
            self._da[bus] = self._da[bus][-cap:]


class PerfectForecaster:
    """Oracle forecaster over known price series (useful for tests and
    price-taker studies)."""

    def __init__(self, da_prices: Dict[str, Sequence[float]],
                 rt_prices: Dict[str, Sequence[float]]):
        self._da = {k: np.asarray(v) for k, v in da_prices.items()}
        self._rt = {k: np.asarray(v) for k, v in rt_prices.items()}

    def _slice(self, arr, hour, horizon, n):
        out = arr[hour: hour + horizon]
        if len(out) < horizon:
            out = np.pad(out, (0, horizon - len(out)), mode="edge")
        return np.tile(out[None, :], (n, 1))

    def forecast_day_ahead_prices(self, date, hour, bus, horizon, n_samples):
        return self._slice(self._da[bus], hour, horizon, n_samples)

    def forecast_real_time_prices(self, date, hour, bus, horizon, n_samples):
        return self._slice(self._rt[bus], hour, horizon, n_samples)
