"""Deadline-aware batch forming: the admission models (a copy of
``dispatches_tpu/serve/admission.py``).

* :class:`ServiceTimeEstimate` — per-bucket service time: a streaming
  p95 (P² estimator, ``obs.online.P2Quantile``) of the observed
  dispatch → fence window on the service clock.  The JAX package seeds
  it before the first sample with a cost-card prior; cost cards
  (``obs.profile``) are not ported, so here the estimate is None until
  the first dispatch completes.
* :class:`ArrivalEstimate` — per-bucket EWMA of the inter-arrival gap.

The policy itself lives in ``serve.service`` next to the queues it reads.
"""

from __future__ import annotations

from typing import Optional

from dispatches_tpu_torch.obs.online import P2Quantile

__all__ = ["ServiceTimeEstimate", "ArrivalEstimate"]


class ServiceTimeEstimate:
    """How long one dispatched batch of this bucket takes to complete.

    ``observe_ms`` feeds the measured dispatch→fence window; before any
    sample the estimate is None ("no estimate", i.e. the fixed-wait
    policy)."""

    def __init__(self, label: str):
        self.label = label
        self._p95 = P2Quantile(0.95)
        self.samples = 0

    def observe_ms(self, ms: float) -> None:
        if ms >= 0.0:
            self._p95.observe(float(ms))
            self.samples += 1

    def p95_ms(self) -> Optional[float]:
        return self._p95.value()

    def estimate_ms(self) -> Optional[float]:
        """Current service-time estimate in ms: the measured p95, or
        None before any dispatch completed."""
        return self._p95.value()

    def estimate_s(self) -> Optional[float]:
        ms = self.estimate_ms()
        return None if ms is None else ms / 1e3


class ArrivalEstimate:
    """EWMA inter-arrival gap per bucket (service-clock seconds)."""

    def __init__(self, alpha: float = 0.25):
        self.alpha = float(alpha)
        self._last: Optional[float] = None
        self._gap: Optional[float] = None

    def observe(self, t: float) -> None:
        if self._last is not None:
            gap = max(t - self._last, 0.0)
            self._gap = (gap if self._gap is None
                         else self.alpha * gap
                         + (1.0 - self.alpha) * self._gap)
        self._last = t

    def gap_s(self) -> Optional[float]:
        """Expected gap to the next arrival; None before two
        arrivals."""
        return self._gap
