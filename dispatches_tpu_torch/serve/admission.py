"""Deadline- and cost-card-aware batch forming: the admission models
(counterpart of ``dispatches_tpu/serve/admission.py``).

* :class:`ServiceTimeEstimate` — per-bucket service time: a streaming
  p95 (P² estimator, ``obs.online.P2Quantile``) of the observed
  dispatch → fence window on the service clock, seeded before the first
  sample by a cost-card roofline prior — ``flops / peak_flops +
  bytes_accessed / peak_bw`` from the bucket's newest card
  (``obs.profile.cards_for``), nominal peaks by card backend.  The port's
  cards carry ``flops`` (matmul-family, a lower bound) and no
  ``bytes_accessed``.
* :class:`ArrivalEstimate` — per-bucket EWMA of the inter-arrival gap.

The policy itself lives in ``serve.service`` next to the queues it reads.
"""

from __future__ import annotations

from typing import Dict, Optional

from dispatches_tpu_torch.obs.online import P2Quantile

__all__ = ["ServiceTimeEstimate", "ArrivalEstimate"]

#: nominal device peaks for the cost-card prior, keyed by the card's
#: ``backend``; replaced by the measured p95 after the first observed
#: dispatch.  ``gpu`` is an NVIDIA H100 SXM at its 700 W limit: 67
#: TFLOP/s float32 (non-tensor-core) and 3.35 TB/s of HBM3, the data
#: sheet's figures.
_NOMINAL_PEAKS: Dict[str, tuple] = {
    # backend: (flops/s, bytes/s)
    "cpu": (5e10, 1e10),
    "gpu": (67e12, 3.35e12),
}
_DEFAULT_PEAKS = _NOMINAL_PEAKS["cpu"]


class ServiceTimeEstimate:
    """How long one dispatched batch of this bucket takes to complete.

    ``observe_ms`` feeds the measured dispatch→fence window; before any
    sample the estimate falls back to the cost-card prior (None when
    profiling is off or no card matches — callers treat None as "no
    estimate", i.e. the fixed-wait policy)."""

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

    def _card_prior_ms(self) -> Optional[float]:
        from dispatches_tpu_torch.obs import profile

        if not profile.enabled():
            return None
        cards = profile.cards_for(f"serve.{self.label}")
        if not cards:
            return None
        card = cards[-1]
        flops = float(card.get("flops") or 0.0)
        nbytes = float(card.get("bytes_accessed") or 0.0)
        if flops <= 0.0 and nbytes <= 0.0:
            return None
        peak_flops, peak_bw = _NOMINAL_PEAKS.get(
            str(card.get("backend", "")).lower(), _DEFAULT_PEAKS)
        return (flops / peak_flops + nbytes / peak_bw) * 1e3

    def estimate_ms(self) -> Optional[float]:
        """Current service-time estimate in ms: measured p95 when any
        dispatch completed, else the cost-card prior, else None."""
        p95 = self._p95.value()
        if p95 is not None:
            return p95
        return self._card_prior_ms()

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
