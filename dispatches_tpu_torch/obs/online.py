"""Streaming quantiles: the P² estimator (a copy of the part of
``dispatches_tpu/obs/online.py`` that the serve layer's admission models
use; the rest of that module — streaming summaries, burn-rate monitors,
drift tests, the online timeline — is not ported yet)."""

from __future__ import annotations

from typing import List, Optional, Sequence

__all__ = ["P2Quantile", "interp_quantile"]


def interp_quantile(xs: Sequence[float], p: float) -> float:
    """Linear-interpolation quantile of a SORTED sequence (numpy's
    default method, so streaming-vs-posthoc comparisons share the
    definition)."""
    n = len(xs)
    if n == 1:
        return xs[0]
    h = (n - 1) * p
    lo = int(h)
    if lo >= n - 1:
        return xs[-1]
    return xs[lo] + (h - lo) * (xs[lo + 1] - xs[lo])


class P2Quantile:
    """One quantile estimated with the P² algorithm: five markers whose
    heights track ``[min, p/2, p, (1+p)/2, max]``, adjusted per
    observation by a piecewise-parabolic update.  O(1) memory, no
    resort, ~1e-2 relative accuracy on smooth distributions."""

    __slots__ = ("p", "_q", "_n", "_np", "_dn", "_count")

    def __init__(self, p: float):
        if not 0.0 < p < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {p}")
        self.p = float(p)
        self._q: List[float] = []       # marker heights (first 5 raw)
        self._n = [0, 1, 2, 3, 4]       # marker positions (0-based)
        self._np: List[float] = []      # desired positions
        self._dn: List[float] = []      # desired-position increments
        self._count = 0

    def observe(self, x: float) -> None:
        x = float(x)
        self._count += 1
        if self._count <= 5:
            self._q.append(x)
            self._q.sort()
            if self._count == 5:
                p = self.p
                self._np = [0.0, 2 * p, 4 * p, 2 + 2 * p, 4.0]
                self._dn = [0.0, p / 2, p, (1 + p) / 2, 1.0]
            return
        q, n, np_ = self._q, self._n, self._np
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = 3
            for i in range(1, 5):
                if x < q[i]:
                    k = i - 1
                    break
        for i in range(k + 1, 5):
            n[i] += 1
        for i in range(5):
            np_[i] += self._dn[i]
        for i in (1, 2, 3):
            d = np_[i] - n[i]
            if ((d >= 1.0 and n[i + 1] - n[i] > 1)
                    or (d <= -1.0 and n[i - 1] - n[i] < -1)):
                d = 1 if d >= 1.0 else -1
                qp = self._parabolic(i, d)
                if not q[i - 1] < qp < q[i + 1]:
                    qp = self._linear(i, d)
                q[i] = qp
                n[i] += d

    def _parabolic(self, i: int, d: int) -> float:
        q, n = self._q, self._n
        return q[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (q[i + 1] - q[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (q[i] - q[i - 1]) / (n[i] - n[i - 1])
        )

    def _linear(self, i: int, d: int) -> float:
        q, n = self._q, self._n
        return q[i] + d * (q[i + d] - q[i]) / (n[i + d] - n[i])

    @property
    def count(self) -> int:
        return self._count

    def value(self) -> Optional[float]:
        """Current estimate (exact while fewer than 5 samples)."""
        if self._count == 0:
            return None
        if self._count < 5:
            return interp_quantile(sorted(self._q), self.p)
        return self._q[2]
