"""Streaming telemetry analytics: O(1) quantiles, burn-rate alerting,
drift detection, and the incremental pipeline-timeline accumulator
(counterpart of ``dispatches_tpu/obs/online.py``, with the same names and
the same arithmetic, so each result equals the JAX package's bitwise on
the same stream).

* :class:`P2Quantile` / :class:`StreamingQuantiles` — the P² algorithm
  (Jain & Chlamtac 1985): five markers per quantile, O(1) memory and
  update, no sample retention.
* :class:`BurnRateMonitor` — multi-window multi-burn-rate alerting over
  SLO objectives: a rule fires only when BOTH its fast and slow windows
  burn error budget above the threshold, with rising-edge emission.
* :class:`DriftDetector` — two-sample Kolmogorov-Smirnov statistic of a
  sliding current window against a frozen head-of-stream reference.
* :class:`TimelineAccumulator` — the incremental counterpart of
  ``timeline.build_timeline``: ingests ``plan.stage`` / ``plan.submit``
  / ``plan.fence`` spans as they retire (via ``trace.add_sink``) and
  keeps the overlap-efficiency + fence/host-stage/queue stall split,
  published as live ``plan.online.*`` gauges — what
  ``plan.adaptive.InflightDepthController`` reads.

Host-side and stdlib-only (no torch, no numpy): these run on the serving
hot path's completion callbacks.
"""

from __future__ import annotations

import heapq
import threading
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "interp_quantile",
    "P2Quantile",
    "StreamingQuantiles",
    "TimeWindow",
    "BurnRateRule",
    "DEFAULT_BURN_RULES",
    "BurnRateMonitor",
    "monitors_from_spec",
    "DriftDetector",
    "ks_statistic",
    "TimelineAccumulator",
]


# ---------------------------------------------------------------------------
# P² streaming quantiles
# ---------------------------------------------------------------------------


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


class StreamingQuantiles:
    """A small bundle of P² estimators plus count/mean/min/max — the
    streaming counterpart of a registry Histogram ``summary()``."""

    DEFAULT_PS = (0.5, 0.95, 0.99)

    def __init__(self, ps: Sequence[float] = DEFAULT_PS):
        self._est = {p: P2Quantile(p) for p in ps}
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def observe(self, x: float) -> None:
        x = float(x)
        self._count += 1
        self._sum += x
        self._min = x if self._min is None else min(self._min, x)
        self._max = x if self._max is None else max(self._max, x)
        for est in self._est.values():
            est.observe(x)

    @property
    def count(self) -> int:
        return self._count

    def quantile(self, p: float) -> Optional[float]:
        return self._est[p].value()

    def summary(self) -> Dict[str, Optional[float]]:
        out: Dict[str, Optional[float]] = {
            "count": self._count,
            "mean": (self._sum / self._count) if self._count else None,
            "min": self._min,
            "max": self._max,
        }
        for p, est in sorted(self._est.items()):
            out[f"p{round(p * 100):d}"] = est.value()
        return out


# ---------------------------------------------------------------------------
# sliding time windows + burn-rate alerting
# ---------------------------------------------------------------------------


class TimeWindow:
    """Samples ``(t, value)`` retained for ``horizon_s`` behind the
    newest ``now`` handed in — the bounded-memory window a burn monitor
    reads quantiles/means from."""

    __slots__ = ("horizon_s", "_buf")

    def __init__(self, horizon_s: float):
        self.horizon_s = float(horizon_s)
        self._buf: Deque[Tuple[float, float]] = deque()

    def observe(self, t: float, value: float) -> None:
        self._buf.append((float(t), float(value)))
        self._prune(t)

    def _prune(self, now: float) -> None:
        cut = now - self.horizon_s
        buf = self._buf
        while buf and buf[0][0] < cut:
            buf.popleft()

    def count(self, now: float) -> int:
        self._prune(now)
        return len(self._buf)

    def mean(self, now: float) -> Optional[float]:
        self._prune(now)
        if not self._buf:
            return None
        return sum(v for _, v in self._buf) / len(self._buf)

    def quantile(self, p: float, now: float) -> Optional[float]:
        self._prune(now)
        if not self._buf:
            return None
        return interp_quantile(sorted(v for _, v in self._buf), p)


@dataclass(frozen=True)
class BurnRateRule:
    """One fast/slow window pair: fire when BOTH windows burn budget
    faster than ``threshold`` (burn 1.0 = exactly on target)."""

    fast_s: float
    slow_s: float
    threshold: float


#: the canonical SRE page/ticket pairs (5m/1h at 14.4x, 30m/6h at 6x) —
#: soak specs swap in pairs scaled to their virtual duration
DEFAULT_BURN_RULES = (
    BurnRateRule(fast_s=300.0, slow_s=3600.0, threshold=14.4),
    BurnRateRule(fast_s=1800.0, slow_s=21600.0, threshold=6.0),
)

_P_FRACTIONS = {"p50": 0.5, "p95": 0.95, "p99": 0.99}


class BurnRateMonitor:
    """Multi-window multi-burn-rate alerting for ONE SLO objective.

    ``kind="quantile"``: feed raw measurements (ms); the window value is
    the ``p`` quantile.  ``kind="ratio"``: feed 1.0 for a bad event and
    0.0 for a good one; the window value is the bad fraction.  Burn is
    ``window_value / target`` — ``obs.slo``'s error-budget reading,
    computed per window.  ``update(now)`` re-evaluates at most every
    ``check_interval_s`` and returns alert dicts for rules that just
    crossed into firing (rising edge); a rule re-arms only after both
    its windows drop back to the threshold."""

    def __init__(self, name: str, *, kind: str, target: float,
                 p: str = "p99",
                 rules: Sequence[BurnRateRule] = DEFAULT_BURN_RULES,
                 metric: Optional[str] = None,
                 check_interval_s: float = 1.0):
        if kind not in ("quantile", "ratio"):
            raise ValueError(f"unknown burn monitor kind {kind!r}")
        if kind == "quantile" and p not in (*_P_FRACTIONS, "mean"):
            raise ValueError(f"unknown quantile {p!r}")
        if target <= 0:
            raise ValueError("target must be positive")
        self.name = name
        self.kind = kind
        self.target = float(target)
        self.p = p
        self.metric = metric          # feed-routing hint for the soak
        self.rules = tuple(rules)
        self.check_interval_s = float(check_interval_s)
        self.burn_peak = 0.0          # max burn seen on any window
        self._windows = {h: TimeWindow(h)
                         for h in {r.fast_s for r in self.rules}
                         | {r.slow_s for r in self.rules}}
        self._firing = {r: False for r in self.rules}
        self._last_check: Optional[float] = None

    def observe(self, t: float, value: float) -> None:
        for w in self._windows.values():
            w.observe(t, value)

    @property
    def firing(self) -> bool:
        """True while any rule is in its firing state (as of the last
        ``update``) — the load-shedding hook: wire this into
        ``SolveService.shed_signal`` to shed under sustained burn."""
        return any(self._firing.values())

    def burn(self, now: float, horizon_s: float) -> Optional[float]:
        w = self._windows[horizon_s]
        if self.kind == "ratio" or self.p == "mean":
            v = w.mean(now)
        else:
            v = w.quantile(_P_FRACTIONS[self.p], now)
        if v is None:
            return None
        return v / self.target

    def update(self, now: float) -> List[Dict]:
        if (self._last_check is not None
                and now - self._last_check < self.check_interval_s):
            return []
        self._last_check = now
        alerts: List[Dict] = []
        for rule in self.rules:
            bf = self.burn(now, rule.fast_s)
            bs = self.burn(now, rule.slow_s)
            for b in (bf, bs):
                if b is not None:
                    self.burn_peak = max(self.burn_peak, b)
            active = (bf is not None and bs is not None
                      and bf > rule.threshold and bs > rule.threshold)
            if active and not self._firing[rule]:
                alerts.append({
                    "t": now,
                    "objective": self.name,
                    "fast_s": rule.fast_s,
                    "slow_s": rule.slow_s,
                    "threshold": rule.threshold,
                    "burn_fast": round(bf, 4),
                    "burn_slow": round(bs, 4),
                })
            self._firing[rule] = active
        return alerts

    def state(self, now: float) -> Dict:
        """Current per-rule burns + firing flags (for the soak report)."""
        rules = []
        for rule in self.rules:
            bf = self.burn(now, rule.fast_s)
            bs = self.burn(now, rule.slow_s)
            rules.append({
                "fast_s": rule.fast_s,
                "slow_s": rule.slow_s,
                "threshold": rule.threshold,
                "burn_fast": None if bf is None else round(bf, 4),
                "burn_slow": None if bs is None else round(bs, 4),
                "firing": self._firing[rule],
            })
        return {"objective": self.name, "kind": self.kind,
                "target": self.target,
                "burn_peak": round(self.burn_peak, 4), "rules": rules}


def monitors_from_spec(spec, *,
                       rules: Sequence[BurnRateRule] = DEFAULT_BURN_RULES,
                       check_interval_s: float = 1.0
                       ) -> List[BurnRateMonitor]:
    """One :class:`BurnRateMonitor` per objective of an
    ``obs.slo.SLOSpec``.  Quantile objectives carry their histogram
    family name in ``monitor.metric``; ratio objectives carry the
    numerator family — the soak's feed routing keys on it."""
    out: List[BurnRateMonitor] = []
    for o in spec.objectives:
        if o.kind == "quantile":
            out.append(BurnRateMonitor(
                o.name, kind="quantile", target=o.target, p=o.p,
                rules=rules, metric=o.metric,
                check_interval_s=check_interval_s))
        else:
            out.append(BurnRateMonitor(
                o.name, kind="ratio", target=o.target, rules=rules,
                metric=(o.num or {}).get("metric"),
                check_interval_s=check_interval_s))
    return out


# ---------------------------------------------------------------------------
# distribution drift
# ---------------------------------------------------------------------------


def ks_statistic(a: Sequence[float], b: Sequence[float]) -> float:
    """Two-sample Kolmogorov-Smirnov statistic (sup distance between
    empirical CDFs)."""
    xs = sorted(float(v) for v in a)
    ys = sorted(float(v) for v in b)
    na, nb = len(xs), len(ys)
    i = j = 0
    d = 0.0
    while i < na and j < nb:
        # advance past ALL ties of the smaller value on both sides
        # before measuring: tied observations step both CDFs together
        v = xs[i] if xs[i] <= ys[j] else ys[j]
        while i < na and xs[i] == v:
            i += 1
        while j < nb and ys[j] == v:
            j += 1
        d = max(d, abs(i / na - j / nb))
    return d


class DriftDetector:
    """KS drift of a sliding current window against a frozen reference.

    The first ``reference`` observations freeze as the head-of-stream
    baseline; later observations fill a sliding window of ``window``
    samples.  ``result()`` reports the KS statistic between the two and
    a ``drifted`` verdict once both sides hold ``min_samples``."""

    def __init__(self, *, reference: int = 256, window: int = 256,
                 threshold: float = 0.35, min_samples: int = 32):
        self.threshold = float(threshold)
        self.min_samples = int(min_samples)
        self._ref_size = int(reference)
        self._ref: List[float] = []
        self._cur: Deque[float] = deque(maxlen=int(window))

    def observe(self, x: float) -> None:
        if len(self._ref) < self._ref_size:
            self._ref.append(float(x))
        else:
            self._cur.append(float(x))

    def statistic(self) -> Optional[float]:
        if (len(self._ref) < self.min_samples
                or len(self._cur) < self.min_samples):
            return None
        return ks_statistic(self._ref, self._cur)

    def result(self) -> Dict:
        ks = self.statistic()
        return {
            "n_ref": len(self._ref),
            "n_cur": len(self._cur),
            "ks": None if ks is None else round(ks, 4),
            "threshold": self.threshold,
            "drifted": bool(ks is not None and ks > self.threshold),
        }


# ---------------------------------------------------------------------------
# incremental pipeline timeline
# ---------------------------------------------------------------------------

# edge kinds in the sweep: host (stage/submit union), inflight, and
# wire (client-side net.rpc spans — zero-depth idle under one is
# network-starved, not demand-starved)
_HOST, _INFLIGHT, _WIRE = 0, 1, 2


class TimelineAccumulator:
    """Streaming ``build_timeline``: same overlap-efficiency and
    fence/host-stage/queue stall attribution, computed from plan
    lifecycle spans AS THEY RETIRE instead of from a post-hoc trace
    scan.

    Subscribe via ``trace.add_sink(acc.ingest)`` (or feed events by
    hand).  The sweep is event-driven: every span contributes interval
    edges to a heap keyed ``(t, step, kind)`` — the same
    ``(-1)-before-(+1)`` tie order as ``build_timeline``'s sort — and
    each ingest advances a watermark to the event's end, accumulating
    host/hidden/zero-depth measure per segment.  For a
    serially-dispatched pipeline (one host thread, the plan's own
    emission order) every later edge lands at or after the watermark,
    so the online figures equal the post-hoc ones exactly (modulo
    zero-length segments at shared timestamps, which carry no measure).

    On every fence the headline figures publish as live gauges —
    ``plan.online.overlap_efficiency`` / ``.occupancy_mean`` /
    ``.stall_pct`` / ``.stall_us{kind=...}`` / ``.n_batches``, labeled
    by plan id — which ``export.render_prometheus`` then scrapes; the
    adaptive in-flight depth item consumes exactly these.

    ``plan=None`` locks onto the first plan id seen; events from other
    plans are ignored."""

    SPAN_NAMES = ("plan.stage", "plan.submit", "plan.fence")

    def __init__(self, plan: Optional[int] = None, *, gauges: bool = True,
                 registry=None):
        self.plan = plan
        self._gauges = gauges
        self._registry = registry
        # ingest is a trace sink, and spans retire concurrently: the
        # plan emits plan.submit outside its window lock (so parallel
        # submitters don't serialize on telemetry), which makes this
        # accumulator's heap + counters multi-writer.  One short
        # host-side lock keeps the sweep consistent.
        self._lock = threading.Lock()
        self._edges: List[Tuple[float, int, int]] = []  # (t, step, kind)
        self._depth_h = 0
        self._depth_i = 0
        self._depth_w = 0
        self._prev: Optional[float] = None
        self._t_lo: Optional[float] = None
        self._t_hi: Optional[float] = None
        self.n_batches = 0
        self._host_us = 0.0
        self._hidden_us = 0.0
        self._fence_bound_us = 0.0
        self._zero_host_us = 0.0    # depth_i == 0 under a host span
        self._zero_wire_us = 0.0    # depth_i == 0, host idle, RPC on wire
        self._zero_empty_us = 0.0   # depth_i == 0, host + wire idle
        self._occupancy: Dict[int, float] = {}
        self._cells = None

    # -- ingest ------------------------------------------------------------

    def ingest(self, event: Dict) -> None:
        """Consume one trace event (Chrome-shaped dict); non-plan
        events and foreign plan ids are ignored, so this is safe as a
        blanket ``trace.add_sink`` — including from concurrently
        retiring spans (thread-safe)."""
        if event.get("ph") != "X":
            return
        name = event.get("name")
        if name == "net.rpc":
            # wire spans carry no plan id; they only refine zero-depth
            # idle into wire_bound vs queue_empty, so they contribute
            # edges without moving the watermark or the wall window
            with self._lock:
                ts = float(event["ts"])
                end = ts + float(event.get("dur", 0.0))
                heapq.heappush(self._edges, (ts, +1, _WIRE))
                heapq.heappush(self._edges, (end, -1, _WIRE))
            return
        if name not in self.SPAN_NAMES:
            return
        args = event.get("args") or {}
        pid = args.get("plan")
        if pid is None:
            return
        with self._lock:
            if self.plan is None:
                self.plan = pid
            elif pid != self.plan:
                return
            ts = float(event["ts"])
            end = ts + float(event.get("dur", 0.0))
            if name == "plan.fence":
                self._fence_bound_us += end - ts
                heapq.heappush(self._edges, (end, -1, _INFLIGHT))
            else:
                # t_lo matches build_timeline: stage/submit starts only
                if self._t_lo is None or ts < self._t_lo:
                    self._t_lo = ts
                heapq.heappush(self._edges, (ts, +1, _HOST))
                heapq.heappush(self._edges, (end, -1, _HOST))
                if name == "plan.submit":
                    self.n_batches += 1
                    heapq.heappush(self._edges, (end, +1, _INFLIGHT))
            if self._t_hi is None or end > self._t_hi:
                self._t_hi = end
            self._advance(end)
            publish = name == "plan.fence" and self._gauges
        if publish:
            self._publish()

    def _advance(self, watermark: float) -> None:
        edges = self._edges
        while edges and edges[0][0] <= watermark:
            t, step, kind = heapq.heappop(edges)
            if self._prev is None:
                self._prev = t
            dt = t - self._prev
            if dt > 0.0:
                self._accumulate(dt)
                self._prev = t
            if kind == _HOST:
                self._depth_h += step
            elif kind == _INFLIGHT:
                self._depth_i += step
            else:
                self._depth_w += step

    def _accumulate(self, dt: float) -> None:
        occ = self._occupancy
        di = self._depth_i
        occ[di] = occ.get(di, 0.0) + dt
        if self._depth_h > 0:
            self._host_us += dt
            if di > 0:
                self._hidden_us += dt
        if di == 0:
            if self._depth_h > 0:
                self._zero_host_us += dt
            elif self._depth_w > 0:
                self._zero_wire_us += dt
            else:
                self._zero_empty_us += dt

    # -- results -----------------------------------------------------------

    def stalls(self) -> Dict[str, float]:
        """Raw stall-attribution counters in microseconds (un-rounded,
        monotone) — the adaptive in-flight depth controller diffs these
        between decisions."""
        return {"fence_bound_us": self._fence_bound_us,
                "host_stage_bound_us": self._zero_host_us,
                "wire_bound_us": self._zero_wire_us,
                "queue_empty_us": self._zero_empty_us}

    def _figures(self) -> Dict:
        wall = max((self._t_hi or 0.0) - (self._t_lo or 0.0), 0.0)
        eff = (self._hidden_us / self._host_us) if self._host_us > 0 else 0.0
        occ_mean = (sum(d * us for d, us in self._occupancy.items()) / wall
                    if wall > 0 else 0.0)
        stall = (self._fence_bound_us + self._zero_host_us
                 + self._zero_wire_us + self._zero_empty_us)
        stall_pct = (100.0 * stall / wall) if wall > 0 else 0.0
        return {"wall": wall, "eff": eff, "occ_mean": occ_mean,
                "stall_pct": stall_pct}

    def result(self) -> Optional[Dict]:
        """Current timeline figures, keyed and rounded exactly like
        ``build_timeline`` (minus the per-batch list); open in-flight
        batches extend to the newest event end, same as the post-hoc
        convention.  None before any batch was submitted."""
        if self.n_batches == 0:
            return None
        f = self._figures()
        wall = f["wall"]
        return {
            "plan": self.plan,
            "n_batches": self.n_batches,
            "wall_us": round(wall, 1),
            "host_us": round(self._host_us, 1),
            "hidden_host_us": round(self._hidden_us, 1),
            "overlap_efficiency": round(f["eff"], 4),
            "occupancy": {d: round(us / wall, 4) if wall > 0 else 0.0
                          for d, us in sorted(self._occupancy.items())},
            "occupancy_mean": round(f["occ_mean"], 3),
            "stall": {
                "fence_bound_us": round(self._fence_bound_us, 1),
                "host_stage_bound_us": round(self._zero_host_us, 1),
                "wire_bound_us": round(self._zero_wire_us, 1),
                "queue_empty_us": round(self._zero_empty_us, 1),
                "stall_pct": round(f["stall_pct"], 2),
            },
        }

    # -- live gauges -------------------------------------------------------

    def _publish(self) -> None:
        if self._cells is None:
            if self._registry is None:
                from dispatches_tpu_torch.obs import registry as _registry

                self._registry = _registry.default_registry()
            reg = self._registry
            labels = {"plan": str(self.plan)}
            self._cells = {
                "eff": (reg.gauge(
                    "plan.online.overlap_efficiency",
                    "live overlap efficiency (incremental accumulator)"),
                    labels),
                "occ": (reg.gauge(
                    "plan.online.occupancy_mean",
                    "live mean in-flight depth"), labels),
                "stall_pct": (reg.gauge(
                    "plan.online.stall_pct",
                    "live stall percentage of wall time"), labels),
                "batches": (reg.gauge(
                    "plan.online.n_batches",
                    "batches ingested by the live accumulator"), labels),
                "stall_us": (reg.gauge(
                    "plan.online.stall_us",
                    "live stall attribution (us) by kind"), labels),
            }
        f = self._figures()
        cells = self._cells
        g, labels = cells["eff"]
        g.set(round(f["eff"], 4), **labels)
        g, labels = cells["occ"]
        g.set(round(f["occ_mean"], 3), **labels)
        g, labels = cells["stall_pct"]
        g.set(round(f["stall_pct"], 2), **labels)
        g, labels = cells["batches"]
        g.set(float(self.n_batches), **labels)
        g, labels = cells["stall_us"]
        g.set(round(self._fence_bound_us, 1), kind="fence_bound", **labels)
        g.set(round(self._zero_host_us, 1), kind="host_stage_bound",
              **labels)
        g.set(round(self._zero_wire_us, 1), kind="wire_bound", **labels)
        g.set(round(self._zero_empty_us, 1), kind="queue_empty", **labels)
