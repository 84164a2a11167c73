"""Service telemetry: per-bucket counters, latency quantiles, and the
``--stats`` text report.

A copy of ``dispatches_tpu/serve/metrics.py`` (pure Python).  The
instruments are the obs-layer ones (``obs.registry``):
:class:`LatencyWindow` is a sliding-window ``Histogram`` and
:class:`BucketStats` rides on a labeled ``Counter`` — both **instance-scoped**
(constructed directly, not through the process registry) so two
services never blend their ``--stats``.  The service mirrors its
aggregate events into the process-wide default registry separately;
:func:`format_stats` renders the metrics dict the way the reference's
solver logs render iteration tables — a fixed-width text block an
operator can tail, byte for byte the JAX package's (header included:
``tests/data/serve_stats_golden.txt`` is its contract).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from dispatches_tpu_torch.obs.registry import Counter, Histogram


class _BucketedWindow(Histogram):
    """Shared shape of the serve windows: one labeled series per bucket
    plus the unlabeled aggregate, with the serve layer's historical
    ``_ms``-suffixed summary keys (p95 added for the SLO layer)."""

    def __init__(self, name: str, help: str, maxlen: int):
        super().__init__(name, help, window=maxlen)
        with self._lock:
            self._w0 = self._window({})
        # bound per-bucket cells, resolved once (hot path: per request)
        self._cells: Dict[str, object] = {}

    def record(self, bucket_label: str, value_ms: float) -> None:
        cell = self._cells.get(bucket_label)
        if cell is None:
            cell = self._cells[bucket_label] = self.labeled(
                bucket=bucket_label)
        with self._lock:
            self._w0.observe(float(value_ms))
        cell.observe(value_ms)

    def summary_ms(self, **labels) -> Dict[str, float]:
        s = Histogram.summary(self, **labels)
        out = {"count": s["count"]}
        if "mean" in s:
            out["mean_ms"] = s["mean"]
            out["p50_ms"] = s["p50"]
            out["p95_ms"] = s["p95"]
            out["p99_ms"] = s["p99"]
        return out


class LatencyWindow(_BucketedWindow):
    """Sliding window of end-to-end request latencies (submit→result,
    ms), per bucket and aggregate."""

    def __init__(self, maxlen: int = 4096):
        super().__init__("serve.latency_ms", "per-request solve latency",
                         maxlen)

    @property
    def count(self) -> int:  # was a plain attribute pre-rebase
        return Histogram.count(self)

    @property
    def total_ms(self) -> float:
        return Histogram.total(self)

    def summary(self) -> Dict[str, float]:
        return self.summary_ms()


class QueueWaitWindow(_BucketedWindow):
    """Sliding window of queue waits (submit→dispatch, ms), per bucket
    and aggregate.  Distinct from :class:`LatencyWindow`
    (submit→result): the gap between the two is solve time."""

    def __init__(self, maxlen: int = 4096):
        super().__init__("serve.queue_wait_ms",
                         "request queue wait (submit -> dispatch)",
                         maxlen)


class BucketStats:
    """Counters for one shape bucket (Counter-backed, label ``event=``)."""

    def __init__(self, label: str):
        self.label = label
        self._events = Counter(f"serve.bucket[{label}]",
                               "per-bucket request/batch events")
        # bound per-event cells: the submit/solve path is per-request,
        # so skip the label formatting Counter.inc would redo each call
        self._cells = {event: self._events.labeled(event=event)
                       for event in ("submitted", "solved", "timeout",
                                     "error", "shed",
                                     "batch", "live", "lanes")}
        self.lane_counts: List[int] = []  # distinct padded widths seen

    def _count(self, event: str) -> int:
        return int(self._cells[event].value())

    def record_submitted(self) -> None:
        self._cells["submitted"].inc()

    def record_solved(self) -> None:
        self._cells["solved"].inc()

    def record_timeout(self) -> None:
        self._cells["timeout"].inc()

    def record_error(self) -> None:
        self._cells["error"].inc()

    def record_shed(self) -> None:
        self._cells["shed"].inc()

    def record_batch(self, n_live: int, lanes: int) -> None:
        self._cells["batch"].inc()
        self._cells["live"].inc(n_live)
        self._cells["lanes"].inc(lanes)
        if lanes not in self.lane_counts:
            self.lane_counts.append(lanes)

    @property
    def submitted(self) -> int:
        return self._count("submitted")

    @property
    def solved(self) -> int:
        return self._count("solved")

    @property
    def timeouts(self) -> int:
        return self._count("timeout")

    @property
    def errors(self) -> int:
        return self._count("error")

    @property
    def shed(self) -> int:
        return self._count("shed")

    @property
    def batches(self) -> int:
        return self._count("batch")

    @property
    def live_dispatched(self) -> int:
        """Real (unpadded) requests dispatched."""
        return self._count("live")

    @property
    def lanes_dispatched(self) -> int:
        """Padded lanes summed over batches."""
        return self._count("lanes")

    @property
    def occupancy(self) -> Optional[float]:
        if not self.lanes_dispatched:
            return None
        return self.live_dispatched / self.lanes_dispatched

    def as_dict(self, compiles: int) -> Dict:
        return {
            "submitted": self.submitted,
            "solved": self.solved,
            "timeouts": self.timeouts,
            "errors": self.errors,
            "shed": self.shed,
            "batches": self.batches,
            "lane_counts": sorted(self.lane_counts),
            "occupancy": (round(self.occupancy, 4)
                          if self.occupancy is not None else None),
            "compiles": compiles,
        }


def format_stats(metrics: Dict) -> str:
    """Render ``SolveService.metrics()`` as the ``--stats`` text report."""
    lines = ["== dispatches_tpu.serve stats =="]
    lines.append(
        "requests: {submitted} submitted / {solved} solved / "
        "{timeouts} timed out; queue depth {queue_depth}".format(**metrics)
    )
    lines.append(
        "batches: {batches} dispatched, mean occupancy {occ}; "
        "compiled programs: {compile_count}".format(
            batches=metrics["batches"],
            occ=("%.3f" % metrics["occupancy_mean"]
                 if metrics["occupancy_mean"] is not None else "n/a"),
            compile_count=metrics["compile_count"],
        )
    )
    lat = metrics["latency"]
    if lat.get("count"):
        lines.append(
            "latency: mean {mean_ms} ms, p50 {p50_ms} ms, p95 {p95_ms} ms, "
            "p99 {p99_ms} ms over {count} request(s)".format(**lat)
        )
    qw = metrics.get("queue_wait") or {}
    if qw.get("count"):
        lines.append(
            "queue wait: mean {mean_ms} ms, p50 {p50_ms} ms, "
            "p95 {p95_ms} ms, p99 {p99_ms} ms over {count} request(s)".format(**qw)
        )
    dl = metrics.get("deadline") or {}
    if dl.get("requests"):
        lines.append(
            "deadlines: {requests} request(s) with deadline, "
            "{missed} missed (miss rate {miss_rate:.4f})".format(**dl)
        )
    ws = metrics["warm_start"]
    lines.append(
        "warm starts: {hits} exact hit(s) / {pred} predicted / "
        "{nb} neighbor hit(s) / {misses} miss(es), "
        "hit rate {rate:.4f}, "
        "{size} cached solution(s), {mp} mispredict(s)".format(
            hits=ws["hits"], pred=ws.get("predicted", 0),
            nb=ws.get("neighbor_hits", 0),
            misses=ws["misses"], rate=ws.get("hit_rate", 0.0),
            size=ws["size"], mp=ws.get("mispredicts", 0))
    )
    if metrics["buckets"]:
        lines.append("buckets:")
        for label, b in sorted(metrics["buckets"].items()):
            occ = ("%.3f" % b["occupancy"]
                   if b["occupancy"] is not None else "n/a")
            lines.append(
                f"  {label}: {b['submitted']} req, {b['batches']} batch(es) "
                f"@ lanes {b['lane_counts']}, occupancy {occ}, "
                f"{b['timeouts']} timeout(s), {b['compiles']} compile(s)"
            )
            blat = b.get("latency_ms") or {}
            bqw = b.get("queue_wait_ms") or {}
            if blat.get("count"):
                lines.append(
                    "    latency p50 {p50_ms} / p95 {p95_ms} / "
                    "p99 {p99_ms} ms".format(**blat)
                    + ("; queue wait p50 {p50_ms} / p95 {p95_ms} / "
                       "p99 {p99_ms} ms".format(**bqw)
                       if bqw.get("count") else "")
                )
    return "\n".join(lines)
