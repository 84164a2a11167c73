"""Aggregate span/instant events and registry snapshots into reports
(counterpart of ``dispatches_tpu/obs/report.py``; the same output, byte
for byte, on the same events).

``python -m dispatches_tpu_torch.obs --report`` renders this for the live
process; drivers embed :func:`aggregate_spans` / :func:`format_report`
to summarize a run they just traced.  The report's header keeps the JAX
package's text, so tools that read either package's report read both.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

__all__ = [
    "aggregate_spans",
    "format_report",
    "load_chrome_trace",
    "validate_chrome_trace",
    "request_journey",
    "journey_processes",
]


def aggregate_spans(events: List[Dict]) -> Dict[str, Dict]:
    """Per-name rollup of span (``ph: X``) and instant (``ph: i``)
    events: ``{name: {count, total_ms, mean_ms, p50_ms, p95_ms, p99_ms,
    max_ms}}`` for spans, ``{name: {count}}`` for instants."""
    from dispatches_tpu_torch.obs.online import interp_quantile

    out: Dict[str, Dict] = {}
    durs: Dict[str, List[float]] = {}
    for e in events:
        name = e.get("name", "?")
        if e.get("ph") == "X":
            agg = out.setdefault(
                name, {"count": 0, "total_ms": 0.0, "max_ms": 0.0}
            )
            dur_ms = e.get("dur", 0.0) / 1e3
            agg["count"] += 1
            agg["total_ms"] += dur_ms
            agg["max_ms"] = max(agg["max_ms"], dur_ms)
            durs.setdefault(name, []).append(dur_ms)
        elif e.get("ph") == "i":
            agg = out.setdefault(name, {"count": 0})
            agg["count"] += 1
    for name, agg in out.items():
        if "total_ms" in agg:
            agg["mean_ms"] = round(agg["total_ms"] / max(agg["count"], 1), 3)
            agg["total_ms"] = round(agg["total_ms"], 3)
            agg["max_ms"] = round(agg["max_ms"], 3)
            xs = sorted(durs[name])
            for key, p in (("p50_ms", 0.5), ("p95_ms", 0.95),
                           ("p99_ms", 0.99)):
                agg[key] = round(interp_quantile(xs, p), 3)
    return out


def format_report(events: List[Dict],
                  registry_snapshot: Optional[Dict] = None,
                  dropped: int = 0) -> str:
    """Human-readable rollup: spans (sorted by total time), instants,
    then the metrics-registry snapshot."""
    agg = aggregate_spans(events)
    spans = {n: a for n, a in agg.items() if "total_ms" in a}
    instants = {n: a for n, a in agg.items() if "total_ms" not in a}

    lines = ["== dispatches_tpu.obs report =="]
    lines.append(f"events: {len(events)} buffered"
                 + (f", {dropped} dropped" if dropped else ""))
    if dropped:
        lines.append(
            f"WARNING: {dropped} event(s) were evicted from the ring "
            "buffer — this report and any exported trace are truncated "
            "(raise DISPATCHES_TPU_OBS_BUFFER)"
        )
    if spans:
        lines.append("spans:")
        width = max(len(n) for n in spans)
        for name in sorted(spans, key=lambda n: -spans[n]["total_ms"]):
            a = spans[name]
            lines.append(
                f"  {name:<{width}}  {a['count']:6d} x  "
                f"total {a['total_ms']:10.3f} ms  "
                f"mean {a['mean_ms']:8.3f} ms  "
                f"p50 {a['p50_ms']:8.3f} ms  "
                f"p95 {a['p95_ms']:8.3f} ms  "
                f"p99 {a['p99_ms']:8.3f} ms  "
                f"max {a['max_ms']:8.3f} ms"
            )
    if instants:
        lines.append("instants:")
        width = max(len(n) for n in instants)
        for name in sorted(instants):
            lines.append(f"  {name:<{width}}  {instants[name]['count']:6d} x")
    if registry_snapshot:
        lines.append("metrics:")
        for name, entry in sorted(registry_snapshot.items()):
            for label, val in sorted(entry["values"].items()):
                series = f"{name}{{{label}}}" if label else name
                lines.append(f"  {series} = {val}")
    return "\n".join(lines) + "\n"


def validate_chrome_trace(events: List[Dict]) -> List[str]:
    """Perfetto-loadability problems in a trace-event list (empty =
    valid).  Checks the invariants the exporter promises: required keys
    per phase, non-negative timestamps sorted per ``tid``, and —
    should a producer ever emit duration-begin events — every ``B``
    closed by a matching ``E`` on its tid."""
    problems: List[str] = []
    last_ts: Dict = {}
    open_b: Dict = {}
    for i, e in enumerate(events):
        ph = e.get("ph")
        if ph is None:
            problems.append(f"event {i}: missing 'ph'")
            continue
        required = ("name", "pid", "tid", "ts") if ph != "E" else (
            "pid", "tid", "ts")
        for k in required:
            if k not in e:
                problems.append(f"event {i} ({ph}): missing {k!r}")
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: bad ts {ts!r}")
            continue
        tid = e.get("tid")
        if tid in last_ts and ts < last_ts[tid]:
            problems.append(
                f"event {i}: ts {ts} < previous {last_ts[tid]} on tid {tid}")
        last_ts[tid] = ts
        if ph == "X" and not isinstance(e.get("dur"), (int, float)):
            problems.append(f"event {i}: X event missing numeric 'dur'")
        elif ph == "B":
            open_b.setdefault(tid, []).append(e.get("name"))
        elif ph == "E":
            if not open_b.get(tid):
                problems.append(f"event {i}: E with no open B on tid {tid}")
            else:
                open_b[tid].pop()
    for tid, names in open_b.items():
        for name in names:
            problems.append(f"unclosed B event {name!r} on tid {tid}")
    return problems


def request_journey(events: List[Dict], request_id: int) -> List[Dict]:
    """The span events carrying ``args.request_id == request_id``
    (``serve.request`` / ``serve.queue_wait`` / ``serve.dispatch``),
    ts-sorted — one request's journey out of a full trace.  In a
    merged multi-process trace, worker-exported spans annotated with
    the router-side ``origin_rid`` (``obs.distributed``) join the same
    journey."""
    def _matches(e: Dict) -> bool:
        args = e.get("args") or {}
        return (args.get("request_id") == request_id
                or args.get("origin_rid") == request_id)

    out = [e for e in events if _matches(e)]
    out.sort(key=lambda e: (e.get("ts", 0.0), e.get("name", "")))
    return out


def journey_processes(events: List[Dict], request_id: int) -> List[int]:
    """Distinct pids contributing spans to one request's journey in a
    merged trace — ≥ 2 proves the journey crossed a process boundary."""
    return sorted({e.get("pid") for e in request_journey(events, request_id)
                   if e.get("pid") is not None})


def load_chrome_trace(path) -> List[Dict]:
    """Read back a trace written by ``trace.export_chrome_trace`` (or
    any Chrome trace-event JSON file)."""
    with open(path) as f:
        payload = json.load(f)
    if isinstance(payload, list):  # bare-array flavor of the format
        return payload
    return payload.get("traceEvents", [])
