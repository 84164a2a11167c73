"""Distributed tracing: wire-level trace context, clock alignment, and
multi-process trace/metrics merging (counterpart of
``dispatches_tpu/obs/distributed.py``).

Every observability surface below this module is per-process: the span
tracer rings, the metrics registry, the Prometheus exporter and the
pipeline timeline all stop at the process boundary.  Once a request is
routed through ``fleet.remote`` to a ``net`` worker, its journey is
split across (at least) two processes with two unrelated
``perf_counter`` epochs.  This module stitches the journey back
together:

* **Trace context** — a compact dict (``rid`` request identity,
  ``pid``/``gen`` origin process identity, ``parent`` innermost open
  span at the origin) that ``RpcClient.call`` attaches to every frame
  when armed, and ``RpcServer`` re-hydrates on the far side, so spans
  emitted inside a worker carry the router-side request identity.
* **Clock offset** — remote ``now_us`` samples piggybacked on
  ``hello``/``ping`` give a midpoint offset estimate per replica
  (lowest-RTT sample wins), good to ~RTT/2 — plenty for nesting
  millisecond solves inside hundred-millisecond RPC windows.
* **Merging** — :func:`merge_traces` aligns remote span timestamps
  onto the local clock, stamps per-process ``pid`` rows (with
  ``process_name`` metadata), renormalizes so no timestamp is negative
  and emits one Chrome trace that ``report.validate_chrome_trace``
  accepts; :func:`merge_registry_snapshots` sums counters across
  processes for the fleet rollup.

Armed by ``DISPATCHES_TPU_NET_TRACE`` (or :func:`enable`); the
disarmed RPC hot path pays exactly one cached-boolean branch
(spy-pinned in ``tests/test_torch_distributed.py``).  Everything here
is host-side and stdlib-only — no torch, no numpy.  Chrome events keep
the JAX package's ``dispatches_tpu`` category, so the two packages'
traces merge.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence

from dispatches_tpu_torch.analysis.flags import flag_enabled
from dispatches_tpu_torch.obs import trace as obs_trace

__all__ = [
    "enabled",
    "enable",
    "TraceContext",
    "ClockSync",
    "set_generation",
    "submit_context",
    "remote_context",
    "current",
    "wire_context",
    "decode_context",
    "offset_from_exchange",
    "sync_clock",
    "merge_traces",
    "export_merged_trace",
    "request_processes",
    "merge_registry_snapshots",
]

_ENABLED: Optional[bool] = None   # lazily resolved from the env flag

# origin generation stamped into outbound contexts; workers set this to
# their service generation at startup, the router process leaves it 1
_GENERATION = 1


def enabled() -> bool:
    """Whether wire-level trace propagation is armed
    (``DISPATCHES_TPU_NET_TRACE``).  Read once, lazily; :func:`enable`
    overrides for the rest of the process."""
    global _ENABLED
    if _ENABLED is None:
        _ENABLED = flag_enabled("NET_TRACE")
    return _ENABLED


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = bool(on)


def set_generation(gen: int) -> None:
    """Record this process's service generation for outbound contexts."""
    global _GENERATION
    _GENERATION = int(gen)


class TraceContext(NamedTuple):
    """One hop of request identity: who originated the call, under
    which open span, on behalf of which request."""

    rid: Optional[str]      # origin request id (the facade's submit rid)
    pid: int                # origin OS process id
    gen: int                # origin service generation
    parent: Optional[str]   # innermost span open at the origin


# The active context.  On the client side it carries the request id the
# facade is submitting (so RpcClient.call can stamp it into the frame);
# on the server side it carries the DECODED remote context for the
# duration of one handler, so worker code (``_rpc_submit``) can read
# the router-side identity without the RPC layer knowing about it.
_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "dispatches_tpu_torch_trace_context", default=None
)


def current() -> Optional[TraceContext]:
    """The trace context active in this execution context (either a
    client-side submit context or a server-side remote context)."""
    return _CTX.get()


@contextlib.contextmanager
def submit_context(rid: Optional[str]):
    """Client side: associate ``rid`` with every RPC issued inside the
    block, so the wire context carries the request identity and not
    just process identity."""
    ctx = TraceContext(rid, os.getpid(), _GENERATION,
                       obs_trace.current_span())
    tok = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(tok)


@contextlib.contextmanager
def remote_context(tc: Dict):
    """Server side: re-hydrate a decoded wire context for the duration
    of one handler invocation."""
    ctx = decode_context(tc)
    tok = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(tok)


def wire_context() -> Dict:
    """The compact dict attached to an outbound RPC frame.  Keys are
    short (one wire frame per call): ``rid``/``pid``/``gen``/``par``,
    absent keys omitted."""
    ctx = _CTX.get()
    d: Dict = {"pid": os.getpid(), "gen": _GENERATION}
    if ctx is not None:
        if ctx.rid is not None:
            d["rid"] = ctx.rid
        d["gen"] = ctx.gen
    par = obs_trace.current_span()
    if par is None and ctx is not None:
        par = ctx.parent
    if par is not None:
        d["par"] = par
    return d


def decode_context(tc: Dict) -> TraceContext:
    """Inverse of :func:`wire_context`; tolerant of missing keys (a
    newer client talking to this decoder only adds keys)."""
    return TraceContext(
        rid=tc.get("rid"),
        pid=int(tc.get("pid", 0)),
        gen=int(tc.get("gen", 1)),
        parent=tc.get("par"),
    )


# ---------------------------------------------------------------------------
# Clock alignment
# ---------------------------------------------------------------------------


class ClockSync(NamedTuple):
    """One clock-offset estimate for a remote process.

    ``offset_us`` maps the remote tracer clock onto the local one:
    ``local_ts = remote_ts + offset_us``.  The error bound is ±RTT/2
    (the remote sample could have been taken anywhere inside the
    exchange window), so estimates keep the lowest-RTT sample."""

    offset_us: float
    rtt_us: float


def offset_from_exchange(t_send_us: float, t_recv_us: float,
                         remote_now_us: float) -> ClockSync:
    """Midpoint estimator: assume the remote clock was sampled halfway
    through the exchange, so ``remote_now ≈ midpoint(send, recv)`` on
    the local axis."""
    mid = 0.5 * (float(t_send_us) + float(t_recv_us))
    return ClockSync(offset_us=mid - float(remote_now_us),
                     rtt_us=float(t_recv_us) - float(t_send_us))


def sync_clock(ping, samples: int = 3) -> Optional[ClockSync]:
    """Estimate a remote clock offset from ``samples`` ping exchanges.

    ``ping`` is a zero-argument callable returning the remote response
    dict (must carry ``now_us``); the lowest-RTT sample wins.  Returns
    None if no exchange produced a usable sample (telemetry never
    raises into the transport)."""
    best: Optional[ClockSync] = None
    for _ in range(max(int(samples), 1)):
        t0 = obs_trace.now_us()
        try:
            resp = ping()
        except Exception:
            continue
        t1 = obs_trace.now_us()
        remote = resp.get("now_us") if isinstance(resp, dict) else None
        if remote is None:
            continue
        est = offset_from_exchange(t0, t1, remote)
        if best is None or est.rtt_us < best.rtt_us:
            best = est
    return best


# ---------------------------------------------------------------------------
# Trace merging
# ---------------------------------------------------------------------------


def _process_meta(pid: int, label: str) -> Dict:
    return {"name": "process_name", "ph": "M", "pid": int(pid), "tid": 0,
            "ts": 0.0, "cat": "__metadata", "args": {"name": label}}


def merge_traces(local_events: Sequence[Dict],
                 remotes: Iterable[Dict],
                 *,
                 local_pid: Optional[int] = None,
                 local_label: str = "router") -> List[Dict]:
    """Merge per-process trace dumps into one Chrome event list.

    ``remotes`` items are dicts with ``pid`` (int), ``label`` (str),
    ``offset_us`` (remote→local clock offset, 0 if unknown) and
    ``events`` (the remote ring, tracer-shaped).  Remote timestamps are
    shifted onto the local clock, every event is stamped with its
    process's ``pid``, and the whole set is renormalized so the minimum
    timestamp is 0 (``validate_chrome_trace`` rejects negative ``ts``,
    and an unknown offset of 0 would otherwise leave remote events on a
    foreign epoch, possibly below the local one).  Events are sorted by
    ``(tid, ts)`` — the validator keys its monotonicity check on
    ``tid`` alone, so a global per-tid order is required, and thread
    ids from distinct processes virtually never collide (and a
    collision only interleaves two tracks, it cannot fail validation).
    ``process_name`` metadata rows label each pid in Perfetto."""
    merged: List[Dict] = []
    lpid = os.getpid() if local_pid is None else int(local_pid)
    labels: Dict[int, str] = {lpid: local_label}
    for e in local_events:
        ce = dict(e)
        ce.setdefault("pid", lpid)
        ce.setdefault("cat", "dispatches_tpu")
        merged.append(ce)
    for r in remotes:
        pid = int(r.get("pid") or 0)
        off = float(r.get("offset_us") or 0.0)
        labels.setdefault(pid, str(r.get("label") or f"worker:{pid}"))
        for e in r.get("events") or ():
            ce = dict(e)
            ce["ts"] = float(ce.get("ts", 0.0)) + off
            ce["pid"] = pid
            ce.setdefault("cat", "dispatches_tpu")
            merged.append(ce)
    if merged:
        lo = min(float(e.get("ts", 0.0)) for e in merged)
        if lo < 0.0 or lo > 0.0:
            for e in merged:
                e["ts"] = float(e.get("ts", 0.0)) - lo
    merged.sort(key=lambda e: (e.get("tid", 0), e.get("ts", 0.0)))
    meta = [_process_meta(pid, label) for pid, label in sorted(labels.items())]
    return meta + merged


def export_merged_trace(path, local_events: Sequence[Dict],
                        remotes: Iterable[Dict],
                        *,
                        local_pid: Optional[int] = None,
                        local_label: str = "router",
                        dropped: int = 0) -> int:
    """Write a merged multi-process Chrome trace to ``path``; returns
    the merged event count (metadata rows included)."""
    import json

    merged = merge_traces(local_events, remotes, local_pid=local_pid,
                          local_label=local_label)
    payload = {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "otherData": {"events_dropped": int(dropped)},
    }
    with open(path, "w") as f:
        json.dump(payload, f)
    return len(merged)


def request_processes(events: Sequence[Dict], request_id) -> List[int]:
    """Distinct pids that emitted at least one span for ``request_id``
    in a merged trace — ≥2 means the journey genuinely crossed the
    wire."""
    rid = request_id
    pids = set()
    for e in events:
        args = e.get("args") or {}
        if args.get("request_id") == rid or str(args.get("request_id")) == str(rid):
            pids.add(int(e.get("pid", 0)))
    return sorted(pids)


# ---------------------------------------------------------------------------
# Registry snapshot merging
# ---------------------------------------------------------------------------


def merge_registry_snapshots(per_process: Dict[str, Dict]) -> Dict:
    """Sum counter values across per-process registry snapshots (the
    ``MetricsRegistry.snapshot()`` shape), keyed by metric name then
    label text.  Gauges and histograms are point-in-time/per-process
    quantities with no meaningful cross-process sum, so they are
    skipped — the fleet rollup renders those per process instead."""
    out: Dict[str, Dict[str, float]] = {}
    for snap in per_process.values():
        for name, entry in (snap or {}).items():
            if not isinstance(entry, dict) or entry.get("kind") != "counter":
                continue
            slot = out.setdefault(name, {})
            for lbl, val in (entry.get("values") or {}).items():
                slot[lbl] = slot.get(lbl, 0.0) + float(val)
    return out
