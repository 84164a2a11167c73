"""Pipeline timeline: reconstruct the execution-plan batch lifecycle
from trace events and score the dispatch-ahead pipeline (counterpart of
``dispatches_tpu/obs/timeline.py``, the same names and arithmetic).

The plan emits three retroactive lifecycle spans per batch when tracing
is on (``plan.stage`` → host staging, ``plan.submit`` → host dispatch,
``plan.fence`` → host wait on the device), each stamped with the
owning plan's id and the batch's per-plan sequence number.  This module
turns one plan's events back into a per-batch timeline and computes:

* **overlap efficiency** — the fraction of host stage/dispatch wall
  time that was hidden under an in-flight batch;
* **in-flight occupancy** — the distribution of the dispatch window
  depth over wall time;
* **stall attribution** — wall time lost to ``fence_bound`` (host
  blocked on the device), ``host_stage_bound`` (nothing in flight
  while the host staged/dispatched), ``wire_bound`` (nothing in flight
  or staged but an RPC was on the wire) and ``queue_empty`` (nothing in
  flight, staged, or on the wire).

``local_pid`` tags batches ``host_local`` vs ``cross_process`` in a
trace merged from several processes.  :func:`counter_events` adds a
``plan.inflight`` counter track to the Chrome-trace export.  Host-side
and torch-free: it works on a live trace buffer or a loaded trace file.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = [
    "PLAN_SPAN_NAMES",
    "plan_ids",
    "build_timeline",
    "build_timelines",
    "counter_events",
    "format_timeline",
]

#: the lifecycle spans the plan emits (``plan.dispatch`` is the
#: submit→done envelope; the timeline is reconstructed from the other
#: three)
PLAN_SPAN_NAMES = ("plan.stage", "plan.submit", "plan.fence",
                   "plan.dispatch")


def _plan_events(events: List[Dict], plan: Optional[int]) -> List[Dict]:
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("name") not in PLAN_SPAN_NAMES:
            continue
        args = e.get("args") or {}
        if "plan" not in args:
            continue
        if plan is not None and args["plan"] != plan:
            continue
        out.append(e)
    return out


def plan_ids(events: List[Dict]) -> List[int]:
    """Plan ids present in ``events`` (sorted)."""
    return sorted({(e.get("args") or {}).get("plan")
                   for e in _plan_events(events, None)})


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Union of half-open intervals, sorted and coalesced."""
    out: List[Tuple[float, float]] = []
    for lo, hi in sorted(i for i in intervals if i[1] > i[0]):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _overlap(span: Tuple[float, float],
             merged: List[Tuple[float, float]]) -> float:
    lo, hi = span
    return sum(max(0.0, min(hi, m_hi) - max(lo, m_lo))
               for m_lo, m_hi in merged)


def _subtract(spans: List[Tuple[float, float]],
              merged: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Parts of ``spans`` not covered by ``merged`` (both half-open;
    ``merged`` must already be sorted/coalesced via :func:`_merge`)."""
    out: List[Tuple[float, float]] = []
    for lo, hi in spans:
        cur = lo
        for m_lo, m_hi in merged:
            if m_hi <= cur:
                continue
            if m_lo >= hi:
                break
            if m_lo > cur:
                out.append((cur, m_lo))
            cur = max(cur, m_hi)
            if cur >= hi:
                break
        if cur < hi:
            out.append((cur, hi))
    return out


def _wire_spans(events: List[Dict],
                local_pid: Optional[int]) -> List[Tuple[float, float]]:
    """Client-side RPC wall intervals (``net.rpc`` complete spans).
    In a merged trace, ``local_pid`` restricts to the local process's
    own calls — remote workers' RPCs don't stall this pipeline."""
    out: List[Tuple[float, float]] = []
    for e in events:
        if e.get("ph") != "X" or e.get("name") != "net.rpc":
            continue
        pid = e.get("pid")
        if local_pid is not None and pid is not None and pid != local_pid:
            continue
        ts = float(e["ts"])
        out.append((ts, ts + float(e.get("dur", 0.0))))
    return out


def build_timeline(events: List[Dict],
                   plan: Optional[int] = None,
                   local_pid: Optional[int] = None) -> Optional[Dict]:
    """Reconstruct one plan's batch timeline from trace events.

    ``plan`` selects the pipeline when the trace interleaves several;
    None picks the plan with the most submitted batches.  ``local_pid``
    identifies "this" process in a merged multi-process trace — it
    drives per-batch ``placement`` tagging and restricts wire-stall
    accounting to local RPC spans.  Returns None when the events carry
    no plan lifecycle spans.
    """
    if plan is None:
        ids = plan_ids(events)
        if not ids:
            return None
        counts = {
            pid: sum(1 for e in _plan_events(events, pid)
                     if e["name"] == "plan.submit")
            for pid in ids
        }
        plan = max(ids, key=lambda pid: (counts[pid], -pid))
    evts = _plan_events(events, plan)
    if not evts:
        return None

    stage_spans: List[Tuple[float, float]] = []
    submits: Dict[int, Dict] = {}
    fences: Dict[int, Dict] = {}
    for e in evts:
        ts, dur, args = float(e["ts"]), float(e.get("dur", 0.0)), e["args"]
        if e["name"] == "plan.stage":
            stage_spans.append((ts, ts + dur))
        elif e["name"] == "plan.submit":
            submits[args["seq"]] = {"t0": ts, "t1": ts + dur, "args": args,
                                    "pid": e.get("pid")}
        elif e["name"] == "plan.fence":
            fences[args["seq"]] = {"t0": ts, "t1": ts + dur, "args": args}
    if not submits:
        return None

    t_lo = min([s["t0"] for s in submits.values()]
               + [s[0] for s in stage_spans])
    t_hi = max([s["t1"] for s in submits.values()]
               + [s[1] for s in stage_spans]
               + [f["t1"] for f in fences.values()])
    wall_us = max(t_hi - t_lo, 0.0)

    batches: List[Dict] = []
    inflight_spans: List[Tuple[float, float]] = []
    for seq in sorted(submits):
        sub, fen = submits[seq], fences.get(seq)
        a = sub["args"]
        fence_end = fen["t1"] if fen is not None else t_hi
        sub_pid = sub.get("pid")
        placement = ("cross_process"
                     if local_pid is not None and sub_pid is not None
                     and sub_pid != local_pid else "host_local")
        # in flight = dispatched (host returned from submit) until the
        # fence observed device completion; an unfenced batch counts to
        # the end of the trace window
        inflight_spans.append((sub["t1"], fence_end))
        batches.append({
            "seq": seq,
            "label": a.get("label"),
            "lanes": a.get("lanes"),
            "live": a.get("live"),
            "request_ids": a.get("request_ids"),
            "submit_us": round(sub["t0"], 1),
            "dispatched_us": round(sub["t1"], 1),
            "fence_start_us": (None if fen is None
                               else round(fen["t0"], 1)),
            "fence_end_us": (None if fen is None
                             else round(fen["t1"], 1)),
            "fence_wait_us": (None if fen is None
                              else round(fen["t1"] - fen["t0"], 1)),
            "span_us": round(fence_end - sub["t0"], 1),
            "inflight_after_submit": a.get("inflight"),
            "placement": placement,
            # retirement rank from the plan's fence counter: under
            # schedule="ready" it can disagree with seq (out-of-order
            # fence); None for unfenced batches / traces without fence ranks
            "fence_order": (None if fen is None
                            else (fen["args"] or {}).get("order")),
        })

    # out-of-order fences: batches whose retirement rank disagrees
    # with submission order (always 0 under FIFO scheduling)
    ordered = [(b["fence_order"], b["seq"]) for b in batches
               if b["fence_order"] is not None]
    by_order = [seq for _, seq in sorted(ordered)]
    fence_reorders = sum(1 for got, fifo in zip(by_order, sorted(by_order))
                         if got != fifo)

    # -- overlap efficiency: host wall time hidden under in-flight work
    host_spans = stage_spans + [(s["t0"], s["t1"]) for s in submits.values()]
    merged_inflight = _merge(inflight_spans)
    host_us = sum(hi - lo for lo, hi in _merge(host_spans))
    hidden_us = sum(_overlap(sp, merged_inflight)
                    for sp in _merge(host_spans))
    overlap_efficiency = (hidden_us / host_us) if host_us > 0 else 0.0

    # -- in-flight occupancy: window depth weighted by wall time
    edges: List[Tuple[float, int]] = []
    for lo, hi in inflight_spans:
        edges.append((lo, +1))
        edges.append((hi, -1))
    edges.sort()
    occupancy: Dict[int, float] = {}
    depth, prev = 0, t_lo
    zero_spans: List[Tuple[float, float]] = []
    for t, step in edges:
        if t > prev:
            occupancy[depth] = occupancy.get(depth, 0.0) + (t - prev)
            if depth == 0:
                zero_spans.append((prev, t))
        depth += step
        prev = max(prev, t)
    if t_hi > prev:
        occupancy[depth] = occupancy.get(depth, 0.0) + (t_hi - prev)
        if depth == 0:
            zero_spans.append((prev, t_hi))
    occupancy_mean = (sum(d * us for d, us in occupancy.items()) / wall_us
                      if wall_us > 0 else 0.0)

    # -- stall attribution.  Fence waits happen at depth >= 1 (the
    # fencing batch is still in flight), so the buckets never
    # double-count wall time: zero-depth idle is split host-staged vs
    # wire-bound vs truly empty by interval subtraction.
    fence_bound_us = sum(f["t1"] - f["t0"] for f in fences.values())
    merged_host = _merge(host_spans)
    host_stage_bound_us = sum(_overlap(z, merged_host) for z in zero_spans)
    pure_idle = _subtract(zero_spans, merged_host)
    merged_wire = _merge(_wire_spans(events, local_pid))
    wire_bound_us = sum(_overlap(z, merged_wire) for z in pure_idle)
    queue_empty_us = (sum(hi - lo for lo, hi in pure_idle)
                      - wire_bound_us)
    stall_us = (fence_bound_us + host_stage_bound_us + wire_bound_us
                + queue_empty_us)
    stall_pct = (100.0 * stall_us / wall_us) if wall_us > 0 else 0.0

    return {
        "plan": plan,
        "n_batches": len(batches),
        "fence_reorders": fence_reorders,
        "batches": batches,
        "wall_us": round(wall_us, 1),
        "host_us": round(host_us, 1),
        "hidden_host_us": round(hidden_us, 1),
        "overlap_efficiency": round(overlap_efficiency, 4),
        "occupancy": {d: round(us / wall_us, 4) if wall_us > 0 else 0.0
                      for d, us in sorted(occupancy.items())},
        "occupancy_mean": round(occupancy_mean, 3),
        "stall": {
            "fence_bound_us": round(fence_bound_us, 1),
            "host_stage_bound_us": round(host_stage_bound_us, 1),
            "wire_bound_us": round(wire_bound_us, 1),
            "queue_empty_us": round(queue_empty_us, 1),
            "stall_pct": round(stall_pct, 2),
        },
    }


def build_timelines(events: List[Dict]) -> Dict[int, Dict]:
    """One timeline per plan id present in ``events``."""
    out: Dict[int, Dict] = {}
    for pid in plan_ids(events):
        tl = build_timeline(events, plan=pid)
        if tl is not None:
            out[pid] = tl
    return out


def counter_events(events: List[Dict],
                   plan: Optional[int] = None) -> List[Dict]:
    """Chrome counter-track (``ph: C``) events for the in-flight depth
    of each plan in ``events`` — merge them into a trace export and
    Perfetto draws the dispatch window as a counter lane under the
    spans.  ``plan`` restricts to one pipeline."""
    out: List[Dict] = []
    for pid in plan_ids(events):
        if plan is not None and pid != plan:
            continue
        tl = build_timeline(events, plan=pid)
        if tl is None:
            continue
        steps: List[Tuple[float, int]] = []
        for b in tl["batches"]:
            steps.append((b["dispatched_us"], +1))
            end = b["fence_end_us"]
            if end is not None:
                steps.append((end, -1))
        steps.sort()
        depth = 0
        for ts, step in steps:
            depth += step
            out.append({
                "name": f"plan.inflight#{pid}",
                "ph": "C",
                "ts": float(ts),
                "tid": 0,
                "args": {"inflight": depth},
            })
    return out


def format_timeline(tl: Optional[Dict]) -> str:
    """Human-readable rendering for ``--timeline``."""
    if tl is None:
        return ("no plan lifecycle events in the trace (was tracing "
                "enabled while an ExecutionPlan dispatched?)\n")
    lines = [f"== plan {tl['plan']} pipeline timeline =="]
    lines.append(
        f"batches: {tl['n_batches']}  wall {tl['wall_us'] / 1e3:.3f} ms  "
        f"host {tl['host_us'] / 1e3:.3f} ms"
        + (f"  out-of-order fences: {tl['fence_reorders']}"
           if tl.get("fence_reorders") else ""))
    lines.append(
        f"overlap efficiency: {tl['overlap_efficiency']:.3f} "
        f"({tl['hidden_host_us'] / 1e3:.3f} ms of host staging hidden "
        "under in-flight batches)")
    occ = "  ".join(f"depth {d}: {frac:.1%}"
                    for d, frac in tl["occupancy"].items())
    lines.append(f"inflight occupancy: {occ}  "
                 f"(mean {tl['occupancy_mean']:.2f})")
    st = tl["stall"]
    lines.append(
        f"stalls: {st['stall_pct']:.1f}% of wall  "
        f"[fence-bound {st['fence_bound_us'] / 1e3:.3f} ms, "
        f"host-stage-bound {st['host_stage_bound_us'] / 1e3:.3f} ms, "
        f"wire-bound {st.get('wire_bound_us', 0.0) / 1e3:.3f} ms, "
        f"queue-empty {st['queue_empty_us'] / 1e3:.3f} ms]")
    lines.append("batches (seq: dispatch->fence, fence wait, requests):")
    for b in tl["batches"]:
        rids = b.get("request_ids")
        wait = b.get("fence_wait_us")
        order = b.get("fence_order")
        lines.append(
            f"  #{b['seq']:<3d} {b.get('label') or '?':<24s} "
            f"lanes {b.get('lanes')} live {b.get('live')}  "
            f"span {b['span_us'] / 1e3:8.3f} ms  "
            + (f"fence {wait / 1e3:8.3f} ms" if wait is not None
               else "in flight")
            + (f"  fenced #{order}" if order is not None
               and order != b["seq"] else "")
            + (f"  requests {rids}" if rids else ""))
    return "\n".join(lines) + "\n"
