"""The PyTorch port's pipeline timeline (``dispatches_tpu_torch.obs.timeline``)
held to the JAX package's ``obs.timeline`` on the same event lists.

Host Python with the same arithmetic in both packages, so bitwise:

- ``build_timeline`` (by plan, by the most-submitted default, with a
  ``local_pid`` over a merged trace), ``build_timelines``,
  ``counter_events``, ``plan_ids`` and ``format_timeline`` on the hand-built
  dispatch-ahead shape of tests/test_timeline_export.py and on seeded
  lifecycle streams (wire spans, a foreign plan, unfenced batches,
  out-of-order fences);
- the port's plan spans (a CPU plan under ``schedule="ready"`` and one
  that fences every batch) read by the port's timeline: the same as
  JAX's timeline on those events, and overlap efficiency, occupancy and
  stalls equal to the port's ``TimelineAccumulator`` fed the same spans
  (the port's CPU plan emits its spans in watermark order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu.obs import timeline as jtl  # noqa: E402

from dispatches_tpu_torch.obs import online as ton  # noqa: E402
from dispatches_tpu_torch.obs import timeline as ttl  # noqa: E402
from dispatches_tpu_torch.obs import trace as ttrace  # noqa: E402
from test_torch_obs_online import _lifecycle_stream  # noqa: E402
from test_torch_stacked import one_torch_thread  # noqa: E402,F401


def _span(name, ts, dur, pid=None, **args):
    e = {"name": name, "ph": "X", "ts": float(ts), "dur": float(dur), "tid": 1, "args": args}
    if pid is not None:
        e["pid"] = pid
    return e


def _pipelined_events(plan=7):
    """tests/test_timeline_export.py's hand-built two-batch shape."""
    return [
        _span("plan.stage", 0, 10, plan=plan, lanes=4),
        _span("plan.submit", 10, 5, plan=plan, seq=1, label="k", lanes=4, live=4, inflight=1),
        _span("plan.stage", 15, 10, plan=plan, lanes=4),
        _span("plan.submit", 25, 5, plan=plan, seq=2, label="k", lanes=4, live=3,
              inflight=2, request_ids=[11, 12, 13]),
        _span("plan.fence", 40, 10, plan=plan, seq=1, label="k", lanes=4, inflight=1),
        _span("plan.fence", 50, 5, plan=plan, seq=2, label="k", lanes=4, inflight=0),
    ]


def _merged_trace():
    """Two processes' spans in one trace: plan 5 of pid 1 (with its own
    wire spans), plan 6 submitted from pid 2, a remote RPC, and one
    unfenced batch."""
    ev = [_span("plan.stage", 0, 20, pid=1, plan=5, lanes=2),
          _span("plan.submit", 20, 5, pid=1, plan=5, seq=1, label="a", lanes=2),
          _span("plan.submit", 30, 5, pid=2, plan=5, seq=2, label="a", lanes=2),
          _span("net.rpc", 60, 30, pid=1),
          _span("net.rpc", 95, 40, pid=2),
          _span("plan.fence", 50, 8, pid=1, plan=5, seq=1, label="a", lanes=2, order=2),
          _span("plan.stage", 140, 10, pid=1, plan=6, lanes=1),
          _span("plan.submit", 150, 2, pid=1, plan=6, seq=1, label="b", lanes=1)]
    ev.append({"name": "compile", "ph": "i", "ts": 3.0, "tid": 1, "args": {}})
    return ev


CASES = {
    "hand-built": _pipelined_events(),
    "merged": _merged_trace(),
    "seeded-7": _lifecycle_stream(7),
    "seeded-11": _lifecycle_stream(11, plan=4, other=2),
    "empty": [_span("serve.request", 0, 3)],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_timeline_functions_bitwise(name):
    events = CASES[name]
    assert ttl.plan_ids(events) == jtl.plan_ids(events)
    assert ttl.build_timeline(events) == jtl.build_timeline(events)
    for pid in jtl.plan_ids(events):
        for local in (None, 1, 2):
            assert ttl.build_timeline(events, plan=pid, local_pid=local) == \
                jtl.build_timeline(events, plan=pid, local_pid=local)
    assert ttl.build_timelines(events) == jtl.build_timelines(events)
    assert ttl.counter_events(events) == jtl.counter_events(events)
    for pid in jtl.plan_ids(events):
        assert ttl.counter_events(events, plan=pid) == jtl.counter_events(events, plan=pid)
    assert ttl.format_timeline(ttl.build_timeline(events)) == \
        jtl.format_timeline(jtl.build_timeline(events))


def test_hand_built_numbers():
    """The hand-computed figures of tests/test_timeline_export.py."""
    tl = ttl.build_timeline(_pipelined_events())
    assert tl["plan"] == 7 and tl["n_batches"] == 2 and tl["wall_us"] == 55.0
    assert (tl["host_us"], tl["hidden_host_us"], tl["overlap_efficiency"]) == (30.0, 15.0, 0.5)
    st = tl["stall"]
    assert (st["fence_bound_us"], st["host_stage_bound_us"], st["queue_empty_us"]) == \
        (15.0, 15.0, 0.0)
    assert tl["batches"][1]["request_ids"] == [11, 12, 13]
    assert ttl.PLAN_SPAN_NAMES == jtl.PLAN_SPAN_NAMES
    assert ttl.__all__ == jtl.__all__


@pytest.mark.parametrize("opts", [dict(inflight=2, schedule="ready"), dict(inflight=1)],
                         ids=["ahead-ready", "sync"])
def test_port_plan_spans_read_by_the_port_timeline(opts):
    from dispatches_tpu_torch.plan import ExecutionPlan, PlanOptions

    ttrace.reset()
    ttrace.enable(True)
    try:
        plan = ExecutionPlan(PlanOptions(device="cpu", donate=False, **opts))
        prog = plan.program(lambda p: p["a"].sum(dim=1), label="timeline.rec",
                            donate_argnums=())
        rng = np.random.default_rng(9)
        for i in range(8):
            staged = plan.stage({"a": rng.random((2 + i % 3, 5))}, lanes=2 + i % 3)
            plan.submit(prog, (staged,), n_live=2, lanes=2 + i % 3,
                        request_ids=[2 * i, 2 * i + 1])
        plan.drain()
        events = ttrace.events()
    finally:
        ttrace.enable(False)
        ttrace.reset()
    tl = ttl.build_timeline(events, plan=plan.plan_id)
    assert tl == jtl.build_timeline(events, plan=plan.plan_id)
    assert tl["n_batches"] == 8 and tl["batches"][3]["request_ids"] == [6, 7]
    assert [b["seq"] for b in tl["batches"]] == list(range(1, 9))
    acc = ton.TimelineAccumulator(plan=plan.plan_id, gauges=False)
    for e in events:
        acc.ingest(e)
    online = acc.result()
    for key in ("n_batches", "overlap_efficiency", "occupancy_mean", "occupancy", "stall"):
        assert online[key] == tl[key], key
    # a submit lands before it trims the window, so the depth peaks one
    # above the window bound
    assert max(tl["occupancy"]) == opts["inflight"] + 1
