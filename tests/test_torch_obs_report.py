"""The PyTorch port's trace report (``dispatches_tpu_torch.obs.report``)
held to the JAX package's ``obs.report`` on the same seeded event lists,
bitwise (``==`` on dicts, lists and strings): ``aggregate_spans``,
``format_report`` with a registry snapshot and a drop count,
``validate_chrome_trace`` on a clean and a broken trace,
``request_journey`` / ``journey_processes``, and ``load_chrome_trace``
on a trace the port's tracer exported."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu.obs import registry as jreg  # noqa: E402
from dispatches_tpu.obs import report as jrep  # noqa: E402

from dispatches_tpu_torch.obs import registry as treg  # noqa: E402
from dispatches_tpu_torch.obs import report as trep  # noqa: E402
from dispatches_tpu_torch.obs import trace as ttrace  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

NAMES = ("serve.request", "serve.dispatch", "serve.batch", "plan.fence")


def _events(seed, n=400):
    """Spans and instants over two pids and three tids, ts-sorted per
    tid, with request ids (and one router-side ``origin_rid``)."""
    rng = np.random.default_rng(seed)
    out, ts = [], {}
    for i in range(n):
        tid = int(rng.integers(0, 3))
        pid = 1 + int(rng.integers(0, 2))
        t = ts.get(tid, 0.0) + float(rng.exponential(50.0))
        ts[tid] = t
        if rng.random() < 0.2:
            out.append({"name": "flight.trigger", "ph": "i", "ts": t, "pid": pid,
                        "tid": tid, "s": "t", "args": {"request_id": int(rng.integers(0, 20))}})
            continue
        args = {"request_id": int(rng.integers(0, 20)), "bucket": "pdlp#0"}
        if rng.random() < 0.1:
            args = {"origin_rid": args["request_id"]}
        out.append({"name": NAMES[int(rng.integers(0, len(NAMES)))], "ph": "X", "ts": t,
                    "dur": float(rng.lognormal(3.0, 1.0)), "pid": pid, "tid": tid,
                    "args": args})
    return out


def test_api_matches_jax():
    assert trep.__all__ == jrep.__all__


@pytest.mark.parametrize("seed", [0, 1])
def test_aggregate_and_format_equal_jax(seed):
    evts = _events(seed)
    assert trep.aggregate_spans(evts) == jrep.aggregate_spans(evts)
    snaps = []
    for reg in (treg.MetricsRegistry(), jreg.MetricsRegistry()):
        reg.counter("serve.requests", "events").inc(3, event="submitted")
        reg.gauge("plan.inflight").set(2.0)
        for v in np.random.default_rng(seed).lognormal(2.0, 0.5, 50):
            reg.histogram("serve.latency_ms").observe(float(v), bucket="pdlp#0")
        snaps.append(reg.snapshot())
    assert snaps[0] == snaps[1]
    for dropped in (0, 7):
        assert (trep.format_report(evts, snaps[0], dropped=dropped)
                == jrep.format_report(evts, snaps[1], dropped=dropped))
    assert trep.format_report([]) == jrep.format_report([])


def test_validate_chrome_trace_equal_jax():
    good = _events(2)  # ts increases on every tid
    assert trep.validate_chrome_trace(good) == jrep.validate_chrome_trace(good) == []
    bad = [{"ph": "X", "ts": -1.0, "pid": 1, "tid": 1},
           {"name": "x", "ph": "X", "ts": 5.0, "pid": 1, "tid": 2},
           {"name": "y", "ph": "i", "ts": 1.0, "pid": 1, "tid": 2},
           {"name": "z", "ph": "B", "ts": 2.0, "pid": 1, "tid": 2},
           {"ph": "E", "ts": 3.0, "pid": 1, "tid": 9},
           {"name": "w"}]
    problems = trep.validate_chrome_trace(bad)
    assert problems == jrep.validate_chrome_trace(bad) and len(problems) >= 6


def test_request_journey_equal_jax():
    evts = _events(3)
    for rid in range(20):
        assert trep.request_journey(evts, rid) == jrep.request_journey(evts, rid)
        assert trep.journey_processes(evts, rid) == jrep.journey_processes(evts, rid)
    assert trep.request_journey(evts, 99) == []


def test_load_chrome_trace_of_a_port_export(tmp_path):
    ttrace.reset()
    ttrace.enable(True)
    try:
        with ttrace.span("batch", bucket="pdlp#0"):
            ttrace.instant("tick", request_id=1)
        ttrace.complete("serve.request", ttrace.now_us(), 12.5, request_id=1)
        path = tmp_path / "trace.json"
        n = ttrace.export_chrome_trace(str(path))
    finally:
        ttrace.enable(False)
        ttrace.reset()
    loaded = trep.load_chrome_trace(path)
    assert len(loaded) == n == 3 and loaded == jrep.load_chrome_trace(path)
    assert trep.validate_chrome_trace(loaded) == []
    assert [e["name"] for e in trep.request_journey(loaded, 1)] == \
        [e["name"] for e in jrep.request_journey(loaded, 1)]
