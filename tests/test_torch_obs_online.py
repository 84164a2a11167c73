"""The PyTorch port's streaming analytics (``dispatches_tpu_torch.obs.online``)
held to the JAX package's ``obs.online`` on the same seeded streams.

Every class is host Python with the same arithmetic in both packages, so
every comparison is bitwise (``==`` on floats, dicts and lists):

- ``StreamingQuantiles`` summaries after every observation of a
  heavy-tailed stream;
- ``TimeWindow`` counts, means and quantiles as the window slides;
- ``BurnRateMonitor`` alerts, firing flags and states, for quantile,
  mean and ratio objectives, and ``monitors_from_spec`` on the JAX
  package's built-in SLO spec and on a spec read from JSON;
- ``ks_statistic`` with ties, and ``DriftDetector`` results as a stream
  drifts;
- ``TimelineAccumulator`` on a seeded lifecycle stream with wire spans
  and a foreign plan, and on a span stream recorded from the port's own
  plan: results, raw stalls and the live ``plan.online.*`` gauges;
- the tracer's sinks (an accumulator subscribed with ``trace.add_sink``
  equals one fed the ring afterwards), ``current_span`` and the memory
  sampler hook, the JAX tracer's API names all present.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu.obs import online as jon  # noqa: E402
from dispatches_tpu.obs import registry as jreg  # noqa: E402
from dispatches_tpu.obs import slo as jslo  # noqa: E402

from dispatches_tpu_torch.obs import online as ton  # noqa: E402
from dispatches_tpu_torch.obs import registry as treg  # noqa: E402
from dispatches_tpu_torch.obs import trace as ttrace  # noqa: E402
from test_torch_stacked import one_torch_thread  # noqa: E402,F401


def _stream(seed, n=600):
    """A heavy-tailed latency stream (ms) with a level shift halfway."""
    rng = np.random.default_rng(seed)
    x = rng.lognormal(mean=3.0, sigma=0.6, size=n)
    x[n // 2:] *= 1.8
    return [float(v) for v in x]


def test_exports_match_jax():
    assert ton.__all__ == jon.__all__
    assert ton.DEFAULT_BURN_RULES == tuple(
        ton.BurnRateRule(r.fast_s, r.slow_s, r.threshold) for r in jon.DEFAULT_BURN_RULES)


@pytest.mark.parametrize("ps", [(0.5, 0.95, 0.99), (0.1, 0.9)])
def test_streaming_quantiles_bitwise(ps):
    j, t = jon.StreamingQuantiles(ps), ton.StreamingQuantiles(ps)
    assert t.summary() == j.summary()
    for x in _stream(1):
        j.observe(x)
        t.observe(x)
        assert t.summary() == j.summary()
    assert t.count == j.count and all(t.quantile(p) == j.quantile(p) for p in ps)


def test_time_window_bitwise():
    rng = np.random.default_rng(2)
    j, t = jon.TimeWindow(30.0), ton.TimeWindow(30.0)
    now = 0.0
    for v in _stream(2, 300):
        now += float(rng.exponential(0.5))
        j.observe(now, v)
        t.observe(now, v)
        later = now + float(rng.uniform(0, 40))
        assert t.count(now) == j.count(now)
        assert t.mean(now) == j.mean(now)
        assert t.quantile(0.99, now) == j.quantile(0.99, now)
        assert t.count(later) == j.count(later)  # prunes both the same
    assert t.mean(now + 100.0) is None and j.mean(now + 100.0) is None


def _drive_monitors(pairs, seed):
    """Feed each (JAX, port) monitor pair the same timed stream; returns
    nothing, asserting alerts, firing flags and states as it goes."""
    rng = np.random.default_rng(seed)
    now = 0.0
    for v in _stream(seed, 500):
        now += float(rng.exponential(2.0))
        bad = 1.0 if v > 40.0 else 0.0
        for jm, tm in pairs:
            val = bad if jm.kind == "ratio" else v
            jm.observe(now, val)
            tm.observe(now, val)
            assert tm.update(now) == jm.update(now)
            assert tm.firing == jm.firing
    for jm, tm in pairs:
        assert tm.state(now) == jm.state(now)
        assert tm.burn_peak == jm.burn_peak


def test_burn_rate_monitors_bitwise():
    rules = [(60.0, 300.0, 1.5), (120.0, 600.0, 1.1)]
    pairs = []
    for kw in (dict(kind="quantile", target=45.0, p="p99"),
               dict(kind="quantile", target=30.0, p="mean"),
               dict(kind="quantile", target=50.0, p="p50"),
               dict(kind="ratio", target=0.2)):
        pairs.append((
            jon.BurnRateMonitor("o", rules=[jon.BurnRateRule(*r) for r in rules],
                                check_interval_s=3.0, **kw),
            ton.BurnRateMonitor("o", rules=[ton.BurnRateRule(*r) for r in rules],
                                check_interval_s=3.0, **kw)))
    _drive_monitors(pairs, 3)
    assert any(jm.burn_peak > 1.5 for jm, _ in pairs)  # the stream burns
    for bad in (dict(kind="x", target=1.0), dict(kind="quantile", target=1.0, p="p42"),
                dict(kind="ratio", target=0.0)):
        with pytest.raises(ValueError):
            jon.BurnRateMonitor("b", **bad)
        with pytest.raises(ValueError):
            ton.BurnRateMonitor("b", **bad)


def _spec_forms(tmp_path):
    """The JAX package's own spec forms: its built-in spec, and a spec
    read from JSON through ``load_spec``."""
    path = tmp_path / "slo.json"
    path.write_text(json.dumps({"name": "t", "objectives": [
        {"name": "lat", "kind": "quantile", "metric": "serve.latency_ms",
         "p": "p95", "target": 45.0},
        {"name": "miss", "kind": "ratio", "target": 0.2,
         "num": {"metric": "serve.deadline", "labels": {"event": "missed"}},
         "den": {"metric": "serve.requests"}}]}))
    return [jslo.builtin_spec(), jslo.load_spec(str(path))]


def test_monitors_from_spec_bitwise(tmp_path):
    rules = (jon.BurnRateRule(60.0, 300.0, 1.5),)
    for spec in _spec_forms(tmp_path):
        jms = jon.monitors_from_spec(spec, rules=rules, check_interval_s=2.0)
        tms = ton.monitors_from_spec(spec, rules=(ton.BurnRateRule(60.0, 300.0, 1.5),),
                                     check_interval_s=2.0)
        assert [(m.name, m.kind, m.target, m.p, m.metric, m.check_interval_s)
                for m in tms] == [(m.name, m.kind, m.target, m.p, m.metric,
                                   m.check_interval_s) for m in jms]
        _drive_monitors(list(zip(jms, tms)), 4)
    # the default rules are the SRE pairs in both packages
    jd = jon.monitors_from_spec(jslo.builtin_spec())
    td = ton.monitors_from_spec(jslo.builtin_spec())
    assert [[(r.fast_s, r.slow_s, r.threshold) for r in m.rules] for m in td] == \
        [[(r.fast_s, r.slow_s, r.threshold) for r in m.rules] for m in jd]


def test_ks_statistic_and_drift_detector_bitwise():
    rng = np.random.default_rng(5)
    for _ in range(20):
        a = rng.integers(0, 12, size=int(rng.integers(1, 60))).astype(float)
        b = rng.integers(0, 12, size=int(rng.integers(1, 60))).astype(float) + 0.5 * rng.integers(0, 2)
        assert ton.ks_statistic(a, b) == jon.ks_statistic(a, b)
    kw = dict(reference=64, window=48, threshold=0.3, min_samples=16)
    j, t = jon.DriftDetector(**kw), ton.DriftDetector(**kw)
    drifted = False
    for x in _stream(6, 400):
        j.observe(x)
        t.observe(x)
        assert t.result() == j.result()
        assert t.statistic() == j.statistic()
        drifted |= j.result()["drifted"]
    assert drifted  # the level shift is detected


def _lifecycle_stream(seed, plan=3, other=9):
    """A seeded dispatch-ahead span stream in watermark order: up to
    three batches in flight, stage/submit/fence spans of ``plan``,
    interleaved spans of a foreign plan, and ``net.rpc`` wire spans."""
    rng = np.random.default_rng(seed)
    ev, t, seq, window = [], 0.0, 0, []

    def span(name, ts, dur, **args):
        ev.append({"name": name, "ph": "X", "ts": float(ts), "dur": float(dur),
                   "tid": 1, "args": args})

    for _ in range(30):
        if rng.random() < 0.3:
            span("net.rpc", t, float(rng.uniform(5, 80)))
        stage = float(rng.uniform(5, 200))
        span("plan.stage", t, stage, plan=plan, lanes=8)
        t += stage
        sub = float(rng.uniform(1, 30))
        seq += 1
        span("plan.submit", t, sub, plan=plan, seq=seq, label="k", lanes=8,
             live=int(rng.integers(1, 9)), inflight=len(window) + 1)
        window.append(seq)
        t += sub
        if rng.random() < 0.2:
            span("plan.submit", t, 3.0, plan=other, seq=seq, label="o", lanes=2,
                 live=2, inflight=1)
        if len(window) >= int(rng.integers(1, 4)):
            gap = float(rng.uniform(0, 100))
            t += gap
            fence = float(rng.uniform(0, 400))
            span("plan.fence", t, fence, plan=plan, seq=window.pop(0), label="k",
                 lanes=8, inflight=len(window), order=seq)
            t += fence
        t += float(rng.uniform(0, 50))
    for s in window:
        span("plan.fence", t, 20.0, plan=plan, seq=s, label="k", lanes=8,
             inflight=0, order=s)
        t += 20.0
    return ev


def _gauges(reg):
    snap = reg.snapshot()
    return {k: v for k, v in snap.items() if k.startswith("plan.online")}


def _assert_accumulators_equal(events):
    jr, tr = jreg.MetricsRegistry(), treg.MetricsRegistry()
    j, t = jon.TimelineAccumulator(registry=jr), ton.TimelineAccumulator(registry=tr)
    assert t.result() is None and j.result() is None
    for e in events:
        j.ingest(e)
        t.ingest(e)
        assert t.stalls() == j.stalls()
        assert t.result() == j.result()
    assert t.plan == j.plan and t.n_batches == j.n_batches > 0
    assert _gauges(tr) == _gauges(jr) and _gauges(tr)
    return t.result()


def test_timeline_accumulator_on_a_seeded_stream_bitwise():
    res = _assert_accumulators_equal(_lifecycle_stream(7))
    st = res["stall"]
    assert res["plan"] == 3 and st["fence_bound_us"] > 0 and st["host_stage_bound_us"] > 0
    assert st["wire_bound_us"] > 0 or st["queue_empty_us"] > 0


def test_timeline_accumulator_on_the_ports_plan_spans_bitwise():
    """A span stream recorded from the port's plan (tracing on, a CPU
    plan with a dispatch-ahead window of 2): the same dicts through both
    accumulators."""
    from dispatches_tpu_torch.plan import ExecutionPlan, PlanOptions

    ttrace.reset()
    ttrace.enable(True)
    try:
        plan = ExecutionPlan(PlanOptions(device="cpu", inflight=2, donate=False))
        prog = plan.program(lambda p: p["a"] * 2.0, label="online.rec", donate_argnums=())
        rng = np.random.default_rng(8)
        for _ in range(6):
            staged = plan.stage({"a": rng.random((4, 3))}, lanes=4)
            plan.submit(prog, (staged,), n_live=4, lanes=4)
        plan.drain()
        events = [e for e in ttrace.events()
                  if (e.get("args") or {}).get("plan") == plan.plan_id]
    finally:
        ttrace.enable(False)
        ttrace.reset()
    assert {e["name"] for e in events} >= {"plan.stage", "plan.submit", "plan.fence"}
    res = _assert_accumulators_equal(events)
    assert res["n_batches"] == 6


def test_trace_sinks_current_span_and_memory_sampler():
    """``trace.add_sink`` hands every recorded span to an accumulator as it
    retires (the same figures as feeding it the ring afterwards);
    ``current_span`` names the innermost open span; the memory sampler runs
    at every span exit; a raising sink or sampler breaks nothing."""
    from dispatches_tpu.obs import trace as jtrace

    from dispatches_tpu_torch.plan import ExecutionPlan, PlanOptions

    assert set(jtrace.__all__) <= set(ttrace.__all__)
    calls = []

    def bad(_event):
        raise RuntimeError("a broken sink")

    ttrace.reset()
    ttrace.enable(True)
    acc = ton.TimelineAccumulator(gauges=False)
    try:
        ttrace.add_sink(bad)
        ttrace.add_sink(acc.ingest)
        ttrace.add_sink(acc.ingest)  # idempotent
        ttrace.set_memory_sampler(lambda: calls.append(1) or 1 / 0)
        assert ttrace.current_span() is None
        with ttrace.span("outer"):
            with ttrace.span("inner"):
                assert ttrace.current_span() == "inner"
            assert ttrace.current_span() == "outer"
        assert len(calls) == 2
        plan = ExecutionPlan(PlanOptions(device="cpu", inflight=2, donate=False))
        prog = plan.program(lambda p: p["a"] + 1.0, label="online.sink", donate_argnums=())
        for _ in range(4):
            plan.submit(prog, (plan.stage({"a": np.ones((2, 2))}, lanes=2),), n_live=2, lanes=2)
        plan.drain()
        events = ttrace.events()
    finally:
        for fn in (bad, acc.ingest):
            ttrace.remove_sink(fn)
        ttrace.remove_sink(bad)  # idempotent
        ttrace.set_memory_sampler(None)
        ttrace.enable(False)
        ttrace.reset()
    replay = ton.TimelineAccumulator(plan=plan.plan_id, gauges=False)
    for e in events:
        replay.ingest(e)
    assert acc.plan == plan.plan_id and acc.result() == replay.result()
    assert acc.n_batches == 4 and ttrace._SINKS == []
