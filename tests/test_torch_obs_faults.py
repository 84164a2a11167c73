"""The port's observability and fault-injection modules held to the JAX
package's: registry counters, gauges and histogram quantiles equal on the
same observations; fault scenarios parse to the same rules and fire
alike; trace spans nest and export alike; the P² quantile and the admission
estimators agree; the lock-order sanitizer catches an inversion."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu.faults import inject as j_faults  # noqa: E402
from dispatches_tpu.obs import online as j_online  # noqa: E402
from dispatches_tpu.obs import registry as j_reg  # noqa: E402
from dispatches_tpu.obs import trace as j_trace  # noqa: E402
from dispatches_tpu.serve import admission as j_adm  # noqa: E402

from dispatches_tpu_torch.analysis import runtime as t_runtime  # noqa: E402
from dispatches_tpu_torch.faults import inject as t_faults  # noqa: E402
from dispatches_tpu_torch.obs import online as t_online  # noqa: E402
from dispatches_tpu_torch.obs import registry as t_reg  # noqa: E402
from dispatches_tpu_torch.obs import trace as t_trace  # noqa: E402
from dispatches_tpu_torch.serve import admission as t_adm  # noqa: E402
from test_torch_stacked import one_torch_thread  # noqa: E402,F401


@pytest.fixture(autouse=True)
def _clean():
    for tr in (j_trace, t_trace):
        tr.enable(False)
        tr.reset()
    for f in (j_faults, t_faults):
        f.reset()
    yield
    for tr in (j_trace, t_trace):
        tr.enable(False)
        tr.reset()
    for f in (j_faults, t_faults):
        f.reset()


def _drive_registry(reg, values):
    r = reg.MetricsRegistry()
    c = r.counter("req", "requests")
    g = r.gauge("depth")
    h = r.histogram("lat", window=64)
    bound = c.labeled(event="ok")
    for i, v in enumerate(values):
        bound.inc()
        c.inc(2, event="err" if i % 3 else "ok")
        g.set(v, bucket=f"b{i % 2}")
        g.inc(-1.0)
        h.observe(v)
        h.labeled(bucket=f"b{i % 2}").observe(2 * v)
    before = r.snapshot()
    c.inc(5, event="late")
    h.observe(1.0)
    return r.snapshot(), reg.diff_snapshots(before, r.snapshot()), \
        [h.quantile(q) for q in (0.5, 0.95, 0.99)], c.total()


def test_registry_matches_jax():
    values = np.random.default_rng(0).lognormal(0.0, 1.0, 200).tolist()
    assert _drive_registry(t_reg, values) == _drive_registry(j_reg, values)


def test_p2_quantile_and_admission_estimators_match_jax():
    xs = np.random.default_rng(1).lognormal(1.0, 0.7, 500)
    for p in (0.5, 0.95, 0.99):
        a, b = j_online.P2Quantile(p), t_online.P2Quantile(p)
        for i, x in enumerate(xs):
            a.observe(x)
            b.observe(x)
            if i in (0, 3, 4, 50, 499):
                assert a.value() == b.value()
    ja, ta = j_adm.ServiceTimeEstimate("b"), t_adm.ServiceTimeEstimate("b")
    assert ja.estimate_ms() is None and ta.estimate_ms() is None  # no profile
    for x in xs[:40]:
        ja.observe_ms(x)
        ta.observe_ms(x)
    assert ja.estimate_ms() == ta.estimate_ms() and ja.samples == ta.samples
    jr, tr = j_adm.ArrivalEstimate(), t_adm.ArrivalEstimate()
    for t in np.cumsum(xs[:30]) / 1e3:
        jr.observe(t)
        tr.observe(t)
    assert jr.gap_s() == tr.gap_s()


_SPECS = [
    "plan.fence,p=0.25,times=6,seed=7;plan.fence,poison_mod=37",
    {"rules": [{"site": "solver", "match": "sweep"}, "serve.stage,times=2"]},
    "plan.stage,times=0",
    {"site": "plan.stage", "times": None},
    "plan.fence,times=2,after=1,every=2",
    "service.clock,skew_s=2.5,times=2",
    "plan.fence,hang_s=30,times=1;plan.submit,poison_ids=3|7",
]


def _rule_fields(sc):
    return [(r.site, r.p, r.times, r.after, r.every, r.seed, r.match,
             r.poison_ids, r.poison_mod, r.skew_s, r.hang_s) for r in sc.rules]


@pytest.mark.parametrize("spec", _SPECS)
def test_fault_scenarios_parse_to_same_rules(spec):
    assert _rule_fields(t_faults.parse_scenario(spec)) == \
        _rule_fields(j_faults.parse_scenario(spec))


@pytest.mark.parametrize("bad", ["plan.bogus,times=1", "plan.fence,frequency=2", "p=0.5"])
def test_fault_scenarios_reject_alike(bad):
    with pytest.raises(ValueError) as je:
        j_faults.parse_scenario(bad)
    with pytest.raises(ValueError) as te:
        t_faults.parse_scenario(bad)
    assert str(je.value) == str(te.value)


def _fire_seq(faults, spec, n=200):
    sc = faults.parse_scenario(spec)
    out = []
    for i in range(n):
        try:
            sc.check("plan.fence", label="serve.pdlp#0" if i % 2 else "sweep.chunk",
                     request_ids=[i, i + 1])
            out.append(0)
        except faults.InjectedFault:
            out.append(1)
    return out


@pytest.mark.parametrize("spec", ["plan.fence,p=0.3,times=0,seed=11",
                                  "plan.fence,match=sweep,times=5",
                                  "plan.fence,poison_mod=7"])
def test_fault_firing_sequence_matches_jax(spec):
    assert _fire_seq(t_faults, spec) == _fire_seq(j_faults, spec)


def test_fault_arming_env_and_restore(monkeypatch):
    assert not t_faults.armed()
    monkeypatch.setenv("DISPATCHES_TPU_FAULTS", "plan.fence,times=1")
    assert not t_faults.armed()  # env cached at first check
    t_faults.reset()
    assert t_faults.armed()
    prev = t_faults.arm("serve.stage,times=1")
    assert prev.rules[0].site == "plan.fence"
    assert t_faults.arm(prev).rules[0].site == "serve.stage"
    assert t_faults.disarm() is prev and not t_faults.armed()


def _traced(trace, tmp_path, name):
    trace.enable(True)
    with trace.span("outer", k=1) as sp:
        with trace.span("inner"):
            trace.instant("compile", label="x")
        sp.fence([1.0, {"a": None}])
    t0 = trace.now_us()
    trace.complete("serve.request", t0, 5.0, request_id=3)
    path = tmp_path / name
    n = trace.export_chrome_trace(path)
    payload = json.loads(path.read_text())
    shape = [(e["name"], e["ph"], e.get("cat"),
              {k: v for k, v in e["args"].items()}) for e in trace.events()]
    return n, shape, sorted(payload), payload["otherData"]


def test_trace_spans_nest_and_export_alike(tmp_path):
    assert _traced(t_trace, tmp_path, "t.json") == _traced(j_trace, tmp_path, "j.json")
    evts = {e["name"]: e for e in t_trace.events()}
    assert evts["inner"]["args"]["parent"] == "outer"
    assert "parent" not in evts["outer"]["args"]


def test_trace_disabled_is_a_noop_and_fence_passes_cpu_tensors():
    x = torch.ones(3)
    assert t_trace.span("x").fence(x) is x  # fences even when disabled
    t_trace.instant("nothing")
    assert t_trace.events() == []


def test_sanitized_lock_catches_inversion(monkeypatch):
    import threading

    assert isinstance(t_runtime.sanitized_lock("a"), type(threading.RLock()))
    monkeypatch.setenv("DISPATCHES_TPU_SANITIZE", "1")
    t_runtime.reset_lock_order()
    a = t_runtime.sanitized_lock("test.a")
    b = t_runtime.sanitized_lock("test.b", reentrant=False)
    with a:
        with b:
            pass
    with pytest.raises(t_runtime.LockOrderError, match="inversion"):
        with b:
            with a:
                pass
    report = t_runtime.lock_order_report()
    assert "test.a -> test.b" in report["edges"]
    assert report["inversions"][0]["kind"] == "inversion"
    t_runtime.reset_lock_order()
