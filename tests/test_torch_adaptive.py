"""The PyTorch port's adaptive in-flight depth controller
(``dispatches_tpu_torch.plan.adaptive``) held to the JAX package's on the
same span streams, and wired into the port's plan.

The controller is host Python with the JAX package's arithmetic, so the
comparisons are exact: the same ``depth`` after every ingested span and
the same ``decisions`` counts, for

- tests/test_plan.py's shapes: growth on fence dominance capped at
  ``max_inflight``, multiplicative shrink on host dominance floored at 1,
  ``on_backoff``, and growth gated by ``mem_budget_bytes``;
- seeded streams at several ``decide_every`` / ``dominance`` settings,
  with backoffs between spans;
- the span stream a port plan with ``inflight_max`` records under a
  ``FakeClock`` (the tracer's clock and the fences' device time both
  come from it): the plan's own trajectory, a fresh port controller's
  replay and JAX's replay agree, and the plan's window follows the depth.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu.plan.adaptive import InflightDepthController as JCtrl  # noqa: E402

from dispatches_tpu_torch.obs import registry as treg  # noqa: E402
from dispatches_tpu_torch.obs import trace as ttrace  # noqa: E402
from dispatches_tpu_torch.plan import ExecutionPlan, PlanOptions  # noqa: E402
from dispatches_tpu_torch.plan.adaptive import InflightDepthController as TCtrl  # noqa: E402
from test_torch_stacked import one_torch_thread  # noqa: E402,F401


def _ev(name, ts, dur, plan=1):
    return {"name": name, "ph": "X", "ts": float(ts), "dur": float(dur),
            "args": {"plan": plan}}


def _lifecycle(base, host_us, fence_us):
    """One stage -> submit -> fence round starting at ``base`` (us)."""
    return [_ev("plan.stage", base, host_us),
            _ev("plan.submit", base + host_us, 5.0),
            _ev("plan.fence", base + host_us + 5.0, fence_us)]


def _pair(**kw):
    kw.setdefault("plan", 1)
    kw.setdefault("gauges", False)
    return JCtrl(**kw), TCtrl(**kw)


def _drive(pair, events, backoff_at=()):
    """Feed both controllers; returns the depth trajectory, asserting the
    two agree after every span."""
    j, t = pair
    trail = []
    for i, ev in enumerate(events):
        if i in backoff_at:
            j.on_backoff()
            t.on_backoff()
        j.ingest(ev)
        t.ingest(ev)
        assert t.depth == j.depth, i
        assert t.decisions == j.decisions, i
        trail.append(t.depth)
    assert t.acc.stalls() == j.acc.stalls()
    return trail


def test_grows_on_fence_dominance_and_caps():
    pair = _pair(base=2, max_inflight=4, decide_every=1)
    events = [e for k in range(3) for e in _lifecycle(k * 1e4, 10.0, 5000.0)]
    trail = _drive(pair, events)
    assert trail[2::3] == [3, 4, 4]
    assert pair[1].decisions == {"grow": 2, "shrink": 0, "hold": 1}


def test_shrinks_multiplicatively_and_floors_at_one():
    pair = _pair(base=4, max_inflight=8, decide_every=1)
    events = [e for k in range(3) for e in _lifecycle(k * 1e4, 5000.0, 10.0)]
    assert _drive(pair, events)[2::3] == [2, 1, 1]


def test_backoff_shrinks_immediately():
    j, t = _pair(base=8, max_inflight=8)
    for _ in range(4):
        j.on_backoff()
        t.on_backoff()
        assert (t.depth, t.decisions) == (j.depth, j.decisions)
    assert t.depth == 1 and t.decisions == {"grow": 0, "shrink": 3, "hold": 1}


@pytest.mark.parametrize("peak", [60.0, 30.0, None], ids=["over", "under", "unknown"])
def test_memory_budget_gates_growth(peak):
    pair = _pair(base=2, max_inflight=8, decide_every=1, mem_budget_bytes=100,
                 peak_bytes_fn=lambda: peak)
    trail = _drive(pair, _lifecycle(0.0, 10.0, 5000.0))
    # 3 slots x 60 bytes break the 100-byte budget; 3 x 30 do not; an
    # unknown peak (profiling off) leaves growth unconstrained
    assert trail[-1] == {60.0: 2, 30.0: 3, None: 3}[peak]


@pytest.mark.parametrize("decide_every,dominance,seed",
                         [(2, 2.0, 5), (1, 1.5, 6), (3, 4.0, 7)])
def test_seeded_streams_replay_to_the_same_trajectory(decide_every, dominance, seed):
    rng = np.random.default_rng(seed)
    events, t = [], 0.0
    for _ in range(40):
        events.extend(_lifecycle(t, host_us=float(rng.uniform(5, 3000)),
                                 fence_us=float(rng.uniform(5, 5000))))
        t += 10_000.0
    backoffs = set(rng.choice(len(events), size=3, replace=False).tolist())
    trail = _drive(_pair(base=2, max_inflight=6, decide_every=decide_every,
                         dominance=dominance), events, backoff_at=backoffs)
    assert min(trail) >= 1 and max(trail) <= 6 and len(set(trail)) > 1


def test_gauges_publish_like_jax():
    reg = treg.MetricsRegistry()
    t = TCtrl(base=2, max_inflight=4, plan=3, decide_every=1, registry=reg)
    for ev in _lifecycle(0.0, 10.0, 5000.0):
        ev["args"]["plan"] = 3
        t.ingest(ev)
    snap = reg.snapshot()
    assert snap["plan.adaptive.inflight"]["values"] == {"plan=3": 3.0}
    assert snap["plan.adaptive.decisions"]["values"] == {"direction=grow,plan=3": 1.0}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, seconds):
        self.t += seconds


class _DeviceTime:
    """A completion probe whose wait takes ``seconds`` of the fake clock:
    the batch's device time, seen by the fence."""

    def __init__(self, clock, seconds):
        self.clock, self.seconds = clock, seconds

    def query(self):
        return False

    def synchronize(self):
        self.clock.advance(self.seconds)


def test_port_plan_with_inflight_max_under_a_fake_clock(monkeypatch):
    clock = FakeClock()
    host = {"s": 1e-4}  # host time between two reads of the tracer's clock

    def now_us():
        clock.advance(host["s"])
        return clock.t * 1e6

    monkeypatch.setattr(ttrace, "now_us", now_us)
    rng = np.random.default_rng(11)
    plan = ExecutionPlan(PlanOptions(device="cpu", donate=False, inflight=2,
                                     inflight_max=5), clock=clock)
    device_s = iter(np.concatenate([rng.uniform(0.02, 0.05, 16),     # fence-bound
                                    rng.uniform(1e-5, 1e-4, 16)]))   # host-bound
    plan._marker = lambda device=None: _DeviceTime(clock, float(next(device_s)))
    work = {"s": 0.0}  # host time of the program's own dispatch

    def kernel(p):
        clock.advance(work["s"])
        return p["a"] * 2.0

    prog = plan.program(kernel, label="adaptive.rec", donate_argnums=())
    seen, trail, limits = [], [], []
    ingest = plan.controller.ingest

    def record(ev):
        seen.append(ev)
        ingest(ev)
        trail.append(plan.controller.depth)

    plan.controller.ingest = record
    for k in range(32):
        host["s"], work["s"] = (1e-4, 0.0) if k < 16 else (0.01, 0.05)
        staged = plan.stage({"a": rng.random((4, 2))}, lanes=4)
        ticket = plan.submit(prog, (staged,), n_live=4, lanes=4)
        limits.append(plan.inflight_limit)
        assert plan.inflight <= plan.inflight_limit
        if k >= 16:  # a synchronous caller: the device waits on the host
            plan.collect(ticket)
    plan.drain()
    assert limits == [max(d, 1) for d in limits] and max(limits) > 2
    assert trail[-1] < max(trail)  # grew while fence-bound, shrank after
    # the recorded spans replay to the same trajectory, in both packages
    for Ctrl in (TCtrl, JCtrl):
        fresh = Ctrl(base=2, max_inflight=5, plan=plan.plan_id, gauges=False)
        replay = []
        for ev in seen:
            fresh.ingest(ev)
            replay.append(fresh.depth)
        assert replay == trail
        assert fresh.decisions == plan.controller.decisions
