"""The PyTorch port's flight recorder (``dispatches_tpu_torch.obs.flight``)
held to the JAX package's ``obs.flight``, and its hooks in the port.

- The constants (``TRIGGER_KINDS``, ``DEFAULT_COOLDOWN_S``,
  ``MAX_BUNDLES``, ``TAIL_EVENTS``, ``PLAN_TAIL_EVENTS``).
- One seeded trigger sequence on one fake clock, run through both
  recorders with the same registry activity: the bundles have the same
  keys, kinds, trigger context, metrics diffs, ``plan`` sections and
  convergence tails; the cooldown suppresses the same triggers with the
  same ``suppressed_counts``; pruning under a small ``MAX_BUNDLES`` keeps
  the same survivors.  Bundle names and ``ts_unix`` / ``pid`` (process
  identity) are not compared.
- Counterparts of the JAX package's disarmed-writes-nothing (the
  cooldown clock is never read) and never-raises (``flight.errors``
  counts the swallowed failure) tests.
- The hooks: a ``deadline_miss`` bundle from ``SolveService`` (with the
  ``plan`` section and the bucket's cost card when profiling is on), a
  ``plan_error`` bundle from a failed stage, a ``shed`` bundle, a
  ``plan_hang`` bundle from the fence watchdog and a ``nan_guard``
  bundle from ``analysis.runtime.nan_guard``.
"""

import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu.obs import flight as jfl  # noqa: E402
from dispatches_tpu.obs import registry as jreg  # noqa: E402
from dispatches_tpu.obs import trace as jtrace  # noqa: E402
from dispatches_tpu.obs.soak import FakeClock as JFakeClock  # noqa: E402

from dispatches_tpu_torch.faults import inject as faults  # noqa: E402
from dispatches_tpu_torch.obs import flight as tfl  # noqa: E402
from dispatches_tpu_torch.obs import registry as treg  # noqa: E402
from dispatches_tpu_torch.obs import trace as ttrace  # noqa: E402
from dispatches_tpu_torch.obs.soak import FakeClock, StubNLP, make_stub_solver  # noqa: E402
from dispatches_tpu_torch.serve import ServeOptions, SolveService  # noqa: E402
from torch_isolation import isolated_obs_state  # noqa: E402,F401
from torch_threads import one_torch_thread  # noqa: E402,F401

CPU = "cpu"
EVENTS = "flight.torch_parity.events"


@pytest.fixture(autouse=True)
def _clean():
    for mod in (tfl, jfl):
        mod.reset()
    ttrace.enable(False)
    jtrace.enable(False)
    faults.reset()
    yield
    for mod in (tfl, jfl):
        mod.reset()
    faults.reset()


def test_constants_match_jax():
    for name in ("SCHEMA_VERSION", "MAX_BUNDLES", "TAIL_EVENTS", "PLAN_TAIL_EVENTS",
                 "TRIGGER_KINDS", "DEFAULT_COOLDOWN_S"):
        assert getattr(tfl, name) == getattr(jfl, name), name
    assert tfl.__all__ == jfl.__all__
    assert (tfl.MAX_BUNDLES, tfl.TAIL_EVENTS, tfl.PLAN_TAIL_EVENTS) == (64, 256, 32)


def _sequence(seed, n=40):
    rng = np.random.default_rng(seed)
    kinds = list(jfl.TRIGGER_KINDS) + ["burn_rate"] * 4 + ["shed"] * 3
    out = []
    for i in range(n):
        kind = kinds[int(rng.integers(0, len(kinds)))]
        out.append(dict(
            kind=kind, dt=float(rng.choice([0.0, 1.0, 3.0, 12.0])),
            inc=int(rng.integers(0, 4)),
            kw=dict(request_id=int(rng.integers(0, 100)) if rng.random() < 0.7 else None,
                    bucket="pdlp#0", label=f"serve.pdlp#{i % 2}",
                    params_fingerprint=f"{int(rng.integers(0, 1 << 30)):08x}",
                    solver_options={"kind": "pdlp", "precision": "f32"},
                    detail={"waited_ms": float(rng.exponential(20.0)), "i": i},
                    convergence_tail=([{"row": 0, "gap": 1e-3, "it": 40}]
                                      if rng.random() < 0.3 else None))))
    return out


def _run(fl, reg, clock, directory, seq):
    fl.enable(str(directory))
    fl.set_clock(clock)
    # a counter only this file touches: the default registries outlive a
    # test file, and a JAX test of its own (tests/test_slo_flight.py) fills
    # a "flight.test.events" counter in JAX's registry alone
    ctr = reg.counter(EVENTS, "test events")
    reg.gauge("plan.inflight").set(1.0)
    reg.gauge("serve.queue_depth").set(3.0)
    paths, bundles, suppressed = [], [], []
    for step in seq:
        clock.advance(step["dt"])
        ctr.inc(step["inc"], event=step["kind"])
        path = fl.trigger(step["kind"], **step["kw"])
        paths.append(path)
        # read now: a later trigger may prune it
        bundles.append(None if path is None else fl.load_bundle(path))
        suppressed.append(fl.suppressed_counts())
    return paths, bundles, suppressed, fl.bundles(str(directory))


@pytest.mark.parametrize("seed", [0, 1])
def test_trigger_sequence_equal_jax(tmp_path, monkeypatch, seed):
    for mod in (tfl, jfl):
        monkeypatch.setattr(mod, "MAX_BUNDLES", 6)
    t_p, t_b, t_s, t_list = _run(tfl, treg.default_registry(), FakeClock(), tmp_path / "t",
                                 _sequence(seed))
    j_p, j_b, j_s, j_list = _run(jfl, jreg.default_registry(), JFakeClock(), tmp_path / "j",
                                 _sequence(seed))
    assert [p is None for p in t_p] == [p is None for p in j_p]
    assert t_s == j_s and any(t_s)
    assert sum(p is not None for p in t_p) > 6  # some were pruned
    for tb, jb in zip(t_b, j_b):
        if tb is None:
            continue
        assert list(tb) == list(jb)
        for key in ("schema", "kind", "trigger", "suppressed_since_last", "convergence_tail",
                    "cost_card", "trace_tail", "trace_dropped"):
            assert tb[key] == jb[key], key
        assert tb["plan"] == jb["plan"] == {"inflight": 1.0, "queue_depth": 3.0,
                                            "timeline_tail": []}
        assert tb["metrics"][EVENTS] == jb["metrics"][EVENTS]
        # after the first bundle the diffs cover only this test's activity
        if tb is not next(b for b in t_b if b is not None):
            assert tb["metrics_diff"] == jb["metrics_diff"]
    # the same survivors after pruning, oldest first
    assert len(t_list) == len(j_list) == 6
    strip = lambda bs: [{k: v for k, v in b.items() if k not in ("path", "ts_unix")}  # noqa: E731
                        for b in bs]
    assert strip(t_list) == strip(j_list)
    ident = ("path", "ts_unix", "pid", "metrics", "metrics_diff")
    full = lambda fl, d: [{k: v for k, v in b.items() if k not in ident}  # noqa: E731
                          for b in fl.bundles(str(d), full=True)]
    assert full(tfl, tmp_path / "t") == full(jfl, tmp_path / "j")


def test_disarmed_writes_nothing_and_reads_no_clock(tmp_path, monkeypatch):
    monkeypatch.delenv("DISPATCHES_TPU_OBS_FLIGHT_DIR", raising=False)
    calls = []
    tfl.set_clock(lambda: calls.append(1) or 0.0)
    assert not tfl.enabled()
    assert tfl.trigger("burn_rate") is None and tfl.trigger("deadline_miss", request_id=1) is None
    assert calls == [] and tfl.suppressed_counts() == {}
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setenv("DISPATCHES_TPU_OBS_FLIGHT_DIR", str(tmp_path))
    assert tfl.enabled()
    tfl.enable("")
    assert not tfl.enabled()
    # a disarmed service and sweep hook never reach the bundle writer
    monkeypatch.setattr(tfl, "_write_bundle",
                        lambda *a, **k: (_ for _ in ()).throw(AssertionError("written")))
    svc = SolveService(ServeOptions(max_batch=4, max_wait_ms=1e9), clock=FakeClock(),
                       device=CPU)
    hs = [svc.submit(StubNLP(), solver="pdlp", base_solver=make_stub_solver(),
                     deadline_ms=0.0) for _ in range(4)]
    assert [h.result().status for h in hs] == ["TIMEOUT"] * 4


def test_trigger_never_raises(tmp_path, monkeypatch, caplog):
    tfl.enable(str(tmp_path))
    monkeypatch.setattr(tfl, "_write_bundle",
                        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("disk on fire")))
    errs0 = treg.counter("flight.errors").total()
    with caplog.at_level(logging.DEBUG, logger="dispatches_tpu_torch.obs.flight"):
        assert tfl.trigger("nan_guard") is None
    assert treg.counter("flight.errors").total() == errs0 + 1
    assert any("flight bundle write failed" in r.getMessage() for r in caplog.records)
    # a recorder pointed at a file, not a directory, fails the same way
    monkeypatch.undo()
    blocker = tmp_path / "file"
    blocker.write_text("x")
    tfl.enable(str(blocker / "sub"))
    assert tfl.trigger("quarantine") is None
    assert treg.counter("flight.errors").total() == errs0 + 2


def _kinds(directory):
    return [b["kind"] for b in tfl.bundles(str(directory))]


def test_serve_hooks_write_bundles(tmp_path, monkeypatch):
    from dispatches_tpu_torch.obs import profile

    monkeypatch.setattr(profile, "_ENABLED", None)
    monkeypatch.setattr(ttrace, "_SPAN_HOOK", None)
    monkeypatch.setenv("DISPATCHES_TPU_OBS_PROFILE", "1")
    monkeypatch.setenv("DISPATCHES_TPU_OBS_FLIGHT_DIR", str(tmp_path))
    ttrace.enable(True)
    try:
        clock = FakeClock()
        svc = SolveService(ServeOptions(max_batch=2, max_wait_ms=1e9), clock=clock,
                           device=CPU)
        nlp, solver = StubNLP(), make_stub_solver()
        ok = [svc.submit(nlp, solver="pdlp", base_solver=solver) for _ in range(2)]
        late = svc.submit(nlp, solver="pdlp", base_solver=solver, deadline_ms=1.0)
        clock.advance(0.5)
        svc.flush_all()
        assert [h.result().status for h in ok + [late]] == ["DONE", "DONE", "TIMEOUT"]
        b = tfl.load_bundle(tfl.bundles(str(tmp_path))[-1]["path"])
        assert b["kind"] == "deadline_miss" and b["trigger"]["request_id"] == late.request_id
        assert b["trigger"]["label"] == "serve.pdlp#0"
        assert b["plan"]["queue_depth"] is not None
        assert {e["name"] for e in b["plan"]["timeline_tail"]} >= {"plan.submit", "plan.fence"}
        assert b["cost_card"] is not None and b["cost_card"]["label"] == "serve.pdlp#0"
        # a failed stage: plan_error naming every request of the batch
        faults.arm("serve.stage,times=1")
        bad = [svc.submit(nlp, solver="pdlp", base_solver=solver) for _ in range(2)]
        assert [h.result().status for h in bad] == ["ERROR", "ERROR"]
        faults.reset()
        b = tfl.load_bundle(tfl.bundles(str(tmp_path))[-1]["path"])
        assert b["kind"] == "plan_error"
        assert b["trigger"]["detail"]["request_ids"] == [h.request_id for h in bad]
        # load shedding
        shed = SolveService(ServeOptions(max_batch=8, max_wait_ms=1e9, shed_queue_depth=1),
                            clock=clock, device=CPU)
        hs = [shed.submit(nlp, solver="pdlp", base_solver=solver) for _ in range(2)]
        assert hs[1].status == "SHED"
        assert _kinds(tmp_path) == ["deadline_miss", "plan_error", "shed"]
        shed.flush_all()
    finally:
        ttrace.enable(False)
        ttrace.reset()
        profile.reset()


def test_plan_hang_and_nan_guard_bundles(tmp_path, monkeypatch):
    from dispatches_tpu_torch.analysis.runtime import drain_sanitize_events, nan_guard
    from dispatches_tpu_torch.plan import ExecutionPlan, PlanOptions

    monkeypatch.setenv("DISPATCHES_TPU_OBS_FLIGHT_DIR", str(tmp_path))
    clk = FakeClock()
    plan = ExecutionPlan(PlanOptions(device=CPU, inflight=2, donate=False,
                                     fence_timeout_ms=25.0), clock=clk)
    prog = plan.program(lambda a: a * 2.0, label="flight.toy", vmap_axes=0)
    arr = np.asarray([1.0, 2.0])

    def _restage(idxs):
        rows = arr[list(idxs)]
        return (plan.stage(rows, lanes=len(rows), donate=False),), len(rows), None

    faults.arm("plan.fence,hang_s=5,times=1")
    ticket = plan.submit(prog, (plan.stage(arr, lanes=2, donate=False),), n_live=2, lanes=2,
                         restage=_restage)
    np.testing.assert_allclose(plan.collect(ticket).numpy(), [2.0, 4.0])
    faults.reset()
    b = tfl.load_bundle(tfl.bundles(str(tmp_path))[-1]["path"])
    assert b["kind"] == "plan_hang" and b["trigger"]["label"] == "flight.toy"
    assert b["trigger"]["detail"]["fence_timeout_ms"] == 25.0
    assert b["trigger"]["detail"]["plan"] == plan.plan_id
    monkeypatch.setenv("DISPATCHES_TPU_SANITIZE", "1")
    with pytest.warns(UserWarning, match="non-finite"):
        nan_guard("pdlp.iterate", torch.tensor([1.0, float("nan")]))
    nan_guard("pdlp.clean", torch.ones(3))
    assert drain_sanitize_events() == ["pdlp.iterate"]
    b = tfl.load_bundle(tfl.bundles(str(tmp_path))[-1]["path"])
    assert b["kind"] == "nan_guard" and b["trigger"]["detail"] == {"guard": "pdlp.iterate"}
    assert _kinds(tmp_path) == ["plan_hang", "nan_guard"]
    assert os.path.basename(tfl.bundles(str(tmp_path))[0]["path"]).startswith("flight-")
