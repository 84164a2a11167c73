"""The PyTorch port's fleet tier (``dispatches_tpu_torch.fleet``) held to the
JAX package's ``fleet`` on the CPU, every router on a ``FakeClock`` over
stub replicas (``obs.soak.StubNLP`` and its lane-batched stub solver):

- ``n_replicas == 1`` is a pass-through: bitwise the bare service's
  results, and none of the fleet machinery is touched;
- the same submit sequence gives the same replica choices (the
  power-of-two sampler is ``random.Random(seed)`` in both packages, the
  fingerprints are byte-compatible), the same affinity map, the same
  deadline-slack scores and the same fleet-shed decisions as JAX's router;
  the ``router.submit`` fault site and ``shed_signal`` refuse at the door;
- heartbeat failover: a killed replica is detected only after its
  timeout, its journal re-homed onto the survivors, its orphaned handles
  bridged to terminal statuses, with the same ``fleet_stats`` as JAX's; a
  wedged poll is fail-stop; a fleet with no live replica raises;
- gossip: warm-index entries cross replicas with exact-key dedupe, the
  service-time estimate is adopted cold only, the predictor is adopted
  most-trained-wins and bitwise; the same merge counts as JAX's;
- ``FleetOptions.from_env`` reads JAX's three flags;
- the soak's ``fleet`` section on the chaos-kill spec of
  ``tests/test_fleet.py`` equals JAX's report in every virtual-time field
  (floats to 1e-12 relative) and loses nothing; its bad specs raise JAX's
  ``ValueError``s;
- ``python -m dispatches_tpu_torch.fleet --stats --json --device cpu``
  prints the JAX CLI's keys and values.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dispatches_tpu.fleet as jfleet  # noqa: E402
from dispatches_tpu import plan as jplan  # noqa: E402
from dispatches_tpu import serve as jserve  # noqa: E402
from dispatches_tpu.faults import inject as jfaults  # noqa: E402
from dispatches_tpu.obs import soak as jsoak  # noqa: E402

import dispatches_tpu_torch.fleet as tfleet  # noqa: E402
from dispatches_tpu_torch import plan as tplan  # noqa: E402
from dispatches_tpu_torch import serve as tserve  # noqa: E402
from dispatches_tpu_torch.faults import inject as tfaults  # noqa: E402
from dispatches_tpu_torch.obs import soak as tsoak  # noqa: E402
from torch_isolation import isolated_obs_state  # noqa: E402,F401
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-12
CHAOS_KILL = {  # tests/test_fleet.py:test_fleet_soak_chaos_kill_loses_nothing
    "traffic": {"rate_rps": 120.0, "duration_s": 2.0, "seed": 3, "deadline_ms": 2000.0},
    "service": {"max_batch": 4, "max_wait_ms": 10.0, "inflight": 2},
    "service_time": {"base_ms": 5.0, "per_lane_ms": 0.5, "jitter_ms": 0.5},
    "fleet": {"n_replicas": 3, "kill": [[0, 1.0]], "heartbeat_timeout_ms": 150.0,
              "gossip_interval_s": 0.5},
}

PORT = types.SimpleNamespace(
    fleet=tfleet, plan=tplan, serve=tserve, faults=tfaults, soak=tsoak,
    plan_kw={"device": "cpu"}, solver=tsoak.make_stub_solver(),
    warm_solver=tsoak.make_stub_solver(warm=True))
JAX = types.SimpleNamespace(
    fleet=jfleet, plan=jplan, serve=jserve, faults=jfaults, soak=jsoak, plan_kw={},
    solver=jsoak.make_stub_solver(), warm_solver=jsoak.make_stub_solver(warm=True))


@pytest.fixture(autouse=True)
def _fleet_env(monkeypatch):
    for flag in ("SERVE_JOURNAL_DIR", "OBS_FLIGHT_DIR", "OBS_FLEET_EXPORT_DIR", "FLEET_REPLICAS",
                 "FLEET_HEARTBEAT_MS", "FLEET_GOSSIP_INTERVAL_S"):
        monkeypatch.delenv(f"DISPATCHES_TPU_{flag}", raising=False)


def _service(pkg, clock, warm=False, **kw):
    plan = pkg.plan.ExecutionPlan(pkg.plan.PlanOptions(inflight=2, **pkg.plan_kw))
    return pkg.serve.SolveService(pkg.serve.ServeOptions(
        max_batch=4, max_wait_ms=5.0, warm_start=warm, plan=plan), clock=clock, **kw)


def _router(pkg, n, clock, *, durable_dir=None, warm=False, **opt_kw):
    def make_service(replica_id, journal_dir):
        return _service(pkg, clock, warm=warm, journal_dir=journal_dir)

    return pkg.fleet.FleetRouter(pkg.fleet.FleetOptions(n_replicas=n, **opt_kw), clock=clock,
                                 make_service=make_service, durable_dir=durable_dir)


def _params(nlp, i):
    p = nlp.default_params()
    p["p"]["price"] = p["p"]["price"] * (1.0 + 0.01 * i)
    return p


def _submit(pkg, target, nlp, i, **kw):
    return target.submit(nlp, _params(nlp, i), solver="pdlp", base_solver=pkg.solver, **kw)


def _outcome(h):
    r = h.result()
    return (h.request_id, h.bucket_label, r.status, r.obj if r.obj is None else float(r.obj))


def _same_runs(t, j):
    """Two runs' records equal, objectives to ``RTOL`` (the stub sums a
    lane axis in torch and one scenario in JAX: the last bit may differ)."""
    _equal(json.loads(json.dumps(t)), json.loads(json.dumps(j)))


def test_api_matches_jax():
    assert tfleet.__all__ == jfleet.__all__
    assert tfleet.FleetOptions() == tfleet.FleetOptions(**jfleet.FleetOptions().__dict__)
    from dispatches_tpu.fleet import router as jr, replica as jrep, gossip as jg
    from dispatches_tpu_torch.fleet import router as tr, replica as trep, gossip as tg

    assert (tr._SLACK_PENALTY, tr._AFFINITY_MAX) == (jr._SLACK_PENALTY, jr._AFFINITY_MAX)
    assert trep.DEFAULT_HEARTBEAT_TIMEOUT_MS == jrep.DEFAULT_HEARTBEAT_TIMEOUT_MS
    assert tg.DEFAULT_INTERVAL_S == jg.DEFAULT_INTERVAL_S


def test_single_replica_is_a_bitwise_pass_through(monkeypatch):
    nlp = tsoak.StubNLP()
    clk = tsoak.FakeClock()
    bare, router = _service(PORT, clk), _router(PORT, 1, clk)
    pairs = []
    for i in range(9):
        pairs.append((_submit(PORT, bare, nlp, i), _submit(PORT, router, nlp, i)))
        clk.advance(0.002)
        bare.poll()
        router.poll()
    assert bare.flush_all() == router.flush_all()
    for hb, hf in pairs:
        rb, rf = hb.result(), hf.result()
        assert rb.status == rf.status == "DONE" and hb.request_id == hf.request_id
        assert rb.obj == rf.obj
        for field in rb.result._fields:
            a, b = getattr(rb.result, field), getattr(rf.result, field)
            assert a.dtype == b.dtype and torch.equal(a, b), field
    mb, mf = bare.metrics(), router.metrics()
    for key in ("submitted", "solved", "errors", "shed", "batches", "flushes", "queue_depth"):
        assert mb[key] == mf[key], key
    assert mf["fleet"]["n_replicas"] == 1

    def _boom(*a, **kw):
        raise AssertionError("fleet machinery touched in single mode")

    monkeypatch.setattr(tfleet.Gossip, "__init__", _boom)
    monkeypatch.setattr(tfleet.ReplicaHandle, "heartbeat", _boom)
    router = _router(PORT, 1, clk)
    assert router._gossip is None and router.durable_dir is None
    h = _submit(PORT, router, nlp, 0)
    clk.advance(0.01)
    router.poll()
    router.flush_all()
    assert h.done() and h.result().status == "DONE"
    assert router._tracked == {} and router._bridges == [] and router.replicas[0].beats == 0


def _routing_run(pkg):
    nlp = pkg.soak.StubNLP()
    clk = pkg.soak.FakeClock()
    router = _router(pkg, 3, clk)
    handles = []
    for i in range(30):
        handles.append(_submit(pkg, router, nlp, i % 24, deadline_ms=None if i % 3 else 50.0))
        if i % 7 == 6:
            clk.advance(0.004)
            router.poll()
    router.flush_all()
    # affinity: repeats of one fingerprint land on one replica
    for _ in range(5):
        _submit(pkg, router, nlp, 5)
    router.flush_all()
    per = {r.name: r.metrics()["submitted"] for r in router.replicas}
    # slack arithmetic on replica 0's own estimate
    replica = router.replicas[0]
    bucket = next(iter(replica.service._buckets.values()))
    for _ in range(64):  # the virtual replay solves in zero time: teach 100 ms
        bucket.est.observe_ms(100.0)
    est = replica.est_service_s()
    assert est > 0.0
    scores = [router._score(replica, d, clk()) for d in (est * 1e6, est * 1e3 / 2.0, None)]
    return {"affinity": dict(router._affinity), "per": per, "scores": scores,
            "outcomes": [_outcome(h) for h in handles], "fleet": router.fleet_stats()}


def test_routing_choices_affinity_and_slack_equal_jax():
    t, j = _routing_run(PORT), _routing_run(JAX)
    _same_runs(t, j)
    assert all(n > 0 for n in t["per"].values()) and sum(t["per"].values()) == 35
    assert t["scores"][0] == t["scores"][2] and t["scores"][1] >= 1e6


def _shed_run(pkg):
    nlp = pkg.soak.StubNLP()
    clk = pkg.soak.FakeClock()
    router = _router(pkg, 2, clk, shed_queue_depth=3)
    handles = [_submit(pkg, router, nlp, i) for i in range(40)]
    statuses = [h.status for h in handles]
    shed = [h for h in handles if h.status == "SHED"]
    assert shed and all(h.done() and h.request_id < 0 and h.bucket_label == "fleet" for h in shed)
    router.flush_all()
    assert all(h.done() for h in handles)
    out = {"statuses": statuses, "shed": router.metrics()["shed"]}
    router = _router(pkg, 2, clk)
    pkg.faults.arm("router.submit,p=1.0,times=1")
    try:
        out["fault"] = [_submit(pkg, router, nlp, i).status for i in range(2)]
    finally:
        pkg.faults.reset()
    router.shed_signal = lambda: True
    out["signal"] = [_submit(pkg, router, nlp, 2).status]
    router.shed_signal = None
    out["signal"].append(_submit(pkg, router, nlp, 3).status)
    return out


def test_fleet_shed_fault_site_and_shed_signal_equal_jax():
    t, j = _shed_run(PORT), _shed_run(JAX)
    assert t == j
    assert t["fault"][0] == "SHED" != t["fault"][1]
    assert t["signal"][0] == "SHED" != t["signal"][1]


def _failover_run(pkg, root):
    nlp = pkg.soak.StubNLP()
    clk = pkg.soak.FakeClock()
    router = _router(pkg, 3, clk, durable_dir=str(root), heartbeat_timeout_ms=250.0)
    handles = [_submit(pkg, router, nlp, i) for i in range(12)]
    victim = max(router.replicas, key=lambda r: r.queue_depth())
    open_before = victim.queue_depth()
    assert open_before > 0
    orphans = [h for h in handles if not h.done()
               and (victim.replica_id, h.request_id) in router._tracked]
    router.kill(victim.replica_id)
    router.poll()
    assert router.failovers == 0  # detection waits for the timeout
    clk.advance(0.3)
    router.poll()
    assert router.failovers == 1 and victim.failed_over
    assert router.rehomed >= open_before and router.rehome_lost == 0
    router.flush_all()
    router.poll()
    assert all(h.done() for h in handles)
    assert all(h.result().status == "DONE" for h in orphans)
    clk.advance(1.0)
    router.poll()
    assert router.failovers == 1  # a journal is re-homed at most once
    stats = router.fleet_stats()
    assert stats["alive"] == 2 and stats["bridges_open"] == 0
    # a wedged poll is fail-stop, then failed over; the survivor serves
    router2 = _router(pkg, 2, clk, durable_dir=str(root / "w"), heartbeat_timeout_ms=100.0)
    wedged = router2.replicas[0]

    def _wedged(now=None):
        raise RuntimeError("wedged")

    wedged.service.poll = _wedged
    router2.poll()
    assert not wedged.alive
    clk.advance(0.2)
    router2.poll()
    h = _submit(pkg, router2, nlp, 0)
    router2.flush_all()
    for replica in router2.replicas:
        router2.kill(replica.replica_id)
    with pytest.raises(RuntimeError, match="no live replicas"):
        _submit(pkg, router2, nlp, 1)
    return {"victim": victim.replica_id, "orphans": len(orphans), "stats": stats,
            "outcomes": [_outcome(x) for x in handles], "wedged": router2.failovers,
            "survivor": _outcome(h)}


def test_failover_rehome_bridges_and_stats_equal_jax(tmp_path):
    t = _failover_run(PORT, tmp_path / "t")
    j = _failover_run(JAX, tmp_path / "j")
    _same_runs(t, j)
    assert t["orphans"] > 0 and t["wedged"] == 1 and t["survivor"][2] == "DONE"


def _gossip_run(pkg):
    nlp = pkg.soak.StubNLP()
    clk = pkg.soak.FakeClock()
    router = _router(pkg, 2, clk, warm=True, gossip_interval_s=1.0, affinity=False)
    opts = {"warm_contract": True, "warm_dims": (nlp.n, 1)}
    donor, recipient = (r.service for r in router.replicas)
    for i in range(4):
        donor.submit(nlp, _params(nlp, i), solver="pdlp", base_solver=pkg.warm_solver,
                     options=dict(opts))
    donor.flush_all()
    recipient.submit(nlp, _params(nlp, 99), solver="pdlp", base_solver=pkg.warm_solver,
                     options=dict(opts))
    recipient.flush_all()
    sizes = [s.metrics()["warm_start"]["size"] for s in (donor, recipient)]
    merged = [router._gossip.exchange(), router._gossip.exchange()]
    sizes.append(recipient.metrics()["warm_start"]["size"])
    # cold-only estimate adoption through the stash of an unformed bucket
    router = _router(pkg, 2, clk, affinity=False)
    donor, recipient = (r.service for r in router.replicas)
    _submit(pkg, donor, nlp, 0)
    donor.flush_all()
    label = next(iter(donor._buckets.values())).stats.label
    router._gossip.exchange()
    stashed = label in recipient._restored_buckets
    _submit(pkg, recipient, nlp, 1)
    bucket = next(iter(recipient._buckets.values()))
    own = bucket.est.samples
    recipient.flush_all()
    return {"sizes": sizes, "merged": merged, "stashed": stashed, "adopted_samples": own,
            "after": bucket.est.samples, "stats": router.fleet_stats()}


def test_gossip_index_and_estimate_adoption_equal_jax():
    t, j = _gossip_run(PORT), _gossip_run(JAX)
    _same_runs(t, j)
    assert t["merged"][0] > 0 and t["merged"][1] == 0 and t["sizes"][2] > 1
    assert t["stashed"] and 0 < t["adopted_samples"] < t["after"]


def _predictor_run(pkg, fit, params_of):
    nlp = pkg.soak.StubNLP()
    clk = pkg.soak.FakeClock()
    router = _router(pkg, 2, clk, warm=True, gossip_interval_s=1.0, affinity=False)
    opts = {"warm_contract": True, "warm_dims": (nlp.n, 1)}
    donor, recipient = (r.service for r in router.replicas)
    for svc, i in ((donor, 0), (recipient, 1)):
        svc.submit(nlp, _params(nlp, i), solver="pdlp", base_solver=pkg.warm_solver,
                   options=dict(opts))
        svc.flush_all()
    db = next(iter(donor._buckets.values()))
    rb = next(iter(recipient._buckets.values()))
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((16, 4)).astype(np.float32)
    xs = rng.standard_normal((16, nlp.n)).astype(np.float32)
    zs = rng.standard_normal((16, 1)).astype(np.float32)
    first = fit(vecs, xs, zs)
    db.predict_trainer.adopt(first, trained_samples=16)
    ready = rb.predict_trainer.ready()
    router._gossip.exchange()
    trained = [rb.predict_trainer.trained_samples]
    same = all(params_of(first)[k].tobytes() == params_of(rb.predict_trainer.predictor)[k].tobytes()
               for k in params_of(first))
    staged = rb.predict_weights is not None
    better = fit(vecs, xs + 1.0, zs)
    rb.predict_trainer.adopt(better, trained_samples=32)
    router._gossip.exchange()
    trained.append(db.predict_trainer.trained_samples)
    back = all(params_of(better)[k].tobytes() == params_of(db.predict_trainer.predictor)[k].tobytes()
               for k in params_of(better))
    router._gossip.exchange()
    trained += [db.predict_trainer.trained_samples, rb.predict_trainer.trained_samples]
    return {"ready_before": ready, "trained": trained, "same": same, "staged": staged,
            "back": back}


def test_gossip_predictor_most_trained_wins_equal_jax():
    from dispatches_tpu.learn import fit as jfit
    from dispatches_tpu_torch.learn import fit as tfit

    t = _predictor_run(PORT, lambda v, x, z: tfit(v, x, z, hidden=4, epochs=20, device="cpu"),
                       lambda p: {k: np.asarray(v) for k, v in p.params.items()})
    j = _predictor_run(JAX, lambda v, x, z: jfit(v, x, z, hidden=4, epochs=20),
                       lambda p: {k: np.asarray(v) for k, v in p.params.items()})
    assert t == j
    assert t == {"ready_before": False, "trained": [16, 32, 32, 32], "same": True,
                 "staged": True, "back": True}


def test_fleet_options_from_env_equal_jax(monkeypatch):
    monkeypatch.setenv("DISPATCHES_TPU_FLEET_REPLICAS", "3")
    monkeypatch.setenv("DISPATCHES_TPU_FLEET_HEARTBEAT_MS", "125.5")
    monkeypatch.setenv("DISPATCHES_TPU_FLEET_GOSSIP_INTERVAL_S", "2.5")
    t = tfleet.FleetOptions.from_env()
    assert t.__dict__ == jfleet.FleetOptions.from_env().__dict__
    assert (t.n_replicas, t.heartbeat_timeout_ms, t.gossip_interval_s) == (3, 125.5, 2.5)
    assert tfleet.FleetOptions.from_env(n_replicas=1).n_replicas == 1


def _virtual(report):
    out = json.loads(json.dumps(report, default=str))
    out.pop("report_path", None)
    tl = out["timeline"]
    out["timeline"] = None if tl is None else {"keys": sorted(tl), "n_batches": tl["n_batches"]}
    return out


def _equal(got, want, path=()):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _equal(got[k], want[k], path + (k,))
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, path + (i,))
    elif isinstance(want, float):
        assert isinstance(got, float) and got == pytest.approx(want, rel=RTOL, abs=0.0), path
    else:
        assert got == want and type(got) is type(want), path


def test_fleet_soak_chaos_kill_equals_jax_and_loses_nothing():
    t = tsoak.run_soak(json.loads(json.dumps(CHAOS_KILL)), device="cpu")
    j = jsoak.run_soak(json.loads(json.dumps(CHAOS_KILL)))
    _equal(_virtual(t), _virtual(j))
    fleet, c = t["fleet"], t["requests"]
    assert fleet["enabled"] and fleet["n_replicas"] == 3 and fleet["alive"] == 2
    assert fleet["failovers"] == 1 and fleet["rehomed"] > 0 and fleet["rehome_lost"] == 0
    assert c["hung"] == 0 and fleet["replica_lost_request_rate"] == 0.0
    assert t["replica_lost_request_rate"] == 0.0
    assert c["done"] + c["timeout"] + c["error"] + c["shed"] == c["submitted"]
    assert "fleet: 2/3 replicas alive, 1 killed, 1 failover(s)" in tsoak.format_soak_report(t)


def test_fleet_soak_rejects_bad_specs():
    with pytest.raises(ValueError, match="virtual"):
        tsoak.run_soak({"traffic": {"rate_rps": 10.0, "duration_s": 0.1},
                        "fleet": {"n_replicas": 2}}, virtual=False, device="cpu")
    with pytest.raises(ValueError, match="mutually"):
        tsoak.run_soak({"traffic": {"rate_rps": 10.0, "duration_s": 0.1},
                        "fleet": {"n_replicas": 2},
                        "restart": {"enabled": True, "crash_at_s": 0.05}}, device="cpu")


def test_cli_stats_json_equals_jax(capsys):
    from dispatches_tpu.fleet.__main__ import main as jax_main

    env = {k: v for k, v in os.environ.items() if not k.startswith("DISPATCHES_TPU_")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-m", "dispatches_tpu_torch.fleet", "--stats", "--json",
                           "--device", "cpu"], capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout)
    assert jax_main(["--stats", "--json"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert list(got) == list(want) and got == want
    assert got["hung"] == 0 and got["fleet"]["n_replicas"] == 2
