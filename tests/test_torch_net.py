"""The PyTorch port's multi-process tier on the CPU: real port worker
processes (``python -m dispatches_tpu_torch.net --worker --device cpu``,
stub model) behind a port ``FleetRouter`` from ``fleet.connect_fleet``.

These run on the real clock, so they assert counts and identities only,
never a latency or a batch size, with generous timeouts (heartbeat 5 s,
request deadlines 60 s):

- 4 threaded submitters through 2 workers with the lock sanitizer on in
  every process: each request ends with exactly one terminal status, all
  DONE, and the lock-order report shows zero inversions, the ``net.*``
  locks among the holds;
- one of 2 workers SIGKILLed with requests open: one failover, nothing
  lost in the re-home from its journal directory, nothing hung;
- 2 workers with ``NET_TRACE`` on both sides and ``OBS_FLEET_EXPORT_DIR``
  set: the merged Chrome trace validates with no negative timestamp or
  duration, every request's journey crosses at least 2 processes (one a
  worker), the hello recorded the worker pids and a clock offset each,
  and the fleet ``metrics.prom`` carries both workers' ``process`` labels;
- the fleet CLI's remote mode (``--workers 2 --trace-export --prom-out``)
  exits 0 with the JAX CLI's keys;
- a worker and the fleet CLI asked for ``cuda`` (their default) on a
  machine without a card raise the device error before any work.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu_torch.analysis import runtime as runtime_mod  # noqa: E402
from dispatches_tpu_torch.fleet import FleetOptions, connect_fleet  # noqa: E402
from dispatches_tpu_torch.obs import distributed as tdist  # noqa: E402
from dispatches_tpu_torch.obs import report as treport  # noqa: E402
from dispatches_tpu_torch.obs import trace as ttrace  # noqa: E402
from dispatches_tpu_torch.obs.soak import StubNLP  # noqa: E402
from torch_isolation import isolated_obs_state  # noqa: E402,F401
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEARTBEAT_MS = 5_000.0
DEADLINE_MS = 60_000.0


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("DISPATCHES_TPU_")}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", PYTHONPATH=ROOT, **extra)
    return env


def _spawn(tmp_path, idx, env, device="cpu"):
    proc = subprocess.Popen(
        [sys.executable, "-m", "dispatches_tpu_torch.net", "--worker", "--port", "0",
         "--journal-dir", str(tmp_path / f"w{idx}"), "--model", "stub", "--max-batch", "8",
         "--max-wait-ms", "5", "--tick-ms", "5", "--device", device],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env, cwd=ROOT)
    ready = json.loads(proc.stdout.readline())
    assert ready.get("ready") and ready.get("port") and ready["pid"] == proc.pid
    return proc, ready["port"]


@pytest.fixture()
def workers(tmp_path):
    procs = []

    def start(n, **env):
        procs.extend(_spawn(tmp_path, i, _env(**env)) for i in range(n))
        return procs

    yield start
    for proc, _ in procs:
        proc.kill()
    for proc, _ in procs:
        proc.wait(timeout=10)


def _params(base, k, i):
    return {"p": {"price": np.asarray(base["p"]["price"]) * (1.0 + 0.01 * k + 0.001 * i)},
            "fixed": {}}


def _drive(router, threads, budget_s=90.0):
    t_end = time.monotonic() + budget_s
    while any(t.is_alive() for t in threads) and time.monotonic() < t_end:
        router.poll()
        time.sleep(0.005)
    for t in threads:
        t.join(timeout=5.0)
    assert not any(t.is_alive() for t in threads), "a submitter is still waiting"


def test_threaded_submitters_two_workers_sanitized(workers, monkeypatch):
    monkeypatch.setenv("DISPATCHES_TPU_SANITIZE", "1")
    runtime_mod.reset_lock_order()
    procs = workers(2, DISPATCHES_TPU_SANITIZE="1")
    router = connect_fleet([("127.0.0.1", port) for _, port in procs],
                           options=FleetOptions(n_replicas=2, heartbeat_timeout_ms=HEARTBEAT_MS,
                                                gossip_interval_s=0.5))
    nlp = StubNLP()
    base = nlp.default_params()
    handles = [[] for _ in range(4)]
    results = [[] for _ in range(4)]
    errors = []

    def submitter(k):
        try:
            for i in range(12):
                handles[k].append(router.submit(nlp, _params(base, k, i), solver="pdlp",
                                                deadline_ms=DEADLINE_MS))
            for h in handles[k]:
                results[k].append(h.result(timeout=60.0))
        except Exception as exc:  # pragma: no cover - diagnostic
            errors.append(exc)

    threads = [threading.Thread(target=submitter, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    _drive(router, threads)
    assert not errors, errors
    flat = [h for hs in handles for h in hs]
    assert len(flat) == 48 and len({(h.bucket_label, h._rid) for h in flat}) == 48
    assert all(h.done() for h in flat)
    assert [r.status for rs in results for r in rs] == ["DONE"] * 48
    m = router.metrics()
    assert m["submitted"] == 48 and m["solved"] == 48 and m["fleet"]["failovers"] == 0
    report = runtime_mod.lock_order_report()
    assert report["inversions"] == [], report["inversions"]
    assert any(name.startswith("net.") for name in report["holds"]), report["holds"]
    router.drain()


def test_sigkill_failover_rehomes_open_requests(workers):
    procs = workers(2)
    router = connect_fleet([("127.0.0.1", port) for _, port in procs],
                           options=FleetOptions(n_replicas=2, heartbeat_timeout_ms=HEARTBEAT_MS,
                                                gossip_interval_s=10.0))
    nlp = StubNLP()
    base = nlp.default_params()
    handles = []
    for i in range(40):
        for attempt in (0, 1):
            try:
                handles.append(router.submit(nlp, _params(base, 0, i), solver="pdlp",
                                             deadline_ms=DEADLINE_MS))
                break
            except Exception:
                if attempt:
                    raise
                router.poll()  # fail-stop containment, then re-route
        if i == 20:
            procs[0][0].send_signal(signal.SIGKILL)
        router.poll()
        time.sleep(0.002)
    t_end = time.monotonic() + 60.0
    while (router.failovers == 0 or not all(h.done() for h in handles)) \
            and time.monotonic() < t_end:
        router.poll()
        try:
            router.flush_all()
        except Exception:
            pass
        time.sleep(0.01)
    assert router.failovers == 1 and router.rehome_lost == 0
    assert sum(not h.done() for h in handles) == 0
    assert all(h.status in ("DONE", "TIMEOUT") for h in handles)
    stats = router.fleet_stats()
    assert stats["alive"] == 1 and stats["bridges_open"] == 0
    assert not stats["per_replica"]["replica-00"]["alive"]


def test_two_worker_trace_merge_and_fleet_export(workers, tmp_path, monkeypatch):
    export_dir = tmp_path / "fleet-export"
    monkeypatch.setenv("DISPATCHES_TPU_OBS_FLEET_EXPORT_DIR", str(export_dir))
    tdist.enable(True)
    ttrace.enable(True)
    procs = workers(2, DISPATCHES_TPU_NET_TRACE="1")
    router = connect_fleet([("127.0.0.1", port) for _, port in procs],
                           options=FleetOptions(n_replicas=2, heartbeat_timeout_ms=HEARTBEAT_MS,
                                                gossip_interval_s=60.0))
    nlp = StubNLP()
    base = nlp.default_params()
    handles = [[] for _ in range(2)]
    errors = []

    def submitter(k):
        try:
            for i in range(8):
                handles[k].append(router.submit(nlp, _params(base, k, i), solver="pdlp",
                                                deadline_ms=DEADLINE_MS))
            for h in handles[k]:
                h.result(timeout=60.0)
        except Exception as exc:  # pragma: no cover - diagnostic
            errors.append(exc)

    threads = [threading.Thread(target=submitter, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    _drive(router, threads)
    assert not errors, errors
    flat = [h for hs in handles for h in hs]
    assert len(flat) == 16 and all(h.done() for h in flat)
    router._exporter.export()
    remotes = router.trace_exports()
    assert len(remotes) == 2
    path = tmp_path / "merged_trace.json"
    tdist.export_merged_trace(path, ttrace.events(), remotes)
    events = treport.load_chrome_trace(path)
    assert treport.validate_chrome_trace(events) == []
    assert all(e.get("ts", 0.0) >= 0.0 and e.get("dur", 0.0) >= 0.0 for e in events)
    stats = router.fleet_stats()["per_replica"]
    worker_pids = {proc.pid for proc, _ in procs}
    assert {per["pid"] for per in stats.values()} == worker_pids
    assert all(per["clock_offset_us"] is not None for per in stats.values())
    for h in flat:
        # keyed by the wire-unique rid: the router's fleet.request and the
        # worker's serve spans carry it as origin_rid, the worker's
        # net.rpc.serve span as its request_id
        pids = treport.journey_processes(events, h._rid)
        assert len(pids) >= 2 and worker_pids & set(pids), (h._rid, pids)
    prom = (export_dir / "metrics.prom").read_text()
    for name, per in stats.items():
        assert f'process="{name}:pid{per["pid"]}"' in prom
    router.drain()


def test_cli_workers_trace_export_and_prom(tmp_path):
    """``python -m dispatches_tpu_torch.fleet --workers 2 --trace-export
    --prom-out --json --device cpu``: exit 0, the JAX CLI's remote-mode
    keys, a valid merged trace from 3 processes, a process-labelled
    exposition."""
    trace, prom = tmp_path / "merged.json", tmp_path / "fleet.prom"
    proc = subprocess.run(
        [sys.executable, "-m", "dispatches_tpu_torch.fleet", "--workers", "2", "--n", "24",
         "--trace-export", str(trace), "--prom-out", str(prom), "--json", "--device", "cpu"],
        capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout)
    # the JAX CLI's multi-replica metrics keys, then what remote mode adds
    assert list(out) == ["submitted", "solved", "timeouts", "errors", "shed", "queue_depth",
                         "flushes", "batches", "compile_count", "programs", "deadline",
                         "warm_start", "fleet", "hung", "fleet_counters", "trace"]
    assert out["hung"] == 0 and out["solved"] == 24 and out["fleet"]["alive"] == 2
    assert out["trace"]["valid"] and out["trace"]["processes"] == 3
    assert treport.validate_chrome_trace(treport.load_chrome_trace(trace)) == []
    labels = {per["pid"] for per in out["fleet"]["per_replica"].values()}
    text = prom.read_text()
    assert all(f':pid{pid}"' in text for pid in labels) and len(labels) == 2


def test_worker_and_cli_on_cuda_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is the right default there")
    from dispatches_tpu_torch.fleet.__main__ import main as fleet_main
    from dispatches_tpu_torch.net.worker import WorkerHost

    for call in (lambda: WorkerHost(), lambda: WorkerHost(device="cuda"),
                 lambda: fleet_main(["--stats"]), lambda: fleet_main(["--workers", "2"])):
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            call()
