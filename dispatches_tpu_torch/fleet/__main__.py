"""CLI: ``python -m dispatches_tpu_torch.fleet --stats [--json]``
(counterpart of ``dispatches_tpu/fleet/__main__.py``).

Default mode drives a small self-contained demo workload through a
multi-replica :class:`~dispatches_tpu_torch.fleet.FleetRouter` on a virtual
clock (the stub model — one tiny lane-batched program) and
prints the fleet-tier operator view: aggregate counters plus the
per-replica routing/health block (``fleet_stats``).  With ``--json``
the raw metrics dict is printed instead (one JSON line, BENCH-style).

``--workers N`` (or ``--endpoints host:port,...``) runs the same
workload across REAL worker processes over the wire, and unlocks the
fleet telemetry rollup:

* ``--trace-export PATH`` — arm wire-level tracing
  (``DISPATCHES_TPU_NET_TRACE``) on both sides, pull every live
  replica's trace ring (``trace_export`` RPC), clock-align it onto the
  router's tracer epoch and write ONE merged Chrome trace with
  per-process ``pid`` rows; the merged file is validated with
  ``report.validate_chrome_trace`` before exit.
* ``--prom-out PATH`` — write one merged Prometheus exposition: the
  router's own registry followed by every replica's snapshot
  (``metrics_snapshot`` RPC), process-labeled.
* ``--stats`` gains per-method RPC latency lines (the ``net.rpc_ms``
  histogram), summed remote counters and per-replica worker identity
  (pid / endpoint / clock offset).

Everything runs on ``--device`` (``cuda`` unless the caller asks for the
CPU; the spawned workers get the same flag).  The JAX package's CI
smoke-runs its demo mode and the 2-worker ``--trace-export`` path; the
port's tests and ``chip_smoke.py`` run both here.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from typing import List, Optional, Sequence, Tuple


def _render_text(metrics: dict) -> str:
    fleet = metrics["fleet"]
    lines = [
        "fleet stats",
        "===========",
        f"replicas          {fleet['alive']}/{fleet['n_replicas']} alive",
        f"submitted         {metrics['submitted']}",
        f"solved            {metrics['solved']}",
        f"timeouts          {metrics['timeouts']}",
        f"errors            {metrics['errors']}",
        f"shed              {metrics['shed']} "
        f"(fleet rung: {fleet['fleet_shed']})",
        f"queue depth       {metrics['queue_depth']}",
        f"batches           {metrics['batches']}",
        f"programs          {metrics['programs']} "
        f"(compiles: {metrics['compile_count']})",
        f"failovers         {fleet['failovers']} "
        f"(rehomed: {fleet['rehomed']}, lost: {fleet['rehome_lost']})",
    ]
    gossip = fleet.get("gossip")
    if gossip is not None:
        lines.append(f"gossip            {gossip['exchanges']} rounds, "
                     f"{gossip['entries_merged']} entries merged")
    warm = metrics.get("warm_start")
    if warm is not None:
        lines.append(f"warm-start        hit rate "
                     f"{warm['hit_rate']:.2f} (size {warm['size']})")
    lines.extend(_rpc_latency_lines())
    lines.append("")
    lines.append("per replica")
    lines.append("-----------")
    for name, per in fleet["per_replica"].items():
        state = "alive" if per["alive"] else "dead"
        line = (
            f"{name:<14} {state:<6} gen {per['generation']} "
            f"beats {per['beats']} (lost {per['beats_lost']}) "
            f"submitted {per['submitted']} solved {per['solved']} "
            f"depth {per['queue_depth']}")
        if per.get("pid") is not None:
            off = per.get("clock_offset_us")
            line += (f"  [pid {per['pid']} @ {per.get('endpoint')}"
                     + (f", clock {off:+.0f} us" if off is not None else "")
                     + "]")
        lines.append(line)
    return "\n".join(lines)


def _rpc_latency_lines() -> List[str]:
    """Per-method RPC latency from the local ``net.rpc_ms`` histogram
    (empty in demo mode — no RPCs were issued)."""
    from dispatches_tpu_torch.obs import registry as obs_registry

    snap = obs_registry.default_registry().snapshot()
    entry = snap.get("net.rpc_ms")
    if not entry or not entry.get("values"):
        return []
    lines = ["", "rpc latency (client-observed, ms)",
             "---------------------------------"]
    for label, summary in sorted(entry["values"].items()):
        method = label.partition("=")[2] or label
        lines.append(
            f"{method:<14} n {int(summary.get('count', 0)):<6} "
            f"p50 {summary.get('p50', 0.0):8.3f}  "
            f"p95 {summary.get('p95', 0.0):8.3f}  "
            f"p99 {summary.get('p99', 0.0):8.3f}")
    return lines


def _remote_counter_lines(summed: dict) -> List[str]:
    """The fleet-summed cross-process counters worth an operator's
    glance (full detail lives in ``--prom-out``)."""
    picks = ("serve.requests", "net.rpc.calls", "net.bytes",
             "net.retries", "net.connects")
    lines: List[str] = []
    for name in picks:
        series = summed.get(name)
        if not series:
            continue
        total = sum(series.values())
        lines.append(f"{name:<16} {total:12.0f}  "
                     + "  ".join(f"{lbl or 'total'}={val:.0f}"
                                 for lbl, val in sorted(series.items())))
    if lines:
        lines = ["", "fleet counters (summed across processes)",
                 "----------------------------------------"] + lines
    return lines


def _parse_endpoints(raw: str) -> List[Tuple[str, int]]:
    eps = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        eps.append((host or "127.0.0.1", int(port)))
    return eps


def _spawn_workers(n: int, root: str, *, max_batch: int,
                   trace: bool, device: str = "cuda"
                   ) -> Tuple[List, List[Tuple[str, int]]]:
    env = dict(os.environ)
    if trace:
        env["DISPATCHES_TPU_NET_TRACE"] = "1"
    procs = []
    eps: List[Tuple[str, int]] = []
    for i in range(n):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dispatches_tpu_torch.net", "--worker",
             "--port", "0", "--journal-dir", os.path.join(root, f"w{i}"),
             "--model", "stub", "--max-batch", str(max_batch),
             "--max-wait-ms", "5", "--tick-ms", "5", "--device", device],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True, env=env))
    for p in procs:
        ready = json.loads(p.stdout.readline())
        if not ready.get("ready"):
            raise RuntimeError(f"worker failed to start: {ready}")
        eps.append(("127.0.0.1", ready["port"]))
    return procs, eps


def _run_demo(ns) -> int:
    import numpy as np

    from dispatches_tpu_torch.fleet import FleetOptions, FleetRouter
    from dispatches_tpu_torch.obs.soak import FakeClock, StubNLP, make_stub_solver
    from dispatches_tpu_torch.serve.service import ServeOptions, SolveService

    clock = FakeClock()
    options = FleetOptions(n_replicas=ns.replicas, gossip_interval_s=0.5)

    def make_service(replica_id, journal_dir):
        return SolveService(ServeOptions(max_batch=ns.max_batch,
                                         max_wait_ms=5.0),
                            clock=clock, journal_dir=journal_dir,
                            device=ns.device)

    router = FleetRouter(options, clock=clock, make_service=make_service)
    nlp = StubNLP()
    base_solver = make_stub_solver()
    base = nlp.default_params()
    handles = []
    for i in range(ns.n):
        params = {"p": {"price": np.asarray(base["p"]["price"])
                        * (1.0 + 0.001 * i)},
                  "fixed": {}}
        handles.append(router.submit(nlp, params, solver="pdlp",
                                     base_solver=base_solver))
        clock.advance(0.01)
        router.poll()
    router.flush_all()
    router.poll()
    metrics = router.metrics()
    hung = sum(1 for h in handles if not h.done())
    if ns.json:
        metrics["hung"] = hung
        print(json.dumps(metrics, default=str))
    else:
        print(_render_text(metrics))
        if hung:
            print(f"\nWARNING: {hung} handles never reached a "
                  "terminal status")
    return 1 if hung else 0


def _run_remote(ns) -> int:
    import tempfile

    import numpy as np

    from dispatches_tpu_torch.fleet import FleetOptions, connect_fleet
    from dispatches_tpu_torch.obs import distributed as obs_distributed
    from dispatches_tpu_torch.obs import export as obs_export
    from dispatches_tpu_torch.obs import report as obs_report
    from dispatches_tpu_torch.obs import trace as obs_trace
    from dispatches_tpu_torch.obs.soak import StubNLP

    trace = bool(ns.trace_export)
    if trace:
        # both sides of the wire must be armed BEFORE any RPC flows:
        # spawned workers inherit DISPATCHES_TPU_NET_TRACE, the local
        # process arms programmatically
        obs_distributed.enable(True)
        obs_trace.enable(True)
    procs: List = []
    rc = 0
    try:
        if ns.endpoints:
            eps = _parse_endpoints(ns.endpoints)
        else:
            root = tempfile.mkdtemp(prefix="fleet-cli-")
            procs, eps = _spawn_workers(ns.workers, root,
                                        max_batch=ns.max_batch,
                                        trace=trace, device=ns.device)
        router = connect_fleet(eps, options=FleetOptions(
            n_replicas=len(eps), heartbeat_timeout_ms=2_000.0,
            gossip_interval_s=30.0))
        nlp = StubNLP()
        base = nlp.default_params()
        handles = []
        for i in range(ns.n):
            params = {"p": {"price": np.asarray(base["p"]["price"])
                            * (1.0 + 0.001 * i)},
                      "fixed": {}}
            handles.append(router.submit(nlp, params, solver="pdlp",
                                         deadline_ms=60_000.0))
            router.poll()
        t_end = time.monotonic() + ns.timeout_s
        while (not all(h.done() for h in handles)
               and time.monotonic() < t_end):
            router.poll()
            try:
                router.flush_all()
            except Exception:
                pass
            time.sleep(0.002)
        hung = sum(1 for h in handles if not h.done())
        metrics = router.metrics()
        snapshots = router.replica_snapshots()
        summed = obs_distributed.merge_registry_snapshots(snapshots)

        trace_block = None
        if trace:
            remotes = router.trace_exports()
            n_events = obs_distributed.export_merged_trace(
                ns.trace_export, obs_trace.events(), remotes,
                dropped=obs_trace.dropped()
                + sum(r.get("dropped", 0) for r in remotes))
            merged = obs_report.load_chrome_trace(ns.trace_export)
            problems = obs_report.validate_chrome_trace(merged)
            trace_block = {
                "path": str(ns.trace_export),
                "events": n_events,
                "processes": 1 + len(remotes),
                "valid": not problems,
                "problems": problems[:8],
            }
            if problems:
                rc = 1

        if ns.prom_out:
            text = (obs_export.render_prometheus()
                    + obs_export.render_prometheus_snapshots(snapshots))
            with open(ns.prom_out, "w") as f:
                f.write(text)

        try:
            router.drain()
        except Exception:
            pass

        if ns.json:
            metrics["hung"] = hung
            metrics["fleet_counters"] = summed
            if trace_block is not None:
                metrics["trace"] = trace_block
            print(json.dumps(metrics, default=str))
        else:
            print(_render_text(metrics))
            for line in _remote_counter_lines(summed):
                print(line)
            if trace_block is not None:
                verdict = ("valid" if trace_block["valid"]
                           else f"INVALID: {trace_block['problems']}")
                print(f"\nmerged trace      {trace_block['events']} events "
                      f"from {trace_block['processes']} processes "
                      f"-> {trace_block['path']} ({verdict})")
            if hung:
                print(f"\nWARNING: {hung} handles never reached a "
                      "terminal status")
        return 1 if hung else rc
    finally:
        for p in procs:
            try:
                p.send_signal(signal.SIGKILL)
                p.wait(timeout=10)
            except Exception:
                pass


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dispatches_tpu_torch.fleet",
        description="replicated solve-tier demo / stats report")
    ap.add_argument("--stats", action="store_true",
                    help="print the text stats report (default action)")
    ap.add_argument("--json", action="store_true",
                    help="print the raw metrics dict as one JSON line")
    ap.add_argument("--n", type=int, default=48,
                    help="demo requests (default 48)")
    ap.add_argument("--replicas", type=int, default=2,
                    help="fleet size (default 2; in-process demo mode)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--workers", type=int, default=0,
                    help="spawn N real worker processes and run the "
                    "workload over the wire instead of in-process")
    ap.add_argument("--endpoints", default="",
                    help="comma-separated host:port of already-running "
                    "workers (alternative to --workers)")
    ap.add_argument("--trace-export", default="",
                    help="arm wire-level tracing and write ONE merged "
                    "multi-process Chrome trace to this path "
                    "(implies worker mode)")
    ap.add_argument("--prom-out", default="",
                    help="write merged fleet Prometheus exposition to "
                    "this path (worker mode)")
    ap.add_argument("--timeout-s", type=float, default=60.0,
                    help="worker-mode completion deadline (default 60)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the demo's replicas and of the "
                    "spawned workers (default cuda; raises when no card is "
                    "present; cpu for tests)")
    ns = ap.parse_args(argv)
    from dispatches_tpu_torch import resolve_device

    resolve_device(ns.device)  # fail before any worker is spawned

    if ns.workers or ns.endpoints or ns.trace_export:
        if not (ns.workers or ns.endpoints):
            ns.workers = 2  # --trace-export alone implies a 2-worker run
        return _run_remote(ns)
    return _run_demo(ns)


if __name__ == "__main__":
    sys.exit(main())
