"""``python -m dispatches_tpu_torch.net --worker``: one fleet worker process
(counterpart of ``dispatches_tpu/net/worker.py``).

A worker hosts a real :class:`~dispatches_tpu_torch.serve.SolveService` —
its own NLP model, base solver, execution plan, and (when given
``--journal-dir``) write-ahead journal — behind an
:class:`~dispatches_tpu_torch.net.rpc.RpcServer`.  Live objects never cross
the wire: a submit RPC carries params / solver name / options /
deadline only, and the worker binds them to ITS model and solver, the
same contract :func:`fleet.handoff.rehome` uses in-process (nlp and
base_solver are live state the survivor supplies).

Delivery contract (what makes cross-process exactly-once work):

* **submit** carries a client-unique ``rid``; a retried submit whose
  first attempt executed but whose response was lost is deduplicated
  (the worker answers with the original request id instead of queueing
  a twin);
* **poll/flush/drain** return every terminal result not yet
  acknowledged; results leave the worker's done-buffer only when a
  later call ``ack``\\ s them — a lost response is re-delivered, never
  dropped, and the client side completes each handle at most once.

On startup the worker prints one JSON *ready line*
(``{"ready": true, "port": N, "pid": P}``) to stdout so a parent that
spawned it with ``--port 0`` learns the kernel-assigned port.

``--tick-ms`` arms a background pump thread calling ``service.poll``
so queued batches dispatch between RPCs; ``--service-ms`` wraps the
plan so each batch completion takes that much real wall-clock time in
THIS process (the multi-process bench measures genuine cross-process
parallelism with it, not just RPC overhead).

The service runs on ``--device`` (``cuda`` unless the caller asks for the
CPU; asking for ``cuda`` with no card raises).  Results leave the device
when they are reaped: the done-buffer holds host numpy arrays, so a
result's bytes on the wire are the bytes the JAX worker would send.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
from typing import Dict, List, Optional

__all__ = ["WorkerHost", "main"]


def _build_model(model: str):
    """Returns ``(nlp, solver_name, base_solver)`` for a model name.

    ``stub`` is the tier-1 default: the soak harness's minimal
    pdlp-with-base_solver path, one tiny lane-batched program.
    ``arbitrage`` is the storage-arbitrage flowsheet demo from
    ``serve/__main__.py`` (service-built per-scenario PDLP).
    """
    if model == "stub":
        from dispatches_tpu_torch.obs.soak import StubNLP, make_stub_solver

        return StubNLP(), "pdlp", make_stub_solver()
    if model == "arbitrage":
        from dispatches_tpu_torch.serve.__main__ import _arbitrage_nlp

        return _arbitrage_nlp(12), "pdlp", None
    raise ValueError(f"unknown worker model {model!r}")


def _modeled_plan(service_ms: float, device):
    """An ExecutionPlan whose fence spends ``service_ms`` of real time
    per batch — modeled device compute, paid inside THIS process so
    multi-worker throughput reflects genuine process parallelism."""
    from dispatches_tpu_torch.plan.execution import ExecutionPlan, PlanOptions

    sleep_s = float(service_ms) / 1e3

    class _ModeledPlan(ExecutionPlan):
        def _complete_oldest(self):
            if self._window:
                time.sleep(sleep_s)
            return super()._complete_oldest()

    return _ModeledPlan(PlanOptions.from_env(device=device))


def _to_host(tree):
    """``tree`` with every tensor leaf moved to the host as a numpy array
    (namedtuples keep their type and fields)."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_to_host(v) for v in tree])
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _done_payload(handle) -> dict:
    """The done-buffer entry of a terminal handle (host values only)."""
    res = handle.result(timeout=0)
    return {
        "id": handle.request_id,
        "bucket": handle.bucket_label,
        "status": res.status,
        "obj": None if res.obj is None else float(res.obj),
        "latency_ms": res.latency_ms,
        "result": _to_host(res.result),
    }


class WorkerHost:
    """The RPC-facing shell around one SolveService."""

    def __init__(self, *, model: str = "stub",
                 journal_dir: Optional[str] = None,
                 max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 service_ms: float = 0.0,
                 tick_ms: float = 0.0,
                 host: str = "127.0.0.1", port: int = 0,
                 device=None):
        from dispatches_tpu_torch import resolve_device
        from dispatches_tpu_torch.analysis.runtime import sanitized_lock
        from dispatches_tpu_torch.net import rpc as rpc_mod
        from dispatches_tpu_torch.obs import distributed as obs_distributed
        from dispatches_tpu_torch.obs import trace as obs_trace
        from dispatches_tpu_torch.serve.service import ServeOptions, SolveService

        self.model = model
        self.device = resolve_device(device)
        self.nlp, self.solver, self.base_solver = _build_model(model)
        overrides: Dict = {}
        if max_batch is not None:
            overrides["max_batch"] = int(max_batch)
        if max_wait_ms is not None:
            overrides["max_wait_ms"] = float(max_wait_ms)
        if service_ms > 0.0:
            overrides["plan"] = _modeled_plan(service_ms, self.device)
        self.service = SolveService(
            ServeOptions.from_env(**overrides),
            clock=time.monotonic, journal_dir=journal_dir,
            device=None if "plan" in overrides else self.device)
        self.journal_dir = journal_dir
        # guards the handle / done-buffer / rid-dedupe dicts only; all
        # service calls run outside it (the service has its own lock —
        # nesting would add a cross-module lock-order edge for nothing)
        self._lock = sanitized_lock("net.worker")
        self._handles: Dict[int, object] = {}
        self._done: Dict[int, dict] = {}
        self._by_rid: Dict[str, int] = {}
        # request id → router-side origin identity (from the wire trace
        # context); trace_export stamps it back onto serve.* spans so
        # worker-side events carry the router's request identity
        self._origin: Dict[int, dict] = {}
        if obs_distributed.enabled():
            # workers record spans whenever wire tracing is armed, so a
            # later trace_export pull has a ring to drain
            obs_trace.enable(True)
            obs_distributed.set_generation(self.service.generation)
        self._tick_ms = float(tick_ms)
        self._pump: Optional[threading.Thread] = None
        self._running = False
        self.server = rpc_mod.RpcServer({
            "hello": self._rpc_hello,
            "submit": self._rpc_submit,
            "poll": self._rpc_poll,
            "flush": self._rpc_flush,
            "drain": self._rpc_drain,
            "metrics": self._rpc_metrics,
            "metrics_snapshot": self._rpc_metrics_snapshot,
            "trace_export": self._rpc_trace_export,
            "gossip_donate": self._rpc_gossip_donate,
            "gossip_merge": self._rpc_gossip_merge,
        }, host=host, port=port)
        self.port = self.server.port

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "WorkerHost":
        self._running = True
        self.server.start()
        if self._tick_ms > 0.0:
            self._pump = threading.Thread(
                target=self._pump_loop, name="worker-pump", daemon=True)
            self._pump.start()
        return self

    def stop(self) -> None:
        self._running = False
        self.server.stop()

    def _pump_loop(self) -> None:
        period = self._tick_ms / 1e3
        while self._running:
            try:
                self.service.poll()
            except Exception:
                pass  # draining / shutdown races must not kill the pump
            time.sleep(period)

    # -- delivery bookkeeping ----------------------------------------------

    def _reap(self, ack) -> List[dict]:
        """Move newly-terminal handles into the done-buffer, drop the
        entries the caller acknowledged, and return everything still
        awaiting acknowledgement (re-delivery until acked)."""
        with self._lock:
            if ack:
                for rid in ack:
                    self._done.pop(int(rid), None)
            finished = [h for h in self._handles.values() if h.done()]
            for handle in finished:
                del self._handles[handle.request_id]
            pending = list(self._done.values())
        for handle in finished:
            payload = _done_payload(handle)
            with self._lock:
                self._done[handle.request_id] = payload
            pending.append(payload)
        return pending

    # -- handlers (each runs on an RPC connection thread) -------------------

    def _rpc_hello(self, payload) -> dict:
        from dispatches_tpu_torch.obs import trace as obs_trace

        opts = self.service.options
        return {
            "pid": os.getpid(),
            "model": self.model,
            "generation": self.service.generation,
            # monotonic tracer-clock sample: the client brackets hello
            # with now_us() reads and midpoints a clock-offset estimate
            "now_us": obs_trace.now_us(),
            "journal_dir": self.journal_dir,
            "options": {
                "max_batch": opts.max_batch,
                "max_wait_ms": opts.max_wait_ms,
                "max_queue": opts.max_queue,
                "adaptive_wait": opts.adaptive_wait,
            },
        }

    def _rpc_submit(self, payload) -> dict:
        rid = payload.get("rid")
        if rid is not None:
            with self._lock:
                known = self._by_rid.get(rid)
            if known is not None:
                # retried submit whose response was lost: answer with
                # the original, do not queue a twin
                return {"id": known, "dup": True}
        solver = payload.get("solver")
        if solver in (None, "auto"):
            # "auto" resolves against the WORKER's model, not the
            # client's — the worker owns the solver, as in-process
            # replicas own theirs
            solver = self.solver
        handle = self.service.submit(
            self.nlp, payload.get("params"), payload.get("x0"),
            solver=solver,
            options=payload.get("options"),
            deadline_ms=payload.get("deadline_ms"),
            warm_key=payload.get("warm_key"),
            base_solver=self.base_solver)
        origin = self._submit_origin(rid)
        # completed at submit (shed / expired): its done-buffer entry is
        # built outside the lock (the result leaves the device)
        done_now = _done_payload(handle) if handle.done() else None
        with self._lock:
            if rid is not None:
                self._by_rid[rid] = handle.request_id
            if origin is not None:
                self._origin[handle.request_id] = origin
                while len(self._origin) > 4096:  # bounded, oldest out
                    self._origin.pop(next(iter(self._origin)))
            if done_now is not None:
                # straight to the done-buffer, no handle to track
                self._done[handle.request_id] = done_now
            else:
                self._handles[handle.request_id] = handle
        return {"id": handle.request_id, "bucket": handle.bucket_label,
                "queue_depth": self.service._queue_depth()}

    def _rpc_poll(self, payload) -> dict:
        dispatched = self.service.poll()
        done = self._reap((payload or {}).get("ack"))
        return {
            "dispatched": dispatched,
            "queue_depth": self.service._queue_depth(),
            "est_service_s": self._est_service_s(),
            "done": done,
        }

    def _rpc_flush(self, payload) -> dict:
        handled = self.service.flush_all()
        done = self._reap((payload or {}).get("ack"))
        return {
            "handled": handled,
            "queue_depth": self.service._queue_depth(),
            "est_service_s": self._est_service_s(),
            "done": done,
        }

    def _rpc_drain(self, payload) -> dict:
        out = self.service.drain()
        done = self._reap((payload or {}).get("ack"))
        return {"handled": out.get("handled", 0),
                "snapshot": out.get("snapshot"),
                "done": done}

    @staticmethod
    def _submit_origin(rid) -> Optional[dict]:
        """Router-side identity of the submit being handled, decoded by
        the RPC layer from the frame's trace context (None when wire
        tracing is disarmed)."""
        from dispatches_tpu_torch.obs import distributed as obs_distributed

        if not obs_distributed.enabled():
            return None
        ctx = obs_distributed.current()
        if ctx is None:
            return None
        return {"rid": ctx.rid if ctx.rid is not None else rid,
                "pid": ctx.pid, "gen": ctx.gen}

    def _rpc_metrics(self, payload) -> dict:
        return self.service.metrics()

    def _rpc_metrics_snapshot(self, payload) -> dict:
        """Full registry snapshot for the fleet telemetry rollup —
        plain dicts, so it crosses the journal codec untouched."""
        from dispatches_tpu_torch.obs import registry as obs_registry
        from dispatches_tpu_torch.obs import trace as obs_trace

        return {
            "pid": os.getpid(),
            "generation": self.service.generation,
            "now_us": obs_trace.now_us(),
            "snapshot": obs_registry.default_registry().snapshot(),
        }

    def _rpc_trace_export(self, payload) -> dict:
        """Tail of the local trace ring for the fleet trace merger.
        Spans whose ``request_id`` the worker has an origin record for
        are annotated with the router-side identity, so the merged
        trace shows one journey, not two disconnected ids."""
        from dispatches_tpu_torch.obs import trace as obs_trace

        limit = int((payload or {}).get("limit") or 0)
        evts = obs_trace.events()
        if limit > 0:
            evts = evts[-limit:]
        with self._lock:
            origin = dict(self._origin)
        out = []
        for e in evts:
            args = e.get("args") or {}
            o = origin.get(args.get("request_id"))
            if o is not None:
                e = dict(e)
                args = dict(args)
                args["origin_rid"] = o["rid"]
                args["origin_pid"] = o["pid"]
                e["args"] = args
            out.append(e)
        return {
            "pid": os.getpid(),
            "generation": self.service.generation,
            "now_us": obs_trace.now_us(),
            "dropped": obs_trace.dropped(),
            "events": out,
        }

    def _rpc_gossip_donate(self, payload) -> dict:
        from dispatches_tpu_torch.fleet import gossip as gossip_mod

        return {"buckets": gossip_mod.donate_states(self.service)}

    def _rpc_gossip_merge(self, payload) -> dict:
        from dispatches_tpu_torch.fleet import gossip as gossip_mod

        adopted = sum(
            gossip_mod.merge_bucket_state(self.service, label, state)
            for label, state in (payload or {}).get("pairs", []))
        return {"adopted": adopted}

    def _est_service_s(self) -> Optional[float]:
        best = None
        for bucket in self.service._buckets.values():
            est = getattr(bucket, "est", None)
            if est is None:
                continue
            val = est.estimate_s()
            if val is not None and (best is None or val > best):
                best = val
        return best


def main(argv=None) -> int:
    from dispatches_tpu_torch.analysis.flags import flag_name

    parser = argparse.ArgumentParser(
        prog="python -m dispatches_tpu_torch.net",
        description="dispatches_tpu_torch fleet worker process")
    parser.add_argument("--worker", action="store_true", required=True,
                        help="run a worker (the only mode today; "
                        "explicit so future modes stay additive)")
    parser.add_argument("--port", type=int, default=None,
                        help="TCP port (default $DISPATCHES_TPU_NET_PORT "
                        "or 0 = kernel-assigned, printed on the ready line)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--journal-dir", default=None,
                        help="write-ahead journal directory (on a shared "
                        "filesystem, survivors re-home from it)")
    parser.add_argument("--model", default="stub",
                        choices=("stub", "arbitrage"))
    parser.add_argument("--max-batch", type=int, default=None)
    parser.add_argument("--max-wait-ms", type=float, default=None)
    parser.add_argument("--tick-ms", type=float, default=0.0,
                        help="background poll pump period (0 = off)")
    parser.add_argument("--service-ms", type=float, default=0.0,
                        help="modeled per-batch compute time (real "
                        "wall-clock, paid in this process)")
    parser.add_argument("--device", default="cuda",
                        help="torch device the service runs on (default "
                        "cuda; raises when no card is present; cpu for "
                        "tests)")
    args = parser.parse_args(argv)

    port = args.port
    if port is None:
        raw = os.environ.get(flag_name("NET_PORT"), "")
        port = int(raw) if raw else 0

    host = WorkerHost(
        model=args.model, journal_dir=args.journal_dir,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        service_ms=args.service_ms, tick_ms=args.tick_ms,
        host=args.host, port=port, device=args.device).start()
    print(json.dumps({"ready": True, "port": host.port,
                      "pid": os.getpid()}), flush=True)

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except ValueError:
            pass  # not the main thread (embedded use)
    try:
        while not stop.is_set():
            stop.wait(0.2)
    finally:
        host.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
