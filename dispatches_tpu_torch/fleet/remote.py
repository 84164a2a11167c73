"""Remote replicas: the ReplicaHandle surface over RPC (counterpart of
``dispatches_tpu/fleet/remote.py``).

:class:`RemoteReplicaHandle` presents EXACTLY the surface
:class:`~dispatches_tpu_torch.fleet.replica.ReplicaHandle` does — the router
routes, sheds, gossips, and heartbeat-failovers over it unchanged,
so one :class:`~dispatches_tpu_torch.fleet.router.FleetRouter` can front an
in-process fleet, a multi-process fleet
(``python -m dispatches_tpu_torch.net --worker`` per replica), or a mix.

The ``service`` attribute is a :class:`RemoteServiceFacade` speaking
the worker's RPC vocabulary (submit/poll/flush/drain/metrics/gossip)
while exposing the SolveService call shapes the router and
:func:`fleet.handoff.rehome` already use — ``submit(nlp, params, ...)``
accepts and ignores the live ``nlp``/``base_solver`` objects (the
worker binds ITS model, the same contract rehome relies on in-process).

Failure semantics:

* **heartbeat** is a ``ping`` RPC with the ``NET_HEARTBEAT_MS``
  deadline and NO retries — a lost beat must stay lost so the router's
  silence detection fires honestly.  A beat that does come back still
  crosses the ``replica.heartbeat`` fault site, so chaos scenarios
  drive remote and local replicas identically.
* **submit/poll retries** live in the RPC client (capped-exponential
  backoff, ``net.*`` fault sites): a transient network fault is
  absorbed invisibly; only an exhausted retry budget surfaces — and a
  ``poll`` that raises is exactly the router's fail-stop containment
  trigger, which kills the handle and lets heartbeat silence drive
  journal-handoff rehoming onto survivors.
* **kill()** closes the handle's client and snapshots final metrics;
  it never kills the worker process (a dead *handle* is the router's
  view; the process's fate belongs to its supervisor).

Cross-process exactly-once delivery rides the worker's ack'd
done-buffer: every poll/flush ships back unacknowledged terminal
results, the facade completes each matching local handle once and
acknowledges on the next call — a lost response is re-delivered, a
re-delivered result is dropped by the ack bookkeeping.
"""
from __future__ import annotations

import itertools
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from dispatches_tpu_torch.analysis.runtime import sanitized_lock
from dispatches_tpu_torch.net import rpc as rpc_mod
from dispatches_tpu_torch.obs import distributed as obs_distributed
from dispatches_tpu_torch.obs import flight as obs_flight
from dispatches_tpu_torch.obs import trace as obs_trace
from dispatches_tpu_torch.serve.service import RequestStatus, ServeResult
from dispatches_tpu_torch.fleet.replica import (
    DEFAULT_HEARTBEAT_TIMEOUT_MS,
    ReplicaHandle,
)

__all__ = ["RemoteReplicaHandle", "RemoteServiceFacade", "connect_fleet"]

#: default per-RPC deadline for control-plane calls (submit/poll/...):
#: generous — these bound hangs, not latency; heartbeats have their own
DEFAULT_RPC_DEADLINE_MS = 30_000.0


class _RemoteOptions:
    """The slice of ServeOptions the router reads off a replica
    (``_score`` uses ``max_batch``), mirrored from the worker's hello."""

    __slots__ = ("max_batch", "max_wait_ms", "max_queue", "adaptive_wait")

    def __init__(self, opts: Dict):
        self.max_batch = int(opts.get("max_batch", 64))
        self.max_wait_ms = float(opts.get("max_wait_ms", 10.0))
        self.max_queue = int(opts.get("max_queue", 1024))
        self.adaptive_wait = bool(opts.get("adaptive_wait", False))


class RemoteSolveHandle:
    """Client-side future for one request living on a remote worker.

    Mirrors the SolveHandle surface the router's tracking, bridging,
    and callers use: ``done``/``result``/``status``/``_complete`` plus
    the bookkeeping attributes (``request_id``, ``bucket_label``,
    ``params``, ``submitted_at``, ``deadline_at``)."""

    __slots__ = ("_facade", "params", "submitted_at", "deadline_at",
                 "request_id", "bucket_label", "_result", "_t_submit_us",
                 "_rid")

    def __init__(self, facade, params, submitted_at, deadline_at,
                 request_id, bucket_label):
        self._facade = facade
        self.params = params
        self.submitted_at = submitted_at
        self.deadline_at = deadline_at
        self.request_id = request_id
        self.bucket_label = bucket_label
        self._result: Optional[ServeResult] = None
        # tracer-clock submit timestamp (None when tracing is disarmed);
        # the facade emits a retroactive fleet.request span from it when
        # the terminal result lands, bracketing the whole remote journey
        self._t_submit_us: Optional[float] = None
        # the wire-unique submit rid: worker-assigned int request ids
        # restart at 1 per worker, so in a MERGED trace only this
        # string keys one journey unambiguously (workers stamp it onto
        # their spans as origin_rid at trace_export time)
        self._rid: Optional[str] = None

    @property
    def status(self) -> str:
        return (RequestStatus.QUEUED if self._result is None
                else self._result.status)

    def done(self) -> bool:
        return self._result is not None

    def result(self, timeout: Optional[float] = None) -> ServeResult:
        """Drive the remote queue (flush RPCs) until this request's
        result arrives; ``timeout`` is wall-clock seconds."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while self._result is None:
            self._facade.flush_all()
            if self._result is not None:
                break
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"remote request {self.request_id} still pending "
                    f"after {timeout} s (bucket {self.bucket_label!r})")
            time.sleep(0.005)  # the worker's pump may still be solving
        return self._result

    def _complete(self, serve_result: ServeResult) -> None:
        self._result = serve_result


class RemoteServiceFacade:
    """SolveService call shapes over the worker RPC vocabulary."""

    def __init__(self, client: "rpc_mod.RpcClient", hello: Dict, *,
                 rpc_deadline_ms: float = DEFAULT_RPC_DEADLINE_MS):
        self._client = client
        self.options = _RemoteOptions(hello.get("options") or {})
        self.generation = int(hello.get("generation", 1))
        self.remote_pid = hello.get("pid")
        self.remote_journal_dir = hello.get("journal_dir")
        self.rpc_deadline_ms = float(rpc_deadline_ms)
        # guards the handle map + ack list + cached depth/est — RPC
        # I/O always runs outside it (the JAX package's lock discipline GL009)
        self._lock = sanitized_lock("net.facade")
        self._handles: Dict[int, RemoteSolveHandle] = {}
        self._acks: List[int] = []
        # results that arrived BEFORE their submit response: the worker
        # can complete a request inside the submit RPC window (batch=1
        # flushes synchronously), so a concurrent poll on another
        # pooled connection may deliver the done result while the
        # submitter thread is still blocked in its submit call.  Stash
        # it here; submit consumes it when the handle materialises.
        # Never leaks: every stash has that submit in flight.
        self._early: Dict[int, ServeResult] = {}
        self._depth = 0
        self._est_s: Optional[float] = None
        # rid sequence: monotonic_ns alone could collide for two
        # submitter threads landing in the same nanosecond
        self._rid_seq = itertools.count()

    # -- SolveService surface ----------------------------------------------

    def submit(self, nlp, params=None, x0=None, *, solver: str = "auto",
               options: Optional[Dict] = None,
               deadline_ms: Optional[float] = None,
               warm_key=None, base_solver=None) -> RemoteSolveHandle:
        """Submit to the remote worker.  ``nlp``/``base_solver`` are
        accepted and IGNORED — live objects never cross the wire; the
        worker binds its own model (the rehome contract)."""
        if params is None and nlp is not None:
            params = nlp.default_params()
        rid = (f"{self._client.peer}/{id(self):x}/"
               f"{time.monotonic_ns():x}-{next(self._rid_seq)}")
        payload = {
            "rid": rid, "params": params, "x0": x0, "solver": solver,
            "options": options, "deadline_ms": deadline_ms,
            "warm_key": warm_key,
        }
        traced = obs_distributed.enabled()
        t_submit_us = obs_trace.now_us() if traced else None
        try:
            if traced:
                # the wire context of this call (and any retry) carries
                # the submit rid, so the worker's spans for this request
                # name the router-side identity
                with obs_distributed.submit_context(rid):
                    resp = self._client.call(
                        "submit", payload, deadline_ms=self.rpc_deadline_ms)
            else:
                resp = self._client.call(
                    "submit", payload, deadline_ms=self.rpc_deadline_ms)
        except rpc_mod.RpcRemoteError as exc:
            # e.g. "service is draining": the same RuntimeError contract
            # the in-process service has
            raise RuntimeError(str(exc)) from exc
        now = time.monotonic()
        deadline_at = (None if deadline_ms is None
                       else now + deadline_ms / 1e3)
        handle = RemoteSolveHandle(
            self, params, now, deadline_at, int(resp["id"]),
            resp.get("bucket", "remote"))
        handle._t_submit_us = t_submit_us
        handle._rid = rid
        with self._lock:
            early = self._early.pop(handle.request_id, None)
            if early is None:
                self._handles[handle.request_id] = handle
            self._depth = int(resp.get("queue_depth", self._depth + 1))
        if early is not None:
            # a concurrent poll beat us to the result — complete the
            # handle now instead of registering it for delivery
            self._finish(handle, early)
        return handle

    def poll(self, now: Optional[float] = None) -> int:
        resp = self._rpc_with_acks("poll")
        return int(resp.get("dispatched", 0))

    def flush_all(self) -> int:
        resp = self._rpc_with_acks("flush")
        return int(resp.get("handled", 0))

    def drain(self) -> Dict:
        resp = self._rpc_with_acks("drain")
        return {"handled": int(resp.get("handled", 0)),
                "snapshot": resp.get("snapshot")}

    def metrics(self) -> Dict:
        return self._client.call("metrics",
                                 deadline_ms=self.rpc_deadline_ms)

    def _queue_depth(self) -> int:
        with self._lock:
            return self._depth

    def est_service_s(self) -> Optional[float]:
        with self._lock:
            return self._est_s

    # -- delivery ----------------------------------------------------------

    def _rpc_with_acks(self, method: str) -> Dict:
        with self._lock:
            acks = list(self._acks)
        resp = self._client.call(method, {"ack": acks},
                                 deadline_ms=self.rpc_deadline_ms)
        self._absorb(resp, acks)
        return resp

    def _absorb(self, resp: Dict, sent_acks: Sequence[int]) -> None:
        """Complete local handles from reported terminal results and
        advance the ack window (exactly-once: a handle completes the
        first time its result arrives; re-deliveries only re-ack)."""
        completions: List[Tuple[RemoteSolveHandle, ServeResult]] = []
        with self._lock:
            # acks the worker has now consumed leave the window
            self._acks = [a for a in self._acks if a not in set(sent_acks)]
            for item in resp.get("done", ()):
                request_id = int(item["id"])
                seen = request_id in self._acks
                if not seen:
                    self._acks.append(request_id)
                handle = self._handles.pop(request_id, None)
                result = ServeResult(
                    item["status"], item.get("result"),
                    item.get("obj"), item.get("latency_ms"))
                if handle is not None and not handle.done():
                    completions.append((handle, result))
                elif handle is None and not seen:
                    # first sight of an id with no handle: its submit
                    # response is still in flight — stash, don't drop
                    # (``seen`` re-deliveries of an already-completed
                    # id must NOT stash, or they would leak)
                    self._early[request_id] = result
            if "queue_depth" in resp:
                self._depth = int(resp["queue_depth"])
            if "est_service_s" in resp:
                self._est_s = resp["est_service_s"]
        for handle, result in completions:
            self._finish(handle, result)

    def _finish(self, handle: RemoteSolveHandle,
                result: ServeResult) -> None:
        """Terminal bookkeeping for a completed handle — shared by the
        delivery pump and the early-result path in ``submit`` (a
        request the worker finished inside the submit RPC window still
        needs its router-side envelope span)."""
        handle._complete(result)
        t0 = handle._t_submit_us
        if t0 is not None and obs_trace.enabled():
            # one envelope span per remote request on the ROUTER's
            # clock: the worker's serve.* spans for the same
            # request_id nest inside it in the merged trace
            obs_trace.complete(
                "fleet.request", t0, obs_trace.now_us() - t0,
                request_id=handle.request_id,
                origin_rid=handle._rid,
                bucket=handle.bucket_label, peer=self._client.peer,
                status=result.status)
        if result.status == RequestStatus.TIMEOUT:
            self._flight_deadline(handle, result)

    def _flight_deadline(self, handle: RemoteSolveHandle,
                         result: ServeResult) -> None:
        """Router-side deadline-miss bundle carrying the implicated
        worker's metrics snapshot (best-effort, never raises)."""
        if not obs_flight.enabled():
            return
        try:
            obs_flight.trigger(
                "deadline_miss",
                request_id=handle.request_id,
                bucket=handle.bucket_label,
                detail={"peer": self._client.peer,
                        "latency_ms": result.latency_ms,
                        "replica_snapshot": self.metrics_snapshot()})
        except Exception:
            pass  # diagnostics must never take down delivery

    # -- fleet telemetry pull ------------------------------------------------

    def metrics_snapshot(self) -> Optional[Dict]:
        """The worker's full registry snapshot (+ pid/generation/clock
        sample); None on any failure — telemetry pulls are best-effort
        and never raise into routing or diagnostics paths."""
        try:
            return self._client.call("metrics_snapshot",
                                     deadline_ms=2_000.0, retries=0)
        except Exception:
            return None

    def trace_export(self, limit: int = 0) -> Optional[Dict]:
        """Tail of the worker's trace ring (``limit=0`` = whole ring);
        None on any failure."""
        try:
            return self._client.call("trace_export", {"limit": int(limit)},
                                     deadline_ms=10_000.0, retries=0)
        except Exception:
            return None

    def close(self) -> None:
        self._client.close()


class RemoteReplicaHandle(ReplicaHandle):
    """A fleet replica living in another process, behind RPC."""

    def __init__(self, replica_id: int, host: str, port: int, *,
                 journal_dir: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic,
                 heartbeat_timeout_ms: float = DEFAULT_HEARTBEAT_TIMEOUT_MS,
                 rpc_deadline_ms: float = DEFAULT_RPC_DEADLINE_MS,
                 client: Optional["rpc_mod.RpcClient"] = None):
        self._client = (client if client is not None
                        else rpc_mod.RpcClient(host, port))
        self.endpoint = f"{host}:{int(port)}"
        t_send_us = obs_trace.now_us()
        hello = self._client.call("hello",
                                  deadline_ms=rpc_deadline_ms)
        t_recv_us = obs_trace.now_us()
        facade = RemoteServiceFacade(self._client, hello,
                                     rpc_deadline_ms=rpc_deadline_ms)
        if journal_dir is None:
            # shared-filesystem deployment: the worker's own journal
            # directory is where survivors re-home from after a crash
            journal_dir = facade.remote_journal_dir
        super().__init__(replica_id, facade, journal_dir=journal_dir,
                         clock=clock,
                         heartbeat_timeout_ms=heartbeat_timeout_ms)
        self.generation = facade.generation
        # real worker identity (not just the endpoint string) — fleet
        # stats and per-replica metric labels carry these
        self.worker_pid = facade.remote_pid
        # clock-offset estimate from the hello exchange itself (the
        # midpoint method); refresh_clock() tightens it over pings
        self.clock_sync: Optional[obs_distributed.ClockSync] = None
        if hello.get("now_us") is not None:
            self.clock_sync = obs_distributed.offset_from_exchange(
                t_send_us, t_recv_us, hello["now_us"])

    # -- health ------------------------------------------------------------

    def heartbeat(self, now: Optional[float] = None) -> bool:
        """One liveness beat = one ping RPC, never retried.  A beat
        that comes back still runs the base-class path (the
        ``replica.heartbeat`` fault site and counters), so scenario
        grammars treat remote and local replicas identically."""
        if not self.alive or self.service is None:
            return False
        if not self._client.ping():
            self.beats_lost += 1
            self._obs_beats.inc(replica=self.name, event="lost")
            return False
        return super().heartbeat(now)

    # -- routing signals ---------------------------------------------------

    def est_service_s(self) -> Optional[float]:
        """The worker's own admission estimate, cached from the last
        poll/flush response (never an RPC on the routing hot path)."""
        if not self.alive or self.service is None:
            return None
        return self.service.est_service_s()

    # -- fleet telemetry ----------------------------------------------------

    def refresh_clock(self, samples: int = 3) -> Optional[
            obs_distributed.ClockSync]:
        """Tighten the clock-offset estimate with ``samples`` ping
        exchanges (lowest RTT wins, including the hello-time estimate);
        keeps the previous estimate on total failure."""
        if not self.alive or self.service is None:
            return self.clock_sync
        est = obs_distributed.sync_clock(
            lambda: self._client.call("ping", deadline_ms=1_000.0,
                                      retries=0),
            samples=samples)
        if est is not None and (self.clock_sync is None
                                or est.rtt_us < self.clock_sync.rtt_us):
            self.clock_sync = est
        return self.clock_sync

    def metrics_snapshot(self) -> Optional[Dict]:
        """Best-effort pull of the worker's registry snapshot (None when
        dead or unreachable — never raises)."""
        if not self.alive or self.service is None:
            return None
        return self.service.metrics_snapshot()

    def trace_export(self, limit: int = 0) -> Optional[Dict]:
        """Best-effort pull of the worker's trace-ring tail."""
        if not self.alive or self.service is None:
            return None
        return self.service.trace_export(limit=limit)

    # -- gossip ------------------------------------------------------------

    def gossip_donate(self) -> dict:
        if not self.alive or self.service is None:
            return {}
        resp = self._client.call(
            "gossip_donate", deadline_ms=self.service.rpc_deadline_ms)
        return resp.get("buckets", {})

    def gossip_adopt(self, pairs) -> int:
        if not self.alive or self.service is None:
            return 0
        resp = self._client.call(
            "gossip_merge", {"pairs": [list(p) for p in pairs]},
            deadline_ms=self.service.rpc_deadline_ms)
        return int(resp.get("adopted", 0))

    # -- lifecycle ---------------------------------------------------------

    def kill(self) -> None:
        """Drop this handle (final metrics RPC on a short leash, close
        the client).  The remote PROCESS is untouched — its lifetime
        belongs to its supervisor, and after a real crash there is
        nothing to reach anyway."""
        if not self.alive:
            return
        self.alive = False
        service, self.service = self.service, None
        if service is not None:
            try:
                self.final_metrics = self._client.call(
                    "metrics", deadline_ms=1_000.0, retries=0)
            except Exception:
                self.final_metrics = None
        self._client.close()


def connect_fleet(endpoints: Sequence[Tuple[str, int]], *,
                  options=None,
                  clock: Callable[[], float] = time.monotonic,
                  rpc_deadline_ms: float = DEFAULT_RPC_DEADLINE_MS):
    """Build a FleetRouter over remote workers at ``endpoints``
    (``[(host, port), ...]``).  Each worker must already be serving;
    its hello supplies the journal directory failover replays from."""
    from dispatches_tpu_torch.fleet.router import FleetOptions, FleetRouter

    if options is None:
        options = FleetOptions.from_env(n_replicas=len(endpoints))
    replicas = [
        RemoteReplicaHandle(
            i, host, port, clock=clock,
            heartbeat_timeout_ms=options.heartbeat_timeout_ms,
            rpc_deadline_ms=rpc_deadline_ms)
        for i, (host, port) in enumerate(endpoints)]
    return FleetRouter(options, clock=clock, replicas=replicas)
