"""FleetRouter: N SolveService replicas behind one service façade
(counterpart of ``dispatches_tpu/fleet/router.py``).

Routing policy (``docs/fleet.md``):

* **power-of-two choices** — two live replicas sampled per request,
  the one with the better score wins.  The score is queue depth plus a
  large penalty when the replica's own admission service-time estimate
  says the queue ahead of this request would already burn its deadline
  slack — so deadline-bearing traffic steers away from replicas that
  cannot meet it, without a global scan;
* **fingerprint affinity** — repeat parameters re-route to the replica
  that served them last (its warm-start index already holds the
  solution), unless that replica is dead or saturated;
* **fleet-level shed** — when EVERY live replica sits at/above the
  fleet shed depth, the router refuses at the door with a terminal
  ``SHED`` handle that never touches a replica (per-replica shed rungs
  still apply underneath).

Failure handling: replicas heartbeat on the router's clock each poll
(fault site ``replica.heartbeat`` silently eats beats); a replica
whose last beat ages past ``heartbeat_timeout_ms`` is declared dead
and failed over — journal replay + re-home onto survivors
(:mod:`dispatches_tpu_torch.fleet.handoff`), with pre-crash client handles
bridged to their re-homed twins so every accepted request still
reaches a terminal status.  A replica whose ``poll`` raises past its
own retry/watchdog domains is treated as crashed (fail-stop) and
failed over the same way.

Lock discipline: ``fleet.router`` guards only the router's own maps
(tracked handles, bridges, affinity, counters).  Replica service calls
— which take ``serve.service`` internally — always run OUTSIDE it, so
the runtime lock-order sanitizer never sees the two locks nested in
either order.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import random
import tempfile
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from dispatches_tpu_torch.analysis.flags import flag_name
from dispatches_tpu_torch.analysis.runtime import sanitized_lock
from dispatches_tpu_torch.faults import inject as _faults
from dispatches_tpu_torch.obs import registry as obs_registry
from dispatches_tpu_torch.serve.bucket import request_fingerprint
from dispatches_tpu_torch.serve.service import (
    RequestStatus,
    ServeResult,
    SolveService,
)
from dispatches_tpu_torch.fleet import handoff as handoff_mod
from dispatches_tpu_torch.fleet.gossip import DEFAULT_INTERVAL_S, Gossip
from dispatches_tpu_torch.fleet.replica import (
    DEFAULT_HEARTBEAT_TIMEOUT_MS,
    ReplicaHandle,
)

__all__ = ["FleetOptions", "FleetRouter"]

#: routing-score penalty for a replica whose queue already burns the
#: request's deadline — large enough to dominate any realistic depth
_SLACK_PENALTY = 1e6
#: affinity-map bound: oldest fingerprint evicted past this
_AFFINITY_MAX = 65536


@dataclass(frozen=True)
class FleetOptions:
    """Fleet-tier knobs (env-overridable, see :meth:`from_env`)."""

    n_replicas: int = 1
    heartbeat_timeout_ms: float = DEFAULT_HEARTBEAT_TIMEOUT_MS
    gossip_interval_s: float = DEFAULT_INTERVAL_S
    #: fleet-level shed rung: refuse at the router when every live
    #: replica's queue depth is at/above this (None = rung off)
    shed_queue_depth: Optional[int] = None
    #: fingerprint affinity (warm-index locality) on by default
    affinity: bool = True
    #: seed for the power-of-two-choices sampler (deterministic tests)
    seed: int = 0

    @classmethod
    def from_env(cls, **overrides) -> "FleetOptions":
        def _get(short: str, cast, default):
            raw = os.environ.get(flag_name(short), "")
            return cast(raw) if raw else default

        values = dict(
            n_replicas=_get("FLEET_REPLICAS", int, 1),
            heartbeat_timeout_ms=_get(
                "FLEET_HEARTBEAT_MS", float, DEFAULT_HEARTBEAT_TIMEOUT_MS),
            gossip_interval_s=_get(
                "FLEET_GOSSIP_INTERVAL_S", float, DEFAULT_INTERVAL_S),
        )
        values.update(overrides)
        return cls(**values)


class _FleetShedHandle:
    """Duck-typed terminal handle for a request refused at the router
    (fleet-level shed or an injected ``router.submit`` fault): ``done``
    immediately, status ``SHED`` — mirroring the service's shed
    contract without ever touching a replica.  Request ids are negative
    so they can never collide with replica-minted ids."""

    __slots__ = ("params", "submitted_at", "deadline_at", "request_id",
                 "_result")

    bucket_label = "fleet"

    def __init__(self, params, submitted_at, deadline_at, request_id):
        self.params = params
        self.submitted_at = submitted_at
        self.deadline_at = deadline_at
        self.request_id = request_id
        self._result = ServeResult(RequestStatus.SHED, None, None, 0.0)

    @property
    def status(self) -> str:
        return self._result.status

    def done(self) -> bool:
        return True

    def result(self, timeout: Optional[float] = None) -> ServeResult:
        return self._result


class _Tracked:
    """What the router remembers per in-flight request — enough to
    re-home it (nlp/base_solver are not journaled; they are live
    objects) and to bridge its handle after a failover.  The submit
    arguments ride along too: a result that went terminal at a remote
    worker but died undelivered in its done-buffer is *closed* in the
    journal, so replay cannot rescue it — only the router's own copy
    of the request can."""

    __slots__ = ("handle", "nlp", "base_solver", "params", "solver",
                 "options", "deadline_ms")

    def __init__(self, handle, nlp, base_solver, params=None,
                 solver=None, options=None, deadline_ms=None):
        self.handle = handle
        self.nlp = nlp
        self.base_solver = base_solver
        self.params = params
        self.solver = solver
        self.options = options
        self.deadline_ms = deadline_ms


class FleetRouter:
    """Replicated solve tier with the SolveService surface
    (``submit`` / ``poll`` / ``flush_all`` / ``drain`` / ``metrics``).

    ``make_service(replica_id, journal_dir)`` builds each replica's
    service (default: ``SolveService`` on the router's clock and on
    ``device``, ``cuda`` unless given, with the given journal
    directory).  ``durable_dir`` roots the per-replica
    journal directories; with more than one replica it defaults to a
    scratch directory — fleet failover IS journal replay, so
    multi-replica mode implies durability.
    """

    def __init__(self, options: Optional[FleetOptions] = None, *,
                 clock: Callable[[], float] = time.monotonic,
                 make_service: Optional[Callable] = None,
                 durable_dir: Optional[str] = None,
                 replicas: Optional[List[ReplicaHandle]] = None,
                 device=None):
        if replicas is not None:
            # caller-built handles (e.g. fleet.remote.connect_fleet):
            # they own their services and journal dirs; the router's
            # replica count follows the handles, everything else —
            # routing, shed, heartbeat failover, gossip — is identical
            if not replicas:
                raise ValueError("replicas must be non-empty when given")
            if options is None:
                options = FleetOptions.from_env(n_replicas=len(replicas))
            elif options.n_replicas != len(replicas):
                options = dataclasses.replace(
                    options, n_replicas=len(replicas))
        self.options = options if options is not None else FleetOptions.from_env()
        if self.options.n_replicas < 1:
            raise ValueError(
                f"n_replicas must be >= 1, got {self.options.n_replicas}")
        self._clock = clock
        self._multi = self.options.n_replicas > 1
        # guards the router's own maps only — never held across a
        # replica service call (see module docstring)
        self._lock = sanitized_lock("fleet.router")
        if durable_dir is None and self._multi and replicas is None:
            durable_dir = tempfile.mkdtemp(prefix="dispatches-fleet-")
        self.durable_dir = durable_dir
        if replicas is not None:
            self._replicas = list(replicas)
        else:
            if make_service is None:
                def make_service(replica_id, journal_dir):
                    return SolveService(clock=clock, journal_dir=journal_dir,
                                        device=device)
            self._replicas = []
            for i in range(self.options.n_replicas):
                journal_dir = None
                if durable_dir is not None:
                    journal_dir = os.path.join(durable_dir,
                                               f"replica-{i:02d}")
                self._replicas.append(ReplicaHandle(
                    i, make_service(i, journal_dir),
                    journal_dir=journal_dir, clock=clock,
                    heartbeat_timeout_ms=self.options.heartbeat_timeout_ms))
        self._by_id = {r.replica_id: r for r in self._replicas}
        self._rng = random.Random(self.options.seed)
        #: (replica_id, request_id) -> _Tracked, pruned as handles finish
        self._tracked: Dict[Tuple[int, int], _Tracked] = {}
        #: (re-homed twin, orphan handle) pairs awaiting completion
        self._bridges: List[Tuple[object, object]] = []
        self._affinity: "OrderedDict[str, int]" = OrderedDict()
        # rehome fallbacks for requests submitted before a restart of
        # the router itself (journal records carry no live objects)
        self._default_nlp = None
        self._default_base_solver = None
        self._submitted = 0
        self._shed = 0
        self.failovers = 0
        self.rehomed = 0
        self.rehome_lost = 0
        self._shed_seq = itertools.count(1)
        #: injectable fleet-wide shed signal (mirrors
        #: ``SolveService.shed_signal``): while it returns True, new
        #: submits are refused at the router
        self.shed_signal: Optional[Callable[[], bool]] = None
        self._gossip = (Gossip(self._replicas,
                               interval_s=self.options.gossip_interval_s,
                               clock=clock)
                        if self._multi else None)
        self._obs_failovers = obs_registry.counter(
            "fleet.failovers", "replicas declared dead and failed over "
            "(label=replica)")
        self._obs_rehomed = obs_registry.counter(
            "fleet.rehomed", "open requests re-homed onto survivors at "
            "failover (label=replica is the dead source)")
        self._obs_shed = obs_registry.counter(
            "fleet.shed", "requests refused at the router (fleet shed "
            "rung or injected router.submit fault)")
        self._obs_depth = obs_registry.gauge(
            "fleet.replica.queue_depth",
            "pending requests per replica (label=replica)")
        self._obs_alive = obs_registry.gauge(
            "fleet.replicas_alive", "live replicas behind the router")
        # fleet-mode continuous export: when OBS_FLEET_EXPORT_DIR is
        # set, one metrics.prom merges the router's registry with live
        # remote-replica snapshots (process-labeled).  Disarmed, poll
        # pays one `is None` check.
        self._exporter = None
        exp_dir = os.environ.get(flag_name("OBS_FLEET_EXPORT_DIR"), "")
        if exp_dir:
            try:
                from dispatches_tpu_torch.obs import export as obs_export

                self._exporter = obs_export.ContinuousExporter(
                    obs_export.ExportOptions.from_env(directory=exp_dir),
                    clock=clock,
                    fleet_snapshots=self.replica_snapshots)
            except Exception:
                self._exporter = None  # telemetry never blocks serving
        self._update_gauges()

    # -- introspection -----------------------------------------------------

    @property
    def replicas(self) -> Tuple[ReplicaHandle, ...]:
        return tuple(self._replicas)

    def live_replicas(self) -> List[ReplicaHandle]:
        return [r for r in self._replicas if r.alive]

    # -- submission --------------------------------------------------------

    def submit(self, nlp, params=None, x0=None, *, solver: str = "auto",
               options: Optional[Dict] = None,
               deadline_ms: Optional[float] = None,
               warm_key=None, base_solver=None):
        """Route one request to a replica; returns its SolveHandle.

        Single-replica mode is a pure pass-through (bitwise-identical
        to calling the service directly — the parity contract); the
        fleet shed rung and routing policy engage only with replicas
        to choose between.
        """
        if not self._multi:
            return self._replicas[0].service.submit(
                nlp, params, x0, solver=solver, options=options,
                deadline_ms=deadline_ms, warm_key=warm_key,
                base_solver=base_solver)
        now = self._clock()
        params = nlp.default_params() if params is None else params
        deadline_at = None if deadline_ms is None else now + deadline_ms / 1e3
        if _faults.armed():
            try:
                _faults.check("router.submit", label="fleet")
            except _faults.InjectedFault as exc:
                _faults.note_recovered(exc)
                return self._refuse(params, now, deadline_at)
        if self.shed_signal is not None and self.shed_signal():
            return self._refuse(params, now, deadline_at)
        live = self.live_replicas()
        if not live:
            raise RuntimeError("fleet has no live replicas")
        depth_limit = self.options.shed_queue_depth
        if depth_limit is not None and all(
                r.queue_depth() >= depth_limit for r in live):
            return self._refuse(params, now, deadline_at)
        replica = self._choose(live, params, deadline_ms, now)
        handle = replica.service.submit(
            nlp, params, x0, solver=solver, options=options,
            deadline_ms=deadline_ms, warm_key=warm_key,
            base_solver=base_solver)
        with self._lock:
            self._submitted += 1
            self._default_nlp = nlp
            self._default_base_solver = base_solver
            self._tracked[(replica.replica_id, handle.request_id)] = \
                _Tracked(handle, nlp, base_solver, params=params,
                         solver=solver, options=options,
                         deadline_ms=deadline_ms)
        return handle

    def _refuse(self, params, now, deadline_at) -> _FleetShedHandle:
        with self._lock:
            self._submitted += 1
            self._shed += 1
            request_id = -next(self._shed_seq)
        self._obs_shed.inc()
        return _FleetShedHandle(params, now, deadline_at, request_id)

    def _choose(self, live, params, deadline_ms, now) -> ReplicaHandle:
        fingerprint = request_fingerprint(params)
        depth_limit = self.options.shed_queue_depth
        if self.options.affinity:
            with self._lock:
                rid = self._affinity.get(fingerprint)
            if rid is not None:
                replica = self._by_id.get(rid)
                if (replica is not None and replica.alive
                        and (depth_limit is None
                             or replica.queue_depth() < depth_limit)):
                    return replica
        if len(live) == 1:
            choice = live[0]
        else:
            a, b = self._rng.sample(live, 2)
            choice = min((a, b),
                         key=lambda r: self._score(r, deadline_ms, now))
        if self.options.affinity:
            with self._lock:
                self._affinity[fingerprint] = choice.replica_id
                self._affinity.move_to_end(fingerprint)
                while len(self._affinity) > _AFFINITY_MAX:
                    self._affinity.popitem(last=False)
        return choice

    def _score(self, replica: ReplicaHandle, deadline_ms, now) -> float:
        depth = replica.queue_depth()
        score = float(depth)
        if deadline_ms is not None:
            est_s = replica.est_service_s()
            if est_s:
                max_batch = max(replica.service.options.max_batch, 1)
                batches_ahead = depth // max_batch + 1
                if batches_ahead * est_s > deadline_ms / 1e3:
                    score += _SLACK_PENALTY
        return score

    # -- dispatch / liveness ----------------------------------------------

    def poll(self, now: Optional[float] = None) -> int:
        """Poll every live replica, pump heartbeats, detect and fail
        over dead replicas, tick gossip, and complete bridged orphans.
        Returns the number of requests the replicas dispatched."""
        now = self._clock() if now is None else now
        n = 0
        for replica in self._replicas:
            if not replica.alive:
                continue
            try:
                n += replica.service.poll(now)
            except Exception as exc:
                # fail-stop containment: a poll that escaped the plan's
                # retry/bisection/watchdog domains means the replica is
                # wedged — treat it as crashed; the heartbeat timeout
                # below turns that into a failover.  Bundle the evidence
                # (including the replica's own metrics, reachable only
                # until the kill closes its client) first.
                self._flight_poll_error(replica, exc)
                replica.kill()
        if self._multi:
            for replica in self._replicas:
                replica.heartbeat(now)
            self._check_failover(now)
            if self._gossip is not None:
                self._gossip.maybe_exchange(now)
        self._pump_bridges()
        self._prune_tracked()
        self._update_gauges()
        if self._exporter is not None:
            self._exporter.maybe_export(now)
        return n

    @staticmethod
    def _flight_poll_error(replica: ReplicaHandle, exc: Exception) -> None:
        """Router-side plan_error bundle for a fail-stopped replica,
        carrying that replica's metrics snapshot when it can still be
        pulled (remote handles expose ``metrics_snapshot``; in-process
        ones share the router's registry).  Best-effort, never raises."""
        from dispatches_tpu_torch.obs import flight as obs_flight

        if not obs_flight.enabled():
            return
        try:
            puller = getattr(replica, "metrics_snapshot", None)
            snapshot = puller() if callable(puller) else None
            obs_flight.trigger(
                "plan_error",
                label=replica.name,
                detail={"replica": replica.name,
                        "error": f"{type(exc).__name__}: {exc}",
                        "worker_pid": getattr(replica, "worker_pid", None),
                        "replica_snapshot": snapshot})
        except Exception:
            pass  # diagnostics must never break containment

    def flush_all(self) -> int:
        """Drain every live replica's pending queue; returns how many
        requests were handled.  Bridged orphans complete afterwards."""
        n = 0
        for replica in self._replicas:
            if replica.alive:
                n += replica.service.flush_all()
        self._pump_bridges()
        self._update_gauges()
        return n

    def drain(self) -> Dict[str, Dict]:
        """Graceful fleet shutdown: drain every live replica (final
        snapshot + clean journal marker each); per-replica reports."""
        reports = {}
        for replica in self._replicas:
            if replica.alive:
                reports[replica.name] = replica.service.drain()
        self._pump_bridges()
        return reports

    def kill(self, replica_id: int) -> ReplicaHandle:
        """Fail-stop one replica (chaos/soak kill windows).  Detection
        and failover are NOT run here — they happen in :meth:`poll`
        when the heartbeat silence exceeds the timeout, so the router
        learns of the death exactly as it would in production."""
        replica = self._by_id[replica_id]
        replica.kill()
        self._update_gauges()
        return replica

    def _check_failover(self, now: float) -> None:
        # detection is by heartbeat SILENCE, not by the alive flag: a
        # locally-killed replica (router.kill, fail-stop poll) stops
        # beating and ages out exactly like a remote crash would, so
        # the detection latency the soak measures is honest
        for replica in self._replicas:
            if replica.failed_over:
                continue
            if replica.beat_age_ms(now) <= replica.heartbeat_timeout_ms:
                continue
            self._fail_replica(replica, now)

    def _fail_replica(self, replica: ReplicaHandle, now: float) -> None:
        replica.failed_over = True
        replica.kill()
        self.failovers += 1
        self._obs_failovers.inc(replica=replica.name)
        result = handoff_mod.rehome(self, replica)
        self.rehomed += result.rehomed
        self.rehome_lost += result.lost
        if result.rehomed:
            self._obs_rehomed.inc(result.rehomed, replica=replica.name)
        self._resolve_stranded(replica)
        self._update_gauges()

    def _resolve_stranded(self, dead: ReplicaHandle) -> None:
        """Re-solve requests the journal considers closed but whose
        client handle never got the result.

        Journal replay only re-homes requests that were still *open*
        on the dead replica's books.  A wire-tier worker can complete
        a request (journal it terminal) and then die with the result
        sitting undelivered in its done-buffer — replay skips it, yet
        the caller's handle would hang forever.  Every tracked entry
        for the dead replica that survives ``rehome``'s pops and is
        not ``done()`` is exactly that case (or a request whose accept
        never hit the journal before the crash): resubmit it from the
        router's own copy of the request and bridge the orphan.
        Solvers are deterministic, so the twin reproduces the lost
        result; handle complete-once keeps delivery exactly-once."""
        with self._lock:
            mine = [key for key in self._tracked
                    if key[0] == dead.replica_id]
            stranded = [self._tracked.pop(key) for key in mine]
        stranded = [t for t in stranded if not t.handle.done()]
        resolved = lost = 0
        for tracked in stranded:
            survivor = self._pick_survivor()
            if survivor is None or tracked.nlp is None:
                lost += 1
                continue
            try:
                twin = survivor.service.submit(
                    tracked.nlp, tracked.params, solver=tracked.solver,
                    options=tracked.options,
                    deadline_ms=tracked.deadline_ms,
                    base_solver=tracked.base_solver)
            except Exception:
                lost += 1
                continue
            resolved += 1
            self._track(survivor, twin, tracked.nlp,
                        tracked.base_solver, params=tracked.params,
                        solver=tracked.solver, options=tracked.options,
                        deadline_ms=tracked.deadline_ms)
            self._bridge(twin, tracked.handle)
        self.rehomed += resolved
        self.rehome_lost += lost
        if resolved:
            self._obs_rehomed.inc(resolved, replica=dead.name)

    # -- handoff plumbing (called by fleet.handoff) ------------------------

    def _pop_tracked(self, replica_id: int,
                     request_id: int) -> Optional[_Tracked]:
        with self._lock:
            return self._tracked.pop((int(replica_id), int(request_id)),
                                     None)

    def _track(self, replica: ReplicaHandle, handle, nlp,
               base_solver, params=None, solver=None, options=None,
               deadline_ms=None) -> None:
        with self._lock:
            self._tracked[(replica.replica_id, handle.request_id)] = \
                _Tracked(handle, nlp, base_solver, params=params,
                         solver=solver, options=options,
                         deadline_ms=deadline_ms)

    def _bridge(self, twin, orphan) -> None:
        with self._lock:
            self._bridges.append((twin, orphan))

    def _pick_survivor(self) -> Optional[ReplicaHandle]:
        live = self.live_replicas()
        if not live:
            return None
        return min(live, key=lambda r: r.queue_depth())

    def _pump_bridges(self) -> None:
        """Complete orphaned pre-crash handles whose re-homed twins
        finished (``SolveHandle._complete`` only stores the result, so
        completing an orphan off-service is safe)."""
        with self._lock:
            if not self._bridges:
                return
            pending, self._bridges = self._bridges, []
        still_open = []
        for twin, orphan in pending:
            if twin.done():
                if not orphan.done():
                    orphan._complete(twin._result)
            else:
                still_open.append((twin, orphan))
        if still_open:
            with self._lock:
                self._bridges = still_open + self._bridges

    def _prune_tracked(self) -> None:
        with self._lock:
            if not self._tracked:
                return
            self._tracked = {key: t for key, t in self._tracked.items()
                             if not t.handle.done()}

    def _update_gauges(self) -> None:
        alive = 0
        for replica in self._replicas:
            depth = replica.queue_depth()
            if replica.alive:
                alive += 1
            self._obs_depth.set(float(depth), replica=replica.name)
        self._obs_alive.set(float(alive))

    # -- telemetry ---------------------------------------------------------

    def replica_snapshots(self) -> Dict[str, Dict]:
        """Live remote replicas' registry snapshots, keyed by a
        ``<name>:pid<pid>`` process label — the fleet exporter's and
        trace merger's pull source.  Replicas without a
        ``metrics_snapshot`` surface (in-process handles share the
        router's registry already) and failed pulls are skipped."""
        out: Dict[str, Dict] = {}
        for replica in self._replicas:
            puller = getattr(replica, "metrics_snapshot", None)
            if not callable(puller):
                continue
            snap = puller()
            if not snap:
                continue
            pid = snap.get("pid", getattr(replica, "worker_pid", None))
            out[f"{replica.name}:pid{pid}"] = snap.get("snapshot") or {}
        return out

    def trace_exports(self, limit: int = 0) -> List[Dict]:
        """Live remote replicas' trace rings, clock-aligned and shaped
        for ``obs.distributed.merge_traces`` remotes.  Each pull first
        refreshes the replica's clock-offset estimate (best effort);
        replicas without a trace surface are skipped."""
        out: List[Dict] = []
        for replica in self._replicas:
            puller = getattr(replica, "trace_export", None)
            if not callable(puller):
                continue
            refresh = getattr(replica, "refresh_clock", None)
            if callable(refresh):
                try:
                    refresh()
                except Exception:
                    pass
            resp = puller(limit)
            if not resp:
                continue
            sync = getattr(replica, "clock_sync", None)
            out.append({
                "pid": resp.get("pid"),
                "label": replica.name,
                "offset_us": 0.0 if sync is None else sync.offset_us,
                "events": resp.get("events") or [],
                "dropped": int(resp.get("dropped") or 0),
            })
        return out

    def fleet_stats(self) -> Dict:
        """The ``fleet`` telemetry block (also embedded by
        :meth:`metrics`)."""
        per = {}
        for replica in self._replicas:
            m = replica.metrics()
            sync = getattr(replica, "clock_sync", None)
            per[replica.name] = {
                "alive": replica.alive,
                "generation": replica.generation,
                # real worker identity (remote replicas record these
                # from the hello; in-process replicas report None)
                "pid": getattr(replica, "worker_pid", None),
                "endpoint": getattr(replica, "endpoint", None),
                "clock_offset_us": (None if sync is None
                                    else round(sync.offset_us, 1)),
                "beats": replica.beats,
                "beats_lost": replica.beats_lost,
                "submitted": None if m is None else m["submitted"],
                "solved": None if m is None else m["solved"],
                "queue_depth": None if m is None else m["queue_depth"],
            }
        return {
            "n_replicas": len(self._replicas),
            "alive": sum(1 for r in self._replicas if r.alive),
            "failovers": self.failovers,
            "rehomed": self.rehomed,
            "rehome_lost": self.rehome_lost,
            "fleet_shed": self._shed,
            "bridges_open": len(self._bridges),
            "tracked_inflight": len(self._tracked),
            "gossip": (None if self._gossip is None else
                       {"exchanges": self._gossip.exchanges,
                        "entries_merged": self._gossip.entries_merged}),
            "per_replica": per,
        }

    def metrics(self) -> Dict:
        """Service-shaped telemetry plus a ``fleet`` block.

        Single-replica mode returns the underlying service's metrics
        verbatim (plus ``fleet``).  Multi-replica mode sums the count
        metrics across replicas (dead replicas contribute their
        at-death snapshot); latency/queue-wait percentiles do not
        aggregate across replicas and are reported per replica only.
        """
        if not self._multi:
            m = self._replicas[0].service.metrics()
            m["fleet"] = self.fleet_stats()
            return m
        agg: Dict = {
            "submitted": self._submitted,
            "solved": 0, "timeouts": 0, "errors": 0,
            "shed": self._shed,
            "queue_depth": 0, "flushes": 0, "batches": 0,
            "compile_count": 0, "programs": 0,
        }
        deadline = {"requests": 0, "missed": 0}
        warm = {"hits": 0, "neighbor_hits": 0, "misses": 0,
                "mispredicts": 0, "size": 0}
        for replica in self._replicas:
            m = replica.metrics()
            if m is None:
                continue
            for key in ("solved", "timeouts", "errors", "shed",
                        "flushes", "batches", "compile_count",
                        "programs"):
                agg[key] += m[key]
            if replica.alive:
                agg["queue_depth"] += m["queue_depth"]
            for key in deadline:
                deadline[key] += m["deadline"][key]
            for key in warm:
                warm[key] += m["warm_start"][key]
        lookups = warm["hits"] + warm["neighbor_hits"] + warm["misses"]
        warm["hit_rate"] = ((warm["hits"] + warm["neighbor_hits"]) / lookups
                            if lookups else 0.0)
        total = sum(
            (replica.metrics() or {}).get("submitted", 0)
            for replica in self._replicas)
        deadline["miss_rate"] = (deadline["missed"] / total if total
                                 else 0.0)
        agg["deadline"] = deadline
        agg["warm_start"] = warm
        agg["fleet"] = self.fleet_stats()
        return agg
