"""One replica of the solve service behind the fleet router (counterpart
of ``dispatches_tpu/fleet/replica.py``).

:class:`ReplicaHandle` wraps a :class:`~dispatches_tpu_torch.serve.SolveService`
with the lifecycle and health state the router needs — heartbeats on
the injectable clock, the journal directory failover replays from, and
a fail-stop :meth:`kill` that models a process crash (the service
object is dropped mid-flight; nothing is drained, no clean-shutdown
marker is journaled, so recovery sees exactly what a real crash would
leave behind).

Heartbeats go through the ``replica.heartbeat`` fault site: an armed
rule silently drops the beat (contained — the router's timeout logic,
not an exception, is what detects the silence), so chaos runs exercise
the same detection path a wedged replica would.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from dispatches_tpu_torch.faults import inject as _faults
from dispatches_tpu_torch.obs import registry as obs_registry

__all__ = ["ReplicaHandle"]

DEFAULT_HEARTBEAT_TIMEOUT_MS = 500.0


class ReplicaHandle:
    """Lifecycle + health wrapper around one SolveService replica."""

    def __init__(self, replica_id: int, service, *,
                 journal_dir: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic,
                 heartbeat_timeout_ms: float = DEFAULT_HEARTBEAT_TIMEOUT_MS):
        self.replica_id = int(replica_id)
        self.name = f"replica-{self.replica_id:02d}"
        self.service = service
        #: directory the replica journals into — the failover path
        #: replays it after death, so it must outlive the service
        self.journal_dir = journal_dir
        self._clock = clock
        self.heartbeat_timeout_ms = float(heartbeat_timeout_ms)
        self.alive = True
        #: set by the router once failover has run for this replica —
        #: a journal must be re-homed at most once
        self.failed_over = False
        self.generation = int(getattr(service, "generation", 1))
        self.born_at = clock()
        self.last_beat = self.born_at
        self.beats = 0
        self.beats_lost = 0
        #: metrics snapshot taken at :meth:`kill` so a dead replica
        #: still accounts for the work it did
        self.final_metrics: Optional[dict] = None
        self._obs_beats = obs_registry.counter(
            "fleet.heartbeats", "replica heartbeats seen by the router "
            "(label=replica; event=ok|lost — lost means an armed "
            "replica.heartbeat fault swallowed the beat)")

    # -- health ------------------------------------------------------------

    def heartbeat(self, now: Optional[float] = None) -> bool:
        """Record one liveness beat; returns False when the replica is
        dead or an armed ``replica.heartbeat`` fault ate the beat."""
        if not self.alive or self.service is None:
            return False
        now = self._clock() if now is None else now
        if _faults.armed():
            try:
                _faults.check("replica.heartbeat", label=self.name)
            except _faults.InjectedFault as exc:
                _faults.note_recovered(exc)
                self.beats_lost += 1
                self._obs_beats.inc(replica=self.name, event="lost")
                return False
        self.last_beat = now
        self.beats += 1
        self._obs_beats.inc(replica=self.name, event="ok")
        return True

    def beat_age_ms(self, now: Optional[float] = None) -> float:
        now = self._clock() if now is None else now
        return (now - self.last_beat) * 1e3

    def healthy(self, now: Optional[float] = None) -> bool:
        """Alive with a recent-enough beat.  A killed replica stops
        beating, so this goes False one heartbeat timeout after the
        crash — detection latency is honest, never instantaneous."""
        return self.alive and self.beat_age_ms(now) <= self.heartbeat_timeout_ms

    # -- routing signals ---------------------------------------------------

    def queue_depth(self) -> int:
        if not self.alive or self.service is None:
            return 0
        return self.service._queue_depth()

    def est_service_s(self) -> Optional[float]:
        """Worst-case (max) per-batch service-time estimate across the
        replica's buckets, in seconds; None before any bucket has a
        calibrated estimate."""
        if not self.alive or self.service is None:
            return None
        best = None
        for bucket in self.service._buckets.values():
            est = getattr(bucket, "est", None)
            if est is None:
                continue
            val = est.estimate_s()
            if val is not None and (best is None or val > best):
                best = val
        return best

    # -- gossip ------------------------------------------------------------

    def gossip_donate(self) -> dict:
        """This replica's donation for one gossip round:
        ``{bucket label: snapshot bucket state}`` (JSON-safe).  A
        remote handle overrides this with a ``gossip_donate`` RPC."""
        if not self.alive or self.service is None:
            return {}
        from dispatches_tpu_torch.fleet import gossip as gossip_mod

        return gossip_mod.donate_states(self.service)

    def gossip_adopt(self, pairs) -> int:
        """Merge ordered ``(label, state)`` donations into this
        replica's service; returns warm-index entries adopted.  A
        remote handle overrides this with a ``gossip_merge`` RPC."""
        if not self.alive or self.service is None:
            return 0
        from dispatches_tpu_torch.fleet import gossip as gossip_mod

        return sum(gossip_mod.merge_bucket_state(self.service, label, state)
                   for label, state in pairs)

    # -- lifecycle ---------------------------------------------------------

    def kill(self) -> None:
        """Fail-stop crash: drop the service object mid-flight.

        Nothing is drained and no clean-shutdown marker is written —
        the journal directory is left exactly as a crashed process
        would leave it (flushed accept/status records, no ``clean``),
        which is what :func:`dispatches_tpu_torch.fleet.handoff.rehome`
        replays.  The journal file handle is closed (we share the
        process with the survivors; a real crash gets this for free).
        """
        if not self.alive:
            return
        self.alive = False
        service, self.service = self.service, None
        if service is None:
            return
        try:
            self.final_metrics = service.metrics()
        except Exception:
            self.final_metrics = None
        journal = getattr(service, "_journal", None)
        if journal is not None:
            try:
                journal.close()
            except Exception:
                pass

    def metrics(self) -> Optional[dict]:
        """Live metrics, or the at-death snapshot for a dead replica."""
        if self.alive and self.service is not None:
            return self.service.metrics()
        return self.final_metrics
