"""Failover: replay a dead replica's journal, re-home its open work
(counterpart of ``dispatches_tpu/fleet/handoff.py``).

When the router declares a replica dead (heartbeat timeout or a poll
that escaped its failure domains), :func:`rehome` replays the
replica's write-ahead journal with
:func:`dispatches_tpu_torch.serve.journal.replay` — the open set is keyed by
request id with ``orig``-link supersede semantics, so requests the
dead replica itself had recovered earlier are not double-counted —
and resubmits every still-open request onto the least-loaded
survivor.  The resubmission goes through the survivor's normal
``submit`` path, so it lands in the survivor's OWN journal as a fresh
accept: a second failure replays it there.  Deadlines restart their
relative budget, same as single-service crash recovery (the original
absolute instant lived on a dead replica's books).

Client handles issued against the dead replica are bridged: the router
remembers ``(replica_id, request_id) -> handle`` at submit, and
:func:`rehome` pairs each orphan with its re-homed twin.  The router's
poll pump completes the orphan with the twin's result once it lands,
so a caller holding a pre-crash handle still sees a terminal status —
the fleet-level no-hang contract.
"""
from __future__ import annotations

from typing import NamedTuple

from dispatches_tpu_torch.serve import journal as journal_mod

__all__ = ["RehomeResult", "rehome"]


class RehomeResult(NamedTuple):
    replayed: int   # open requests found in the dead replica's journal
    rehomed: int    # resubmitted onto survivors (re-journaled there)
    lost: int       # could not be re-homed (no survivor / no nlp / error)


def rehome(router, dead) -> "RehomeResult":
    """Replay ``dead``'s journal and re-home its open requests through
    ``router`` onto the surviving replicas.  Never raises: a request
    that cannot be re-homed is counted ``lost``, not thrown."""
    if dead.journal_dir is None:
        return RehomeResult(0, 0, 0)
    try:
        replayed = journal_mod.replay(dead.journal_dir)
    except Exception:
        return RehomeResult(0, 0, 0)
    rehomed = lost = 0
    for rec in replayed.open_requests:
        tracked = router._pop_tracked(dead.replica_id, rec["id"])
        if tracked is not None and tracked.handle.done():
            # the client already holds a terminal result (e.g. shed or
            # timed out before the crash); re-solving it would be a
            # duplicate, not a rescue
            continue
        survivor = router._pick_survivor()
        nlp = tracked.nlp if tracked is not None else router._default_nlp
        base_solver = (tracked.base_solver if tracked is not None
                       else router._default_base_solver)
        if survivor is None or nlp is None:
            lost += 1
            continue
        try:
            twin = survivor.service.submit(
                nlp, rec["params"], solver=rec["solver"],
                options=rec["options"], deadline_ms=rec["deadline_ms"],
                base_solver=base_solver)
        except Exception:
            lost += 1
            continue
        rehomed += 1
        router._track(survivor, twin, nlp, base_solver,
                      params=rec["params"], solver=rec["solver"],
                      options=rec["options"],
                      deadline_ms=rec["deadline_ms"])
        if tracked is not None:
            router._bridge(twin, tracked.handle)
    return RehomeResult(len(replayed.open_requests), rehomed, lost)
