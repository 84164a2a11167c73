"""Fleet serve: a replicated :class:`~dispatches_tpu_torch.serve.SolveService`
tier behind one submit/poll/flush façade (counterpart of
``dispatches_tpu/fleet/``).

The :class:`FleetRouter` owns N replicas (each a full SolveService with
its own ExecutionPlan and write-ahead journal directory) and routes
each request with power-of-two-choices on queue depth plus a
deadline-slack penalty, with bucket-fingerprint affinity so repeat
parameters land on the replica whose warm-start index already knows
them.  Liveness is heartbeat-based (``docs/fleet.md``): a replica whose
last beat ages past the timeout is declared dead and failed over —
its journal is replayed (:mod:`dispatches_tpu_torch.fleet.handoff`) and the
open requests re-homed onto survivors, re-journaled there so a second
failure replays them again.  Replicas periodically gossip warm-start
index entries and admission service-time estimates
(:mod:`dispatches_tpu_torch.fleet.gossip`) through the snapshot codec, so a
cold or re-joined replica serves with the fleet's calibration instead
of relearning it.

``n_replicas == 1`` (the default) is a pure pass-through: no gossip,
no heartbeat machinery, bitwise-identical behaviour to a bare
SolveService.

The replicas need not share the router's process:
:class:`~dispatches_tpu_torch.fleet.remote.RemoteReplicaHandle` presents the
same handle surface over RPC to a
``python -m dispatches_tpu_torch.net --worker`` process
(:func:`~dispatches_tpu_torch.fleet.remote.connect_fleet` wires a whole
fleet of them), and the router routes/sheds/heartbeat-failovers over
it unchanged — journal handoff re-homes a killed worker's open
requests from its journal directory on a shared filesystem
(``docs/net.md``).
"""
from dispatches_tpu_torch.fleet.gossip import Gossip
from dispatches_tpu_torch.fleet.handoff import RehomeResult, rehome
from dispatches_tpu_torch.fleet.remote import (
    RemoteReplicaHandle,
    RemoteServiceFacade,
    connect_fleet,
)
from dispatches_tpu_torch.fleet.replica import ReplicaHandle
from dispatches_tpu_torch.fleet.router import FleetOptions, FleetRouter

__all__ = [
    "FleetOptions",
    "FleetRouter",
    "Gossip",
    "RehomeResult",
    "RemoteReplicaHandle",
    "RemoteServiceFacade",
    "ReplicaHandle",
    "connect_fleet",
    "rehome",
]
