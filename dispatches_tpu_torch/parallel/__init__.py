"""Parallel execution layer: scenario sharding over a device mesh
(counterpart of ``dispatches_tpu/parallel``).

The latent parallel dimensions (LMP scenarios, rolling-horizon days,
stochastic bid scenarios) all map to one pattern: a batch axis split
over a 1-D :class:`~dispatches_tpu_torch.parallel.sharding.Mesh` of torch
devices, with a lane-batched solver running each shard on its device.
"""

from dispatches_tpu_torch.parallel.sharding import (
    Mesh,
    scenario_mesh,
    scenario_sharded_solver,
)

__all__ = ["Mesh", "scenario_mesh", "scenario_sharded_solver"]
