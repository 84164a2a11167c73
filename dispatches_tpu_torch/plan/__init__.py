"""The execution-plan layer of the port: mesh placement, bounded (or
adaptive, :mod:`~dispatches_tpu_torch.plan.adaptive`) dispatch-ahead
batching, retries and lane bisection for every solve path (see
:mod:`dispatches_tpu_torch.plan.execution`)."""

from dispatches_tpu_torch.plan.execution import (
    ExecutionPlan,
    PlanError,
    PlanOptions,
    PlanProgram,
    PlanTicket,
)

__all__ = ["ExecutionPlan", "PlanError", "PlanOptions", "PlanProgram",
           "PlanTicket"]
