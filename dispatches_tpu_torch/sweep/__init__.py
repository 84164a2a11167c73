"""Design-space sweep engine of the port (counterpart of
``dispatches_tpu.sweep``): declarative specs, chunked batched execution
through the execution plan or the solve service, chunk-checkpointed fault
tolerance in an on-disk result store, and the sweep->surrogate handoff."""

from dispatches_tpu_torch.sweep.engine import SweepOptions, run_sweep
from dispatches_tpu_torch.sweep.spec import Axis, SweepSpec, grid, lhs, synhist
from dispatches_tpu_torch.sweep.store import (
    STATUS_OK,
    STATUS_QUARANTINED,
    STATUS_REFINE_FAILED,
    STATUS_RETRIED,
    ResultStore,
    format_report,
)
from dispatches_tpu_torch.sweep.surrogate import SweepData, train_revenue_surrogate

__all__ = [
    "Axis",
    "ResultStore",
    "STATUS_OK",
    "STATUS_QUARANTINED",
    "STATUS_REFINE_FAILED",
    "STATUS_RETRIED",
    "SweepData",
    "SweepOptions",
    "SweepSpec",
    "format_report",
    "grid",
    "lhs",
    "run_sweep",
    "synhist",
    "train_revenue_surrogate",
]
