"""Micro-batching solve service of the port (counterpart of
``dispatches_tpu.serve``): turns the lane-batched solvers into a
request-serving layer."""

from dispatches_tpu_torch.serve.bucket import (
    lane_menu,
    pad_lanes,
    params_signature,
    request_fingerprint,
)
from dispatches_tpu_torch.serve.metrics import format_stats
from dispatches_tpu_torch.serve.service import (
    RequestStatus,
    ServeOptions,
    ServeResult,
    SolveHandle,
    SolveService,
    get_default_service,
    set_default_service,
)

__all__ = [
    "RequestStatus",
    "ServeOptions",
    "ServeResult",
    "SolveHandle",
    "SolveService",
    "format_stats",
    "get_default_service",
    "lane_menu",
    "pad_lanes",
    "params_signature",
    "request_fingerprint",
    "set_default_service",
]
