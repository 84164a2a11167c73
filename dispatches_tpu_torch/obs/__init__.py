"""Observability of the port (``dispatches_tpu.obs`` counterpart, in
part): the metrics registry, the span tracer and the P² streaming
quantile.  The report, solver-log, profile, ledger, SLO, flight,
timeline and export modules are not ported yet (``ROADMAP.md``)."""

from dispatches_tpu_torch.obs.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    counter,
    default_registry,
    diff_snapshots,
    gauge,
    histogram,
)
from dispatches_tpu_torch.obs.trace import (  # noqa: F401
    dropped,
    enable,
    enabled,
    events,
    export_chrome_trace,
    instant,
    reset,
    span,
)
