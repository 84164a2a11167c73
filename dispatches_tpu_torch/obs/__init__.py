"""Observability of the port (``dispatches_tpu.obs`` counterpart, in
part): the metrics registry, the span tracer with its sinks, the
streaming analytics (``online``), the pipeline timeline (``timeline``)
and the cost cards (``profile``).  The report, solver-log, ledger, SLO,
flight and export modules are not ported yet (``ROADMAP.md``)."""

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
