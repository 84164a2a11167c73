"""dispatches_tpu_torch.obs — tracing, metrics, and solver telemetry
(counterpart of ``dispatches_tpu.obs``):

* :mod:`~dispatches_tpu_torch.obs.registry` — process-wide labeled
  counters / gauges / histograms (``serve``'s ``--stats`` is built on it);
* :mod:`~dispatches_tpu_torch.obs.trace` — contextvar span tracer with
  explicit device fencing, sinks and Chrome-trace export (Perfetto);
* :mod:`~dispatches_tpu_torch.obs.solverlog` — decode per-iteration IPM /
  PDLP / Newton convergence telemetry captured by the solvers;
* :mod:`~dispatches_tpu_torch.obs.profile` — opt-in cost cards per plan
  program signature (``DISPATCHES_TPU_OBS_PROFILE``);
* :mod:`~dispatches_tpu_torch.obs.ledger` — append-only JSONL perf ledger
  with the ``--check-regressions`` CI gate;
* :mod:`~dispatches_tpu_torch.obs.slo` — declarative SLO objectives
  graded from registry snapshots (``--slo [--check]``);
* :mod:`~dispatches_tpu_torch.obs.flight` — triggered flight recorder
  dumping diagnostic bundles on anomalies
  (``DISPATCHES_TPU_OBS_FLIGHT_DIR``; ``--flight``);
* :mod:`~dispatches_tpu_torch.obs.timeline` — per-batch execution-plan
  pipeline timeline: overlap efficiency, in-flight occupancy, stall
  attribution (``--timeline``);
* :mod:`~dispatches_tpu_torch.obs.export` — continuous telemetry export
  for long-running processes: Prometheus text rendering + periodic JSONL
  time series (``DISPATCHES_TPU_OBS_EXPORT_DIR``);
* :mod:`~dispatches_tpu_torch.obs.online` and
  :mod:`~dispatches_tpu_torch.obs.soak` — streaming analytics and the
  soak harness (``--soak``);
* :mod:`~dispatches_tpu_torch.obs.distributed` — wire-level trace
  context, clock alignment and multi-process trace/metrics merging for
  the fleet tier (``DISPATCHES_TPU_NET_TRACE``).

Everything here is disabled by default; set ``DISPATCHES_TPU_OBS=1``
(or call :func:`enable`) to record, and run
``python -m dispatches_tpu_torch.obs --report`` for the rollup.
"""

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
from dispatches_tpu_torch.obs.solverlog import (  # noqa: F401
    ConvergenceTrace,
    decode_ipm,
    decode_newton,
    decode_pdlp,
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
from dispatches_tpu_torch.obs.report import (  # noqa: F401
    aggregate_spans,
    format_report,
    load_chrome_trace,
    request_journey,
    validate_chrome_trace,
)
from dispatches_tpu_torch.obs import (  # noqa: F401
    distributed,
    export,
    flight,
    ledger,
    profile,
    slo,
    timeline,
)
