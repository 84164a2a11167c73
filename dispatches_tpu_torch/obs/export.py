"""Continuous telemetry export for long-running processes (counterpart
of ``dispatches_tpu/obs/export.py``; the Prometheus text and the JSONL
records are byte-compatible with the JAX package's, series names
included).

The registry's end-of-run views (``--report``, ``--stats``) answer
nothing about a serve process that is *still running* — the north
star's always-on service needs to be scraped mid-run.  Two exporters,
one module:

* :func:`render_prometheus` — the registry as Prometheus text
  exposition format: counters and gauges verbatim, histograms as
  summaries (``quantile`` series + ``_count``/``_sum``), label values
  escaped per the format spec, and **deterministic series ordering**
  (metrics sorted by name, series by label set) so two renders of the
  same registry are byte-identical.
* :class:`ContinuousExporter` — a periodic writer on an **injectable
  clock** (the serve service feeds it its own ``clock``, so tests
  drive intervals deterministically): every interval it appends one
  JSONL record of windowed time-series data (counter deltas via
  ``diff_snapshots``, gauge levels, histogram quantile summaries) to a
  bounded, rotating set of files, and atomically rewrites a
  ``metrics.prom`` textfile next to them (the node-exporter textfile-
  collector pattern — point a scraper at the file and the process is
  observable mid-run with no HTTP server in the hot path).

Armed by ``DISPATCHES_TPU_OBS_EXPORT_DIR`` (interval / rotation bounds
via the other ``DISPATCHES_TPU_OBS_EXPORT_*`` flags); a
:class:`~dispatches_tpu_torch.serve.SolveService` arms itself at construction
when the flag is set and ticks the exporter from ``submit``/``poll``.
Disarmed, the serve hot path pays one ``is None`` check (spy-pinned in
``tests/test_timeline_export.py``).  Host-side and stdlib-only.
"""

from __future__ import annotations

import json
import os
import re
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from dispatches_tpu_torch.analysis.flags import flag_name
from dispatches_tpu_torch.obs import registry as obs_registry

__all__ = [
    "ExportOptions",
    "ContinuousExporter",
    "enabled",
    "process_start_us",
    "render_prometheus",
    "render_prometheus_snapshots",
    "set_restart_generation",
    "PROM_FILE",
]

SCHEMA_VERSION = 1
PROM_FILE = "metrics.prom"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")

# restart visibility: every
# ``metrics.prom`` rewrite carries this process's start timestamp and
# its recovery generation, so a scraper's ``changes()`` over either
# series counts restarts — the SRE crash-loop alert input.
_process_start_us: Optional[float] = None
_restart_generation: int = 1


def process_start_us() -> float:
    """Wall-clock start stamp of this process (us since epoch, frozen
    at first read)."""
    global _process_start_us
    if _process_start_us is None:
        _process_start_us = time.time() * 1e6
    return _process_start_us


def set_restart_generation(generation: int) -> int:
    """Record the service's recovery generation (stamped by
    ``SolveService`` when it restores from a durability directory);
    returns the previous value."""
    global _restart_generation
    prev = _restart_generation
    _restart_generation = int(generation)
    return prev


def enabled() -> bool:
    """Whether continuous export is armed for this process
    (``DISPATCHES_TPU_OBS_EXPORT_DIR`` set)."""
    return bool(os.environ.get(flag_name("OBS_EXPORT_DIR"), ""))


@dataclass(frozen=True)
class ExportOptions:
    """Where and how often the continuous exporter writes."""

    #: JSONL + ``metrics.prom`` output directory.
    directory: str = ""
    #: seconds between interval records (measured on the caller's
    #: injectable clock, NOT wall time).
    interval_s: float = 10.0
    #: rotation: JSONL files kept (oldest deleted).
    max_files: int = 8
    #: rotation: records per JSONL file before starting the next.
    max_records: int = 1024

    @classmethod
    def from_env(cls, **overrides) -> "ExportOptions":
        """Defaults with ``DISPATCHES_TPU_OBS_EXPORT_*`` env overrides
        applied (flags registered in ``analysis.flags``; GL006)."""
        env: Dict = {}
        raw = os.environ.get(flag_name("OBS_EXPORT_DIR"), "")
        if raw:
            env["directory"] = raw
        raw = os.environ.get(flag_name("OBS_EXPORT_INTERVAL_S"), "")
        if raw:
            env["interval_s"] = float(raw)
        raw = os.environ.get(flag_name("OBS_EXPORT_MAX_FILES"), "")
        if raw:
            env["max_files"] = int(raw)
        raw = os.environ.get(flag_name("OBS_EXPORT_MAX_RECORDS"), "")
        if raw:
            env["max_records"] = int(raw)
        env.update(overrides)
        return cls(**env)


# ---------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------

def _prom_name(name: str) -> str:
    return "dispatches_tpu_" + _NAME_RE.sub("_", name)


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _escape_help(text: str) -> str:
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _labels_text(key, extra: Optional[List] = None) -> str:
    pairs = list(key) + list(extra or [])
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_escape_label(v)}"' for k, v in pairs)
    return "{" + body + "}"


def _fmt(value) -> str:
    return repr(float(value))


def render_prometheus(registry: Optional[obs_registry.MetricsRegistry]
                      = None) -> str:
    """The registry in Prometheus text exposition format (0.0.4).

    Byte-deterministic for a given registry state: metrics render
    sorted by name (the registry already hands them over sorted) and
    series sorted by label set, so the output diffs cleanly and the
    golden-file test can pin it exactly.
    """
    registry = (obs_registry.default_registry()
                if registry is None else registry)
    lines: List[str] = []
    for m in registry.metrics():
        pname = _prom_name(m.name)
        if m.help:
            lines.append(f"# HELP {pname} {_escape_help(m.help)}")
        if m.kind == "histogram":
            lines.append(f"# TYPE {pname} summary")
            for key in sorted(m.series()):
                labels = dict(key)
                summary = m.summary(**labels)
                for q, field in (("0.5", "p50"), ("0.95", "p95"),
                                 ("0.99", "p99")):
                    if field in summary:
                        lines.append(
                            f"{pname}{_labels_text(key, [('quantile', q)])}"
                            f" {_fmt(summary[field])}")
                lines.append(f"{pname}_sum{_labels_text(key)}"
                             f" {_fmt(m.total(**labels))}")
                lines.append(f"{pname}_count{_labels_text(key)}"
                             f" {_fmt(summary.get('count', 0))}")
        else:
            lines.append(f"# TYPE {pname} {m.kind}")
            for key in sorted(m.series()):
                val = m.value(**dict(key))
                lines.append(f"{pname}{_labels_text(key)}"
                             f" {_fmt(0.0 if val is None else val)}")
    return "\n".join(lines) + ("\n" if lines else "")


def _parse_label_text(text: str) -> List:
    """Inverse of ``registry.label_text`` for snapshot keys (''= no
    labels); values never contain commas or '=' in this codebase's
    label vocabulary (method/bucket/replica/peer names)."""
    if not text:
        return []
    pairs = []
    for part in text.split(","):
        k, _, v = part.partition("=")
        pairs.append((k, v))
    return pairs


def render_prometheus_snapshots(per_process: Dict[str, Dict]) -> str:
    """Registry *snapshots* — typically pulled from other processes via
    the ``metrics_snapshot`` worker RPC — as Prometheus text, every
    series labeled ``process="<label>"``.

    Same determinism contract as :func:`render_prometheus` (metrics
    sorted by name, series by label set); histograms render their
    windowed quantiles and count (a snapshot carries no exact sum, so
    no ``_sum`` series).  Snapshots carry no help strings, so only
    ``# TYPE`` headers are emitted — the local render above them
    already documents shared families.
    """
    by_name: Dict[str, Dict] = {}
    for process in sorted(per_process):
        snap = per_process[process] or {}
        for name, entry in sorted(snap.items()):
            if not isinstance(entry, dict) or "kind" not in entry:
                continue
            slot = by_name.setdefault(name, {"kind": entry["kind"],
                                             "series": []})
            for label, val in sorted((entry.get("values") or {}).items()):
                pairs = ([("process", process)]
                         + _parse_label_text(label))
                slot["series"].append((pairs, val))
    lines: List[str] = []
    for name in sorted(by_name):
        entry = by_name[name]
        pname = _prom_name(name)
        kind = entry["kind"]
        if kind == "histogram":
            lines.append(f"# TYPE {pname} summary")
            for pairs, summary in entry["series"]:
                for q, field in (("0.5", "p50"), ("0.95", "p95"),
                                 ("0.99", "p99")):
                    if field in summary:
                        lines.append(
                            f"{pname}{_labels_text(pairs, [('quantile', q)])}"
                            f" {_fmt(summary[field])}")
                lines.append(f"{pname}_count{_labels_text(pairs)}"
                             f" {_fmt(summary.get('count', 0))}")
        else:
            lines.append(f"# TYPE {pname} {kind}")
            for pairs, val in entry["series"]:
                lines.append(f"{pname}{_labels_text(pairs)}"
                             f" {_fmt(0.0 if val is None else val)}")
    return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------
# periodic JSONL time series
# ---------------------------------------------------------------------

class ContinuousExporter:
    """Interval-driven registry exporter (module docstring).

    ``maybe_export(now)`` is the only call sites need: it returns
    immediately unless ``interval_s`` elapsed on the injected clock
    since the last record (the first call always writes, establishing
    the baseline), and it swallows I/O errors — telemetry never takes
    down the process it observes.  ``export()`` writes unconditionally
    and raises, for tests and shutdown flushes.
    """

    def __init__(self, options: Optional[ExportOptions] = None, *,
                 clock: Callable[[], float] = time.monotonic,
                 registry: Optional[obs_registry.MetricsRegistry] = None,
                 fleet_snapshots: Optional[
                     Callable[[], Dict[str, Dict]]] = None):
        self.options = (options if options is not None
                        else ExportOptions.from_env())
        if not self.options.directory:
            raise ValueError(
                "ContinuousExporter needs a directory (set "
                "DISPATCHES_TPU_OBS_EXPORT_DIR or pass ExportOptions)")
        self._clock = clock
        self._registry = (obs_registry.default_registry()
                          if registry is None else registry)
        # fleet mode: a provider returning {process_label: registry
        # snapshot} (the FleetRouter pulls live remote replicas); each
        # metrics.prom rewrite merges those series, process-labeled,
        # after the local render
        self._fleet_snapshots = fleet_snapshots
        self._last: Optional[float] = None
        self._seq = 0
        self._file_idx = 1
        self._records_in_file = 0
        self._prev_snapshot: Dict = {}

    # -- interval driver ---------------------------------------------------

    def maybe_export(self, now: Optional[float] = None) -> Optional[str]:
        """Write one interval record when due; returns the JSONL path
        written, or None (not due yet, or the write failed)."""
        now = self._clock() if now is None else now
        if (self._last is not None
                and now - self._last < self.options.interval_s):
            return None
        try:
            return self.export(now)
        except Exception:
            return None

    def export(self, now: Optional[float] = None) -> str:
        """Write one interval record unconditionally; returns the JSONL
        path.  Also atomically rewrites ``metrics.prom``."""
        now = self._clock() if now is None else now
        snapshot = self._registry.snapshot()
        record = self._record(now, snapshot)
        path = self._append(record)
        self._write_prom()
        self._prev_snapshot = snapshot
        self._last = now
        return path

    # -- record assembly ---------------------------------------------------

    def _record(self, now: float, snapshot: Dict) -> Dict:
        self._seq += 1
        gauges = {name: entry["values"]
                  for name, entry in snapshot.items()
                  if entry["kind"] == "gauge"}
        quantiles = {name: entry["values"]
                     for name, entry in snapshot.items()
                     if entry["kind"] == "histogram"}
        return {
            "schema": SCHEMA_VERSION,
            "seq": self._seq,
            "t": now,
            "interval_s": self.options.interval_s,
            # counters (and gauge moves) as deltas over the window;
            # gauges/quantiles as levels — the time-series shape a
            # dashboard wants
            "delta": obs_registry.diff_snapshots(self._prev_snapshot,
                                                 snapshot),
            "gauges": gauges,
            "quantiles": quantiles,
        }

    # -- files -------------------------------------------------------------

    def _jsonl_path(self, idx: int) -> str:
        return os.path.join(self.options.directory,
                            f"telemetry-{idx:05d}.jsonl")

    def _append(self, record: Dict) -> str:
        os.makedirs(self.options.directory, exist_ok=True)
        if self._records_in_file >= max(int(self.options.max_records), 1):
            self._file_idx += 1
            self._records_in_file = 0
            self._prune()
        path = self._jsonl_path(self._file_idx)
        with open(path, "a") as f:
            f.write(json.dumps(record, sort_keys=True) + "\n")
        self._records_in_file += 1
        return path

    def _prune(self) -> None:
        keep = max(int(self.options.max_files), 1)
        try:
            names = sorted(n for n in os.listdir(self.options.directory)
                           if n.startswith("telemetry-")
                           and n.endswith(".jsonl"))
        except OSError:
            return
        # the file about to be opened counts against the bound
        for n in names[:max(0, len(names) - (keep - 1))]:
            try:
                os.remove(os.path.join(self.options.directory, n))
            except OSError:
                pass

    def _write_prom(self) -> None:
        # appended after the registry render (not inside it) so the
        # byte-pinned render_prometheus golden stays untouched
        remote = ""
        if self._fleet_snapshots is not None:
            try:
                per = self._fleet_snapshots() or {}
                remote = render_prometheus_snapshots(per)
            except Exception:
                remote = ""  # a dead worker must not stop local export
        name = "dispatches_tpu_process_start_us"
        text = (
            render_prometheus(self._registry)
            + remote
            + f"# HELP {name} process start timestamp (us since epoch);"
            " the generation label increments on journal/snapshot"
            " recovery\n"
            + f"# TYPE {name} gauge\n"
            + f'{name}{{generation="{_restart_generation}"}}'
            f" {_fmt(process_start_us())}\n")
        path = os.path.join(self.options.directory, PROM_FILE)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)  # atomic: scrapers never see a torn file
