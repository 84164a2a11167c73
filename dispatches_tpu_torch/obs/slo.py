"""Declarative SLO objectives evaluated from the metrics registry
(counterpart of ``dispatches_tpu/obs/slo.py``).

Is the service meeting its latency/error budget?  A spec (JSON file or
the built-in example) declares objectives over registry instruments,
:func:`evaluate` grades a snapshot against them, and ``python -m
dispatches_tpu_torch.obs --slo [--json] [--check]`` renders attainment
+ burn (``--check`` exits non-zero on violation — the CI gate).

Two objective kinds cover the serve/sweep stack:

* ``quantile`` — a percentile upper bound on a Histogram family, e.g.
  p95 end-to-end latency per bucket.  ``group_by`` evaluates every
  series carrying that label separately (one result row per bucket);
  ``labels`` pins one exact series; neither = the unlabeled aggregate.
* ``ratio`` — an upper bound on ``sum(num series) / sum(den series)``
  over Counter families, e.g. deadline misses / submitted requests, or
  quarantined / total sweep points.

Objectives with no data (empty window, zero denominator) report
``no_data`` and never fail ``--check`` — the same soft-pass discipline
as the ledger's MIN_RECORDS gate, so a fresh process is not a paged
incident.  **Burn** is ``measured / target``: 1.0 = the budget is
exactly consumed, above 1.0 the objective is violated (the familiar
error-budget burn-rate reading, computed over the sliding window the
registry keeps).

Host-side and stdlib-only (no torch import), like the rest of ``obs``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from dispatches_tpu_torch.analysis.flags import flag_name

__all__ = [
    "SLOObjective",
    "SLOSpec",
    "builtin_spec",
    "load_spec",
    "evaluate",
    "format_results",
    "violations",
]

_QUANTILE_KEYS = ("p50", "p95", "p99", "mean")


@dataclass(frozen=True)
class SLOObjective:
    """One graded objective; see the module docstring for the kinds."""

    name: str
    kind: str                         # "quantile" | "ratio"
    target: float                     # upper bound (ms for quantile)
    # quantile kind
    metric: Optional[str] = None      # histogram family name
    p: str = "p99"                    # one of _QUANTILE_KEYS
    labels: Dict[str, str] = field(default_factory=dict)
    group_by: Optional[str] = None    # label to fan out over (e.g. "bucket")
    # ratio kind
    num: Optional[Dict] = None        # {"metric": ..., "labels": {...}}
    den: Optional[Dict] = None

    def __post_init__(self):
        if self.kind not in ("quantile", "ratio"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if self.kind == "quantile":
            if not self.metric:
                raise ValueError(f"objective {self.name!r}: quantile "
                                 "kind needs 'metric'")
            if self.p not in _QUANTILE_KEYS:
                raise ValueError(
                    f"objective {self.name!r}: p must be one of "
                    f"{_QUANTILE_KEYS}, got {self.p!r}")
        else:
            if not (self.num and self.num.get("metric")):
                raise ValueError(f"objective {self.name!r}: ratio kind "
                                 "needs num.metric")
            if not (self.den and self.den.get("metric")):
                raise ValueError(f"objective {self.name!r}: ratio kind "
                                 "needs den.metric")


@dataclass(frozen=True)
class SLOSpec:
    name: str
    objectives: Tuple[SLOObjective, ...]


def _objective_from_dict(d: Dict) -> SLOObjective:
    return SLOObjective(
        name=d["name"],
        kind=d["kind"],
        target=float(d["target"]),
        metric=d.get("metric"),
        p=d.get("p", "p99"),
        labels=dict(d.get("labels") or {}),
        group_by=d.get("group_by"),
        num=d.get("num"),
        den=d.get("den"),
    )


def spec_from_dict(d: Dict) -> SLOSpec:
    return SLOSpec(
        name=d.get("name", "unnamed"),
        objectives=tuple(_objective_from_dict(o)
                         for o in d.get("objectives", ())),
    )


def builtin_spec() -> SLOSpec:
    """The built-in example objectives (mirrored by
    ``examples/slo_spec.json``, the committed spec CI checks against).
    Targets are generous — they encode "the service is not on fire",
    not a production latency budget; deployments commit their own
    spec and point ``DISPATCHES_TPU_OBS_SLO`` at it."""
    return spec_from_dict({
        "name": "builtin",
        "objectives": [
            {"name": "serve_latency_p99", "kind": "quantile",
             "metric": "serve.latency_ms", "p": "p99",
             "target": 60000.0, "group_by": "bucket"},
            {"name": "serve_queue_wait_p95", "kind": "quantile",
             "metric": "serve.queue_wait_ms", "p": "p95",
             "target": 30000.0, "group_by": "bucket"},
            {"name": "deadline_miss_ratio", "kind": "ratio",
             "num": {"metric": "serve.deadline",
                     "labels": {"event": "missed"}},
             "den": {"metric": "serve.requests",
                     "labels": {"event": "submitted"}},
             "target": 0.01},
            {"name": "sweep_quarantine_rate", "kind": "ratio",
             "num": {"metric": "sweep.points",
                     "labels": {"event": "quarantined"}},
             "den": {"metric": "sweep.points"},
             "target": 0.05},
            {"name": "sweep_refine_fail_rate", "kind": "ratio",
             "num": {"metric": "sweep.points",
                     "labels": {"event": "refine_failed"}},
             "den": {"metric": "sweep.points"},
             "target": 0.05},
        ],
    })


def load_spec(path: Optional[str] = None) -> SLOSpec:
    """Load a spec JSON; ``path`` defaults to ``DISPATCHES_TPU_OBS_SLO``
    and, when that is unset too, the built-in example objectives."""
    if path is None:
        path = os.environ.get(flag_name("OBS_SLO"), "") or None
    if path is None:
        return builtin_spec()
    with open(path) as f:
        return spec_from_dict(json.load(f))


# -- evaluation ------------------------------------------------------------


def _parse_label_text(text: str) -> Dict[str, str]:
    """Inverse of ``registry.label_text`` ('' = no labels)."""
    if not text:
        return {}
    out = {}
    for part in text.split(","):
        k, _, v = part.partition("=")
        out[k] = v
    return out


def _matches(series_labels: Dict[str, str], want: Dict[str, str]) -> bool:
    return all(series_labels.get(k) == str(v) for k, v in want.items())


def _sum_counter(snapshot: Dict, sel: Dict) -> Optional[float]:
    entry = snapshot.get(sel["metric"])
    if entry is None:
        return None
    want = {str(k): str(v) for k, v in (sel.get("labels") or {}).items()}
    total, seen = 0.0, False
    for text, val in entry["values"].items():
        if _matches(_parse_label_text(text), want):
            total += float(val)
            seen = True
    return total if seen else None


def _eval_quantile(obj: SLOObjective, snapshot: Dict) -> List[Dict]:
    entry = snapshot.get(obj.metric)
    rows: List[Dict] = []
    if entry is None or entry.get("kind") != "histogram":
        return [_row(obj, series="", value=None)]
    want = {str(k): str(v) for k, v in obj.labels.items()}
    matched = False
    for text, summ in sorted(entry["values"].items()):
        lbls = _parse_label_text(text)
        if not _matches(lbls, want):
            continue
        if obj.group_by is not None and obj.group_by not in lbls:
            continue
        if obj.group_by is None and text and not want:
            continue  # no grouping requested: the unlabeled aggregate only
        matched = True
        rows.append(_row(obj, series=text, value=summ.get(obj.p),
                         count=summ.get("count", 0)))
    if not matched:
        rows.append(_row(obj, series="", value=None))
    return rows


def _row(obj: SLOObjective, series: str, value, count: int = 0) -> Dict:
    if value is None or (obj.kind == "quantile" and not count):
        return {"objective": obj.name, "kind": obj.kind, "series": series,
                "value": None, "target": obj.target, "ok": None,
                "burn": None, "no_data": True}
    value = float(value)
    burn = value / obj.target if obj.target > 0 else float("inf")
    return {"objective": obj.name, "kind": obj.kind, "series": series,
            "value": round(value, 6), "target": obj.target,
            "ok": value <= obj.target, "burn": round(burn, 4),
            "no_data": False}


def _eval_ratio(obj: SLOObjective, snapshot: Dict) -> List[Dict]:
    num = _sum_counter(snapshot, obj.num)
    den = _sum_counter(snapshot, obj.den)
    if den is None or not den:
        return [_row(obj, series="", value=None)]
    return [_row(obj, series="", value=(num or 0.0) / den, count=1)]


def evaluate(spec: Optional[SLOSpec] = None,
             snapshot: Optional[Dict] = None) -> List[Dict]:
    """Grade ``snapshot`` (default: the live default registry) against
    ``spec`` (default: :func:`load_spec`); one result row per evaluated
    series: ``{objective, kind, series, value, target, ok, burn,
    no_data}``."""
    if spec is None:
        spec = load_spec()
    if snapshot is None:
        from dispatches_tpu_torch.obs import registry as _registry

        snapshot = _registry.default_registry().snapshot()
    rows: List[Dict] = []
    for obj in spec.objectives:
        if obj.kind == "quantile":
            rows.extend(_eval_quantile(obj, snapshot))
        else:
            rows.extend(_eval_ratio(obj, snapshot))
    return rows


def violations(rows: List[Dict]) -> List[Dict]:
    """Rows that measured data AND breached their target."""
    return [r for r in rows if r["ok"] is False]


def format_results(spec: SLOSpec, rows: List[Dict]) -> str:
    """Operator-facing attainment table (the ``--slo`` text output)."""
    lines = [f"== SLO report · spec '{spec.name}' =="]
    for r in rows:
        series = f" [{r['series']}]" if r["series"] else ""
        if r["no_data"]:
            lines.append(f"  {r['objective']}{series}: no data "
                         f"(target {r['target']:g})")
            continue
        state = "OK  " if r["ok"] else "VIOL"
        lines.append(
            f"  {state} {r['objective']}{series}: "
            f"{r['value']:g} vs target {r['target']:g} "
            f"(burn {r['burn']:.2f})"
        )
    bad = violations(rows)
    lines.append(
        f"{len(bad)} violation(s), "
        f"{sum(1 for r in rows if r['no_data'])} no-data objective(s), "
        f"{len(rows)} series graded"
    )
    return "\n".join(lines)
