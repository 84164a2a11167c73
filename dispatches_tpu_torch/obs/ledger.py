"""Append-only JSONL perf ledger with a trailing-window regression gate
(counterpart of ``dispatches_tpu/obs/ledger.py``: records are
byte-compatible, so either package loads and gates the other's
``ledger.jsonl``; the port records its torch device type, ``"cuda"`` or
``"cpu"``, as ``backend``).

The ledger turns each measured run (today the port's managed sweeps)
into one schema-versioned JSON line keyed by git SHA, device backend,
and a workload fingerprint, appended to ``<dir>/ledger.jsonl``.  Trends
render via ``python -m dispatches_tpu_torch.obs --ledger`` and
``--check-regressions`` compares the latest record of every
(kind, workload, backend) group against the median of its trailing
window — a *performance* gate for CI.

Gated metrics and their directions:

* ``solves_per_sec`` — higher is better; regression when the latest
  falls below ``median * (1 - tol)``;
* ``compile_count``, ``peak_bytes`` and ``pdhg_iters_mean`` — lower is
  better; regression when the latest exceeds ``median * (1 + tol)``.
  ``pdhg_iters_mean`` is the direct guardrail for the reflected-Halpern
  solver upgrade: records carry the solver ``algorithm`` tag in
  ``extra``, and since the workload fingerprint keys the group, an
  algorithm change that silently re-inflates iteration counts trips the
  gate even when wall-clock noise hides it.

Tolerance comes from ``DISPATCHES_TPU_OBS_LEDGER_TOL`` (default 0.3 —
wide enough for shared-CI noise, tight enough to catch a 2x cliff).
Groups with fewer than :data:`MIN_RECORDS` records are reported as
``insufficient`` and **soft-pass**, so the gate can ride in CI from the
first run.  Automatic writes (the sweep engine) happen only when
``DISPATCHES_TPU_OBS_LEDGER_DIR`` is set — tier-1 test runs stay
write-free and deterministic.

stdlib-only (plus ``analysis.flags``): the CI gate imports the ledger
without importing torch.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from dispatches_tpu_torch.analysis.flags import flag_name

__all__ = [
    "SCHEMA_VERSION",
    "enabled",
    "default_dir",
    "default_tolerance",
    "git_sha",
    "make_record",
    "append",
    "load",
    "check_regressions",
    "format_trend",
    "format_check",
]

SCHEMA_VERSION = 1
LEDGER_FILE = "ledger.jsonl"
DEFAULT_DIR = "perf_ledger"
DEFAULT_TOL = 0.3
DEFAULT_WINDOW = 5
MIN_RECORDS = 3

#: metric -> +1 (higher is better) / -1 (lower is better)
GATED_METRICS = {
    "solves_per_sec": +1,
    "compile_count": -1,
    "peak_bytes": -1,
    "pdhg_iters_mean": -1,
    # post-refinement accuracy vs the HiGHS reference: catches a
    # mixed-precision trade going wrong before any test tolerance trips
    # (deterministic per workload and backend, so the gate is not noisy)
    "obj_rel_err": -1,
    # serve tail latency and deadline-miss fraction
    "serve_p99_ms": -1,
    "deadline_miss_rate": -1,
    # dispatch-ahead pipeline health from the plan timeline
    # (obs.timeline): host time hidden under device work (higher is
    # better) and the ahead arm's stall share (lower is better)
    "overlap_efficiency": +1,
    "plan_stall_pct": -1,
    # soak (obs.soak): streaming P² p99 and the worst multi-window SLO
    # burn rate any objective reached
    "soak_p99_ms": -1,
    "slo_burn_max": -1,
    # warm/cold and predicted/cold mean PDHG iterations on correlated
    # replays: a rise means warm starts or the predictor stopped paying
    "pdhg_iters_warm_ratio": -1,
    "pdhg_iters_pred_ratio": -1,
    # chaos replay: recovered/injected faults (anything below 1.0 is an
    # escaped fault) and the p99 while faults fire
    "fault_recovery_rate": +1,
    "chaos_p99_ms": -1,
    # crash-restart: rebuild cost and the fraction of accepted requests
    # lost (the durability contract is exactly zero)
    "restart_recovery_ms": -1,
    "lost_request_rate": -1,
    # fleet and multi-process fleet: scaling efficiency over one replica
    # or process, and requests left non-terminal after a failover
    "fleet_scaling_efficiency": +1,
    "replica_lost_request_rate": -1,
    "multihost_scaling_efficiency": +1,
    "remote_lost_request_rate": -1,
}

_GIT_SHA: Optional[str] = None


def default_dir() -> str:
    """``DISPATCHES_TPU_OBS_LEDGER_DIR`` or ``perf_ledger``."""
    return os.environ.get(flag_name("OBS_LEDGER_DIR"), "") or DEFAULT_DIR


def enabled() -> bool:
    """Whether automatic ledger writes are on: true iff the ledger
    directory flag is set (explicit ``append`` calls always work)."""
    return bool(os.environ.get(flag_name("OBS_LEDGER_DIR"), ""))


def default_tolerance() -> float:
    raw = os.environ.get(flag_name("OBS_LEDGER_TOL"), "")
    return float(raw) if raw else DEFAULT_TOL


def git_sha() -> str:
    """Short SHA of the repo this package runs from ('unknown' outside
    a checkout); cached per process."""
    global _GIT_SHA
    if _GIT_SHA is None:
        try:
            r = subprocess.run(
                ["git", "rev-parse", "--short=12", "HEAD"],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                capture_output=True, text=True, timeout=10,
            )
            _GIT_SHA = r.stdout.strip() if r.returncode == 0 else "unknown"
        except Exception:
            _GIT_SHA = "unknown"
    return _GIT_SHA or "unknown"


def make_record(kind: str, workload: str, metrics: Dict, *,
                backend: Optional[str] = None,
                extra: Optional[Dict] = None) -> Dict:
    """One ledger record: identity (schema/sha/kind/workload/backend),
    timestamp, and the measured ``metrics`` dict (gated metrics by the
    :data:`GATED_METRICS` names; anything else rides along)."""
    rec = {
        "schema": SCHEMA_VERSION,
        "sha": git_sha(),
        "ts": round(time.time(), 3),
        "kind": str(kind),
        "workload": str(workload),
        "backend": backend,
        "metrics": dict(metrics),
    }
    if extra:
        rec["extra"] = dict(extra)
    return rec


def append(record: Dict, dir=None) -> Path:
    """Append one record as a sorted-keys JSON line; returns the ledger
    path.  Append-only by construction — history is never rewritten."""
    path = Path(dir if dir is not None else default_dir())
    path.mkdir(parents=True, exist_ok=True)
    ledger = path / LEDGER_FILE
    with open(ledger, "a") as f:
        f.write(json.dumps(record, sort_keys=True) + "\n")
    return ledger


def load(dir=None) -> List[Dict]:
    """Records in append order; a torn final line (killed writer) is
    skipped rather than poisoning the history."""
    ledger = Path(dir if dir is not None else default_dir()) / LEDGER_FILE
    if not ledger.is_file():
        return []
    out: List[Dict] = []
    for line in ledger.read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            continue
    return out


def _group(records: Sequence[Dict]) -> Dict[Tuple, List[Dict]]:
    groups: Dict[Tuple, List[Dict]] = {}
    for r in records:
        if r.get("schema") != SCHEMA_VERSION:
            continue
        key = (r.get("kind"), r.get("workload"), r.get("backend"))
        groups.setdefault(key, []).append(r)
    return groups


def _median(vals: Sequence[float]) -> float:
    xs = sorted(vals)
    n = len(xs)
    mid = n // 2
    return xs[mid] if n % 2 else 0.5 * (xs[mid - 1] + xs[mid])


def check_regressions(records: Optional[Sequence[Dict]] = None, *,
                      dir=None, window: int = DEFAULT_WINDOW,
                      tol: Optional[float] = None,
                      min_records: int = MIN_RECORDS) -> Dict:
    """Latest record of each group vs the median of its up-to-``window``
    trailing predecessors, per gated metric.

    Returns ``{"ok", "checked", "regressions", "insufficient"}`` —
    ``ok`` is False only when a gated metric actually regressed beyond
    tolerance; groups shorter than ``min_records`` soft-pass into
    ``insufficient``."""
    if records is None:
        records = load(dir)
    tol = default_tolerance() if tol is None else float(tol)
    out: Dict = {"ok": True, "tol": tol, "checked": [],
                 "regressions": [], "insufficient": []}
    for key, rs in sorted(_group(records).items(), key=lambda kv: str(kv[0])):
        group = "/".join(str(k) for k in key)
        if len(rs) < min_records:
            out["insufficient"].append({"group": group, "records": len(rs)})
            continue
        latest = rs[-1]
        trailing = rs[-(window + 1):-1]
        for metric, direction in GATED_METRICS.items():
            cur = latest.get("metrics", {}).get(metric)
            vals = [r["metrics"][metric] for r in trailing
                    if metric in r.get("metrics", {})]
            if cur is None or not vals:
                continue
            med = _median(vals)
            if direction > 0:
                bad = cur < med * (1.0 - tol)
            else:
                bad = cur > med * (1.0 + tol)
            entry = {"group": group, "metric": metric,
                     "latest": cur, "median": round(med, 6),
                     "sha": latest.get("sha"), "ok": not bad}
            out["checked"].append(entry)
            if bad:
                out["regressions"].append(entry)
                out["ok"] = False
    return out


def format_trend(records: Sequence[Dict]) -> str:
    """Human-readable trend: one line per record, grouped."""
    lines = ["== dispatches_tpu.obs perf ledger =="]
    if not records:
        lines.append("(empty)")
        return "\n".join(lines) + "\n"
    for key, rs in sorted(_group(records).items(), key=lambda kv: str(kv[0])):
        lines.append("/".join(str(k) for k in key) + ":")
        for r in rs:
            metrics = r.get("metrics", {})
            shown = ", ".join(
                f"{m}={metrics[m]}" for m in GATED_METRICS if m in metrics
            ) or ", ".join(f"{k}={v}" for k, v in sorted(metrics.items())[:3])
            lines.append(f"  {r.get('sha', '?'):>12}  {shown}")
    return "\n".join(lines) + "\n"


def format_check(result: Dict) -> str:
    """Human-readable gate verdict from :func:`check_regressions`."""
    lines = [f"== perf regression gate (tol {result['tol']:.0%}) =="]
    for e in result["checked"]:
        mark = "ok  " if e["ok"] else "FAIL"
        lines.append(
            f"  {mark} {e['group']} {e['metric']}: latest {e['latest']} "
            f"vs trailing median {e['median']}"
        )
    for e in result["insufficient"]:
        lines.append(
            f"  skip {e['group']}: {e['records']} record(s) "
            f"(< {MIN_RECORDS}; gate needs history)"
        )
    if not result["checked"] and not result["insufficient"]:
        lines.append("  (no records)")
    lines.append("verdict: " + ("PASS" if result["ok"] else "REGRESSION"))
    return "\n".join(lines) + "\n"
