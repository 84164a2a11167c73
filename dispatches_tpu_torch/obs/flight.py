"""Triggered flight recorder: atomic diagnostic bundles on anomalies
(counterpart of ``dispatches_tpu/obs/flight.py``; the same bundle
format).

The trace ring is a flight recorder with nobody pulling the tape: by the
time an operator asks why a point was quarantined or a request blew its
deadline, the evidence has been overwritten.  This module pulls the tape
at the moment of the anomaly.  Trigger hooks sit on the paths that
already classify failure — serve's deadline handling, sweep's
quarantine/refine-fail statuses, the nan-guard callback, solver
non-convergence at dispatch — and each call to :func:`trigger` dumps one
self-contained JSON bundle:

* the trace-ring tail (last :data:`TAIL_EVENTS` events, Chrome-trace
  shaped) and the drop counter,
* a full metrics snapshot plus the diff against the previous bundle
  (first bundle diffs against the registry state when the recorder
  module loaded),
* the triggering request's context — ``request_id``, bucket, params
  fingerprint, solver options — as passed by the hook,
* a ``plan`` section: execution-plan pipeline state at trigger time —
  the ``plan.inflight`` / ``serve.queue_depth`` gauges and the last
  :data:`PLAN_TAIL_EVENTS` plan lifecycle spans from the trace ring —
  so a deadline-miss bundle shows whether the pipeline was saturated
  or starved when the request expired,
* the latest AOT cost card for the triggering kernel label (when
  ``obs.profile`` is on) and a solverlog convergence tail (when the
  caller holds one, i.e. the solver was built with ``trace=True``).

Armed iff ``DISPATCHES_TPU_OBS_FLIGHT_DIR`` is set (or :func:`enable`
pointed it at a directory for the process).  Disarmed, the recorder is
**zero overhead**: hooks guard on :func:`enabled` before assembling any
context, and the spy-pinned test asserts no bundle write is ever
reached — the ``obs.profile`` discipline.  Bundles are written
atomically (tmp + ``os.replace``) and the directory is bounded
(:data:`MAX_BUNDLES`, oldest deleted), so the recorder is safe to leave
armed in production.  A recorder that breaks the operation it is
recording is worse than no recorder: every trigger swallows its own
exceptions — but each swallowed write failure increments the
``flight.errors`` counter and emits a debug log line, so a recorder
pointed at a dead directory is still visible to operators.

``python -m dispatches_tpu_torch.obs --flight [--json]`` lists/inspects
bundles.  Host-side and stdlib-only (no torch import).
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional

from dispatches_tpu_torch.analysis.flags import flag_name

_log = logging.getLogger(__name__)

__all__ = [
    "enabled",
    "enable",
    "trigger",
    "bundles",
    "load_bundle",
    "reset",
    "set_clock",
    "set_cooldown",
    "suppressed_counts",
    "TRIGGER_KINDS",
    "DEFAULT_COOLDOWN_S",
    "MAX_BUNDLES",
    "TAIL_EVENTS",
]

SCHEMA_VERSION = 1
MAX_BUNDLES = 64       # directory bound: oldest bundles deleted
TAIL_EVENTS = 256      # trace-ring tail length per bundle
PLAN_TAIL_EVENTS = 32  # plan-lifecycle tail length in the plan section

#: the trigger vocabulary the serve/sweep/runtime hooks use; free-form
#: kinds are accepted (the recorder is a sink, not a registry)
TRIGGER_KINDS = (
    "deadline_miss",
    "quarantine",
    "refine_failed",
    "nan_guard",
    "solver_nonconverged",
    "burn_rate",
    "plan_error",       # batch dispatch/fence failure (serve ERROR path)
    "plan_hang",        # fence watchdog escaped a wedged batch
    "warm_mispredict",  # warm start slower than the cold baseline
    "degrade",          # a graceful-degradation rung engaged
    "shed",             # load-shedding turned a submit away
)

#: per-kind trigger cooldown defaults (seconds).  A sustained burn-rate
#: alert re-fires every monitor check — without a cooldown it would
#: churn through all MAX_BUNDLES in seconds and evict the bundle that
#: actually shows the onset.  Event-shaped kinds (one trigger per
#: failed request/point) default to 0 so a burst of distinct failures
#: still dumps one bundle each; ``DISPATCHES_TPU_OBS_FLIGHT_COOLDOWN_S``
#: (or :func:`set_cooldown`) overrides the cooldown for ALL kinds.
DEFAULT_COOLDOWN_S: Dict[str, float] = {"burn_rate": 30.0,
                                        # an overload sheds every
                                        # submit: bundle the onset,
                                        # not the storm
                                        "shed": 5.0}

_lock = threading.Lock()
_seq = itertools.count(1)
_DIR_OVERRIDE: Optional[str] = None
_last_snapshot: Optional[Dict] = None
_clock = time.monotonic            # injectable: soaks run virtual time
_COOLDOWN_OVERRIDE: Optional[float] = None
_last_fire: Dict[str, float] = {}  # kind -> last written-bundle time
_suppressed: Dict[str, int] = {}   # kind -> suppressed since last write


def _dir() -> str:
    if _DIR_OVERRIDE is not None:
        return _DIR_OVERRIDE
    return os.environ.get(flag_name("OBS_FLIGHT_DIR"), "")


def enabled() -> bool:
    """Whether the recorder is armed (a bundle directory is configured).
    Read per call — the hooks are on cold failure paths, not per-lane
    hot loops, so there is nothing to cache."""
    return bool(_dir())


def enable(directory: Optional[str]) -> None:
    """Arm the recorder at ``directory`` for this process (tests,
    embedding drivers); ``enable(None)`` restores the env-flag
    behaviour, ``enable("")`` force-disarms."""
    global _DIR_OVERRIDE
    _DIR_OVERRIDE = directory if directory is None else str(directory)


def set_clock(fn) -> None:
    """Install the clock the trigger cooldown runs on (None restores
    ``time.monotonic``) — the soak harness points it at its virtual
    clock so coalescing windows are measured in replayed time."""
    global _clock
    _clock = time.monotonic if fn is None else fn


def set_cooldown(seconds: Optional[float]) -> None:
    """Process-level cooldown override for ALL trigger kinds (wins over
    the env flag; None restores per-kind defaults)."""
    global _COOLDOWN_OVERRIDE
    _COOLDOWN_OVERRIDE = None if seconds is None else float(seconds)


def _cooldown_for(kind: str) -> float:
    if _COOLDOWN_OVERRIDE is not None:
        return _COOLDOWN_OVERRIDE
    raw = os.environ.get(flag_name("OBS_FLIGHT_COOLDOWN_S"), "")
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    return DEFAULT_COOLDOWN_S.get(kind, 0.0)


def suppressed_counts() -> Dict[str, int]:
    """Triggers suppressed by the cooldown since the last written
    bundle (per kind) — the next bundle carries and resets these."""
    with _lock:
        return dict(_suppressed)


def reset() -> None:
    """Forget the override, the diff baseline, and the cooldown state
    (clock + last-fire times + suppressed counts)."""
    global _DIR_OVERRIDE, _last_snapshot, _clock, _COOLDOWN_OVERRIDE
    with _lock:
        _DIR_OVERRIDE = None
        _last_snapshot = None
        _clock = time.monotonic
        _COOLDOWN_OVERRIDE = None
        _last_fire.clear()
        _suppressed.clear()


def trigger(kind: str, *, request_id: Optional[int] = None,
            bucket: Optional[str] = None, label: Optional[str] = None,
            params_fingerprint: Optional[str] = None,
            solver_options: Optional[Dict] = None,
            detail: Optional[Dict] = None,
            convergence_tail: Optional[List[Dict]] = None) -> Optional[str]:
    """Record one diagnostic bundle; returns its path (None when the
    recorder is disarmed or the write failed — triggering never raises).

    ``label`` is the kernel/cost-card label (e.g. ``serve.pdlp#0``);
    ``convergence_tail`` is the last rows of a decoded solverlog
    :class:`~dispatches_tpu_torch.obs.solverlog.ConvergenceTrace` when the
    caller has one (``ConvergenceTrace.tail()``).
    """
    directory = _dir()
    if not directory:
        return None
    # cooldown check AFTER the disarmed early-return: the recorder
    # stays zero-overhead when off (spy-pinned)
    cooldown = _cooldown_for(kind)
    if cooldown > 0:
        now = _clock()
        with _lock:
            last = _last_fire.get(kind)
            if last is not None and now - last < cooldown:
                _suppressed[kind] = _suppressed.get(kind, 0) + 1
                return None
            _last_fire[kind] = now
    try:
        return _write_bundle(
            directory, kind, request_id=request_id, bucket=bucket,
            label=label, params_fingerprint=params_fingerprint,
            solver_options=solver_options, detail=detail,
            convergence_tail=convergence_tail)
    except Exception as exc:
        # swallowing is the contract (a diagnostics sink must never
        # take down the serve path) — but count and log the failure so
        # a recorder writing into a dead directory is visible
        _note_write_error(kind, exc)
        return None


def _note_write_error(kind: str, exc: BaseException) -> None:
    try:
        from dispatches_tpu_torch.obs import registry as _registry

        _registry.counter(
            "flight.errors", "flight-recorder bundle writes that "
            "failed and were swallowed (kind = trigger kind)"
        ).inc(kind=str(kind))
    except Exception:
        pass
    _log.debug("flight bundle write failed for trigger %r: %r",
               kind, exc)


def _write_bundle(directory: str, kind: str, *, request_id, bucket, label,
                  params_fingerprint, solver_options, detail,
                  convergence_tail) -> str:
    global _last_snapshot
    from dispatches_tpu_torch.obs import registry as _registry
    from dispatches_tpu_torch.obs import trace as _trace

    os.makedirs(directory, exist_ok=True)
    snapshot = _registry.default_registry().snapshot()
    with _lock:
        baseline = _last_snapshot if _last_snapshot is not None else {}
        diff = _registry.diff_snapshots(baseline, snapshot)
        _last_snapshot = snapshot
        seq = next(_seq)
        suppressed = dict(_suppressed)  # coalesced since the last write
        _suppressed.clear()
    tail = _trace.to_chrome_events(_trace.events()[-TAIL_EVENTS:])
    plan_section = _plan_section(snapshot, _trace.events())
    cost_card = None
    if label is not None:
        try:
            from dispatches_tpu_torch.obs import profile as _profile

            cards = _profile.cards_for(str(label))
            if cards:
                cost_card = cards[-1]
        except Exception:
            pass
    bundle = {
        "schema": SCHEMA_VERSION,
        "kind": str(kind),
        "ts_unix": time.time(),
        "pid": os.getpid(),
        "trigger": {
            "request_id": request_id,
            "bucket": bucket,
            "label": label,
            "params_fingerprint": params_fingerprint,
            "solver_options": solver_options,
            "detail": detail,
        },
        "suppressed_since_last": suppressed,
        "trace_tail": tail,
        "trace_dropped": _trace.dropped(),
        "plan": plan_section,
        "metrics": snapshot,
        "metrics_diff": diff,
        "cost_card": cost_card,
        "convergence_tail": convergence_tail,
    }
    name = f"flight-{time.time_ns():020d}-{seq:04d}-{kind}.json"
    path = os.path.join(directory, name)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(bundle, f, default=str)
    os.replace(tmp, path)  # atomic: readers never see a torn bundle
    _prune(directory)
    try:
        from dispatches_tpu_torch.obs import trace as _t

        _t.instant("flight.trigger", kind=str(kind),
                   request_id=request_id, bucket=bucket)
    except Exception:
        pass
    return path


def _plan_section(snapshot: Dict, events: List[Dict]) -> Dict:
    """Pipeline state at trigger time: the inflight/queue-depth gauges
    from the registry snapshot plus the last plan lifecycle spans from
    the trace ring (empty tail when tracing is off)."""
    from dispatches_tpu_torch.obs.timeline import PLAN_SPAN_NAMES

    def _gauge(name: str):
        entry = snapshot.get(name)
        if not entry or entry.get("kind") != "gauge":
            return None
        values = entry.get("values") or {}
        # both gauges are unlabeled: one series under the "" key
        return values.get("", next(iter(values.values()), None))

    tail = [e for e in events
            if e.get("ph") == "X" and e.get("name") in PLAN_SPAN_NAMES]
    return {
        "inflight": _gauge("plan.inflight"),
        "queue_depth": _gauge("serve.queue_depth"),
        "timeline_tail": tail[-PLAN_TAIL_EVENTS:],
    }


def _bundle_paths(directory: str) -> List[str]:
    try:
        names = [n for n in os.listdir(directory)
                 if n.startswith("flight-") and n.endswith(".json")]
    except OSError:
        return []
    return [os.path.join(directory, n) for n in sorted(names)]


def _prune(directory: str, keep: Optional[int] = None) -> None:
    """Bound the bundle directory: the OLDEST bundles are evicted so a
    new trigger always lands (a recorder that goes blind after
    ``MAX_BUNDLES`` would miss exactly the incident a long soak was
    armed for).  Evictions are counted in ``flight.evicted`` so an
    operator can tell "the onset bundle aged out" from "it never
    fired"."""
    keep = MAX_BUNDLES if keep is None else keep  # read at call time
    paths = _bundle_paths(directory)
    evicted = 0
    for p in paths[:max(0, len(paths) - keep)]:
        try:
            os.remove(p)
            evicted += 1
        except OSError:
            pass
    if evicted:
        try:
            from dispatches_tpu_torch.obs import registry as _registry

            _registry.counter(
                "flight.evicted", "flight bundles evicted (oldest "
                "first) to keep the directory under MAX_BUNDLES"
            ).inc(evicted)
        except Exception:
            pass


def load_bundle(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def bundles(directory: Optional[str] = None,
            full: bool = False) -> List[Dict]:
    """Bundle listing (oldest first) for the CLI: per-bundle header
    ``{path, kind, ts_unix, request_id, bucket}``; ``full=True``
    returns the entire bundle contents under the same keys."""
    directory = directory if directory is not None else _dir()
    if not directory:
        return []
    out: List[Dict] = []
    for p in _bundle_paths(directory):
        try:
            b = load_bundle(p)
        except Exception:
            continue
        if full:
            b["path"] = p
            out.append(b)
        else:
            out.append({
                "path": p,
                "kind": b.get("kind"),
                "ts_unix": b.get("ts_unix"),
                "request_id": (b.get("trigger") or {}).get("request_id"),
                "bucket": (b.get("trigger") or {}).get("bucket"),
            })
    return out
