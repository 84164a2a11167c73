"""Atomic snapshots of the service's learned state (counterpart of
``dispatches_tpu/serve/snapshot.py``; the same JSON schema, so a
snapshot written by either package loads in the other).

The journal (``serve.journal``) makes accepted requests durable; this
module makes durable the state that took real traffic to earn and that
a cold restart would otherwise relearn slowly:

* the IPM warm-start LRU (``SolveService._warm``),
* each bucket's :class:`~dispatches_tpu_torch.serve.warmstart.WarmStartIndex`
  and MispredictGuard EMA,
* each bucket's admission estimators — the ServiceTimeEstimate's P²
  markers (five heights, positions and the count) and the
  ArrivalEstimate's EWMA gap,
* each bucket's fitted warm-start predictor — the
  :class:`~dispatches_tpu_torch.learn.train.OnlineTrainer` weights and
  counters (the replay buffer is transient by design),
* the degradation-ladder rungs, so a service that degraded for a reason
  does not un-degrade by dying.

Everything is written from host copies: the predictor's weights are host
float32 arrays in the trainer (the device copy the dispatch head reads is
restaged on restore, on the trainer's device), warm-start solutions are
host arrays.  Snapshots are written atomically (tmp + ``os.replace``): a
reader sees the previous snapshot or the new one, never a torn file.  A
:class:`SnapshotWriter` ticks periodic snapshots off the service's
injectable clock; ``SolveService.drain()`` writes a final one before the
clean-shutdown journal marker.

Restore is constructor-time (``recover_dir=``): the warm LRU loads at
once; per-bucket state is keyed by bucket label (``pdlp#0``…, stable
across restarts for a same-order workload) and applied when
``_bucket_for`` builds the matching bucket.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import OrderedDict
from typing import Dict, Optional

import torch

from dispatches_tpu_torch.serve import journal as journal_mod
from dispatches_tpu_torch.serve import warmstart

__all__ = [
    "SNAPSHOT_FILE",
    "SCHEMA_VERSION",
    "SnapshotWriter",
    "apply_bucket_state",
    "apply_to_service",
    "load_state",
    "save_snapshot",
]

# v1: ladder/est/arrivals/warm_guard/warm_index.  v2 adds the bucket
# "predictor" section; v1 snapshots restore with no predictor state.
SCHEMA_VERSION = 2
COMPAT_SCHEMAS = (1, 2)
SNAPSHOT_FILE = "snapshot.json"
DEFAULT_INTERVAL_S = 30.0


# ---------------------------------------------------------------------------
# estimator (de)serialization
# ---------------------------------------------------------------------------


def _p2_state(p2) -> Dict:
    return {
        "p": p2.p,
        "q": [float(v) for v in p2._q],
        "n": [int(v) for v in p2._n],
        "np": [float(v) for v in p2._np],
        "dn": [float(v) for v in p2._dn],
        "count": int(p2._count),
    }


def _restore_p2(p2, state: Dict) -> None:
    p2.p = float(state["p"])
    p2._q = [float(v) for v in state["q"]]
    p2._n = [int(v) for v in state["n"]]
    p2._np = [float(v) for v in state["np"]]
    p2._dn = [float(v) for v in state["dn"]]
    p2._count = int(state["count"])


def _bucket_state(bucket) -> Dict:
    state: Dict = {
        "ladder": {
            "warm_fallback": bool(getattr(bucket, "warm_fallback", False)),
            "warm_consec_mispredicts": int(getattr(bucket, "warm_consec_mispredicts", 0)),
            "refine_fails": int(getattr(bucket, "refine_fails", 0)),
        },
    }
    est = getattr(bucket, "est", None)
    if est is not None:
        state["est"] = {"samples": int(est.samples), "p2": _p2_state(est._p95)}
    arrivals = getattr(bucket, "arrivals", None)
    if arrivals is not None:
        state["arrivals"] = {"alpha": arrivals.alpha, "last": arrivals._last,
                             "gap": arrivals._gap}
    guard = getattr(bucket, "warm_guard", None)
    if guard is not None:
        state["warm_guard"] = {"alpha": guard.alpha,
                               "cold_iters_ema": guard.cold_iters_ema,
                               "mispredicts": int(guard.mispredicts)}
    index = getattr(bucket, "warm_index", None)
    if index is not None and len(index):
        state["warm_index"] = journal_mod.encode_tree(index.to_state())
    state["ladder"]["predict_fallback"] = bool(getattr(bucket, "predict_fallback", False))
    state["ladder"]["predict_consec_mispredicts"] = int(
        getattr(bucket, "predict_consec_mispredicts", 0))
    trainer = getattr(bucket, "predict_trainer", None)
    if trainer is not None:
        state["predictor"] = journal_mod.encode_tree(trainer.to_state())
    return state


def apply_bucket_state(bucket, state: Dict) -> None:
    """Restore one bucket's learned state (called by ``_bucket_for`` right
    after construction, before the bucket sees traffic).  A restored
    predictor's weights are staged on the trainer's device for the
    dispatch head."""
    ladder = state.get("ladder") or {}
    if hasattr(bucket, "warm_fallback"):
        bucket.warm_fallback = bool(ladder.get("warm_fallback", False))
        bucket.warm_consec_mispredicts = int(ladder.get("warm_consec_mispredicts", 0))
        bucket.refine_fails = int(ladder.get("refine_fails", 0))
    est_state = state.get("est")
    if est_state is not None and getattr(bucket, "est", None) is not None:
        bucket.est.samples = int(est_state["samples"])
        _restore_p2(bucket.est._p95, est_state["p2"])
    arr_state = state.get("arrivals")
    if arr_state is not None and getattr(bucket, "arrivals", None) is not None:
        bucket.arrivals.alpha = float(arr_state["alpha"])
        bucket.arrivals._last = arr_state["last"]
        bucket.arrivals._gap = arr_state["gap"]
    guard_state = state.get("warm_guard")
    if guard_state is not None and getattr(bucket, "warm_guard", None) is not None:
        bucket.warm_guard.alpha = float(guard_state["alpha"])
        bucket.warm_guard.cold_iters_ema = guard_state["cold_iters_ema"]
        bucket.warm_guard.mispredicts = int(guard_state["mispredicts"])
    index_state = state.get("warm_index")
    if index_state is not None and getattr(bucket, "warm_index", None) is not None:
        bucket.warm_index = warmstart.WarmStartIndex.from_state(
            journal_mod.decode_tree(index_state))
    if hasattr(bucket, "predict_fallback"):
        bucket.predict_fallback = bool(ladder.get("predict_fallback", False))
        bucket.predict_consec_mispredicts = int(ladder.get("predict_consec_mispredicts", 0))
    # a v1 snapshot has no "predictor" section: the trainer stays untrained
    pred_state = state.get("predictor")
    trainer = getattr(bucket, "predict_trainer", None)
    if pred_state is not None and trainer is not None:
        try:
            trainer.load_state(journal_mod.decode_tree(pred_state))
        except Exception:
            pass  # a stale predictor must never block serving
        if trainer.predictor is not None:
            dev = getattr(trainer, "device", None)
            bucket.predict_weights = {
                k: torch.as_tensor(v, device=dev)
                for k, v in trainer.predictor.params.items()}


# ---------------------------------------------------------------------------
# service-level assemble / apply
# ---------------------------------------------------------------------------


def _service_state(service) -> Dict:
    warm_lru = []
    for key, sol in service._warm._d.items():
        try:
            warm_lru.append([journal_mod.encode_tree(list(key)),
                             journal_mod.encode_tree(sol)])
        except Exception:
            continue  # an unencodable solution tree is not worth a crash
    buckets = {}
    for bucket in service._buckets.values():
        buckets[bucket.stats.label] = _bucket_state(bucket)
    return {
        "schema": SCHEMA_VERSION,
        "generation": int(getattr(service, "generation", 1)),
        "t": float(service._now()),
        "warm_lru": warm_lru,
        "buckets": buckets,
    }


def save_snapshot(service, directory: str) -> str:
    """Write one atomic snapshot of ``service`` into ``directory``."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, SNAPSHOT_FILE)
    state = _service_state(service)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as fh:
            json.dump(state, fh, separators=(",", ":"))
        os.replace(tmp, path)  # atomic: never a torn snapshot
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    return path


def load_state(directory: str) -> Optional[Dict]:
    """Read the snapshot in ``directory``; None when absent, torn, or from
    an unknown schema."""
    path = os.path.join(directory, SNAPSHOT_FILE)
    try:
        with open(path, "r", encoding="utf-8") as fh:
            state = json.load(fh)
    except (OSError, ValueError):
        return None
    if state.get("schema") not in COMPAT_SCHEMAS:
        return None
    return state


def apply_to_service(service, state: Dict) -> None:
    """Constructor-time restore: the warm LRU loads now; per-bucket state
    is stashed on the service (``_restored_buckets``) and applied by
    ``_bucket_for`` when a bucket with the same label is built."""
    lru = OrderedDict()
    for key_enc, sol_enc in state.get("warm_lru", ()):
        try:
            key = tuple(journal_mod.decode_tree(key_enc))
            lru[key] = journal_mod.decode_tree(sol_enc)
        except Exception:
            continue
    service._warm._d = lru
    service._restored_buckets = dict(state.get("buckets") or {})
    service.generation = int(state.get("generation", 1)) + 1


# ---------------------------------------------------------------------------
# periodic writer
# ---------------------------------------------------------------------------


class SnapshotWriter:
    """Ticks periodic snapshots off the service's injectable clock."""

    def __init__(self, directory: str, *, interval_s: float = DEFAULT_INTERVAL_S):
        self.directory = str(directory)
        self.interval_s = float(interval_s)
        self._last: Optional[float] = None
        self.writes = 0

    def maybe_snapshot(self, service, now: float) -> Optional[str]:
        if self._last is not None and now - self._last < self.interval_s:
            return None
        self._last = now
        path = save_snapshot(service, self.directory)
        self.writes += 1
        return path

    def snapshot(self, service) -> str:
        """Unconditional snapshot (the ``drain()`` path)."""
        self._last = service._now()
        path = save_snapshot(service, self.directory)
        self.writes += 1
        return path
