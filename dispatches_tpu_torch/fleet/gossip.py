"""Gossiped warm state: replicas exchange what traffic taught them
(counterpart of ``dispatches_tpu/fleet/gossip.py``).

Each gossip round every live replica donates its per-bucket learned
state — warm-start index entries and admission service-time estimates
— serialized through the snapshot codec
(:func:`dispatches_tpu_torch.serve.snapshot._bucket_state`), the same bytes
a crash-recovery snapshot would carry: in production gossip crosses a
process boundary, so the exchange must survive encode → decode, and
reusing the codec keeps one schema for both paths.

The donate/merge halves are replica methods
(:meth:`ReplicaHandle.gossip_donate` / ``gossip_adopt``) backed by the
module-level :func:`donate_states` / :func:`merge_bucket_state` — so a
:class:`fleet.remote.RemoteReplicaHandle` can override the pair with
``gossip_donate``/``gossip_merge`` RPCs while the worker process applies
the *same* merge functions to its local service.  :class:`Gossip` only
schedules rounds and moves the states between replicas.

Merging is additive and conservative:

* warm-start index entries are adopted only when the recipient's index
  does not already know the exact key (ring-eviction then applies its
  normal policy), and anonymous (keyless) entries are skipped — they
  cannot be deduplicated, so re-gossiping them every round would churn
  the ring;
* a service-time estimate is adopted ONLY by a replica with zero
  samples of its own (cold adoption, never averaging — a replica's
  admission policy must stay calibrated to its own hardware once it
  has evidence);
* warm-start predictor weights are adopted most-trained-wins: a donor
  whose trainer has seen strictly more samples replaces the
  recipient's fit wholesale (never averaged — weights fitted on
  different replay windows do not mix), so replicas converge on the
  fleet's best-trained model;
* a recipient that has not built the donor's bucket yet stashes the
  state in ``service._restored_buckets`` under the bucket label —
  exactly the snapshot-restore path — and ``_bucket_for`` applies it
  when the bucket first forms, so a re-joined replica starts warm.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from dispatches_tpu_torch.obs import registry as obs_registry
from dispatches_tpu_torch.serve import journal as journal_mod
from dispatches_tpu_torch.serve import snapshot as snapshot_mod

__all__ = ["Gossip", "donate_states", "merge_bucket_state"]

DEFAULT_INTERVAL_S = 5.0


def donate_states(service) -> Dict[str, dict]:
    """One replica's donation: ``{bucket label: snapshot bucket state}``
    (JSON-safe — already encoded through the snapshot codec)."""
    buckets: Dict[str, dict] = {}
    for bucket in service._buckets.values():
        try:
            buckets[bucket.stats.label] = snapshot_mod._bucket_state(bucket)
        except Exception:
            continue  # an unencodable bucket skips this round
    return buckets


def merge_bucket_state(service, label: str, state: dict) -> int:
    """Fold one donated bucket state into ``service``; returns how
    many warm-index entries were adopted."""
    bucket = next((b for b in service._buckets.values()
                   if b.stats.label == label), None)
    if bucket is None:
        # recipient has not formed this bucket yet: stash through
        # the snapshot-restore path, applied by _bucket_for on
        # first formation (setdefault: an earlier donor wins the
        # round, next round refreshes)
        service._restored_buckets.setdefault(label, state)
        return 0
    adopted = _merge_index(bucket, state.get("warm_index"))
    est_state = state.get("est")
    est = getattr(bucket, "est", None)
    if (est_state is not None and est is not None
            and est.samples == 0 and int(est_state["samples"]) > 0):
        # cold adoption only: own samples always win
        try:
            est.samples = int(est_state["samples"])
            snapshot_mod._restore_p2(est._p95, est_state["p2"])
        except Exception:
            pass
    _merge_predictor(bucket, state.get("predictor"))
    return adopted


def _merge_predictor(bucket, pred_state) -> None:
    """Most-trained-wins predictor adoption: a replica takes the
    donor's fitted weights only when the donor has seen strictly
    more training samples — replicas serving the same stream
    converge on the best-trained model without averaging (weights
    fitted on different replay windows do not mix)."""
    trainer = getattr(bucket, "predict_trainer", None)
    if (trainer is None or pred_state is None
            or getattr(bucket, "predict_fallback", False)):
        return
    try:
        donated = journal_mod.decode_tree(pred_state)
        donor_trained = int(donated.get("trained_samples", 0))
        if donor_trained <= trainer.trained_samples:
            return
        from dispatches_tpu_torch.learn.predictor import StartPredictor

        pred = StartPredictor.from_state(donated.get("predictor"))
        if pred is None:
            return
        trainer.adopt(pred, donor_trained)
        # staged on the trainer's device for the dispatch head, as a
        # snapshot restore stages them
        bucket.predict_weights = {
            k: torch.as_tensor(v, device=getattr(trainer, "device", None))
            for k, v in pred.params.items()}
    except Exception:
        return  # a malformed donation must never take a replica down


def _merge_index(bucket, index_state) -> int:
    index = getattr(bucket, "warm_index", None)
    if index is None or index_state is None:
        return 0
    try:
        donated = journal_mod.decode_tree(index_state)
    except Exception:
        return 0
    vecs = donated.get("vecs")
    if vecs is None:
        return 0
    keys = donated["keys"]
    xs = donated["xs"]
    zs = donated["zs"]
    adopted = 0
    for slot, key in enumerate(keys):
        if isinstance(key, list):
            key = tuple(key)
        if key is None or index.exact(key) is not None:
            continue
        try:
            index.add(key, np.asarray(vecs[slot], np.float64),
                      xs[slot], zs[slot])
        except ValueError:
            # dimension mismatch: the donor's bucket label collided
            # with a differently-shaped problem — refuse the lot
            return adopted
        adopted += 1
    return adopted


class Gossip:
    """Periodic all-pairs exchange of warm state between live replicas,
    ticked off the router's injectable clock."""

    def __init__(self, replicas, *, interval_s: float = DEFAULT_INTERVAL_S,
                 clock: Callable[[], float] = time.monotonic):
        self._replicas = replicas
        self.interval_s = float(interval_s)
        self._clock = clock
        self._last: Optional[float] = None
        self.exchanges = 0
        self.entries_merged = 0
        self._obs_rounds = obs_registry.counter(
            "fleet.gossip_rounds", "gossip rounds completed (all-pairs "
            "warm-state exchange between live replicas)")
        self._obs_merged = obs_registry.counter(
            "fleet.gossip_entries", "warm-start index entries adopted "
            "from gossip (label=replica is the recipient)")

    def maybe_exchange(self, now: Optional[float] = None) -> bool:
        """Run one round if the interval elapsed; returns whether it ran."""
        now = self._clock() if now is None else now
        if self._last is not None and now - self._last < self.interval_s:
            return False
        self._last = now
        self.exchange()
        return True

    def exchange(self) -> int:
        """One all-pairs round; returns the number of entries merged.

        Donations and merges go through the replica handles
        (``gossip_donate``/``gossip_adopt``), so a mixed fleet —
        in-process and remote replicas behind one router — exchanges
        state across process boundaries transparently."""
        live = [r for r in self._replicas
                if r.alive and r.service is not None]
        if len(live) < 2:
            return 0
        donations = []
        for replica in live:
            try:
                donations.append((replica, replica.gossip_donate()))
            except Exception:
                # an unreachable remote donates nothing this round; it
                # can still adopt from the others below
                donations.append((replica, {}))
        merged = 0
        for recipient, _ in donations:
            # ordered donor-major pairs: every donor's state for a label
            # is merged (the second donor may hold keys the first
            # lacked), in deterministic replica order
            pool = [(label, state)
                    for donor, buckets in donations if donor is not recipient
                    for label, state in buckets.items()]
            got = 0
            if pool:
                try:
                    got = recipient.gossip_adopt(pool)
                except Exception:
                    got = 0  # unreachable recipient: skip this round
            if got:
                self._obs_merged.inc(got, replica=recipient.name)
            merged += got
        self.exchanges += 1
        self.entries_merged += merged
        self._obs_rounds.inc()
        return merged
