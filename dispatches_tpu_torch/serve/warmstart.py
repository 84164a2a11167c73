"""Cross-request warm starts: a bounded parameter-space neighbor index
(a copy of ``dispatches_tpu/serve/warmstart.py``; host numpy only).

Production traffic is correlated, so the solution of a *nearby*
request is an excellent primal–dual start for the next one.  This
module holds the retrieval side of that reuse:

* :class:`WarmStartIndex` — per-bucket ring buffer of normalized
  parameter vectors and their solutions.  Exact-fingerprint lookup goes
  through a dict riding the same ring (evicted entries drop out of
  both); neighbor lookup is exact k-NN over the whole buffer — at the
  bounded capacity (a few thousand entries) a vectorized host-side
  distance over a (count, d) array beats any approximate structure.  A
  radius gate turns far neighbors into cold starts: a start from an
  unrelated point can be *worse* than zero.
* :class:`MispredictGuard` — an EMA of cold-lane iteration counts; a
  warm-started lane that converges SLOWER than the cold baseline
  estimate is a mispredicted start (counted, and flight-recorded by the
  caller) so regressions surface in ``--stats`` instead of silently
  eating the warm-start win.

Everything here is deterministic NumPy on the host: same insertion
order + same query ⇒ same retrieval (stable argsort, fixed-order
reductions), which is what the determinism tests pin.

Flags (registered in ``analysis.flags``; GL006):

* ``DISPATCHES_TPU_WARMSTART`` — kill-switch.  Warm starts are ON by
  default; set to ``0``/``false`` to disable retrieval everywhere
  (serve buckets fall back to the historical cold path, bitwise).
* ``DISPATCHES_TPU_WARMSTART_K`` — neighbors averaged per retrieval.
* ``DISPATCHES_TPU_WARMSTART_RADIUS`` — normalized-RMS distance gate.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from dispatches_tpu_torch.analysis.flags import flag_name
from dispatches_tpu_torch.utils.tree import tree_leaves

__all__ = [
    "MispredictGuard",
    "WarmStartIndex",
    "default_k",
    "default_radius",
    "enabled",
    "param_vector",
]

DEFAULT_CAPACITY = 2048
DEFAULT_K = 4
DEFAULT_RADIUS = 0.25


def enabled() -> bool:
    """Kill-switch: warm starts are ON unless ``DISPATCHES_TPU_WARMSTART``
    is set to an explicit falsy value (same falsy vocabulary as
    ``flags.flag_enabled``: ``''``/``'0'``/``'false'``/``'False'``)."""
    raw = os.environ.get(flag_name("WARMSTART"))
    if raw is None:
        return True
    return raw not in ("", "0", "false", "False")


def default_k() -> int:
    raw = os.environ.get(flag_name("WARMSTART_K"), "")
    return int(raw) if raw else DEFAULT_K


def default_radius() -> float:
    raw = os.environ.get(flag_name("WARMSTART_RADIUS"), "")
    return float(raw) if raw else DEFAULT_RADIUS


def param_vector(params) -> np.ndarray:
    """Flatten a params tree (numpy or tensor leaves) into one float64
    host vector.

    Leaf order is sorted-key tree order, the JAX package's — deterministic
    for a fixed structure, which is all the per-bucket index needs (a
    bucket never mixes parameter structures: structure is part of the
    bucket fingerprint).
    """
    leaves = tree_leaves(params)
    if not leaves:
        return np.zeros(0, np.float64)
    return np.concatenate([
        np.asarray(leaf.detach().cpu() if hasattr(leaf, "detach") else leaf,
                   np.float64).ravel()
        for leaf in leaves])


class WarmStartIndex:
    """Bounded ring buffer of (parameter vector, solution) pairs with
    exact-key and radius-gated k-NN retrieval.

    Capacity bounds both memory and lookup cost; insertion past
    capacity overwrites the oldest slot (and drops its exact-key
    mapping).  Distances are normalized per dimension by the scale of
    the FIRST inserted vector (``max(|v|, eps)``) so one huge-magnitude
    leaf cannot drown the others, then reduced as RMS over dimensions —
    the 5% AR(1) perturbations of the bench stream land around 0.05–0.1
    while unrelated points land well past the 0.25 default radius.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 k: Optional[int] = None,
                 radius: Optional[float] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.k = default_k() if k is None else int(k)
        self.radius = default_radius() if radius is None else float(radius)
        self._vecs: Optional[np.ndarray] = None   # (capacity, d) float64
        self._scale: Optional[np.ndarray] = None  # (d,) from first insert
        self._sols: list = [None] * self.capacity  # (x, z) per slot
        self._keys: list = [None] * self.capacity
        self._slot_of: dict = {}                   # exact key -> slot
        self._cursor = 0
        self._count = 0

    def __len__(self) -> int:
        return self._count

    def add(self, key, vec, x, z) -> None:
        """Insert one solved point (ring eviction past capacity).

        ``key`` is the exact-match fingerprint (may be None to skip the
        exact map); ``vec`` the parameter vector; ``x``/``z`` the
        solution in the solver start contract's spaces (scaled-space x,
        original-space z — exactly what ``LPResult`` reports).

        Non-finite entries anywhere in ``vec``/``x``/``z`` drop the
        insert: a NaN objective or diverged iterate must never seed a
        future warm start (it would poison every neighbor within the
        radius), so the index defends itself even if a caller forgets
        the convergence gate."""
        vec = np.asarray(vec, np.float64).ravel()
        x = np.asarray(x)
        z = np.asarray(z)
        if not (np.all(np.isfinite(vec)) and np.all(np.isfinite(x))
                and np.all(np.isfinite(z))):
            return
        if self._vecs is None:
            self._vecs = np.zeros((self.capacity, vec.size), np.float64)
            self._scale = np.maximum(np.abs(vec), 1e-12)
        elif vec.size != self._vecs.shape[1]:
            raise ValueError(
                f"parameter vector size changed: index holds "
                f"{self._vecs.shape[1]}-d vectors, got {vec.size}"
            )
        slot = self._cursor
        old_key = self._keys[slot]
        # evict the old occupant's exact mapping — but only if it still
        # points here (a re-added key maps to its newest slot)
        if old_key is not None and self._slot_of.get(old_key) == slot:
            del self._slot_of[old_key]
        self._vecs[slot] = vec
        self._sols[slot] = (np.asarray(x), np.asarray(z))
        self._keys[slot] = key
        if key is not None:
            self._slot_of[key] = slot
        self._cursor = (self._cursor + 1) % self.capacity
        self._count = min(self._count + 1, self.capacity)

    def _logical_order(self) -> list:
        """Slot indices oldest→newest (a ring's cursor position is an
        accident of history; the insertion order is not)."""
        if self._count < self.capacity:
            return list(range(self._count))
        return [(self._cursor + i) % self.capacity
                for i in range(self.capacity)]

    def to_state(self) -> dict:
        """Serialize to a plain dict of numpy arrays and scalars, entries
        in insertion order (oldest first), so serialize → restore →
        serialize is byte-identical wherever the ring's cursor sat, and a
        restored index answers :meth:`nearest` bitwise-identically."""
        order = self._logical_order()
        return {
            "capacity": self.capacity,
            "k": self.k,
            "radius": self.radius,
            "scale": None if self._scale is None else
                np.array(self._scale, np.float64),
            "vecs": None if self._vecs is None else
                np.array(self._vecs[order], np.float64),
            "keys": [self._keys[s] for s in order],
            "xs": [np.asarray(self._sols[s][0]) for s in order],
            "zs": [np.asarray(self._sols[s][1]) for s in order],
        }

    @classmethod
    def from_state(cls, state: dict) -> "WarmStartIndex":
        """Rebuild an index from :meth:`to_state` output: entries land in
        slots 0..count-1 with the cursor after the newest, so the logical
        ring equals the source's."""
        idx = cls(capacity=int(state["capacity"]), k=int(state["k"]),
                  radius=float(state["radius"]))
        vecs = state.get("vecs")
        if vecs is None:
            return idx
        vecs = np.asarray(vecs, np.float64)
        count = vecs.shape[0]
        idx._vecs = np.zeros((idx.capacity, vecs.shape[1]), np.float64)
        idx._vecs[:count] = vecs
        idx._scale = np.asarray(state["scale"], np.float64)
        for slot in range(count):
            key = state["keys"][slot]
            if isinstance(key, list):
                key = tuple(key)
            idx._sols[slot] = (np.asarray(state["xs"][slot]),
                               np.asarray(state["zs"][slot]))
            idx._keys[slot] = key
            if key is not None:
                idx._slot_of[key] = slot
        idx._count = count
        idx._cursor = count % idx.capacity
        return idx

    def export_pairs(self) -> Tuple[list, list, list]:
        """Training triples ``(vecs, xs, zs)`` in deterministic logical
        order (oldest insertion first, post-eviction), for fitting the
        predictor from a live index.  Lists of per-entry arrays; the
        caller stacks."""
        order = self._logical_order()
        vecs = [np.array(self._vecs[s], np.float64) for s in order]
        xs = [np.asarray(self._sols[s][0]) for s in order]
        zs = [np.asarray(self._sols[s][1]) for s in order]
        return vecs, xs, zs

    def exact(self, key) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Exact-fingerprint lookup: the newest solution recorded under
        ``key``, or None."""
        slot = self._slot_of.get(key)
        return None if slot is None else self._sols[slot]

    def nearest(self, vec, k: Optional[int] = None,
                radius: Optional[float] = None):
        """Radius-gated k-NN retrieval: ``(x, z, nearest_dist)`` or None.

        The returned start is the inverse-distance-weighted average of
        the ≤k in-radius neighbors (one exact hit at distance ~0
        dominates the weights).  None — the cold fallback — when the
        index is empty or the nearest neighbor sits outside the radius.
        """
        if self._count == 0:
            return None
        k = self.k if k is None else int(k)
        radius = self.radius if radius is None else float(radius)
        vec = np.asarray(vec, np.float64).ravel()
        diff = (self._vecs[: self._count] - vec[None, :]) / self._scale[None, :]
        dist = np.sqrt(np.mean(diff * diff, axis=1)) if vec.size else \
            np.zeros(self._count)
        order = np.argsort(dist, kind="stable")[: max(k, 1)]
        order = order[dist[order] <= radius]
        if order.size == 0:
            return None
        w = 1.0 / np.maximum(dist[order], 1e-12)
        w = w / w.sum()
        x = np.zeros_like(np.asarray(self._sols[order[0]][0], np.float64))
        z = np.zeros_like(np.asarray(self._sols[order[0]][1], np.float64))
        for wi, idx in zip(w, order):  # fixed-order sum: deterministic
            xi, zi = self._sols[idx]
            x += wi * np.asarray(xi, np.float64)
            z += wi * np.asarray(zi, np.float64)
        return x, z, float(dist[order[0]])


class MispredictGuard:
    """EMA cold-iteration baseline + mispredicted-warm-start counter.

    Cold lanes feed :meth:`observe_cold`; warm lanes go through
    :meth:`observe_warm`, which returns True (and counts) when the lane
    needed MORE iterations than the cold baseline estimate — the caller
    flight-records those so bad retrievals are attributable."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = float(alpha)
        self.cold_iters_ema: Optional[float] = None
        self.mispredicts = 0

    def observe_cold(self, iters) -> None:
        it = float(iters)
        if self.cold_iters_ema is None:
            self.cold_iters_ema = it
        else:
            self.cold_iters_ema += self.alpha * (it - self.cold_iters_ema)

    def observe_warm(self, iters) -> bool:
        if self.cold_iters_ema is None:
            return False  # no baseline yet: can't call it mispredicted
        if float(iters) > self.cold_iters_ema:
            self.mispredicts += 1
            return True
        return False
