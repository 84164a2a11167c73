"""Shape bucketing for the solve service: program fingerprints and the
padded-lane policy (counterpart of ``dispatches_tpu/serve/bucket.py``).

Two requests share a program iff they agree on (a) the NLP object, (b)
the resolved solver kind and frozen options, and (c) the abstract
signature of their params tree (structure + per-leaf shape/dtype).  That
triple is the *bucket fingerprint*; within a bucket only the lane count
can vary, and it is snapped to a small menu of power-of-two widths, so a
bucket runs a handful of program signatures (``PlanProgram.compiles``
counts them, as the JAX package counts its compiles).

The trees are nested dicts of numpy arrays or tensors, flattened in
sorted-key order (``utils.tree``).  A leaf's bytes are read from the
host, so a request hashes the same whether its leaves are numpy arrays
or tensors.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

import numpy as np

from dispatches_tpu_torch.utils.tree import tree_leaves, tree_structure


def _host(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def freeze_options(options) -> Tuple:
    """Hashable, order-independent form of a solver-options dict."""
    return tuple(sorted((options or {}).items()))


def params_signature(params) -> Tuple:
    """Abstract signature of a params tree: structure plus per-leaf
    (shape, dtype).  Two requests with equal signatures stack into one
    batch and run the same program signature."""
    leaf_sig = tuple((tuple(np.shape(leaf)), _host(leaf).dtype.str)
                     for leaf in tree_leaves(params))
    return (tree_structure(params), leaf_sig)


def request_fingerprint(params) -> str:
    """Content hash of a params tree (structure + leaf bytes) — the
    per-request identity the warm-start caches are keyed by."""
    h = hashlib.blake2b(digest_size=16)
    h.update(repr(tree_structure(params)).encode())
    for leaf in tree_leaves(params):
        arr = _host(leaf)
        h.update(arr.dtype.str.encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def lane_menu(max_batch: int) -> Tuple[int, ...]:
    """The fixed menu of padded lane counts for a bucket: powers of two
    up to ``max_batch``, plus ``max_batch`` itself when it is not a
    power of two."""
    menu = []
    w = 1
    while w < max_batch:
        menu.append(w)
        w *= 2
    menu.append(max_batch)
    return tuple(menu)


def pad_lanes(n_live: int, max_batch: int) -> int:
    """Padded lane count for a batch of ``n_live`` requests: the
    smallest menu entry >= n_live (callers cap batches at max_batch)."""
    if n_live > max_batch:
        raise ValueError(f"batch of {n_live} exceeds max_batch={max_batch}")
    for w in lane_menu(max_batch):
        if w >= n_live:
            return w
    return max_batch
