"""Model-state checkpoints (counterpart of
``dispatches_tpu/utils/checkpoint.py``, host numpy; the files are the
JAX package's, and each package reads what the other writes).

Model state is a nested dict of named arrays (a solution dict from
``CompiledNLP.unravel``), serialized to ``.npz`` with a json manifest
for structure; :func:`solution_x0` and :func:`warm_start_from` turn a
saved or in-memory solution back into a physical ``x0``, guarded
against a changed model layout.  The solve service's IPM warm-start LRU
uses :func:`solution_x0`.  :func:`save_solution` checkpoints a solve
(solution, duals and metadata; tensors on any device are brought to the
host).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np


def _flatten(tree, prefix="", out=None):
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    tree: Dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def save_state(path, tree) -> Path:
    """Serialize a (nested dict of) arrays — the ``to_json`` analog.

    Writes are ATOMIC (tmp file + ``os.replace``): a process killed
    mid-save can never leave a truncated/corrupt checkpoint behind — an
    existing checkpoint at ``path`` survives intact, which is what the
    sweep engine's chunk-level resume leans on.  The ``.npz`` is
    replaced before the shape-manifest ``.json``; a kill between the
    two leaves a fresh npz with a stale (but loadable) manifest, and
    ``load_state`` reads only the npz.
    """
    path = Path(path)
    flat = _flatten(tree)
    npz = path.with_suffix(".npz")
    tmp = npz.with_name(npz.name + ".tmp")
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, npz)
    finally:
        tmp.unlink(missing_ok=True)
    manifest = {k: list(v.shape) for k, v in flat.items()}
    jpath = path.with_suffix(".json")
    jtmp = jpath.with_name(jpath.name + ".tmp")
    try:
        jtmp.write_text(json.dumps(manifest))
        os.replace(jtmp, jpath)
    finally:
        jtmp.unlink(missing_ok=True)
    return npz


def load_state(path):
    """Load a state saved by :func:`save_state` — ``from_json`` analog."""
    path = Path(path)
    data = np.load(path.with_suffix(".npz"))
    return _unflatten({k: data[k] for k in data.files})


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_solution(path, nlp, res) -> Path:
    """Checkpoint a solve: unraveled physical solution + duals +
    metadata (the reference's solved-flowsheet json snapshot)."""
    sol = nlp.unravel(res.x)
    tree = {
        "solution": sol,
        "duals": {
            "lam": _host(res.lam),
            "z_l": _host(res.z_l),
            "z_u": _host(res.z_u),
        },
        "meta": {
            "obj": _host(res.obj),
            "kkt_error": _host(res.kkt_error),
            "x": _host(res.x),
        },
    }
    return save_state(path, tree)


def solution_x0(sol: Dict, nlp) -> Optional[np.ndarray]:
    """Physical x0 vector assembled from an unraveled solution dict
    (``nlp.unravel`` layout), or None when the layout no longer matches
    the model (the init-once-replicate guard).  Shared by the on-disk
    :func:`warm_start_from` path and the solve service's in-memory
    warm-start cache (``serve/service.py``)."""
    parts = []
    for name in nlp.free_names:
        a, b, shape = nlp._slices[name]
        if name not in sol or tuple(np.shape(sol[name])) != tuple(shape):
            return None
        parts.append(np.ravel(np.asarray(sol[name])))
    if not parts:
        return None
    return np.concatenate(parts)


def warm_start_from(path, nlp) -> Optional[np.ndarray]:
    """Physical x0 vector for ``solve(params, x0=...)`` from a solution
    checkpoint, or None when the layout no longer matches (model
    changed since the checkpoint) or the file is missing."""
    try:
        tree = load_state(path)
    except FileNotFoundError:
        return None
    return solution_x0(tree.get("solution", {}), nlp)
