"""Declarative design-space sweep specifications (counterpart of
``dispatches_tpu/sweep/spec.py``; numpy, and torch for the synhist axis).

The reference's headline workflow is a large parametrized sweep — the
Prescient/price-taker runs over (PEM size, tank size, ...) design grids
whose swept results feed ``Train_NN_Surrogates`` (SURVEY.md §3/§6) — but
the reference drives it with ad-hoc shell loops, one process per point.
Here the sweep itself is data: a :class:`SweepSpec` is an ordered tuple
of :class:`Axis` objects, each binding one or more NLP parameter (or
fixed-var) names to per-point values, and the point set is the cartesian
product of the axes.  Axis constructors:

* :func:`grid` — an explicit value list/grid for one name (covers both
  "grid" and "list" axes; each entry may be a scalar or a profile array
  such as a 24-h LMP signal);
* :func:`lhs` — a joint Latin-hypercube sample over several scalar
  names (the design-space sampling the surrogate pipeline trains on);
* :func:`synhist` — an LMP scenario axis sampled from
  ``utils.synhist.ARMAModel`` (the RAVEN-ROM synthetic-history axis),
  always on the CPU, so a spec and its store identity are the same
  whichever device later solves it.

A spec is content-addressed: :meth:`SweepSpec.fingerprint` hashes axis
kinds, names, and value bytes, and the sweep engine keys its on-disk
``ResultStore`` manifest by that fingerprint so a resumed run can never
silently mix results from two different specs.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

__all__ = ["Axis", "SweepSpec", "grid", "lhs", "synhist"]


@dataclass(frozen=True)
class Axis:
    """One sweep axis: ``n`` points, each binding every name in
    ``names`` to the corresponding row of its values array."""

    kind: str                      # "grid" | "lhs" | "synhist"
    names: Tuple[str, ...]
    values: Tuple[np.ndarray, ...]  # one array per name, aligned leading axis
    meta: Tuple = ()               # informational (seed, bounds) — values
    #                                are already part of the fingerprint

    def __post_init__(self):
        if not self.names:
            raise ValueError("axis binds no parameter names")
        if len(self.names) != len(self.values):
            raise ValueError("one values array per name required")
        ns = {len(v) for v in self.values}
        if len(ns) != 1:
            raise ValueError(f"misaligned axis value lengths: {sorted(ns)}")
        if ns.pop() == 0:
            raise ValueError("axis has zero points")

    @property
    def n(self) -> int:
        return len(self.values[0])


def grid(name: str, values) -> Axis:
    """Explicit grid/list axis: ``values`` has one entry per point
    (scalars for a design knob, rows for a profile such as an LMP
    signal)."""
    return Axis("grid", (name,), (np.asarray(values),))


def lhs(bounds: Mapping[str, Tuple[float, float]], n: int,
        seed: int = 0) -> Axis:
    """Joint Latin-hypercube axis: ``n`` points over the scalar names in
    ``bounds`` (name -> (lo, hi)), each dimension stratified into ``n``
    bins with one sample per bin (permuted independently per dim)."""
    if n < 1:
        raise ValueError("lhs needs n >= 1")
    names = tuple(bounds)
    rng = np.random.default_rng(seed)
    cols = []
    for name in names:
        lo, hi = bounds[name]
        u = (rng.permutation(n) + rng.uniform(size=n)) / n
        cols.append(lo + u * (hi - lo))
    meta = (("seed", seed),
            ("bounds", tuple((k, float(bounds[k][0]), float(bounds[k][1]))
                             for k in names)))
    return Axis("lhs", names, tuple(cols), meta)


def synhist(name: str, model, n: int, n_steps: int, seed: int = 0) -> Axis:
    """LMP scenario axis: ``n`` synthetic histories of length
    ``n_steps`` sampled from a ``utils.synhist.ARMAModel`` (the RAVEN
    ROM axis of the reference's stochastic runs).  Sampling happens
    eagerly at spec-construction time, on the CPU (a float64 recursion
    on a GPU may contract to FMA and move a last bit, and with it the
    fingerprint), so the axis — and therefore the spec fingerprint — is
    a pure function of (model, n, n_steps, seed).  The draws are the
    port's own (``ARMAModel.innovations``), not ``jax.random``'s."""
    vals = model.sample(seed, n_steps, n, device="cpu").numpy()
    return Axis("synhist", (name,), (vals,), (("seed", seed),))


@dataclass(frozen=True)
class SweepSpec:
    """Cartesian product of axes; point ``i`` unravels to one coordinate
    per axis (row-major, first axis slowest)."""

    axes: Tuple[Axis, ...]

    def __post_init__(self):
        object.__setattr__(self, "axes", tuple(self.axes))
        if not self.axes:
            raise ValueError("spec has no axes")
        seen: set = set()
        for ax in self.axes:
            for name in ax.names:
                if name in seen:
                    raise ValueError(f"parameter {name!r} bound by two axes")
                seen.add(name)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(ax.n for ax in self.axes)

    @property
    def n_points(self) -> int:
        return int(np.prod(self.shape))

    @property
    def swept_names(self) -> Tuple[str, ...]:
        return tuple(name for ax in self.axes for name in ax.names)

    def values_for(self, idxs) -> Dict[str, np.ndarray]:
        """Swept-name -> values array (leading axis = len(idxs)) for a
        batch of flat point indices."""
        idxs = np.asarray(idxs)
        coords = np.unravel_index(idxs, self.shape)
        out: Dict[str, np.ndarray] = {}
        for ax, c in zip(self.axes, coords):
            for name, vals in zip(ax.names, ax.values):
                out[name] = np.asarray(vals)[c]
        return out

    @property
    def input_names(self) -> Tuple[str, ...]:
        """Column labels of :meth:`inputs_for`: scalar-valued names
        verbatim; profile-valued names (synhist scenarios, LMP grids)
        contribute their realization INDEX as the design coordinate."""
        labels: List[str] = []
        for ax in self.axes:
            for name, vals in zip(ax.names, ax.values):
                labels.append(
                    name if np.asarray(vals).ndim == 1
                    else f"{name}__realization")
        return tuple(labels)

    def inputs_for(self, idxs) -> np.ndarray:
        """(len(idxs), d) design-coordinate matrix — the surrogate
        training inputs (``input_names`` labels the columns)."""
        idxs = np.asarray(idxs)
        coords = np.unravel_index(idxs, self.shape)
        cols = []
        for ax, c in zip(self.axes, coords):
            for vals in ax.values:
                vals = np.asarray(vals)
                cols.append(vals[c] if vals.ndim == 1
                            else np.asarray(c, dtype=np.float64))
        return np.asarray(np.stack(cols, axis=1), dtype=np.float64)

    def fingerprint(self) -> str:
        """Content hash of the spec (axis kinds + names + value bytes):
        the ``ResultStore`` manifest key."""
        h = hashlib.blake2b(digest_size=16)
        h.update(b"sweep-spec-v1")
        for ax in self.axes:
            h.update(ax.kind.encode())
            for name, vals in zip(ax.names, ax.values):
                arr = np.ascontiguousarray(np.asarray(vals))
                h.update(name.encode())
                h.update(str(arr.dtype).encode())
                h.update(str(arr.shape).encode())
                h.update(arr.tobytes())
        return h.hexdigest()

    def describe(self) -> List[Dict]:
        """JSON-able manifest summary (no values — those live in the
        fingerprint)."""
        return [
            {
                "kind": ax.kind,
                "names": list(ax.names),
                "n": ax.n,
                "shapes": {
                    name: list(np.asarray(vals).shape[1:])
                    for name, vals in zip(ax.names, ax.values)
                },
                "meta": [list(m) for m in ax.meta],
            }
            for ax in self.axes
        ]
