"""On-disk result store for design-space sweeps (a copy of
``dispatches_tpu/sweep/store.py``: numpy, the same formats byte for byte).

Layout (one directory per sweep, keyed by the spec fingerprint):

* ``manifest.json`` — DETERMINISTIC identity + chunk table: spec
  fingerprint, base-params fingerprint, chunk plan, per-chunk status.
  An interrupted-then-resumed sweep converges to a manifest bitwise
  identical to an uninterrupted run's, so nothing time- or run-specific
  may live here.
* ``progress.json`` — run telemetry (per-chunk wall time, throughput).
  Deliberately split out of the manifest: timing differs between runs,
  identity must not.
* ``chunks/chunk_NNNNN.npz`` (+ shape-manifest ``.json``) — one
  checkpoint per completed chunk, written atomically through
  ``utils.checkpoint.save_state`` so a killed sweep can never leave a
  truncated chunk behind.  Arrays per chunk: ``index`` (flat point
  ids), ``obj``, ``converged``, ``iterations``, ``status``
  (0 ok / 1 ok-after-retry / 2 quarantined), ``retries``, and
  ``inputs`` (the design-coordinate rows for surrogate training).

The store is the sweep->surrogate interface: :meth:`training_data`
yields (X, y) with quarantined/non-finite points filtered, which
``workflow.surrogates.TrainNNSurrogates.from_sweep`` consumes directly
(no hand-rolled label assembly).
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from dispatches_tpu_torch.utils.checkpoint import load_state, save_state

__all__ = ["ResultStore", "STATUS_OK", "STATUS_RETRIED",
           "STATUS_QUARANTINED", "STATUS_REFINE_FAILED"]

STATUS_OK = 0          # solved on the first batched attempt
STATUS_RETRIED = 1     # non-finite in the batch, recovered on retry
STATUS_QUARANTINED = 2  # non-finite after all retries; obj left as NaN
# finite but did not reach tol even after consuming refinement epochs
# (mixed-precision path): quarantined from training_data like
# non-finite points — a 1e-3-accurate label silently poisons a
# surrogate — but kept distinct so --report shows WHERE the precision
# policy, not the model, is the problem.  Must compare >=
# STATUS_QUARANTINED so the existing `status < STATUS_QUARANTINED`
# training filter excludes it unchanged.
STATUS_REFINE_FAILED = 3

_MANIFEST = "manifest.json"
_PROGRESS = "progress.json"


def _atomic_json(path: Path, payload) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(payload, sort_keys=True, indent=1))
    os.replace(tmp, path)


class ResultStore:
    """Handle on one sweep directory (existing or freshly created)."""

    def __init__(self, path):
        self.path = Path(path)
        mf = self.path / _MANIFEST
        if not mf.is_file():
            raise FileNotFoundError(
                f"{self.path} is not a sweep ResultStore (no {_MANIFEST})")
        self._manifest = json.loads(mf.read_text())

    # -- creation ----------------------------------------------------------

    @classmethod
    def create(cls, path, spec, chunk_size: int, *,
               backend: str = "direct", solver: str = "ipm",
               precision: Optional[str] = None,
               params_fingerprint: Optional[str] = None,
               warm_start: bool = False) -> "ResultStore":
        """Initialise a sweep directory: full chunk plan up front (every
        chunk ``pending``) so resume only ever flips statuses.
        ``precision`` is the RESOLVED solver precision tier — part of
        the store identity, because bf16-inner objectives are not
        interchangeable with f32 ones as surrogate labels."""
        path = Path(path)
        (path / "chunks").mkdir(parents=True, exist_ok=True)
        n = spec.n_points
        chunks = {}
        for cid, start in enumerate(range(0, n, chunk_size)):
            chunks[str(cid)] = {
                "file": f"chunks/chunk_{cid:05d}",
                "start": start,
                "stop": min(start + chunk_size, n),
                "status": "pending",
            }
        manifest = {
            "version": 1,
            "fingerprint": spec.fingerprint(),
            "params_fingerprint": params_fingerprint,
            "n_points": n,
            "chunk_size": int(chunk_size),
            "backend": backend,
            "solver": solver,
            "precision": precision,
            # warm-seeded chunks carry extra x/z arrays AND their
            # objectives depend on the seeding path — part of identity
            "warm_start": bool(warm_start),
            "input_names": list(spec.input_names),
            "axes": spec.describe(),
            "chunks": chunks,
        }
        _atomic_json(path / _MANIFEST, manifest)
        return cls(path)

    @classmethod
    def open_or_create(cls, path, spec, chunk_size: int, *,
                       resume: bool = False, overwrite: bool = False,
                       backend: str = "direct", solver: str = "ipm",
                       precision: Optional[str] = None,
                       params_fingerprint: Optional[str] = None,
                       warm_start: bool = False,
                       ) -> "ResultStore":
        path = Path(path)
        if (path / _MANIFEST).is_file():
            if overwrite:
                shutil.rmtree(path)
            elif not resume:
                raise FileExistsError(
                    f"{path} already holds a sweep ResultStore; pass "
                    "resume=True to continue it or overwrite=True to "
                    "discard it")
            else:
                store = cls(path)
                if store.fingerprint != spec.fingerprint():
                    raise ValueError(
                        "resume refused: on-disk spec fingerprint "
                        f"{store.fingerprint[:12]} != requested "
                        f"{spec.fingerprint()[:12]} (different spec)")
                if (params_fingerprint is not None
                        and store.params_fingerprint is not None
                        and store.params_fingerprint != params_fingerprint):
                    raise ValueError(
                        "resume refused: base params differ from the "
                        "run that created this store")
                if (precision is not None
                        and store.precision is not None
                        and store.precision != precision):
                    raise ValueError(
                        "resume refused: solver precision "
                        f"{precision!r} differs from the "
                        f"{store.precision!r} this store was created "
                        "with (objectives would mix accuracy tiers)")
                if store.warm_start != bool(warm_start):
                    raise ValueError(
                        "resume refused: warm_start="
                        f"{bool(warm_start)} differs from the "
                        f"warm_start={store.warm_start} this store was "
                        "created with (seeding changes the chunk "
                        "arrays and the objective path)")
                return store
        return cls.create(path, spec, chunk_size, backend=backend,
                          solver=solver, precision=precision,
                          params_fingerprint=params_fingerprint,
                          warm_start=warm_start)

    # -- identity / plan ---------------------------------------------------

    @property
    def fingerprint(self) -> str:
        return self._manifest["fingerprint"]

    @property
    def params_fingerprint(self) -> Optional[str]:
        return self._manifest.get("params_fingerprint")

    @property
    def warm_start(self) -> bool:
        """Whether this store's chunks were warm-seeded (False on
        stores that predate the warm-start axis)."""
        return bool(self._manifest.get("warm_start", False))

    @property
    def precision(self) -> Optional[str]:
        """Resolved solver precision tier this store was created with
        (None on stores that predate the precision axis)."""
        return self._manifest.get("precision")

    @property
    def n_points(self) -> int:
        return int(self._manifest["n_points"])

    @property
    def input_names(self) -> Tuple[str, ...]:
        return tuple(self._manifest.get("input_names", ()))

    def chunk_plan(self) -> List[Tuple[int, int, int]]:
        """Sorted (chunk_id, start, stop) triples."""
        return sorted(
            (int(cid), e["start"], e["stop"])
            for cid, e in self._manifest["chunks"].items()
        )

    @property
    def completed(self) -> set:
        return {int(cid) for cid, e in self._manifest["chunks"].items()
                if e["status"] == "done"}

    @property
    def is_complete(self) -> bool:
        return len(self.completed) == len(self._manifest["chunks"])

    # -- recording ---------------------------------------------------------

    def record_chunk(self, cid: int, arrays: Dict[str, np.ndarray],
                     wall_s: float,
                     extra: Optional[Dict] = None) -> None:
        """Durably record one solved chunk: chunk npz first (atomic),
        then the manifest status flip (atomic), then progress telemetry.
        A kill between the steps leaves at worst a solved chunk the
        manifest still calls pending — resume re-solves it to the
        identical bytes.  ``extra`` (e.g. the engine's bytes/point cost
        telemetry) merges into the progress entry only — progress.json
        is run telemetry, never store identity."""
        entry = self._manifest["chunks"][str(cid)]
        save_state(self.path / entry["file"], arrays)
        entry["status"] = "done"
        _atomic_json(self.path / _MANIFEST, self._manifest)
        prog_path = self.path / _PROGRESS
        prog = (json.loads(prog_path.read_text())
                if prog_path.is_file() else {"chunks": {}})
        chunk_entry = {
            "wall_s": round(float(wall_s), 6),
            "n": int(len(arrays["obj"])),
        }
        if extra:
            chunk_entry.update(extra)
        prog["chunks"][str(cid)] = chunk_entry
        _atomic_json(prog_path, prog)

    # -- reading -----------------------------------------------------------

    def load_chunk(self, cid: int) -> Dict[str, np.ndarray]:
        entry = self._manifest["chunks"][str(cid)]
        if entry["status"] != "done":
            raise KeyError(f"chunk {cid} is not completed")
        return load_state(self.path / entry["file"])

    def arrays(self, require_complete: bool = True) -> Dict[str, np.ndarray]:
        """All completed chunks concatenated in chunk order."""
        if require_complete and not self.is_complete:
            raise RuntimeError(
                f"sweep incomplete: {len(self.completed)}/"
                f"{len(self._manifest['chunks'])} chunks done "
                "(pass require_complete=False for a partial view)")
        cids = sorted(self.completed)
        if not cids:
            return {}
        chunks = [self.load_chunk(c) for c in cids]
        return {k: np.concatenate([c[k] for c in chunks])
                for k in chunks[0]}

    def objectives(self) -> np.ndarray:
        return self.arrays()["obj"]

    def statuses(self) -> np.ndarray:
        return self.arrays()["status"]

    def training_data(self) -> Tuple[np.ndarray, np.ndarray]:
        """(X, y) for surrogate training: design coordinates vs sweep
        objectives (revenue labels), quarantined/non-finite points
        dropped."""
        a = self.arrays()
        mask = (a["status"] < STATUS_QUARANTINED) & np.isfinite(a["obj"])
        return a["inputs"][mask], a["obj"][mask]

    def training_pairs(self
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(inputs, x, z) triples for warm-start predictor training
        (``learn.train.fit_from_store``): design coordinates vs the
        saved scaled-space primal and original-space dual solutions,
        quarantined/non-finite points dropped.  Only warm-start stores
        persist x/z chunk arrays, so anything else raises."""
        if not self.warm_start:
            raise RuntimeError(
                "training_pairs needs a warm_start=True store: only "
                "warm-seeded sweeps persist the x/z solution arrays")
        a = self.arrays()
        mask = (a["status"] < STATUS_QUARANTINED) & np.isfinite(a["obj"])
        return a["inputs"][mask], a["x"][mask], a["z"][mask]

    # -- telemetry ---------------------------------------------------------

    def progress(self) -> Dict:
        prog_path = self.path / _PROGRESS
        return (json.loads(prog_path.read_text())
                if prog_path.is_file() else {"chunks": {}})

    def summary(self) -> Dict:
        """Report payload for ``python -m dispatches_tpu_torch.sweep --report``."""
        total_chunks = len(self._manifest["chunks"])
        done = self.completed
        out = {
            "path": str(self.path),
            "fingerprint": self.fingerprint,
            "n_points": self.n_points,
            "chunk_size": self._manifest["chunk_size"],
            "backend": self._manifest.get("backend"),
            "solver": self._manifest.get("solver"),
            "chunks_done": len(done),
            "chunks_total": total_chunks,
        }
        if self.precision is not None:
            out["precision"] = self.precision
        if done:
            a = self.arrays(require_complete=False)
            st = a["status"]
            out.update(
                points_done=int(len(st)),
                ok=int(np.sum(st == STATUS_OK)),
                retried=int(np.sum(st == STATUS_RETRIED)),
                quarantined=int(np.sum(st == STATUS_QUARANTINED)),
                refine_failed=int(np.sum(st == STATUS_REFINE_FAILED)),
                converged=int(np.sum(a["converged"])),
                iterations_mean=float(np.mean(a["iterations"])),
            )
        prog = self.progress()["chunks"]
        chunks_t = [prog[k] for k in sorted(prog, key=int)]
        walls = [c["wall_s"] for c in chunks_t]
        ns = [c["n"] for c in chunks_t]
        if walls:
            total = float(np.sum(walls))
            out["wall_s"] = round(total, 3)
            out["solves_per_sec"] = (
                round(float(np.sum(ns)) / total, 2) if total > 0 else None)
            if len(walls) > 1:
                steady = float(np.sum(walls[1:]))
                out["solves_per_sec_steady"] = (
                    round(float(np.sum(ns[1:])) / steady, 2)
                    if steady > 0 else None)
        bpp = [c["bytes_per_point"] for c in chunks_t
               if "bytes_per_point" in c]
        if bpp:  # engine cost telemetry (DISPATCHES_TPU_OBS_PROFILE)
            out["bytes_per_point"] = round(float(np.mean(bpp)), 1)
        return out


def format_report(summary: Dict) -> str:
    """Human-readable progress/throughput report from ``summary()``."""
    solver_bits = f"solver {summary.get('solver')}"
    if summary.get("precision"):
        solver_bits += f" ({summary['precision']})"
    lines = [
        f"sweep {summary['fingerprint'][:12]} at {summary['path']}",
        f"  backend {summary.get('backend')} · {solver_bits}"
        f" · chunk size {summary['chunk_size']}",
        f"  chunks {summary['chunks_done']}/{summary['chunks_total']} done"
        f" · {summary['n_points']} points planned",
    ]
    if "points_done" in summary:
        refine = (f" · {summary['refine_failed']} refine-failed"
                  if summary.get("refine_failed") else "")
        lines.append(
            f"  status: {summary['ok']} ok · {summary['retried']} retried"
            f" · {summary['quarantined']} quarantined{refine}"
            f" · converged "
            f"{summary['converged']}/{summary['points_done']}")
    if "wall_s" in summary:
        tail = (f" · {summary['solves_per_sec_steady']} steady"
                if "solves_per_sec_steady" in summary else "")
        if "bytes_per_point" in summary:
            tail += f" · {summary['bytes_per_point']:.0f} bytes/point"
        lines.append(
            f"  throughput: {summary['solves_per_sec']} solves/s"
            f"{tail} · wall {summary['wall_s']} s")
    return "\n".join(lines)
