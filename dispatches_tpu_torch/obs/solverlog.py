"""Host-side decoding of per-iteration solver convergence telemetry
(counterpart of ``dispatches_tpu/obs/solverlog.py``).

A thousand-lane batch is undebuggable without per-iteration convergence
visibility: one floored lane drags the whole batch to ``max_iter`` and
nothing in the final result says why.

The capture side lives in the solvers themselves
(``make_ipm_solver(..., trace=True)``, ``make_pdlp_solver(...,
trace=True)``, ``make_newton_solver(..., trace=True)``): each records a
small dict of per-iteration (or per-check) scalars of fixed length,
finished lanes holding their final state, so the rows line up with the
JAX package's.  The values are tensors on the solver's device.

This module is the decode side: move the arrays to the host, trim them
at the iteration count actually used, select a lane out of a batch, and
render operator-facing tables.  It imports neither torch nor the
solvers, so the obs CLI stays light; tensors are recognised by their
``detach``/``cpu`` methods.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "ConvergenceTrace",
    "decode_ipm",
    "decode_pdlp",
    "decode_newton",
]

# mirrors solvers.pdlp.START_KIND_NAMES (not imported: that module
# pulls torch, and this one must stay NumPy-only for the obs CLI)
_START_KIND_NAMES = ("cold", "exact", "neighbor", "predicted")


@dataclass
class ConvergenceTrace:
    """One lane's per-iteration telemetry, trimmed to the iterations
    actually used."""

    solver: str
    iterations: int
    columns: Dict[str, np.ndarray] = field(default_factory=dict)
    # how the lane's iterate was seeded ("cold" | "exact" | "neighbor"
    # | "predicted") — a warm-started tail reads very differently from
    # a cold one (e.g. near-zero err at row 0), so the bundle must say
    # which it is
    start_kind: Optional[str] = None

    def __len__(self) -> int:
        return self.iterations

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

    def tail(self, n: int = 8) -> List[Dict[str, float]]:
        """Last ``n`` recorded rows as plain dicts (JSON-serializable) —
        the shape ``obs.flight.trigger(convergence_tail=...)`` expects
        in a diagnostic bundle."""
        names = list(self.columns)
        rows = len(next(iter(self.columns.values()))) if names else 0
        out: List[Dict[str, float]] = []
        for i in range(max(0, rows - n), rows):
            row: Dict[str, float] = {"row": i}
            if self.start_kind is not None:
                row["start_kind"] = self.start_kind
            for name in names:
                v = self.columns[name][i]
                if np.issubdtype(np.asarray(v).dtype, np.integer):
                    row[name] = int(v)
                else:
                    row[name] = float(v)
            out.append(row)
        return out

    def format(self, every: int = 1) -> str:
        """Fixed-width iteration table (one row per recorded step)."""
        names = list(self.columns)
        header = "iter  " + "  ".join(f"{n:>12s}" for n in names)
        lines = [header]
        rows = len(next(iter(self.columns.values()))) if names else 0
        for i in range(0, rows, max(every, 1)):
            cells = []
            for n in names:
                v = self.columns[n][i]
                if np.issubdtype(np.asarray(v).dtype, np.integer):
                    cells.append(f"{int(v):>12d}")
                else:
                    cells.append(f"{float(v):>12.5e}")
            lines.append(f"{i:4d}  " + "  ".join(cells))
        return "\n".join(lines) + "\n"


def _host(arr) -> np.ndarray:
    """A numpy copy of a trace leaf (a tensor on any device, or an
    array)."""
    if hasattr(arr, "detach") and hasattr(arr, "cpu"):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def _lane(arr, lane: int) -> np.ndarray:
    """Select one lane.  Trace arrays are (iters,) for one scenario or
    (batch, iters) for a batch (the lane axis leads)."""
    a = _host(arr)
    return a[lane] if a.ndim > 1 else a


def _scalar(arr, lane: int) -> float:
    a = _host(arr).reshape(-1)
    return float(a[lane] if a.size > 1 else a[0])


def decode_ipm(trace, result=None, lane: int = 0) -> ConvergenceTrace:
    """Decode ``make_ipm_solver(..., trace=True)`` telemetry.

    Columns: ``mu`` (barrier parameter — monotone non-increasing by the
    Fiacco-McCormick update), ``kkt_error``, ``alpha`` (accepted step),
    ``stall``.  Rows past ``result.iterations`` (finished-lane holds)
    are trimmed when ``result`` is given.
    """
    cols = {k: _lane(trace[k], lane)
            for k in ("mu", "kkt_error", "alpha", "stall")}
    rows = len(cols["mu"])
    n_it = int(_scalar(result.iterations, lane)) if result is not None else rows
    n_it = min(n_it, rows)
    return ConvergenceTrace(
        solver="ipm",
        iterations=n_it,
        columns={k: v[:n_it] for k, v in cols.items()},
    )


def decode_pdlp(trace, result=None, lane: int = 0) -> ConvergenceTrace:
    """Decode ``make_pdlp_solver(..., trace=True)`` telemetry.

    One row per termination check (every ``check_every`` iterations).
    Columns: ``it`` (iteration count at the check), ``err`` (candidate
    KKT error), ``err_best``, and the best-iterate components ``pr`` /
    ``du`` / ``gap`` — so the row at ``it == result.iters`` carries the
    same converged gap the :class:`LPResult` reports.
    """
    cols = {k: _lane(trace[k], lane)
            for k in ("it", "err", "err_best", "pr", "du", "gap")}
    rows = len(cols["it"])
    start_kind = None
    if result is not None:
        n_iters = int(_scalar(result.iters, lane))
        # one recorded row per real check; finished lanes hold `it`
        n_rows = int(np.searchsorted(cols["it"], n_iters, side="left")) + 1
        n_rows = min(max(n_rows, 1), rows)
        sk = getattr(result, "start_kind", None)
        if sk is not None:  # warm-capable program: label the lane
            start_kind = _START_KIND_NAMES[int(_scalar(sk, lane))]
    else:
        n_rows = rows
    return ConvergenceTrace(
        solver="pdlp",
        iterations=n_rows,
        columns={k: v[:n_rows] for k, v in cols.items()},
        start_kind=start_kind,
    )


def decode_newton(trace, result=None, lane: int = 0) -> ConvergenceTrace:
    """Decode ``make_newton_solver(..., trace=True)`` telemetry.

    Columns: ``max_residual`` (inf-norm of the scaled residual after
    each damped step).
    """
    cols = {"max_residual": _lane(trace["max_residual"], lane)}
    rows = len(cols["max_residual"])
    n_it = int(_scalar(result.iterations, lane)) if result is not None else rows
    n_it = min(n_it, rows)
    return ConvergenceTrace(
        solver="newton",
        iterations=n_it,
        columns={k: v[:n_it] for k, v in cols.items()},
    )
