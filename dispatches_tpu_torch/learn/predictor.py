"""Learned warm-start predictor: a small MLP head mapping the canonical
``param_vector`` to a scaled-space primal–dual start (counterpart of
``dispatches_tpu/learn/predictor.py``).

    vn  = (vec - in_mean) / in_scale               # normalized input
    out = vn @ w_lin + tanh(vn @ w1 + b1) @ w2 + b2
    y   = out * out_scale + out_mean               # (n + m,) start

The first ``n`` outputs are the scaled-space primal ``x0`` and the rest
the original-space dual ``z0`` — the spaces of the PDLP start contract
and of what ``serve.warmstart.WarmStartIndex`` stores.

Parameters live in one flat dict of host numpy float32 arrays, drawn by
:func:`init_params` from numpy exactly as the JAX package draws them, so
both packages start from bitwise-equal weights.  :func:`forward` runs on
tensors (any leading lane axes), in the promoted dtype of its inputs as
JAX promotes them; serve runs it as a lane-batched plan program whose
weights are arguments, so online refits rebuild nothing.

Flags (registered in ``analysis.flags``):

* ``DISPATCHES_TPU_WARMSTART_PREDICT`` — kill-switch.  Prediction is ON
  by default whenever warm starts are on; set to ``0``/``false`` and no
  predictor/trainer is even constructed.
* ``DISPATCHES_TPU_WARMSTART_PREDICT_HIDDEN`` — MLP hidden width.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

import torch

from dispatches_tpu_torch.analysis.flags import flag_name

__all__ = [
    "StartPredictor",
    "default_hidden",
    "forward",
    "init_params",
    "predict_enabled",
    "snap_to_bounds",
]

DEFAULT_HIDDEN = 32

# trainable keys, in the fixed order the trainer's Adam state mirrors
PARAM_KEYS = ("w_lin", "w1", "b1", "w2", "b2")
# frozen normalization constants riding the same dict
NORM_KEYS = ("in_mean", "in_scale", "out_mean", "out_scale")


def predict_enabled() -> bool:
    """Kill-switch: the predictor rung is ON unless
    ``DISPATCHES_TPU_WARMSTART_PREDICT`` is set to an explicit falsy
    value (same falsy vocabulary as ``flags.flag_enabled``)."""
    raw = os.environ.get(flag_name("WARMSTART_PREDICT"))
    if raw is None:
        return True
    return raw not in ("", "0", "false", "False")


def default_hidden() -> int:
    raw = os.environ.get(flag_name("WARMSTART_PREDICT_HIDDEN"), "")
    return int(raw) if raw else DEFAULT_HIDDEN


def init_params(d: int, n: int, m: int, hidden: int,
                seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic initial parameter dict (host numpy, float32).

    ``w_lin``/``w2``/``b2`` start at zero so the untrained model
    predicts ``out_mean`` — the mean solution, a sane start — and the
    tanh path only grows weight once training pushes it there.
    Normalization starts at identity; :func:`learn.train.fit` sets it
    from data before the first step.
    """
    rng = np.random.default_rng(seed)
    s = np.sqrt(2.0 / max(d, 1))
    return {
        "w_lin": np.zeros((d, n + m), np.float32),
        "w1": (s * rng.standard_normal((d, hidden))).astype(np.float32),
        "b1": np.zeros(hidden, np.float32),
        "w2": np.zeros((hidden, n + m), np.float32),
        "b2": np.zeros(n + m, np.float32),
        "in_mean": np.zeros(d, np.float32),
        "in_scale": np.ones(d, np.float32),
        "out_mean": np.zeros(n + m, np.float32),
        "out_scale": np.ones(n + m, np.float32),
    }


def forward(params: Dict, vec):
    """Predicted ``(..., n + m)`` start for parameter vectors ``vec``
    (``(..., d)`` tensor).

    ``params`` is a dict of arrays or tensors (an argument, so a plan
    program keeps serving across online refits).  The arithmetic runs in
    the promoted dtype of ``vec`` and the weights — float64 for a float64
    bucket's vectors, as JAX promotes — on ``vec``'s device.  The caller
    splits the output at its primal size ``n``.
    """
    dt = torch.promote_types(vec.dtype, torch.as_tensor(params["w1"]).dtype)
    p = {k: torch.as_tensor(v, device=vec.device).to(dt) for k, v in params.items()}
    vn = (vec.to(dt) - p["in_mean"]) / p["in_scale"]
    out = vn @ p["w_lin"] + torch.tanh(vn @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    return out * p["out_scale"] + p["out_mean"]


def snap_to_bounds(x, lb, ub, eps: float = 1e-3):
    """Snap a predicted primal start onto finite variable bounds it
    nearly touches (within ``eps`` relative), then clip into the box
    (host numpy, float32).

    LP solutions sit at vertices: most primal coordinates are exactly
    *at* a bound, and a regression head lands ``eps``-close instead.
    Snapping restores the active-set structure the PDHG iteration
    locks onto quickly.  Primal only — never snap or otherwise round a
    predicted dual; truncating duals against their sign constraints is
    catastrophic (the solver's own ingestion handles the sign split).
    """
    x = np.asarray(x, np.float32)
    lb = np.asarray(lb, np.float32)
    ub = np.asarray(ub, np.float32)
    tol_lb = eps * (1.0 + np.abs(lb))
    tol_ub = eps * (1.0 + np.abs(ub))
    x = np.where(np.isfinite(lb) & (np.abs(x - lb) < tol_lb), lb, x)
    x = np.where(np.isfinite(ub) & (np.abs(x - ub) < tol_ub), ub, x)
    return np.clip(x, lb, ub)


class StartPredictor:
    """A fitted predictor: parameter dict plus the (d, n, m) shape
    contract.  Construction is cheap — the trainer builds one per refit
    and serve just swaps which dict the staged program receives."""

    def __init__(self, params: Dict[str, np.ndarray], n: int, m: int):
        self.params = params
        self.n = int(n)
        self.m = int(m)
        self.d = int(np.asarray(params["w1"]).shape[0])
        self.hidden = int(np.asarray(params["w1"]).shape[1])

    def predict(self, vec) -> Tuple[np.ndarray, np.ndarray]:
        """Host-side single-point prediction ``(x0, z0)`` — for tests
        and offline use; serve runs :func:`forward` batched on device."""
        p = self.params
        vn = (np.asarray(vec, np.float32).ravel() - p["in_mean"]) \
            / p["in_scale"]
        out = vn @ p["w_lin"] + \
            np.tanh(vn @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
        y = out * p["out_scale"] + p["out_mean"]
        return y[: self.n].copy(), y[self.n:].copy()

    def to_state(self) -> dict:
        return {
            "n": self.n,
            "m": self.m,
            "params": {k: np.asarray(v) for k, v in self.params.items()},
        }

    @classmethod
    def from_state(cls, state: Optional[dict]) -> Optional["StartPredictor"]:
        if state is None:
            return None
        params = {k: np.asarray(v, np.float32) for k, v in state["params"].items()}
        return cls(params, int(state["n"]), int(state["m"]))
