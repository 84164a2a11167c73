"""Fitting the warm-start predictor from serve's own completed results
(counterpart of ``dispatches_tpu/learn/train.py``).

Training is full-batch Adam on the MSE of *normalized* outputs, in
float32 under ``torch.autograd``, with the JAX loop's constants (epochs,
learning rate, betas, eps, bias correction).  Rows are padded to the
next power of two with zero sample weight, as in the JAX package, so
both packages fit the same problem.

:class:`ReplayBuffer` and :class:`OnlineTrainer` are copies (pure
logic): ``observe()`` is a cheap bounded-replay-buffer append called
from the completion path, ``due()`` an O(1) cadence check, and
``refit()`` — the only expensive call — runs from ``SolveService.poll``
on the service clock, never on the submit hot path.  ``fit_from_store``
and ``fit_from_index`` fit offline from a warm-start sweep's saved
solutions (``sweep/store.py:ResultStore.training_pairs``) or a live warm
index (``serve/warmstart.py:WarmStartIndex.export_pairs``).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

import torch

from dispatches_tpu_torch import resolve_device
from dispatches_tpu_torch.analysis.flags import flag_name
from dispatches_tpu_torch.learn.predictor import (
    NORM_KEYS,
    PARAM_KEYS,
    StartPredictor,
    default_hidden,
    init_params,
)

__all__ = [
    "OnlineTrainer",
    "ReplayBuffer",
    "default_refit_every",
    "fit",
    "fit_from_index",
    "fit_from_store",
]

DEFAULT_REFIT_EVERY = 64
DEFAULT_REPLAY_CAPACITY = 2048
DEFAULT_EPOCHS = 300
DEFAULT_LR = 3e-3
MIN_FIT_POINTS = 8


def default_refit_every() -> int:
    raw = os.environ.get(flag_name("WARMSTART_PREDICT_REFIT_N"), "")
    return int(raw) if raw else DEFAULT_REFIT_EVERY


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _adam(tr, norm, X, Yn, w, epochs: int, lr: float):
    """``epochs`` full-batch Adam steps on the weighted MSE of normalized
    outputs; returns the trained tensors.  The JAX loop's constants and
    float32 arithmetic."""
    out_dim = Yn.shape[1]
    b1, b2, eps = 0.9, 0.999, 1e-8
    b1_t = torch.tensor(b1, dtype=torch.float32, device=X.device)
    b2_t = torch.tensor(b2, dtype=torch.float32, device=X.device)
    keys = list(tr)
    mom = {k: torch.zeros_like(v) for k, v in tr.items()}
    vel = {k: torch.zeros_like(v) for k, v in tr.items()}
    vn = (X - norm["in_mean"]) / norm["in_scale"]
    wsum = torch.sum(w) * out_dim
    for i in range(epochs):
        params = [tr[k].requires_grad_(True) for k in keys]
        pred = vn @ tr["w_lin"] + \
            torch.tanh(vn @ tr["w1"] + tr["b1"]) @ tr["w2"] + tr["b2"]
        err = pred - Yn
        loss = torch.sum(w[:, None] * err * err) / wsum
        grads = torch.autograd.grad(loss, params)
        t = torch.tensor(i + 1, dtype=torch.float32, device=X.device)
        c1 = 1.0 - torch.pow(b1_t, t)
        c2 = 1.0 - torch.pow(b2_t, t)
        with torch.no_grad():
            for k, g in zip(keys, grads):
                mom[k] = b1 * mom[k] + (1.0 - b1) * g
                vel[k] = b2 * vel[k] + (1.0 - b2) * g * g
                tr[k] = tr[k].detach() - lr * (mom[k] / c1) / (torch.sqrt(vel[k] / c2) + eps)
    return {k: v.detach() for k, v in tr.items()}


def fit(vecs, xs, zs, *, hidden: Optional[int] = None, seed: int = 0,
        epochs: int = DEFAULT_EPOCHS, lr: float = DEFAULT_LR, device=None
        ) -> StartPredictor:
    """Fit a :class:`StartPredictor` on ``(vec, x, z)`` training triples.

    ``vecs`` is (N, d) parameter vectors; ``xs``/``zs`` the matching
    scaled-space primal and original-space dual solutions (any trailing
    shape, flattened per row).  Non-finite rows are dropped — a
    diverged solve must never steer the predictor.  Deterministic for
    fixed inputs/seed.  The Adam loop runs on ``device`` (``cuda`` unless
    given); the fitted weights come back as host numpy.
    """
    dev = resolve_device(device)

    vecs = np.atleast_2d(np.asarray(vecs, np.float32))
    N = vecs.shape[0]
    xs = np.asarray(xs, np.float32).reshape(N, -1)
    zs = np.asarray(zs, np.float32).reshape(N, -1)
    Y = np.concatenate([xs, zs], axis=1)
    keep = np.all(np.isfinite(vecs), axis=1) & np.all(np.isfinite(Y), axis=1)
    vecs, Y = vecs[keep], Y[keep]
    N = vecs.shape[0]
    if N < 1:
        raise ValueError("fit needs at least one finite training row")
    n, m = xs.shape[1], zs.shape[1]
    d = vecs.shape[1]
    hidden = default_hidden() if hidden is None else int(hidden)

    params = init_params(d, n, m, hidden, seed)
    params["in_mean"] = vecs.mean(axis=0)
    params["in_scale"] = np.maximum(vecs.std(axis=0), 1e-6).astype(np.float32)
    params["out_mean"] = Y.mean(axis=0)
    params["out_scale"] = np.maximum(Y.std(axis=0), 1e-6).astype(np.float32)
    Yn = (Y - params["out_mean"]) / params["out_scale"]

    rows = _next_pow2(N)
    Xp = np.zeros((rows, d), np.float32)
    Ynp = np.zeros((rows, n + m), np.float32)
    w = np.zeros(rows, np.float32)
    Xp[:N], Ynp[:N], w[:N] = vecs, Yn, 1.0

    def t(a):
        return torch.as_tensor(a, device=dev)

    tr = _adam({k: t(params[k]) for k in PARAM_KEYS},
               {k: t(params[k]) for k in NORM_KEYS},
               t(Xp), t(Ynp), t(w), int(epochs), float(lr))
    params.update({k: v.cpu().numpy() for k, v in tr.items()})
    return StartPredictor(params, n, m)


def fit_from_store(store, **kwargs) -> StartPredictor:
    """Offline fit from a warm-start sweep's saved solutions
    (:meth:`ResultStore.training_pairs`; raises on a store swept
    without ``warm_start``).  ``kwargs`` go to :func:`fit`."""
    vecs, xs, zs = store.training_pairs()
    return fit(vecs, xs, zs, **kwargs)


def fit_from_index(index, **kwargs) -> StartPredictor:
    """Offline fit from a live :class:`WarmStartIndex`
    (:meth:`export_pairs`; raises on an empty index).  ``kwargs`` go to
    :func:`fit`."""
    vecs, xs, zs = index.export_pairs()
    if len(vecs) == 0:
        raise ValueError("fit_from_index: the index is empty")
    return fit(np.stack(vecs), np.stack(xs), np.stack(zs), **kwargs)


class ReplayBuffer:
    """Bounded ring of (vec, x, z) training triples, oldest evicted
    first.  Same defensive non-finite drop as the warm index; arrays
    come back in logical insertion order so a refit is deterministic
    for a given observation history."""

    def __init__(self, capacity: int = DEFAULT_REPLAY_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._vecs: Optional[np.ndarray] = None
        self._xs: Optional[np.ndarray] = None
        self._zs: Optional[np.ndarray] = None
        self._cursor = 0
        self._count = 0

    def __len__(self) -> int:
        return self._count

    def append(self, vec, x, z) -> None:
        vec = np.asarray(vec, np.float32).ravel()
        x = np.asarray(x, np.float32).ravel()
        z = np.asarray(z, np.float32).ravel()
        if not (np.all(np.isfinite(vec)) and np.all(np.isfinite(x))
                and np.all(np.isfinite(z))):
            return
        if self._vecs is None:
            self._vecs = np.zeros((self.capacity, vec.size), np.float32)
            self._xs = np.zeros((self.capacity, x.size), np.float32)
            self._zs = np.zeros((self.capacity, z.size), np.float32)
        slot = self._cursor
        self._vecs[slot], self._xs[slot], self._zs[slot] = vec, x, z
        self._cursor = (self._cursor + 1) % self.capacity
        self._count = min(self._count + 1, self.capacity)

    def arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self._count < self.capacity:
            order = np.arange(self._count)
        else:
            order = (self._cursor + np.arange(self.capacity)) % self.capacity
        return self._vecs[order], self._xs[order], self._zs[order]


class OnlineTrainer:
    """Serve-side predictor lifecycle: cheap observation, O(1) cadence
    check, clock-driven refit.  ``trained_samples`` counts the
    observations seen at the last refit or adoption."""

    def __init__(self, n: int, m: int, *, hidden: Optional[int] = None,
                 refit_every: Optional[int] = None,
                 capacity: int = DEFAULT_REPLAY_CAPACITY,
                 min_points: int = MIN_FIT_POINTS, seed: int = 0,
                 device=None):
        self.n = int(n)
        self.m = int(m)
        self.hidden = default_hidden() if hidden is None else int(hidden)
        self.refit_every = (default_refit_every() if refit_every is None
                            else int(refit_every))
        self.min_points = int(min_points)
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.buffer = ReplayBuffer(capacity)
        self.predictor: Optional[StartPredictor] = None
        self.samples = 0          # total ever observed
        self.trained_samples = 0  # samples at last refit/adoption
        self.refits = 0
        self._pending = 0

    def observe(self, vec, x, z) -> None:
        """One completed result (converged + finite, caller-gated).
        O(capacity-row copy); safe on the completion path."""
        self.buffer.append(vec, x, z)
        self.samples += 1
        self._pending += 1

    def due(self) -> bool:
        """O(1): enough fresh results since the last refit?"""
        return (self._pending >= self.refit_every
                and len(self.buffer) >= self.min_points)

    def ready(self) -> bool:
        return self.predictor is not None

    def refit(self, *, epochs: int = DEFAULT_EPOCHS,
              lr: float = DEFAULT_LR,
              window: Optional[int] = None) -> StartPredictor:
        """Full refit from the replay buffer (the expensive call —
        ``SolveService.poll`` gates it behind :meth:`due`).

        ``window`` restricts the fit to the most recent rows.  On a
        drifting stream the solution map's active pieces migrate with
        the traffic, so a small recency window tracks the tube the next
        requests will land in better than the whole buffer; on
        stationary traffic leave it ``None`` (all rows) for the lowest
        variance.  The window never shrinks below ``min_points``.
        """
        vecs, xs, zs = self.buffer.arrays()
        if window is not None:
            tail = max(int(window), self.min_points)
            vecs, xs, zs = vecs[-tail:], xs[-tail:], zs[-tail:]
        self.predictor = fit(vecs, xs, zs, hidden=self.hidden,
                             seed=self.seed, epochs=epochs, lr=lr,
                             device=self.device)
        self._pending = 0
        self.refits += 1
        self.trained_samples = self.samples
        return self.predictor

    def adopt(self, predictor: StartPredictor, trained_samples: int) -> None:
        """Take over a predictor fitted elsewhere.  Shape-checked: a
        bucket never mixes problem sizes."""
        if (predictor.n, predictor.m) != (self.n, self.m):
            raise ValueError(
                f"predictor shape ({predictor.n}, {predictor.m}) does not "
                f"match trainer ({self.n}, {self.m})"
            )
        self.predictor = predictor
        self.trained_samples = int(trained_samples)

    def to_state(self) -> dict:
        """Weights and counters; the replay buffer is transient by design
        (a restored service re-accumulates fresh results)."""
        return {
            "n": self.n,
            "m": self.m,
            "hidden": self.hidden,
            "refit_every": self.refit_every,
            "samples": self.samples,
            "trained_samples": self.trained_samples,
            "refits": self.refits,
            "predictor": None if self.predictor is None
            else self.predictor.to_state(),
        }

    def load_state(self, state: dict) -> None:
        self.samples = int(state.get("samples", 0))
        self.trained_samples = int(state.get("trained_samples", 0))
        self.refits = int(state.get("refits", 0))
        pred = StartPredictor.from_state(state.get("predictor"))
        if pred is not None and (pred.n, pred.m) == (self.n, self.m):
            self.predictor = pred
