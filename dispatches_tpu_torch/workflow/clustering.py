"""Time-series k-means clustering of dispatch day-slices (counterpart of
``dispatches_tpu/workflow/clustering.py``).

Annual dispatch series are cut into 24-h days, all-zero / all-one
capacity-factor days are filtered, and the remaining days are clustered
with Euclidean k-means (the reference's ``tslearn.TimeSeriesKMeans(
metric='euclidean', random_state=42)``) or with soft-DTW k-means; the
trained model round-trips through the reference's json-with-centroids
format.

:func:`kmeans_fit` is k-means++ seeding (:func:`_kmeanspp_init`, drawn
from a ``torch.Generator`` on the CPU seeded with ``seed``, so the seeding
does not depend on the device) followed by a float64 Lloyd loop
(:func:`_lloyd`) on ``device``.  The JAX package seeds with
``jax.random``, so the two packages' seedings differ; the Lloyd loop is
the same arithmetic.  :func:`soft_dtw` walks the DP table by
anti-diagonals: a T x T table takes 2T - 1 vectorized steps, and its
gradient comes from autograd.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from dispatches_tpu_torch import resolve_device

__all__ = ["slice_days", "kmeans_fit", "soft_dtw", "kmeans_fit_softdtw",
           "TimeSeriesClustering"]


def slice_days(year: np.ndarray, time_length: int = 24, filter_opt: bool = True):
    """Cut one annual series into day slices; with ``filter_opt``,
    all-zero and all-one capacity-factor days are removed and counted
    (the single filter rule shared by clustering and label generation).
    Returns (days, zero_count, full_count, kept_day_indices)."""
    days, kept, zero, full = [], [], 0, 0
    day_num = len(year) // time_length
    for d in range(day_num):
        slc = year[d * time_length: (d + 1) * time_length]
        if filter_opt:
            s = float(np.sum(slc))
            if s == 0.0:
                zero += 1
                continue
            if s == float(time_length):
                full += 1
                continue
        days.append(slc)
        kept.append(d)
    return days, zero, full, kept


def _kmeanspp_init(X: torch.Tensor, k: int,
                   generator: torch.Generator) -> torch.Tensor:
    """k-means++ seeding of (N, D) float64 ``X``: the first centre
    uniformly, each next one with probability proportional to its squared
    distance to the nearest chosen centre.  The draws come from
    ``generator`` (a CPU generator) and the distances are taken on the
    host, so the seeding is the same on every device."""
    Xh = X.detach().to("cpu", torch.float64)
    n = Xh.shape[0]
    idx = [int(torch.randint(n, (), generator=generator))]
    d2 = torch.sum((Xh - Xh[idx[0]]) ** 2, dim=1)
    for _ in range(1, k):
        probs = d2 / max(float(d2.sum()), 1e-30)
        if float(probs.sum()) <= 0.0:  # fewer distinct points than k
            probs = torch.full_like(probs, 1.0 / n)
        nxt = int(torch.multinomial(probs, 1, generator=generator))
        idx.append(nxt)
        d2 = torch.minimum(d2, torch.sum((Xh - Xh[nxt]) ** 2, dim=1))
    return X[idx].clone()


def _assign(X: torch.Tensor, centers: torch.Tensor):
    """(labels, squared distances) of every row to its nearest centre, by
    the expanded form ``|x|^2 - 2 x.c + |c|^2`` (the JAX package's)."""
    d2 = (torch.sum(X * X, 1)[:, None] - 2.0 * X @ centers.T
          + torch.sum(centers * centers, 1)[None, :])
    return torch.argmin(d2, 1), torch.min(d2, 1).values


def _lloyd(X: torch.Tensor, centers0: torch.Tensor, n_iter: int = 300,
           tol: float = 1e-6):
    """Lloyd iterations from ``centers0`` until the largest centre move is
    at most ``tol`` or ``n_iter`` steps ran; an empty cluster keeps its
    centre.  One host read per step (the move).  Returns (centers,
    labels, inertia) as tensors on ``X``'s device."""
    centers = centers0.to(X.dtype)
    k = centers.shape[0]
    for _ in range(n_iter):
        labels, _ = _assign(X, centers)
        onehot = torch.nn.functional.one_hot(labels, k).to(X.dtype)
        counts = onehot.sum(0)
        sums = onehot.T @ X
        new = torch.where(counts[:, None] > 0,
                          sums / torch.clamp(counts[:, None], min=1.0), centers)
        shift = torch.max(torch.abs(new - centers))
        centers = new
        if not bool(shift > tol):
            break
    labels, d2 = _assign(X, centers)
    return centers, labels, torch.sum(d2)


def kmeans_fit(X: np.ndarray, n_clusters: int, seed: int = 42,
               n_iter: int = 300, tol: float = 1e-6, device=None):
    """Euclidean k-means on (N, D) data on ``device`` (``cuda`` unless
    given): k-means++ seeding from ``seed``, then Lloyd iterations.
    Returns (centers (k, D), labels (N,), inertia) as numpy and a float."""
    dev = resolve_device(device)
    Xt = torch.as_tensor(np.asarray(X, dtype=np.float64), device=dev)
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    centers0 = _kmeanspp_init(Xt, n_clusters, gen)
    centers, labels, inertia = _lloyd(Xt, centers0, n_iter=n_iter, tol=tol)
    return centers.cpu().numpy(), labels.cpu().numpy(), float(inertia)


def _softmin3(a, b, c, gamma: float):
    z = torch.stack([a, b, c]) * (-1.0 / gamma)
    return -gamma * torch.logsumexp(z, dim=0)


def soft_dtw(x, y, gamma: float = 1.0) -> torch.Tensor:
    """Raw soft-DTW value between univariate series (Cuturi & Blondel
    2017) with a quadratic local cost; ``x`` (..., Tx) and ``y`` (..., Ty)
    broadcast over their leading axes.  The raw value is not a divergence
    (``soft_dtw(x, x) < 0`` in general); the clustering distances use
    ``sdtw(x,y) - (sdtw(x,x) + sdtw(y,y))/2``.

    The DP ``R[i, j] = D[i, j] + softmin(R[i-1, j], R[i-1, j-1],
    R[i, j-1])`` is filled one anti-diagonal ``i + j = s`` at a time: every
    cell of a diagonal depends only on the two diagonals before it, so a
    (Tx, Ty) table takes Tx + Ty - 1 vectorized steps.  Differentiable
    (autograd)."""
    x = torch.as_tensor(x, dtype=torch.float64)
    y = torch.as_tensor(y, dtype=torch.float64, device=x.device)
    D = (x[..., :, None] - y[..., None, :]) ** 2          # (..., Tx, Ty)
    Tx, Ty = D.shape[-2], D.shape[-1]
    batch = D.shape[:-2]
    big = 1e10

    def filler(width):
        return torch.full(batch + (width,), big, dtype=D.dtype, device=D.device)

    # a diagonal s of the padded table R (Tx+1, Ty+1) is a vector over the
    # row i = 0..Tx, holding R[i, s-i] (big off the table); R[0, 0] = 0
    # and the rest of row and column 0 is big
    rows = torch.arange(Tx + 1, device=D.device)
    prev2 = torch.cat([torch.zeros_like(filler(1)), filler(Tx)], dim=-1)  # s = 0
    prev1 = filler(Tx + 1)                                                 # s = 1
    for s in range(2, Tx + Ty + 1):
        # cells (i, j = s - i) with 1 <= i <= Tx and 1 <= j <= Ty
        lo, hi = max(1, s - Ty), min(Tx, s - 1)
        i = rows[lo:hi + 1]
        up = prev1[..., lo - 1:hi]                        # R[i-1, j]
        left = prev1[..., lo:hi + 1]                      # R[i, j-1]
        diag = prev2[..., lo - 1:hi]                      # R[i-1, j-1]
        vals = D[..., i - 1, s - i - 1] + _softmin3(up, diag, left, gamma)
        prev2, prev1 = prev1, torch.cat([filler(lo), vals, filler(Tx - hi)], dim=-1)
    return prev1[..., Tx]


def kmeans_fit_softdtw(X: np.ndarray, n_clusters: int, gamma: float = 1.0,
                       seed: int = 42, n_iter: int = 10,
                       barycenter_steps: int = 25, barycenter_lr: float = 0.2,
                       block: Optional[int] = None, device=None):
    """Soft-DTW k-means on (N, D) day-slices on ``device`` (``cuda``
    unless given): a Euclidean :func:`kmeans_fit` seeds the centres, then
    Lloyd iterations under the soft-DTW divergence (zero at identity)
    with gradient barycentre updates, all k centres at once.  ``block``
    aligns each length-``block`` segment independently and sums (for
    concatenated features such as the RE dispatch||wind day vectors).
    Returns (centers, labels, inertia)."""
    dev = resolve_device(device)
    centers0, _, _ = kmeans_fit(X, n_clusters, seed=seed, device=dev)
    Xt = torch.as_tensor(np.asarray(X, dtype=np.float64), device=dev)
    centers = torch.as_tensor(centers0, device=dev)

    def sdtw(a, b):
        """Pairwise over broadcast leading axes, summed over blocks."""
        if block is None or a.shape[-1] <= block:
            return soft_dtw(a, b, gamma)
        nb = a.shape[-1] // block
        ar = a[..., : nb * block].unflatten(-1, (nb, block))
        br = b[..., : nb * block].unflatten(-1, (nb, block))
        return torch.sum(soft_dtw(ar, br, gamma), dim=-1)

    X_self = sdtw(Xt, Xt)                                 # (N,)

    def dists(cs):
        raw = sdtw(Xt[:, None, :], cs[None, :, :])        # (N, k)
        return raw - 0.5 * (X_self[:, None] + sdtw(cs, cs)[None, :])

    def bary_step(cs, onehotT):
        # one gradient step for all centres at once: (k, D) x (k, N)
        cs = cs.detach().requires_grad_(True)
        d = sdtw(cs[:, None, :], Xt[None, :, :])          # (k, N)
        loss = torch.sum(onehotT * d, dim=1) / torch.clamp(onehotT.sum(1), min=1.0)
        (g,) = torch.autograd.grad(loss.sum(), cs)
        return (cs - barycenter_lr * g).detach()

    with torch.no_grad():
        d = dists(centers)
    for _ in range(n_iter):
        labels = torch.argmin(d, dim=1)
        onehotT = torch.nn.functional.one_hot(labels, n_clusters).to(Xt.dtype).T
        for _ in range(barycenter_steps):
            centers = bary_step(centers, onehotT)
        with torch.no_grad():
            d = dists(centers)
    labels = torch.argmin(d, dim=1)
    inertia = float(torch.sum(torch.min(d, dim=1).values))
    return centers.cpu().numpy(), labels.cpu().numpy(), inertia


class TimeSeriesClustering:
    def __init__(self, num_clusters, simulation_data, filter_opt=True,
                 metric="euclidean", device=None):
        self.simulation_data = simulation_data
        self.num_clusters = num_clusters
        self.filter_opt = filter_opt
        self.metric = metric
        self.device = device
        self._time_length = 24

    @property
    def metric(self):
        return self._metric

    @metric.setter
    def metric(self, value):
        if value not in ("euclidean", "dtw"):
            raise ValueError(
                f"The metric must be one of 'euclidean' or 'dtw', but {value} is given"
            )
        self._metric = value

    @property
    def num_clusters(self):
        return self._num_clusters

    @num_clusters.setter
    def num_clusters(self, value):
        if not isinstance(value, int):
            raise TypeError(
                f"Number of clusters must be an integer, but {type(value)} is given"
            )
        self._num_clusters = value

    # -- day slicing + filtering --------------------------------------

    def _slice_days(self, scaled_dispatch_dict):
        days = []
        for year in scaled_dispatch_dict.values():
            d, _, _, _ = slice_days(year, self._time_length, self.filter_opt)
            days.extend(d)
        return days

    def _transform_data_RE(self, wind_file=None):
        """RE mode clusters (dispatch_day, wind_day) jointly: feature =
        48-vector."""
        scaled = self.simulation_data._scale_data()
        wind_data = self.simulation_data.read_wind_data(wind_file)
        days = []
        for year in scaled.values():
            day_num = min(len(year) // self._time_length, len(wind_data))
            kept, _, _, kept_ids = slice_days(
                year[: day_num * self._time_length],
                self._time_length,
                self.filter_opt,
            )
            for d, i in zip(kept, kept_ids):
                days.append(np.concatenate([d, wind_data[i]]))
        return np.asarray(days)

    def _transform_data(self, wind_file=None):
        if self.simulation_data.case_type == "RE" and wind_file is not None:
            return self._transform_data_RE(wind_file)
        scaled = self.simulation_data._scale_data()
        return np.asarray(self._slice_days(scaled))

    # -- clustering ----------------------------------------------------

    def clustering_data(self, wind_file=None):
        train = self._transform_data(wind_file)
        if self.metric == "dtw":
            # RE concatenated features (24h dispatch || 24h wind) align
            # per 24-h block — no warping across the boundary
            centers, labels, inertia = kmeans_fit_softdtw(
                train, self.num_clusters, seed=42,
                block=24 if train.shape[1] > 24 else None, device=self.device,
            )
        else:
            centers, labels, inertia = kmeans_fit(
                train, self.num_clusters, seed=42, device=self.device
            )
        return {
            "n_clusters": self.num_clusters,
            "cluster_centers_": centers,
            "labels_": labels,
            "inertia_": inertia,
            "metric": self.metric,
        }

    # -- model (de)serialization ----------------------------------------

    def save_clustering_model(self, clustering_model, fpath):
        out = {
            "n_clusters": int(clustering_model["n_clusters"]),
            "metric": clustering_model["metric"],
            "model_params": {
                "cluster_centers_": np.asarray(
                    clustering_model["cluster_centers_"]
                ).tolist()
            },
        }
        with open(fpath, "w") as f:
            json.dump(out, f)
        return fpath

    @staticmethod
    def load_clustering_model(fpath):
        with open(fpath) as f:
            raw = json.load(f)
        centers = np.asarray(raw["model_params"]["cluster_centers_"], dtype=float)
        # tslearn stores (k, T, 1); squeeze any trailing singleton
        if centers.ndim == 3 and centers.shape[-1] == 1:
            centers = centers[:, :, 0]
        return {
            "n_clusters": int(raw.get("n_clusters", len(centers))),
            "cluster_centers_": centers,
            "metric": raw.get("metric", "euclidean"),
        }

    def get_cluster_centers(self, result_path):
        model = self.load_clustering_model(result_path)
        centers = model["cluster_centers_"]
        return {i: centers[i] for i in range(len(centers))}
