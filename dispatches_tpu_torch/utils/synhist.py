"""Synthetic LMP history generation via ARMA sampling (counterpart of
``dispatches_tpu/utils/synhist.py``).

Model: seasonal-mean + ARMA(p, q) residual
    y_t = mu_t + sum_i phi_i a_{t-i} + e_t + sum_j theta_j e_{t-j}
with ``mu_t`` a periodic (e.g. 24-h) profile and Gaussian innovations.

:meth:`ARMAModel.sample` is two steps: Gaussian innovations drawn from a
``torch.Generator`` on the CPU seeded with ``seed`` (so a sample does not
depend on the device), then the deterministic filter :func:`_arma_filter`
over them, vectorized over realizations.  The JAX package draws its
innovations with ``jax.random``, so the seeded draws differ between the
packages; the filter is the same arithmetic.  :class:`RavenARMAROM` is
numpy (its sampling uses numpy's ``default_rng``, as in the JAX package)
and trains its day clusters through ``workflow.clustering.kmeans_fit``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from dispatches_tpu_torch import resolve_device

__all__ = ["ARMAModel", "RavenARMAROM", "generate_clustered_realizations",
           "generate_syn_realizations"]


def _arma_filter(e: torch.Tensor, phi, theta, seasonal_mean,
                 n_steps: int) -> torch.Tensor:
    """(R, n_steps) signals from (R, n_steps + q) innovations: the ARMA
    recursion in float64 on ``e``'s device, plus the tiled seasonal mean.
    Each step takes the AR and MA dot products in the JAX scan's order."""
    e = e.to(torch.float64)
    dev = e.device
    phi = torch.as_tensor(np.asarray(phi, dtype=np.float64), device=dev)
    theta = torch.as_tensor(np.asarray(theta, dtype=np.float64), device=dev)
    mean = np.asarray(seasonal_mean, dtype=np.float64)
    p, q = phi.numel(), theta.numel()
    R = e.shape[0]
    hist = torch.zeros((R, max(p, 1)), dtype=torch.float64, device=dev)
    resid = []
    for t in range(n_steps):
        a_t = e[:, t + q]
        if p:
            a_t = hist[:, :p] @ phi + a_t
        if q:
            a_t = a_t + e[:, t:t + q].flip(-1) @ theta
        if p:
            hist = torch.cat([a_t[:, None], hist[:, :-1]], dim=1)
        resid.append(a_t)
    season = np.tile(mean, n_steps // len(mean) + 1)[:n_steps]
    return torch.as_tensor(season, device=dev) + torch.stack(resid, dim=1)


@dataclass
class ARMAModel:
    phi: Sequence[float]  # AR coefficients
    theta: Sequence[float]  # MA coefficients
    sigma: float  # innovation std
    seasonal_mean: Sequence[float]  # periodic mean profile (e.g. 24 values)

    def innovations(self, seed: int, n_steps: int,
                    n_realizations: int = 1) -> torch.Tensor:
        """(n_realizations, n_steps + q) float64 Gaussian innovations
        with std ``sigma``, drawn on the CPU from ``seed``."""
        gen = torch.Generator(device="cpu").manual_seed(int(seed))
        q = len(self.theta)
        return self.sigma * torch.randn((n_realizations, n_steps + q),
                                        generator=gen, dtype=torch.float64)

    def sample(self, seed: int, n_steps: int, n_realizations: int = 1,
               device=None) -> torch.Tensor:
        """(n_realizations, n_steps) synthetic signals from ``seed``
        (the JAX package takes a PRNG key here), filtered on ``device``
        (``cuda`` unless given)."""
        dev = resolve_device(device)
        e = self.innovations(seed, n_steps, n_realizations).to(dev)
        return _arma_filter(e, self.phi, self.theta, self.seasonal_mean, n_steps)

    @classmethod
    def fit(cls, signal: Sequence[float], p: int = 2, q: int = 0,
            period: int = 24) -> "ARMAModel":
        """Moment-based fit: periodic mean + Yule-Walker AR coefficients
        (a practical stand-in for the RAVEN ROM training)."""
        y = np.asarray(signal, dtype=float)
        n_periods = len(y) // period
        folded = y[: n_periods * period].reshape(n_periods, period)
        mean = folded.mean(axis=0)
        resid = (folded - mean).ravel()
        if p:
            r = np.array([
                np.mean(resid[k:] * resid[: len(resid) - k]) for k in range(p + 1)
            ])
            R = np.array([[r[abs(i - j)] for j in range(p)] for i in range(p)])
            phi = np.linalg.solve(R + 1e-12 * np.eye(p), r[1: p + 1])
            sigma2 = r[0] - phi @ r[1: p + 1]
        else:
            phi = np.zeros(0)
            sigma2 = resid.var()
        return cls(
            phi=list(phi),
            theta=[0.0] * q,
            sigma=float(np.sqrt(max(sigma2, 1e-12))),
            seasonal_mean=list(mean),
        )


def _fourier_design(t: np.ndarray, periods: Sequence[float]) -> np.ndarray:
    """(len(t), 2*len(periods)+1) least-squares design: intercept +
    sin/cos pair per period (RAVEN's Fourier detrend basis)."""
    cols = [np.ones_like(t, dtype=float)]
    for P in periods:
        w = 2.0 * np.pi * t / P
        cols.append(np.sin(w))
        cols.append(np.cos(w))
    return np.stack(cols, axis=1)


def _ma1_fit(g: np.ndarray):
    """Moment fit of MA(1) ``g_t = e_t + theta e_{t-1}``: invert
    ``rho1 = theta/(1+theta^2)`` on the invertible branch."""
    g = g - g.mean()
    r0 = float(np.mean(g * g))
    r1 = float(np.mean(g[1:] * g[:-1]))
    rho = 0.0 if r0 <= 0 else np.clip(r1 / r0, -0.49, 0.49)
    theta = 0.0 if abs(rho) < 1e-9 else (
        (1.0 - np.sqrt(1.0 - 4.0 * rho * rho)) / (2.0 * rho)
    )
    sigma2 = max(r0 / (1.0 + theta * theta), 1e-12)
    return float(theta), float(np.sqrt(sigma2))


def _quantile_map(sorted_vals: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Empirical inverse-CDF: u in (0,1) -> quantiles of sorted_vals."""
    n = len(sorted_vals)
    grid = (np.arange(n) + 0.5) / n
    return np.interp(u, grid, sorted_vals)


@dataclass
class RavenARMAROM:
    """The reference's shipped ARMA ROM **artifact**, trained from its
    RAVEN spec (``ARMA_train.xml`` + ``Price_20xx.csv`` + a year-pointer
    CSV): a Fourier detrend at the XML's periods per year, the
    CDF-preserving residual transform, an ARMA(P=0, Q=1) innovations
    model per 24-h day cluster (``n_clusters`` k-means clusters on raw
    price), and macro-year interpolation between trained years.

    ``generateSyntheticHistory`` returns the nested dict the reference
    builds (``syn_hist_integration.py:100-126``): cluster
    ``weights_days``, 0-based ``cluster_map``, and 1-based
    cluster/hour-keyed ``LMP`` values.  Training runs
    ``kmeans_fit(..., device=device)``; the rest is numpy.
    """

    years: Sequence[int]                 # trained macro years (sorted)
    periods: Sequence[float]
    fourier_coef: dict                   # year -> (2P+1,) LSQ coefficients
    sorted_resid: dict                   # year -> sorted detrended residuals
    sorted_price: dict                   # year -> sorted raw prices (CDF)
    theta: dict                          # year -> (n_clusters,) MA(1) coef
    sigma: dict                          # year -> (n_clusters,) innovation std
    cluster_labels: dict                 # year -> (n_days,) day -> cluster id
    rep_day: dict                        # year -> (n_clusters,) representative day
    n_clusters: int = 20
    pivot_length: int = 24
    preserve_input_cdf: bool = True

    @classmethod
    def train_from_artifact(cls, artifact_dir, device=None) -> "RavenARMAROM":
        """Parse ``ARMA_train.xml`` + pointer CSV and train."""
        import csv
        import xml.etree.ElementTree as ET
        from pathlib import Path

        from scipy.stats import norm

        from dispatches_tpu_torch.workflow.clustering import kmeans_fit

        d = Path(artifact_dir)
        root = ET.parse(d / "ARMA_train.xml").getroot()
        rom = root.find(".//Models/ROM")
        periods = [float(x) for x in rom.findtext("Fourier").split(",")]
        if rom.findtext("P").strip() != "0" or rom.findtext("Q").strip() != "1":
            raise ValueError("the ARMA artifact spec must be P=0, Q=1")
        pivot = int(rom.find("Segment/subspace").get("pivotLength"))
        n_clusters = int(root.findtext(".//PostProcessor/KDD/n_clusters"))
        pointer = root.findtext(".//Files/Input[@name='input']")
        year_files = {}
        with open(d / Path(pointer).name) as f:
            for row in csv.DictReader(f):
                year_files[int(row["Year"])] = d / row["filename"]

        years, fc, sr, sp, th, sg, cl, rd = [], {}, {}, {}, {}, {}, {}, {}
        trained = {}  # filename -> trained tuple, so the 2045 anchor
        # (which points at Price_2021.csv) reuses 2021's fit
        for year in sorted(year_files):
            fn = year_files[year]
            if fn not in trained:
                prices = np.loadtxt(fn, delimiter=",", skiprows=1, usecols=1)
                n = len(prices)
                t = np.arange(n, dtype=float)
                X = _fourier_design(t, periods)
                coef, *_ = np.linalg.lstsq(X, prices, rcond=None)
                resid = prices - X @ coef
                # gaussianise the residual through its empirical CDF
                ranks = np.argsort(np.argsort(resid))
                g = norm.ppf((ranks + 0.5) / n)
                # 24-h segments, clustered on raw price (the XML
                # classifier clusters on 'price')
                n_days = n // pivot
                day_prices = prices[: n_days * pivot].reshape(n_days, pivot)
                centers, labels, _ = kmeans_fit(day_prices, n_clusters,
                                                device=device)
                # representative day = member closest to its centroid
                rep = np.zeros(n_clusters, dtype=int)
                thetas = np.zeros(n_clusters)
                sigmas = np.zeros(n_clusters)
                g_days = g[: n_days * pivot].reshape(n_days, pivot)
                for c in range(n_clusters):
                    members = np.where(labels == c)[0]
                    if len(members) == 0:
                        rep[c] = 0
                        thetas[c], sigmas[c] = 0.0, 1.0
                        continue
                    dist = np.linalg.norm(day_prices[members] - centers[c], axis=1)
                    rep[c] = members[np.argmin(dist)]
                    thetas[c], sigmas[c] = _ma1_fit(g_days[members].ravel())
                trained[fn] = (coef, np.sort(resid), np.sort(prices), thetas,
                               sigmas, labels, rep)
            fc[year], sr[year], sp[year], th[year], sg[year], cl[year], rd[year] = \
                trained[fn]
            years.append(year)
        return cls(years=years, periods=periods, fourier_coef=fc,
                   sorted_resid=sr, sorted_price=sp, theta=th, sigma=sg,
                   cluster_labels=cl, rep_day=rd, n_clusters=n_clusters,
                   pivot_length=pivot)

    def _interp_params(self, year: int):
        """Macro-year interpolation (``Segment grouping='interpolate'``):
        linear in the Fourier coefficients between bracketing trained
        years; per-cluster ARMA params and cluster labels come together
        from the nearest trained year (each year's k-means labeling is an
        arbitrary permutation)."""
        ys = sorted(self.years)
        if year in self.fourier_coef:
            y0 = y1 = year
            w = 0.0
        else:
            if not ys[0] <= year <= ys[-1]:
                raise ValueError(
                    f"year {year} outside trained span {ys[0]}-{ys[-1]}")
            y0 = max(y for y in ys if y <= year)
            y1 = min(y for y in ys if y >= year)
            w = (year - y0) / (y1 - y0)
        coef = (1 - w) * self.fourier_coef[y0] + w * self.fourier_coef[y1]
        nearest = y0 if w < 0.5 else y1
        return coef, self.theta[nearest], self.sigma[nearest], nearest

    def generateSyntheticHistory(self, signal_name: str,
                                 set_years: Sequence[int], seed: int = 42):
        """Clustered-mode sample: per year, one 24-h profile per cluster
        plus the cluster weights/day-map — the nested dict of
        ``syn_hist_integration.py:100-126``."""
        if signal_name not in ("price", "LMP"):
            raise KeyError(
                f"Signal name {signal_name} not found in sampled history "
                "keys: ('price', 'LMP')")
        from scipy.stats import norm

        rng = np.random.default_rng(seed)
        out = {"weights_days": {}, "cluster_map": {}, "LMP": {}}
        H = self.pivot_length
        for year in set_years:
            coef, theta, sigma, near = self._interp_params(year)
            labels = self.cluster_labels[near]
            rep = self.rep_day[near]
            sres = self.sorted_resid[near]
            spri = self.sorted_price[near]
            out["weights_days"][year] = {}
            out["cluster_map"][year] = {}
            vals = np.zeros((self.n_clusters, H))
            for c in range(self.n_clusters):
                members = np.where(labels == c)[0]
                out["weights_days"][year][c + 1] = len(members)
                out["cluster_map"][year][c + 1] = list(members)
                t = rep[c] * H + np.arange(H, dtype=float)
                mean = _fourier_design(t, self.periods) @ coef
                # MA(1) innovations, gaussian scale, CDF-mapped back
                e = rng.standard_normal(H + 1) * sigma[c]
                g = e[1:] + theta[c] * e[:-1]
                z = g / max(sigma[c] * np.sqrt(1 + theta[c] ** 2), 1e-12)
                resid = _quantile_map(sres, norm.cdf(z))
                vals[c] = mean + resid
            if self.preserve_input_cdf:
                # rank-remap the sampled values through the input CDF,
                # with ranks weight-expanded by each cluster's day count
                wts = np.repeat(
                    [max(out["weights_days"][year][c + 1], 1)
                     for c in range(self.n_clusters)], H).astype(float)
                flat = vals.ravel()
                order = np.argsort(flat)
                cumw = np.cumsum(wts[order])
                u_sorted = (cumw - wts[order] / 2.0) / cumw[-1]
                u = np.empty_like(u_sorted)
                u[order] = u_sorted
                vals = _quantile_map(spri, u).reshape(vals.shape)
            out["LMP"][year] = {
                c + 1: {h + 1: float(vals[c, h]) for h in range(H)}
                for c in range(self.n_clusters)
            }
        return out


def generate_clustered_realizations(rom: RavenARMAROM, set_years: Sequence[int],
                                    n_scenarios: int = 1, n_days: int = 365,
                                    seed: int = 42):
    """Expand clustered samples to full-year hourly signals via the
    cluster map — the reference's ``syn_hist_generation.py:21-73``
    (day -> its cluster's representative 24-h profile)."""
    final = {}
    for s in range(1, n_scenarios + 1):
        hist = rom.generateSyntheticHistory("price", set_years, seed=seed + s)
        final[s] = {}
        for y in set_years:
            cmap = hist["cluster_map"][y]
            day_cluster = {d: c for c, days in cmap.items() for d in days}
            if n_days > len(day_cluster):
                raise ValueError(
                    f"n_days={n_days} exceeds the {len(day_cluster)} "
                    f"full days in year {y}'s training data"
                )
            lmp = []
            for d in range(n_days):
                lmp.extend(hist["LMP"][y][day_cluster[d]].values())
            final[s][y] = lmp
    return final[1] if n_scenarios == 1 else final


def generate_syn_realizations(model: ARMAModel, n_realizations: int,
                              n_steps: int, seed: int = 0,
                              signal_name: str = "LMP", device=None):
    """Sample realizations on ``device`` (``cuda`` unless given) into a
    list of dicts of host arrays (the reference returns a list of
    DataFrames, ``syn_hist_generation.py:21-73``)."""
    samples = model.sample(seed, n_steps, n_realizations, device=device).cpu().numpy()
    return [
        {"realization": i, signal_name: samples[i]}
        for i in range(n_realizations)
    ]
