"""Wind plant unit model + resource-to-capacity-factor precompute
(counterpart of ``dispatches_tpu/models/wind_power.py``).

Production is bounded by ``system_capacity * capacity_factor[t]``.  The
capacity factors are a host-side numpy precompute (they enter the NLP
as a param), copied from the JAX package; its module note records how
the SAM constants below were calibrated against the reference's PySAM
anchors.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from dispatches_tpu_torch.core.graph import Flowsheet, UnitModel

# ATB 2018 market-average turbine power curve, kW at integer wind speeds
# 0..27 m/s; rated 5000 kW, hub 110 m.
ATB2018_POWERCURVE_KW = np.array(
    [0, 0, 0, 40.5, 177.7, 403.9, 737.6, 1187.2, 1771.1, 2518.6, 3448.4,
     4562.5, 5000, 5000, 5000, 5000, 5000, 5000, 5000, 5000, 5000, 5000,
     5000, 5000, 5000, 5000, 0, 0],
    dtype=np.float64,
)
ATB2018_RATED_KW = 5000.0

SAM_TURBULENCE_INTENSITY = 0.07358
SAM_LOSS_FACTOR = 0.900701
SAM_WEIBULL_K = 100.0
SAM_WEIBULL_BIN_M_S = 0.25
SAM_WEIBULL_LOSS_FACTOR = 0.901455  # unit-anchor-exact for left-edge 0.25
SAM_PDF_LOSS_FACTOR = 0.834446


def atb2018_capacity_factors(wind_speeds_m_s: Sequence[float]) -> np.ndarray:
    """Ideal (loss-free) capacity factor per timestep from hub-height
    wind speeds: piecewise-linear interpolation of the ATB 2018 power
    curve over its 1 m/s grid, normalized by rated power."""
    speeds = np.asarray(wind_speeds_m_s, dtype=np.float64)
    grid = np.arange(len(ATB2018_POWERCURVE_KW), dtype=np.float64)
    power = np.interp(speeds, grid, ATB2018_POWERCURVE_KW, left=0.0, right=0.0)
    return power / ATB2018_RATED_KW


def sam_windpower_capacity_factors(
    wind_speeds_m_s: Sequence[float],
    turbulence_intensity: float = SAM_TURBULENCE_INTENSITY,
    loss_factor: float = SAM_LOSS_FACTOR,
    n_bins: int = 801,
) -> np.ndarray:
    """Capacity factors matching the reference's PySAM Windpower path:
    expectation of the ATB 2018 power curve under a Gaussian speed
    distribution (sigma = TI * mean speed), times a flat loss factor."""
    v = np.asarray(wind_speeds_m_s, dtype=np.float64)[:, None]
    u = np.linspace(0.0, 40.0, n_bins)[None, :]
    sigma = np.maximum(turbulence_intensity * v, 1e-6)
    w = np.exp(-0.5 * ((u - v) / sigma) ** 2)
    w = w / w.sum(axis=1, keepdims=True)
    grid = np.arange(len(ATB2018_POWERCURVE_KW), dtype=np.float64)
    P = np.interp(u.ravel(), grid, ATB2018_POWERCURVE_KW, left=0.0, right=0.0)
    cf = (w * P.reshape(u.shape)).sum(axis=1) / ATB2018_RATED_KW
    return cf * loss_factor


def sam_weibull_capacity_factors(
    wind_speeds_m_s: Sequence[float],
    weibull_k: float = SAM_WEIBULL_K,
    loss_factor: float = SAM_WEIBULL_LOSS_FACTOR,
    bin_m_s: float = SAM_WEIBULL_BIN_M_S,
) -> np.ndarray:
    """SSC-structural Weibull capacity factors: per timestep, scale
    ``lambda = v / Gamma(1 + 1/k)``, bin probability ``CDF(ws_i) -
    CDF(ws_{i-1})`` over the power curve resampled to a ``bin_m_s``
    grid, expected power from the bin's left-edge output, normalized by
    rated power, times a flat loss factor."""
    from scipy.special import gammaln

    v = np.asarray(wind_speeds_m_s, dtype=np.float64)[:, None]
    lam = np.maximum(v, 1e-9) / np.exp(gammaln(1.0 + 1.0 / weibull_k))
    ws = np.arange(0.0, 40.0 + bin_m_s / 2, bin_m_s)
    grid = np.arange(len(ATB2018_POWERCURVE_KW), dtype=np.float64)
    P = np.interp(ws, grid, ATB2018_POWERCURVE_KW, left=0.0, right=0.0)
    with np.errstate(over="ignore"):  # pow overflow -> CDF saturates at 1
        cdf = 1.0 - np.exp(-np.power(ws[None, :] / lam, weibull_k))
    bins = np.diff(cdf, axis=1)  # P(ws_{i-1} < V <= ws_i)
    mean_kw = bins @ P[:-1]  # left-edge power
    return mean_kw / ATB2018_RATED_KW * loss_factor


def sam_pdf_capacity_factors(
    wind_speeds_m_s: Sequence[float],
    loss_factor: float = SAM_PDF_LOSS_FACTOR,
) -> np.ndarray:
    """Capacity factors for the resource-probability-density path with a
    delta PDF per timestep: power-curve interpolation at the bin speed
    times the flat SAM-default loss multiplier."""
    return atb2018_capacity_factors(wind_speeds_m_s) * loss_factor


class WindPower(UnitModel):
    def __init__(
        self,
        fs: Flowsheet,
        name: str = "windpower",
        capacity_factors: Optional[Sequence[float]] = None,
        wind_speeds: Optional[Sequence[float]] = None,
    ):
        super().__init__(fs, name)

        if capacity_factors is None:
            if wind_speeds is None:
                raise ValueError("provide capacity_factors or wind_speeds")
            capacity_factors = atb2018_capacity_factors(wind_speeds)
        cfs = np.asarray(capacity_factors, dtype=np.float64)[: fs.horizon]
        if cfs.shape != (fs.horizon,):
            raise ValueError(
                f"capacity factors must cover the horizon ({fs.horizon})"
            )

        cap = self.add_var("system_capacity", shape=(), lb=0, ub=1e8, scale=1e3)
        cf = self.add_param("capacity_factor", cfs)
        elec = self.add_var("electricity", lb=0, scale=1e3)

        # curtailment allowed: production <= capacity * CF (an
        # inequality, not an equality)
        self.add_ineq(
            "elec_from_capacity_factor",
            lambda v, p: v[elec] - v[cap] * p[cf],
        )

        self.add_port("electricity_out", {"electricity": elec})
