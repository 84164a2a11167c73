"""Molten-salt and thermal-oil liquid property packages (counterpart of
``dispatches_tpu/properties/salts.py``) on torch tensors.

Counterparts of the reference's hand-written StateBlocks
``dispatches/properties/solarsalt_properties.py`` (:294-336),
``hitecsalt_properties.py`` and ``thermaloil_properties.py`` — polynomial
correlations in temperature for cp, density, viscosity, conductivity and
specific enthalpy, used by the fossil-case storage heat exchangers.

Each package is closed-form and differentiable; "initialization" of the
reference's state blocks has no equivalent because there is nothing to
initialize.  Correlation forms (including the reference's enthalpy
integration conventions) are reproduced exactly so the FE-case physics
regressions carry over; each function notes its reference anchor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch


@dataclass(frozen=True)
class LiquidPackage:
    """A single-component liquid with polynomial T-correlations.

    All properties are mass-based (the reference's state vars are
    ``flow_mass``/``temperature``/``pressure``).
    """

    name: str
    cp_mass: Callable  # J/kg/K
    dens_mass: Callable  # kg/m^3
    enth_mass: Callable  # J/kg
    visc_d: Callable  # Pa s (dynamic)
    therm_cond: Callable  # W/m/K
    ref_temperature: float = 273.15
    temperature_bounds: tuple = (273.15, 550.0, 1000.0)


def _t(T):
    """Tensors pass through; numbers and numpy arrays become float64 CPU
    tensors."""
    if isinstance(T, torch.Tensor):
        return T
    return torch.as_tensor(np.asarray(T, dtype=np.float64))


# ---------------------------------------------------------------------------
# Solar Salt: 60% NaNO3 / 40% KNO3 (reference solarsalt_properties.py:92-145,
# correlations :294-336; Tref = 273.15 K)
# ---------------------------------------------------------------------------

_SS_TREF = 273.15


def _ss_cp(T):
    dT = _t(T) - _SS_TREF
    return 1443.0 + 0.172 * dT


def _ss_rho(T):
    dT = _t(T) - _SS_TREF
    return 2090.0 - 0.636 * dT


def _ss_enth(T):
    # exact integral of cp from Tref (reference :312-317)
    dT = _t(T) - _SS_TREF
    return 1443.0 * dT + 0.172 * 0.5 * dT**2


def _ss_mu(T):
    dT = _t(T) - _SS_TREF
    return 2.2714e-2 - 1.2e-4 * dT + 2.281e-7 * dT**2 - 1.474e-10 * dT**3


def _ss_kappa(T):
    dT = _t(T) - _SS_TREF
    return 0.443 + 1.9e-4 * dT


SolarSalt = LiquidPackage(
    name="solar_salt",
    cp_mass=_ss_cp,
    dens_mass=_ss_rho,
    enth_mass=_ss_enth,
    visc_d=_ss_mu,
    therm_cond=_ss_kappa,
    ref_temperature=_SS_TREF,
    temperature_bounds=(513.15, 550.0, 853.15),
)


# ---------------------------------------------------------------------------
# Hitec Salt: NaNO3/KNO3/NaNO2 ternary (reference hitecsalt_properties.py:
# 97-136, correlations :296-331).  NOTE the reference's enthalpy is
# cp1·T + cp2·T² + cp3·T³ in absolute T — NOT the cp integral; reproduced
# as-is for parity with the FE storage regressions.
# ---------------------------------------------------------------------------


def _hs_cp(T):
    T = _t(T)
    return 5806.0 - 10.833 * T + 7.2413e-3 * T**2


def _hs_rho(T):
    return 2293.6 - 0.7497 * _t(T)


def _hs_enth(T):
    T = _t(T)
    return 5806.0 * T - 10.833 * T**2 + 7.2413e-3 * T**3


def _hs_mu(T):
    # log-form: exp(mu1 + mu2*(ln(T) + mu3))  (reference :323-331)
    T = _t(T)
    return torch.exp(-4.343 - 2.0143 * (torch.log(T) - 5.011))


def _hs_kappa(T):
    # reference kappa: 0.421 - 6.53e-4 * (T - 260)
    T = _t(T)
    return 0.421 - 6.53e-4 * (T - 260.0)


HitecSalt = LiquidPackage(
    name="hitec_salt",
    cp_mass=_hs_cp,
    dens_mass=_hs_rho,
    enth_mass=_hs_enth,
    visc_d=_hs_mu,
    therm_cond=_hs_kappa,
    ref_temperature=273.15,
    temperature_bounds=(435.15, 550.0, 788.15),
)


# ---------------------------------------------------------------------------
# Therminol-66 thermal oil (reference thermaloil_properties.py:94-136,
# correlations :317-345; Tref = 273.15 K)
# ---------------------------------------------------------------------------

_TO_TREF = 273.15


def _to_cp(T):
    dT = _t(T) - _TO_TREF
    return 1496.005 + 3.313 * dT + 0.0008970785 * dT**2


def _to_rho(T):
    dT = _t(T) - _TO_TREF
    return 1026.7 - 0.7281 * dT


def _to_enth(T):
    dT = _t(T) - _TO_TREF
    return 1496.005 * dT + 3.313 * 0.5 * dT**2 + 0.0008970785 / 3.0 * dT**3


def _to_nu(T):
    # kinematic viscosity, exponential correlation (reference :332-345):
    # nu = 1e-6 * exp(586.375 / (dT + 62.5) - 2.2809)  [m^2/s]
    dT = _t(T) - _TO_TREF
    return 1e-6 * torch.exp(586.375 / (dT + 62.5) - 2.2809)


def _to_mu(T):
    return _to_nu(T) * _to_rho(T)


def _to_kappa(T):
    dT = _t(T) - _TO_TREF
    return 0.118294 - 3.3e-5 * dT - 1.5e-7 * dT**2


ThermalOil = LiquidPackage(
    name="thermal_oil",
    cp_mass=_to_cp,
    dens_mass=_to_rho,
    enth_mass=_to_enth,
    visc_d=_to_mu,
    therm_cond=_to_kappa,
    ref_temperature=_TO_TREF,
    temperature_bounds=(273.15, 523.0, 616.0),
)
