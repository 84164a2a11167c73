"""IAPWS water/steam transport properties on torch tensors (counterpart
of ``dispatches_tpu/properties/iapws_transport.py``).

Dynamic viscosity from the IAPWS 2008 formulation (Release on the IAPWS
Formulation 2008 for the Viscosity of Ordinary Water Substance) and
thermal conductivity from the IAPWS 2011 formulation (Release on the
IAPWS Formulation 2011 for the Thermal Conductivity of Ordinary Water
Substance), both without the critical-enhancement term (exactly the
"industrial use" simplification; flowsheet states sit far from the
critical point).

The reference consumes these through the IDAES helmholtz package's
``visc_d_phase`` / ``therm_cond_phase`` (e.g. the storage heat-exchanger
film-coefficient correlations,
``integrated_storage_with_ultrasupercritical_power_plant.py:205-400``).
Both formulations are closed-form in (rho, T) and therefore batch and
differentiate like the EoS itself.

Verified against the releases' published check tables in
``tests/test_iapws95.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from dispatches_tpu_torch.properties.iapws95 import RHOC, TC, _as_tensor

# ----------------------------------------------------------------------
# Viscosity (IAPWS 2008).  Reference temperature/density are the
# critical point; reference viscosity 1e-6 Pa s.
# ----------------------------------------------------------------------

_VH0 = np.array([1.67752, 2.20462, 0.6366564, -0.241605])

# H1[i, j] multiplying (1/Tbar - 1)^i (rhobar - 1)^j
_VH1 = np.zeros((6, 7))
_VH1[0, 0] = 5.20094e-1
_VH1[1, 0] = 8.50895e-2
_VH1[2, 0] = -1.08374
_VH1[3, 0] = -2.89555e-1
_VH1[0, 1] = 2.22531e-1
_VH1[1, 1] = 9.99115e-1
_VH1[2, 1] = 1.88797
_VH1[3, 1] = 1.26613
_VH1[5, 1] = 1.20573e-1
_VH1[0, 2] = -2.81378e-1
_VH1[1, 2] = -9.06851e-1
_VH1[2, 2] = -7.72479e-1
_VH1[3, 2] = -4.89837e-1
_VH1[4, 2] = -2.57040e-1
_VH1[0, 3] = 1.61913e-1
_VH1[1, 3] = 2.57399e-1
_VH1[0, 4] = -3.25372e-2
_VH1[3, 4] = 6.98452e-2
_VH1[4, 5] = 8.72102e-3
_VH1[3, 6] = -4.35673e-3
_VH1[5, 6] = -5.93264e-4


def visc_d(rho, T):
    """Dynamic viscosity [Pa s] at (rho [kg/m^3], T [K])."""
    rho = _as_tensor(rho)
    T = _as_tensor(T)
    Tbar = T / TC
    rbar = rho / RHOC

    # mu0: dilute-gas limit
    s0 = sum(_VH0[i] / Tbar ** i for i in range(4))
    mu0 = 100.0 * torch.sqrt(Tbar) / s0

    # mu1: finite-density contribution
    x = 1.0 / Tbar - 1.0
    y = rbar - 1.0
    acc = 0.0
    for i in range(6):
        inner = 0.0
        for j in range(7):
            if _VH1[i, j] != 0.0:
                inner = inner + _VH1[i, j] * y ** j
        acc = acc + x ** i * inner
    mu1 = torch.exp(rbar * acc)
    return mu0 * mu1 * 1e-6


# ----------------------------------------------------------------------
# Thermal conductivity (IAPWS 2011), no critical enhancement.
# Reference conductivity 1e-3 W/m/K.
# ----------------------------------------------------------------------

_KL0 = np.array([2.443221e-3, 1.323095e-2, 6.770357e-3,
                 -3.454586e-3, 4.096266e-4])

_KL1 = np.array([
    [1.60397357, -0.646013523, 0.111443906, 0.102997357,
     -0.0504123634, 0.00609859258],
    [2.33771842, -2.78843778, 1.53616167, -0.463045512,
     0.0832827019, -0.00719201245],
    [2.19650529, -4.54580785, 3.55777244, -1.40944978,
     0.275418278, -0.0205938816],
    [-1.21051378, 1.60812989, -0.621178141, 0.0716373224, 0.0, 0.0],
    [-2.7203370, 4.57586331, -3.18369245, 1.1168348,
     -0.19268305, 0.012913842],
])


def therm_cond(rho, T):
    """Thermal conductivity [W/m/K] at (rho [kg/m^3], T [K])."""
    rho = _as_tensor(rho)
    T = _as_tensor(T)
    Tbar = T / TC
    rbar = rho / RHOC

    s0 = sum(_KL0[k] / Tbar ** k for k in range(5))
    k0 = torch.sqrt(Tbar) / s0

    x = 1.0 / Tbar - 1.0
    y = rbar - 1.0
    acc = 0.0
    for i in range(5):
        inner = 0.0
        for j in range(6):
            if _KL1[i, j] != 0.0:
                inner = inner + _KL1[i, j] * y ** j
        acc = acc + x ** i * inner
    k1 = torch.exp(rbar * acc)
    return k0 * k1 * 1e-3
