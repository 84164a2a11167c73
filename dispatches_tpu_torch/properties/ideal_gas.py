"""Ideal-gas property packages built on NIST Shomate correlations
(counterpart of ``dispatches_tpu/properties/ideal_gas.py``).

Closed-form pure functions of ``(T, P, y)`` over torch tensors that
vectorize over the leading time axis and are differentiable by
``torch.func``; units call them inside their residuals.

Data source: NIST Chemistry WebBook Shomate coefficients.  Reference
state: T_ref = 298.15 K, P_ref = 101325 Pa.

Shomate forms (t = T/1000):
    cp°(T)            = A + B t + C t² + D t³ + E/t²           [J/mol/K]
    h°(T) − h°(298)   = 1000·(A t + B t²/2 + C t³/3 + D t⁴/4 − E/t + F − H)
    s°(T)             = A ln t + B t + C t²/2 + D t³/3 − E/(2 t²) + G
Ideal mixture with mole fractions y at pressure P:
    h = Σ y_i h_i ;  s = Σ y_i s°_i − R Σ y_i ln y_i − R ln(P/P_ref)

The coefficient tables are numpy on the package; their tensors are built
once per (device, dtype) and cached, so a residual evaluated on the card
never copies them from the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

R_GAS = 8.31446261815324  # J/mol/K


def _as_tensor(x) -> torch.Tensor:
    """Tensors pass through; numbers and numpy arrays become float64
    tensors on the CPU (host-side callers such as unit initializers)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _enth_poly(cols, t):
    """A t + B t²/2 + C t³/3 + D t⁴/4 − E/t from the Shomate columns
    (a (C, 8) numpy table or a tuple of column tensors)."""
    A, B, C, D, E = (cols[:, i] for i in range(5)) if isinstance(cols, np.ndarray) else cols[:5]
    return A * t + B * t**2 / 2 + C * t**3 / 3 + D * t**4 / 4 - E / t


@dataclass(frozen=True)
class IdealGasPackage:
    """A fixed-composition-space ideal-gas mixture package."""

    name: str
    components: Tuple[str, ...]
    mw: np.ndarray  # kg/mol, shape (C,)
    shomate: np.ndarray  # shape (C, 8): A B C D E F G H
    pressure_ref: float = 101325.0
    temperature_ref: float = 298.15
    # FTPx-style state bounds (flow mol/s, temperature K, pressure Pa):
    # (lb, init, ub) triples
    flow_bounds: Tuple[float, float, float] = (0.0, 100.0, 100000.0)
    temperature_bounds: Tuple[float, float, float] = (273.15, 300.0, 1000.0)
    pressure_bounds: Tuple[float, float, float] = (5e4, 1e5, 1e6)
    _cache: Dict = field(default_factory=dict, init=False, repr=False, compare=False)

    @property
    def n_comp(self) -> int:
        return len(self.components)

    def index(self, comp: str) -> int:
        return self.components.index(comp)

    def _consts(self, like: torch.Tensor):
        """(Shomate columns A..H, mw, h°(T_ref) per component) as tensors on
        ``like``'s device and dtype, built at the first call for that
        pair.  h°(T_ref) is the polynomial at t_ref = T_ref/1000 evaluated
        in numpy float64, as the JAX package evaluates it."""
        key = (like.device, like.dtype)
        hit = self._cache.get(key)
        if hit is None:
            def t(a):
                return torch.as_tensor(a, dtype=like.dtype, device=like.device)

            cols = tuple(t(np.ascontiguousarray(self.shomate[:, i])) for i in range(8))
            hit = (cols, t(self.mw), t(_enth_poly(self.shomate, self.temperature_ref / 1000.0)))
            self._cache[key] = hit
        return hit

    # ---- pure-component correlations (vectorized over T) -------------

    def cp_mol_comp(self, T):
        """cp° per component, J/mol/K.  Shape (..., C)."""
        T = _as_tensor(T)
        t = T[..., None] / 1000.0
        A, B, C, D, E = self._consts(T)[0][:5]
        return A + B * t + C * t**2 + D * t**3 + E / t**2

    def enth_mol_comp(self, T):
        """Sensible enthalpy h°(T) − h°(T_ref) per component, J/mol.
        Shape (..., C).

        The Shomate polynomial differenced at T_ref, which cancels the F/H
        integration constants exactly: every component's enthalpy is zero
        at 298.15 K, and reaction heat enters the energy balances only
        through the reaction package's dh_rxn."""
        T = _as_tensor(T)
        cols, _, h_ref = self._consts(T)
        return 1000.0 * (_enth_poly(cols, T[..., None] / 1000.0) - h_ref)

    def entr_mol_comp(self, T):
        """s°(T) per component at P_ref, J/mol/K.  Shape (..., C)."""
        T = _as_tensor(T)
        t = T[..., None] / 1000.0
        A, B, C, D, E, _F, G, _H = self._consts(T)[0]
        return A * torch.log(t) + B * t + C * t**2 / 2 + D * t**3 / 3 - E / (2 * t**2) + G

    # ---- mixture properties ------------------------------------------

    def _yfrac(self, y):
        if y is None:
            if self.n_comp != 1:
                raise ValueError(f"{self.name}: mole fractions required")
            return None
        return _as_tensor(y)

    def cp_mol(self, T, y=None):
        cps = self.cp_mol_comp(T)
        y = self._yfrac(y)
        return cps[..., 0] if y is None else torch.sum(y * cps, dim=-1)

    def enth_mol(self, T, y=None):
        hs = self.enth_mol_comp(T)
        y = self._yfrac(y)
        return hs[..., 0] if y is None else torch.sum(y * hs, dim=-1)

    def entr_mol(self, T, P, y=None):
        ss = self.entr_mol_comp(T)
        P = _as_tensor(P)
        press = -R_GAS * torch.log(P / self.pressure_ref)
        y = self._yfrac(y)
        if y is None:
            return ss[..., 0] + press
        # smooth xlogy: y log y -> 0 as y -> 0 (combustion can consume a
        # component entirely; keep the gradient finite there)
        eps = 1e-30
        mixing = -R_GAS * torch.sum(y * torch.log(torch.clamp(y, min=eps)), dim=-1)
        return torch.sum(y * ss, dim=-1) + mixing + press

    def mw_mix(self, y=None):
        y = self._yfrac(y)
        if y is None:
            return self.mw[0]
        return torch.sum(y * self._consts(y)[1], dim=-1)

    def dens_mol(self, T, P):
        """Ideal-gas molar density, mol/m^3."""
        return _as_tensor(P) / (R_GAS * _as_tensor(T))


# ---------------------------------------------------------------------------
# Package instances (NIST WebBook data)
# ---------------------------------------------------------------------------

# Shomate rows: A, B, C, D, E, F, G, H
_SHOMATE: Dict[str, list] = {
    # H2, valid 298-1000 K
    "hydrogen": [33.066178, -11.363417, 11.432816, -2.772874, -0.158558,
                 -9.980797, 172.707974, 0.0],
    # N2, 100-500 K range fit
    "nitrogen": [19.50583, 19.88705, -8.598535, 1.369784, 0.527601,
                 -4.935202, 212.39000, 0.0],
    # O2, 100-700 K
    "oxygen": [31.32234, -20.23531, 57.86644, -36.50624, -0.007374,
               -8.903471, 246.7945, 0.0],
    # H2O vapor, 500-1700 K
    "water": [30.092, 6.832514, 6.793435, -2.53448, 0.082139,
              -250.881, 223.3967, 0.0],
    # Ar (monoatomic, cp = 20.786)
    "argon": [20.786, 0.000000282, -0.000000146, 0.00000001092, -0.0000000366,
              -6.19735, 179.999, 0.0],
}

_MW: Dict[str, float] = {
    "hydrogen": 2.016e-3,
    "nitrogen": 28.0134e-3,
    "oxygen": 31.9988e-3,
    "water": 18.0153e-3,
    "argon": 39.948e-3,
}


def _mk(name: str, comps: Tuple[str, ...], **kw) -> IdealGasPackage:
    return IdealGasPackage(
        name=name,
        components=comps,
        mw=np.array([_MW[c] for c in comps]),
        shomate=np.array([_SHOMATE[c] for c in comps]),
        **kw,
    )


#: Pure H2 vapor
h2_ideal_vap = _mk("h2_ideal_vap", ("hydrogen",))

#: 5-component H2-combustion mixture (state bounds: flow 0-10000 mol/s,
#: T 273.15-2000 K, P 5e4-1e8 Pa)
hturbine_ideal_vap = _mk(
    "hturbine_ideal_vap",
    ("hydrogen", "nitrogen", "oxygen", "water", "argon"),
    flow_bounds=(0.0, 100.0, 10000.0),
    temperature_bounds=(273.15, 300.0, 2000.0),
    pressure_bounds=(5e4, 1e5, 1e8),
)
