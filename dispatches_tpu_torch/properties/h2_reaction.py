"""Hydrogen-combustion reaction package (counterpart of
``dispatches_tpu/properties/h2_reaction.py``).

Plain data plus pure functions mapping inlet component flows and a
conversion to outlet component flows and reaction heat, consumed by the
HydrogenTurbine's stoichiometric-reactor stage.

Reaction R1:  2 H2 + O2 -> 2 H2O   (vapor phase; dh_rxn is per molar
extent of THIS stoichiometry, i.e. -241.83 kJ per mol H2 burned)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from dispatches_tpu_torch.properties.ideal_gas import (
    IdealGasPackage,
    _as_tensor,
    hturbine_ideal_vap,
)


@dataclass(frozen=True)
class H2CombustionReaction:
    """Single-reaction stoichiometric package over an IdealGasPackage."""

    props: IdealGasPackage = hturbine_ideal_vap
    #: J per mol extent of R1 (2 H2 consumed)
    dh_rxn: float = -4.8366e5
    key_component: str = "hydrogen"
    stoichiometry: Dict[str, float] = field(
        default_factory=lambda: {
            "hydrogen": -2.0,
            "oxygen": -1.0,
            "water": 2.0,
            "nitrogen": 0.0,
            "argon": 0.0,
        }
    )
    _cache: Dict = field(default_factory=dict, init=False, repr=False, compare=False)

    def nu(self) -> np.ndarray:
        """Stoichiometric coefficients aligned with props.components."""
        return np.array([self.stoichiometry[c] for c in self.props.components])

    def _nu_on(self, like: torch.Tensor) -> torch.Tensor:
        """``nu()`` as a tensor on ``like``'s device and dtype, cached."""
        key = (like.device, like.dtype)
        hit = self._cache.get(key)
        if hit is None:
            hit = torch.as_tensor(self.nu(), dtype=like.dtype, device=like.device)
            self._cache[key] = hit
        return hit

    def extent(self, flow_comp_in, conversion):
        """Molar extent from fractional conversion of the key component:
        conv·F_key = -nu_key·xi."""
        k = self.props.index(self.key_component)
        return conversion * flow_comp_in[..., k] / (-self.stoichiometry[self.key_component])

    def outlet_flows(self, flow_comp_in, conversion):
        """Outlet component molar flows after reaction."""
        flow_comp_in = _as_tensor(flow_comp_in)
        xi = self.extent(flow_comp_in, _as_tensor(conversion))
        return flow_comp_in + xi[..., None] * self._nu_on(flow_comp_in)

    def heat_of_reaction(self, flow_comp_in, conversion):
        """Total heat released (J/s, positive = exothermic release); enters
        the reactor energy balance as ``H_out − H_in = −dh_rxn·extent``."""
        return -self.dh_rxn * self.extent(_as_tensor(flow_comp_in), _as_tensor(conversion))
