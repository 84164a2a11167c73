"""Differentiable property packages of the port (counterpart of
``dispatches_tpu.properties``): closed-form pure functions over torch
tensors, vectorized over the time axis and differentiable by
``torch.func``: the ideal-gas packages, the hydrogen-combustion
reaction, IAPWS-95 water/steam (``iapws95``, with host-side flashes for
initialization) and its transport properties, and the molten-salt and
thermal-oil liquids (``salts``).
"""

from dispatches_tpu_torch.properties import iapws95, iapws_transport
from dispatches_tpu_torch.properties.h2_reaction import H2CombustionReaction
from dispatches_tpu_torch.properties.ideal_gas import (
    R_GAS,
    IdealGasPackage,
    h2_ideal_vap,
    hturbine_ideal_vap,
)
from dispatches_tpu_torch.properties.salts import (
    HitecSalt,
    LiquidPackage,
    SolarSalt,
    ThermalOil,
)

__all__ = [
    "R_GAS",
    "IdealGasPackage",
    "h2_ideal_vap",
    "hturbine_ideal_vap",
    "H2CombustionReaction",
    "HitecSalt",
    "LiquidPackage",
    "SolarSalt",
    "ThermalOil",
    "iapws95",
    "iapws_transport",
]
