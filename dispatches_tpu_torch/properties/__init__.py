"""Differentiable property packages of the port (counterpart of
``dispatches_tpu.properties``): closed-form pure functions over torch
tensors, vectorized over the time axis and differentiable by
``torch.func``.  The ideal-gas packages and the hydrogen-combustion
reaction are ported; ``salts.py`` (and the IAPWS packages) wait for the
fossil slice.
"""

from dispatches_tpu_torch.properties.h2_reaction import H2CombustionReaction
from dispatches_tpu_torch.properties.ideal_gas import (
    R_GAS,
    IdealGasPackage,
    h2_ideal_vap,
    hturbine_ideal_vap,
)

__all__ = [
    "R_GAS",
    "IdealGasPackage",
    "h2_ideal_vap",
    "hturbine_ideal_vap",
    "H2CombustionReaction",
]
