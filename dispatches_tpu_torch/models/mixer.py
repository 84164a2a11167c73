"""Mixer unit: N inlet streams → one mixed outlet (counterpart of
``dispatches_tpu/models/mixer.py``): component material balance,
enthalpy balance over the shared property package, and outlet pressure
equal to the smooth minimum of the inlet pressures.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from dispatches_tpu_torch.core.graph import Flowsheet, UnitModel
from dispatches_tpu_torch.models.base import StateBundle
from dispatches_tpu_torch.properties.ideal_gas import IdealGasPackage


def smooth_min(a, b, eps: float = 1.0):
    """Smooth minimum: 0.5(a+b − sqrt((a−b)² + eps²))."""
    return 0.5 * (a + b - torch.sqrt((a - b) ** 2 + eps**2))


class Mixer(UnitModel):
    def __init__(
        self,
        fs: Flowsheet,
        name: str = "mixer",
        props: IdealGasPackage = None,
        inlet_list: List[str] = None,
    ):
        super().__init__(fs, name)
        self.props = props
        self.inlet_list = list(inlet_list or ["inlet_1", "inlet_2"])

        self.inlet_states: Dict[str, StateBundle] = {
            nm: StateBundle(self, nm, props) for nm in self.inlet_list
        }
        self.mixed_state = StateBundle(self, "mixed", props)

        feeds = list(self.inlet_states.values())
        mixed = self.mixed_state

        if props.n_comp > 1:
            self.add_eq(
                "material_mixing",
                lambda v, p: v[mixed.flow_mol_comp]
                - sum(v[f.flow_mol_comp] for f in feeds),
            )
        else:
            self.add_eq(
                "material_mixing",
                lambda v, p: v[mixed.flow_mol]
                - sum(v[f.flow_mol] for f in feeds),
            )

        # enthalpy mixing: sum F_i h(T_i, y_i) = F h(T_mix, y_mix)
        self.add_eq(
            "enthalpy_mixing",
            lambda v, p: mixed.total_enthalpy(v)
            - sum(f.total_enthalpy(v) for f in feeds),
            scale=1e-4,
        )

        # momentum: P_mix = smooth-min of inlet pressures (not
        # over-constrained when every inlet pressure is fixed)
        def min_pressure(v):
            pm = v[feeds[0].pressure]
            for f in feeds[1:]:
                pm = smooth_min(pm, v[f.pressure])
            return pm

        self.add_eq(
            "minimum_pressure",
            lambda v, p: v[mixed.pressure] - min_pressure(v),
            scale=1e-5,
        )

    def fix_feed_composition(self, feed: str, mole_fracs: Dict[str, float]):
        """Tie a feed's component flows to a fixed composition."""
        sb = self.inlet_states[feed]
        y = np.array([mole_fracs[c] for c in self.props.components])
        yp = self.add_param(f"{feed}_mole_fracs", y)
        self.add_eq(
            f"{feed}_composition",
            lambda v, p: v[sb.flow_mol_comp]
            - p[yp] * v[sb.flow_mol][..., None],
        )

    def inlet_port(self, feed: str):
        return self.inlet_states[feed].port

    @property
    def outlet(self):
        return self.mixed_state.port
