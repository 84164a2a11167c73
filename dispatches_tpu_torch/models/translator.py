"""Translator unit: maps a stream between two property packages
(counterpart of ``dispatches_tpu/models/translator.py``).  Total flow,
temperature and pressure pass through unchanged, and the outlet
composition may be fixed (0.99 H2 + 0.0025 of each other component in
the renewables flowsheet).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from dispatches_tpu_torch.core.graph import Flowsheet, UnitModel
from dispatches_tpu_torch.models.base import StateBundle
from dispatches_tpu_torch.properties.ideal_gas import IdealGasPackage


class Translator(UnitModel):
    def __init__(
        self,
        fs: Flowsheet,
        name: str = "translator",
        inlet_props: IdealGasPackage = None,
        outlet_props: IdealGasPackage = None,
        outlet_mole_fracs: Optional[Dict[str, float]] = None,
    ):
        super().__init__(fs, name)
        self.inlet_state = StateBundle(self, "inlet", inlet_props)
        self.outlet_state = StateBundle(self, "outlet", outlet_props)

        # pass-through equalities
        self.add_eq(
            "eq_flow",
            lambda v, p: v[self.outlet_state.flow_mol]
            - v[self.inlet_state.flow_mol],
        )
        self.add_eq(
            "eq_temperature",
            lambda v, p: v[self.outlet_state.temperature]
            - v[self.inlet_state.temperature],
        )
        self.add_eq(
            "eq_pressure",
            lambda v, p: v[self.outlet_state.pressure]
            - v[self.inlet_state.pressure],
            scale=1e-5,
        )

        if outlet_mole_fracs is not None and self.outlet_state.flow_mol_comp:
            y = np.array(
                [outlet_mole_fracs[c] for c in outlet_props.components]
            )
            yp = self.add_param("outlet_mole_fracs", y)
            # fixed outlet composition
            self.add_eq(
                "outlet_composition",
                lambda v, p: v[self.outlet_state.flow_mol_comp]
                - p[yp] * v[self.outlet_state.flow_mol][..., None],
            )

    @property
    def inlet(self):
        return self.inlet_state.port

    @property
    def outlet(self):
        return self.outlet_state.port
