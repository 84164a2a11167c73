"""PEM electrolyzer unit model (counterpart of
``dispatches_tpu/models/pem_electrolyzer.py``): a 0-D efficiency-curve
electrolyzer whose H2 outlet is a material stream,
``outlet.flow_mol[t] == electricity[t] * electricity_to_mol``.  The
renewables flowsheets use 0.002527406 mol/s per kW.
"""

from __future__ import annotations

from dispatches_tpu_torch.core.graph import Flowsheet, UnitModel
from dispatches_tpu_torch.models.base import StateBundle
from dispatches_tpu_torch.properties.ideal_gas import IdealGasPackage, h2_ideal_vap

#: mol H2 per second per kW at 54.953 kWh/kg
PEM_ELECTRICITY_TO_MOL = 0.002527406


class PEMElectrolyzer(UnitModel):
    def __init__(
        self,
        fs: Flowsheet,
        name: str = "pem",
        props: IdealGasPackage = h2_ideal_vap,
        electricity_to_mol: float = PEM_ELECTRICITY_TO_MOL,
    ):
        super().__init__(fs, name)

        elec = self.add_var("electricity", lb=0, scale=1e3)
        self.add_port("electricity_in", {"electricity": elec})

        e2m = self.add_param("electricity_to_mol", electricity_to_mol)

        self.outlet_state = StateBundle(self, "outlet", props)

        # efficiency curve
        self.add_eq(
            "efficiency_curve",
            lambda v, p: v[self.outlet_state.flow_mol] - v[elec] * p[e2m],
        )

    @property
    def outlet(self):
        return self.outlet_state.port
