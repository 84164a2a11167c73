"""Simplified hydrogen tank unit model, linear with no energy balance
(counterpart of ``dispatches_tpu/models/hydrogen_tank_simplified.py``):
three material states (inlet, outlet to pipeline, outlet to turbine),
temperature and pressure ties between them, and a molar holdup balance
``holdup − holdup_prev == dt·(in − out_pipeline − out_turbine)`` with
dt = 3600 s per hour of the flowsheet's period.  The initial holdup is a
scalar var chained over the horizon with ``tshift``.
"""

from __future__ import annotations

from dispatches_tpu_torch.core.graph import Flowsheet, UnitModel, tshift
from dispatches_tpu_torch.models.base import StateBundle
from dispatches_tpu_torch.properties.ideal_gas import IdealGasPackage, h2_ideal_vap


class SimpleHydrogenTank(UnitModel):
    def __init__(
        self,
        fs: Flowsheet,
        name: str = "h2_tank",
        props: IdealGasPackage = h2_ideal_vap,
    ):
        super().__init__(fs, name)
        dt_s = fs.dt_hr * 3600.0

        self.inlet_state = StateBundle(self, "inlet", props)
        self.pipeline_state = StateBundle(self, "outlet_to_pipeline", props)
        self.turbine_state = StateBundle(self, "outlet_to_turbine", props)

        # T/P ties
        for other, tag in (
            (self.turbine_state, "1"),
            (self.pipeline_state, "2"),
        ):
            self.add_eq(
                f"eq_temperature_{tag}",
                lambda v, p, a=self.inlet_state, b=other: (
                    v[a.temperature] - v[b.temperature]
                ),
            )
            self.add_eq(
                f"eq_pressure_{tag}",
                lambda v, p, a=self.inlet_state, b=other: (
                    v[a.pressure] - v[b.pressure]
                ),
            )

        holdup0 = self.add_var("tank_holdup_previous", shape=(), lb=0)
        holdup = self.add_var("tank_holdup", lb=0)

        # material balance
        self.add_eq(
            "tank_material_balance",
            lambda v, p: v[holdup]
            - tshift(v[holdup], v[holdup0])
            - dt_s
            * (
                v[self.inlet_state.flow_mol]
                - v[self.pipeline_state.flow_mol]
                - v[self.turbine_state.flow_mol]
            ),
        )

    @property
    def inlet(self):
        return self.inlet_state.port

    @property
    def outlet_to_pipeline(self):
        return self.pipeline_state.port

    @property
    def outlet_to_turbine(self):
        return self.turbine_state.port

    def report_columns(self, solution):
        """Holdup state column alongside the three stream ports."""
        return {
            "mol": {
                "tank_holdup_previous": self.v("tank_holdup_previous"),
                "tank_holdup": self.v("tank_holdup"),
            }
        }
