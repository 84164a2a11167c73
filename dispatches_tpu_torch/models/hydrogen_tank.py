"""Detailed compressed-gas hydrogen tank with material and energy holdup
(counterpart of ``dispatches_tpu/models/hydrogen_tank.py``): cylindrical
geometry ``V = π·L·(D/2)²``, an ideal-gas holdup, and the internal-energy
balance ``n·u = n0·u0 + dt·(H_in − H_out + Q)``, adiabatic by default.

The tank state (T, P) is a pair of time-indexed vars with scalar initial
conditions chained by ``tshift``, and ideal-gas relations close it:

    n[t] = P[t]·V / (R·T[t])          (holdup from state)
    u(T) = h(T) − R·(T − T_ref)        (ideal-gas internal energy)

so a 1 mol/s fill of a 0.1 m × 0.3 m tank for one hour ends at
300.749 K.
"""

from __future__ import annotations

import math

from dispatches_tpu_torch.core.graph import Flowsheet, UnitModel, tshift
from dispatches_tpu_torch.models.base import StateBundle
from dispatches_tpu_torch.properties.ideal_gas import R_GAS, IdealGasPackage, h2_ideal_vap


class HydrogenTank(UnitModel):
    def __init__(
        self,
        fs: Flowsheet,
        name: str = "h2_tank",
        props: IdealGasPackage = h2_ideal_vap,
    ):
        super().__init__(fs, name)
        dt_s = fs.dt_hr * 3600.0
        self.props = props

        self.inlet_state = StateBundle(self, "inlet", props)
        self.outlet_state = StateBundle(self, "outlet", props)

        # geometry; fix both for simulation
        D = self.add_var("tank_diameter", shape=(), lb=0.1, ub=10.0, init=0.1)
        L = self.add_var("tank_length", shape=(), lb=0.1, ub=10.0, init=0.3)

        # tank internal state + initial conditions
        tlo, ti, thi = props.temperature_bounds
        plo, pi, phi = props.pressure_bounds
        # compressed storage reaches far beyond pipeline state bounds (a
        # one-hour fill reaches 3.8e9 Pa)
        p_hi = max(phi, 1e10)
        Tt = self.add_var("temperature", lb=tlo, ub=thi, init=ti, scale=100.0)
        Pt = self.add_var("pressure", lb=plo, ub=p_hi, init=pi, scale=1e8)
        T0 = self.add_var("previous_temperature", shape=(), lb=tlo, ub=thi,
                          init=ti, scale=100.0)
        P0 = self.add_var("previous_pressure", shape=(), lb=plo, ub=p_hi,
                          init=pi, scale=1e8)
        fs.set_bounds(self.outlet_state.pressure, ub=p_hi)
        fs.set_bounds(self.inlet_state.pressure, ub=p_hi)
        fs.set_scale(self.outlet_state.pressure, 1e8)
        fs.set_scale(self.inlet_state.pressure, 1e6)

        n = self.add_var("material_holdup", lb=0, init=100.0, scale=1e3)
        E = self.add_var("energy_holdup", lb=-1e12, ub=1e12, init=0.0, scale=1e5)

        # external heat duty, default adiabatic
        Q = self.add_var("heat_duty", init=0.0)
        fs.fix(Q, 0.0)

        def volume(v):
            return math.pi * v[L] * (v[D] / 2.0) ** 2

        # holdup from tank state, ideal gas
        self.add_eq(
            "material_holdup_calculation",
            lambda v, p: v[n] * R_GAS * v[Tt] - v[Pt] * volume(v),
            scale=1e-3,
        )

        Tref = props.temperature_ref

        def u_mol(v, T_name):
            return props.enth_mol(v[T_name]) - R_GAS * (v[T_name] - Tref)

        # energy holdup definition E = n*u
        self.add_eq(
            "energy_holdup_calculation",
            lambda v, p: v[E] - v[n] * u_mol(v, Tt),
            scale=1e-5,
        )

        def prev_n(v):
            return v[P0] * volume(v) / (R_GAS * v[T0])

        # material balance
        self.add_eq(
            "material_balances",
            lambda v, p: v[n]
            - tshift(v[n], prev_n(v))
            - dt_s
            * (v[self.inlet_state.flow_mol] - v[self.outlet_state.flow_mol]),
        )

        # internal-energy balance
        self.add_eq(
            "energy_balances",
            lambda v, p: v[E]
            - tshift(v[E], prev_n(v) * u_mol(v, T0))
            - dt_s
            * (
                self.inlet_state.total_enthalpy(v)
                - self.outlet_state.total_enthalpy(v)
                + v[Q]
            ),
            scale=1e-5,
        )

        # outlet leaves at tank conditions
        self.add_eq(
            "outlet_temperature",
            lambda v, p: v[self.outlet_state.temperature] - v[Tt],
        )
        self.add_eq(
            "outlet_pressure",
            lambda v, p: v[self.outlet_state.pressure] - v[Pt],
            scale=1e-5,
        )

    @property
    def inlet(self):
        return self.inlet_state.port

    @property
    def outlet(self):
        return self.outlet_state.port
