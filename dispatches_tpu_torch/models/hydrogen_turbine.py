"""Hydrogen turbine composite unit model (counterpart of
``dispatches_tpu/models/hydrogen_turbine.py``): Compressor →
Stoichiometric Reactor (H2 combustion with a conversion var) → Turbine,
with net mechanical work = compressor work + turbine work.

Each stage is a set of residuals over four StateBundles (inlet →
comp_out → reac_out → outlet) on the 5-component ideal-gas mixture.
Isentropic pressure-changer math:

    s(T_isen, P_out, y) = s(T_in, P_in, y)
    w_isen  = F·(h(T_isen) − h(T_in))
    w_mech  = w_isen/η  (compressor)   or   w_isen·η  (turbine)
    F·h(T_out) = F·h(T_in) + w_mech

Sign convention: compressor work > 0, turbine work < 0; net
``work_mechanical`` < 0 means net power produced.
"""

from __future__ import annotations

import numpy as np
import torch

from dispatches_tpu_torch.core.graph import Flowsheet, UnitModel
from dispatches_tpu_torch.models.base import StateBundle
from dispatches_tpu_torch.properties.h2_reaction import H2CombustionReaction
from dispatches_tpu_torch.properties.ideal_gas import IdealGasPackage, hturbine_ideal_vap


def _host(t) -> np.ndarray:
    """A property value computed on the host as a numpy float64 array."""
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t, dtype=np.float64)


class HydrogenTurbine(UnitModel):
    def __init__(
        self,
        fs: Flowsheet,
        name: str = "h2_turbine",
        props: IdealGasPackage = hturbine_ideal_vap,
        reaction: H2CombustionReaction = None,
    ):
        super().__init__(fs, name)
        self.props = props
        self.reaction = reaction or H2CombustionReaction(props)

        self.inlet_state = StateBundle(self, "inlet", props)
        self.comp_out = StateBundle(self, "compressor.outlet", props, port=False)
        self.reac_out = StateBundle(self, "reactor.outlet", props, port=False)
        self.outlet_state = StateBundle(self, "outlet", props)

        self.compressor_work = self._pressure_changer(
            "compressor", self.inlet_state, self.comp_out, compressor=True
        )
        self._reactor(self.comp_out, self.reac_out)
        self.turbine_work = self._pressure_changer(
            "turbine", self.reac_out, self.outlet_state, compressor=False
        )

    # ------------------------------------------------------------------

    def _pressure_changer(
        self, stage: str, sin: StateBundle, sout: StateBundle, compressor: bool
    ) -> str:
        """Isentropic compressor/turbine stage; returns the mechanical-work
        var name (W).  The user fixes either ``{stage}.deltaP`` or
        ``{stage}.ratioP`` (both tied to the outlet pressure)."""
        props = self.props
        tlo, ti, thi = props.temperature_bounds

        eta = self.add_var(f"{stage}.efficiency_isentropic", shape=(),
                           lb=0.0, ub=1.0, init=0.9)
        dP = self.add_var(f"{stage}.deltaP", lb=-1e8, ub=1e8, init=0.0,
                          scale=1e6)
        rP = self.add_var(f"{stage}.ratioP", lb=0.0, ub=1e3, init=1.0)
        T_is = self.add_var(f"{stage}.temperature_isentropic",
                            lb=tlo, ub=thi, init=ti, scale=100.0)
        W = self.add_var(f"{stage}.work_mechanical", lb=-1e12, ub=1e12,
                         scale=1e7)

        # component flows conserved (vector residual)
        self.add_eq(
            f"{stage}.flow_balance",
            lambda v, p: v[sout.flow_mol_comp] - v[sin.flow_mol_comp],
        )
        # pressure relations: fix one of deltaP / ratioP
        self.add_eq(
            f"{stage}.pressure_delta",
            lambda v, p: v[sout.pressure] - v[sin.pressure] - v[dP],
            scale=1e-5,
        )
        self.add_eq(
            f"{stage}.pressure_ratio",
            lambda v, p: v[sout.pressure] - v[rP] * v[sin.pressure],
            scale=1e-5,
        )
        # isentropic outlet temperature: s(T_is, P_out) == s(T_in, P_in)
        self.add_eq(
            f"{stage}.isentropic",
            lambda v, p: props.entr_mol(v[T_is], v[sout.pressure], sin.y(v))
            - sin.entr_mol(v),
            scale=1e-1,
        )

        def w_isen(v):
            return v[sin.flow_mol] * (
                props.enth_mol(v[T_is], sin.y(v)) - sin.enth_mol(v)
            )

        if compressor:
            self.add_eq(
                f"{stage}.work_definition",
                lambda v, p: v[W] * v[eta] - w_isen(v),
                scale=1e-6,
            )
        else:
            self.add_eq(
                f"{stage}.work_definition",
                lambda v, p: v[W] - v[eta] * w_isen(v),
                scale=1e-6,
            )
        # energy balance defines actual outlet temperature
        self.add_eq(
            f"{stage}.energy_balance",
            lambda v, p: sout.total_enthalpy(v) - sin.total_enthalpy(v) - v[W],
            scale=1e-6,
        )
        return W

    def _reactor(self, sin: StateBundle, sout: StateBundle) -> None:
        """Adiabatic stoichiometric reactor with heat of reaction and a
        conversion of the key component."""
        rxn = self.reaction
        conv = self.add_var("reactor.conversion", shape=(), lb=0.0, ub=1.0,
                            init=0.75)

        self.add_eq(
            "reactor.stoichiometry",
            lambda v, p: v[sout.flow_mol_comp]
            - rxn.outlet_flows(v[sin.flow_mol_comp], v[conv]),
        )
        self.add_eq(
            "reactor.pressure_balance",
            lambda v, p: v[sout.pressure] - v[sin.pressure],
            scale=1e-5,
        )
        # H_out − H_in = −dh_rxn·extent  (exothermic: dh_rxn < 0)
        self.add_eq(
            "reactor.energy_balance",
            lambda v, p: sout.total_enthalpy(v)
            - sin.total_enthalpy(v)
            - rxn.heat_of_reaction(
                v[sin.flow_mol_comp],
                v[conv],
            ),
            scale=1e-6,
        )

    # ------------------------------------------------------------------

    def work_mechanical(self, v):
        """Net mechanical work expression, W."""
        return v[self.compressor_work] + v[self.turbine_work]

    # ------------------------------------------------------------------

    def initialize(self, flow_mol_comp=None, temperature=None, pressure=None) -> None:
        """Host-side stagewise warm start: solve each stage's state with
        scalar bisections on the closed-form Shomate curves (evaluated in
        float64 on the CPU) and write the results as variable inits.
        Reads the currently-fixed inlet state and stage parameters from the
        flowsheet unless a nominal inlet is passed explicitly (for
        flowsheets where the turbine feed is a free stream)."""
        fs, props, rxn = self.fs, self.props, self.reaction
        specs = fs.var_specs

        def fixed(name, default=None):
            s = specs[self.v(name)]
            if s.fixed:
                return np.asarray(s.fixed_value, dtype=float)
            if default is None:
                return np.asarray(s.init, dtype=float)
            return np.asarray(default, dtype=float)

        fc = (
            np.atleast_2d(fixed("inlet.flow_mol_comp"))
            if flow_mol_comp is None
            else np.atleast_2d(np.asarray(flow_mol_comp, dtype=float))
        )
        T_in = (
            np.atleast_1d(fixed("inlet.temperature"))
            if temperature is None
            else np.atleast_1d(np.asarray(temperature, dtype=float))
        )
        P_in = (
            np.atleast_1d(fixed("inlet.pressure"))
            if pressure is None
            else np.atleast_1d(np.asarray(pressure, dtype=float))
        )
        if flow_mol_comp is not None:
            fs.set_init(self.v("inlet.flow_mol_comp"), fc)
            fs.set_init(self.v("inlet.flow_mol"), fc.sum(-1))
        if temperature is not None:
            fs.set_init(self.v("inlet.temperature"), T_in)
        if pressure is not None:
            fs.set_init(self.v("inlet.pressure"), P_in)

        def bisect(f, lo, hi, iters=80):
            lo = np.full_like(_host(f(lo) * 0.0) + lo, lo, dtype=float)
            hi = np.full_like(lo, hi)
            for _ in range(iters):
                mid = 0.5 * (lo + hi)
                neg = _host(f(mid)) < 0
                lo = np.where(neg, mid, lo)
                hi = np.where(neg, hi, mid)
            return 0.5 * (lo + hi)

        tlo, _, thi = props.temperature_bounds

        def stage(fc_in, T1, P1, dP, eta, compressor):
            y = fc_in / np.maximum(fc_in.sum(-1, keepdims=True), 1e-12)
            F = fc_in.sum(-1)
            P2 = P1 + dP
            s1 = _host(props.entr_mol(T1, P1, y))
            T_is = bisect(
                lambda T: _host(props.entr_mol(T, P2, y)) - s1, tlo, thi
            )
            h1 = _host(props.enth_mol(T1, y))
            dh_is = _host(props.enth_mol(T_is, y)) - h1
            w = F * dh_is / eta if compressor else F * dh_is * eta
            h2 = h1 + w / np.maximum(F, 1e-12)
            T2 = bisect(
                lambda T: _host(props.enth_mol(T, y)) - h2, tlo, thi
            )
            return T_is, T2, P2, w

        # compressor
        dPc = np.atleast_1d(fixed("compressor.deltaP"))
        eta_c = fixed("compressor.efficiency_isentropic", 0.9)
        Tc_is, Tc, Pc, Wc = stage(fc, T_in, P_in, dPc, eta_c, True)
        # reactor
        conv = fixed("reactor.conversion", 0.75)
        fc_r = _host(rxn.outlet_flows(fc, conv))
        y_r = fc_r / np.maximum(fc_r.sum(-1, keepdims=True), 1e-12)
        F_r = fc_r.sum(-1)
        H_in = fc.sum(-1) * _host(
            props.enth_mol(Tc, fc / np.maximum(fc.sum(-1, keepdims=True), 1e-12))
        )
        Q = _host(rxn.heat_of_reaction(fc, conv))
        h_r = (H_in + Q) / np.maximum(F_r, 1e-12)
        T_r = bisect(
            lambda T: _host(props.enth_mol(T, y_r)) - h_r, tlo, thi
        )
        # turbine
        dPt = np.atleast_1d(fixed("turbine.deltaP"))
        eta_t = fixed("turbine.efficiency_isentropic", 0.9)
        Tt_is, Tt, Pt, Wt = stage(fc_r, T_r, Pc, dPt, eta_t, False)

        for name, val in [
            ("inlet.flow_mol", fc.sum(-1)),
            ("compressor.outlet.flow_mol", fc.sum(-1)),
            ("compressor.outlet.flow_mol_comp", fc),
            ("compressor.outlet.temperature", Tc),
            ("compressor.outlet.pressure", Pc),
            ("compressor.temperature_isentropic", Tc_is),
            ("compressor.work_mechanical", Wc),
            ("compressor.ratioP", Pc / P_in),
            ("reactor.outlet.flow_mol", F_r),
            ("reactor.outlet.flow_mol_comp", fc_r),
            ("reactor.outlet.temperature", T_r),
            ("reactor.outlet.pressure", Pc),
            ("outlet.flow_mol", F_r),
            ("outlet.flow_mol_comp", fc_r),
            ("outlet.temperature", Tt),
            ("outlet.pressure", Pt),
            ("turbine.temperature_isentropic", Tt_is),
            ("turbine.work_mechanical", Wt),
            ("turbine.ratioP", Pt / Pc),
        ]:
            fs.set_init(self.v(name), np.squeeze(val) if np.ndim(val) else val)

    @property
    def inlet(self):
        return self.inlet_state.port

    @property
    def outlet(self):
        return self.outlet_state.port
