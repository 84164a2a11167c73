"""ConcreteTubeSide: standalone 1D tube-side heat exchanger against a
fixed wall-temperature profile (counterpart of
``dispatches_tpu/models/heat_exchanger_tube.py``; the same variables,
names, order, bounds, scales and residual rows).

Counterpart of the reference's ``dispatches/unit_models/
heat_exchanger_tube.py`` (``ConcreteTubeSideData``): a tube-side control
volume discretized by backward finite differences whose only interaction
is convective heat transfer against a per-(t, x) wall-temperature
variable (``heat = htc * pi * d_inner * (T_wall - T)``), plus the
tube-area closure ``4*A = pi*d_inner**2``.

The x-domain is a dense segment axis on one tensor; the fluid state
along the tube uses the same three-region (liq / two-phase / vap)
IAPWS-95 representation as the ConcreteTES tube sides, with saturation
constants taken at the tube design pressure, so the water can enter
subcooled and leave superheated through the dome in one differentiable
residual set.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dispatches_tpu_torch.core.graph import Flowsheet, UnitModel
from dispatches_tpu_torch.models.concrete_tes import (
    _SatConstants,
    region_state,
    region_tables,
    smooth_max,
    smooth_min,
)
from dispatches_tpu_torch.models.steam_cycle import SteamState
from dispatches_tpu_torch.properties import iapws95 as w95

_SP = 1e-6
_SH = 1e-3
_SQ = 1e-2
_SF = 1e-2


class ConcreteTubeSide(UnitModel):
    """1D tube side vs a fixed wall-temperature profile.

    Fix ``d_tube_inner``/``d_tube_outer``/``tube_length``,
    ``tube_heat_transfer_coefficient`` and ``temperature_wall`` (per
    t, x), plus the inlet state, for a square model (the reference test
    recipe).
    """

    def __init__(self, fs: Flowsheet, name: str = "tube_side",
                 finite_elements: int = 20,
                 design_pressure: float = 101325.0,
                 flow_type: str = "cocurrent"):
        super().__init__(fs, name)
        if flow_type not in ("cocurrent", "countercurrent"):
            raise ValueError(f"unknown flow_type {flow_type!r}")
        self.flow_type = flow_type
        S = int(finite_elements)
        self.n_segments = S
        T = fs.horizon
        self.sat = sat = _SatConstants(design_pressure)

        self.inlet_state = SteamState(self, "tube_inlet", "liq")
        self.outlet_state = SteamState(self, "tube_outlet", "vap")

        d_in = self.add_var("d_tube_inner", shape=(), lb=1e-4, ub=1.0,
                            init=0.01, scale=0.01)
        d_out = self.add_var("d_tube_outer", shape=(), lb=1e-4, ub=1.0,
                             init=0.011, scale=0.01)
        L = self.add_var("tube_length", shape=(), lb=1e-3, ub=1e3,
                         init=5.0)
        A = self.add_var("tube_area", shape=(), lb=1e-9, ub=1.0,
                         init=8e-5, scale=1e-4)
        htc = self.add_var("tube_heat_transfer_coefficient", shape=(T, S),
                           lb=0.0, ub=1e5, init=50.0, scale=100.0)
        Twall = self.add_var("temperature_wall", shape=(T, S),
                             lb=250.0, ub=2000.0, init=298.15, scale=100.0)
        heat = self.add_var("heat", shape=(T, S), lb=-1e7, ub=1e7,
                            init=0.0, scale=1e2)
        self.d_tube_inner, self.d_tube_outer = d_in, d_out
        self.tube_length, self.tube_area = L, A
        self.htc, self.temperature_wall, self.heat = htc, Twall, heat

        # tube area closure (reference ``area_calc_tube``)
        self.add_eq("area_calc_tube",
                    lambda v, p: 4.0 * v[A] - math.pi * v[d_in] ** 2,
                    scale=1e3)

        # three-region fluid state per segment node
        h = self.add_var("enth_mol", shape=(T, S), lb=100.0, ub=9e4,
                         init=3e4, scale=1e4)
        Tl = self.add_var("T_liq", shape=(T, S), lb=255.0,
                          ub=sat.Tsat + 1.0, init=min(400.0, sat.Tsat),
                          scale=100.0)
        dl = self.add_var("delta_liq", shape=(T, S),
                          lb=max(0.9, sat.delta_l - 1.0), ub=3.95, init=3.0)
        Tv = self.add_var("T_vap", shape=(T, S), lb=sat.Tsat - 1.0,
                          ub=1350.0, init=sat.Tsat + 10.0, scale=100.0)
        dv = self.add_var("delta_vap", shape=(T, S), lb=1e-9,
                          ub=sat.delta_v + 0.2, init=sat.delta_v / 2,
                          scale=0.1)
        self.h_nodes = h

        self.add_eq("eos_p_liq",
                    lambda v, p: (w95.p_dT(v[dl], v[Tl]) - sat.P).ravel(),
                    scale=_SP)
        self.add_eq("eos_p_vap",
                    lambda v, p: (w95.p_dT(v[dv], v[Tv]) - sat.P).ravel(),
                    scale=_SP)
        self.add_eq("eos_h_liq",
                    lambda v, p: (w95.h_dT(v[dl], v[Tl])
                                  - smooth_min(v[h], sat.h_l)).ravel(),
                    scale=_SH)
        self.add_eq("eos_h_vap",
                    lambda v, p: (w95.h_dT(v[dv], v[Tv])
                                  - smooth_max(v[h], sat.h_v)).ravel(),
                    scale=_SH)

        sin, sout = self.inlet_state, self.outlet_state

        def T_fluid(v):
            return v[Tl] + v[Tv] - sat.Tsat

        # countercurrent: the fluid (marching in flow order) meets the
        # wall profile from its far end, so the x-indexed wall/htc
        # arrays flip relative to the flow axis
        flip = flow_type == "countercurrent"

        def wall_of(v):
            w = v[Twall]
            return torch.flip(w, dims=(-1,)) if flip else w

        def htc_of(v):
            h_ = v[htc]
            return torch.flip(h_, dims=(-1,)) if flip else h_

        # convective heat transfer per element (reference
        # ``tube_heat_transfer_eq`` integrated over the element length)
        def heat_law(v, p):
            dx = v[L] / S
            return (v[heat]
                    - htc_of(v) * math.pi * v[d_in] * dx
                    * (wall_of(v) - T_fluid(v))).ravel()

        self.add_eq("tube_heat_transfer_eq", heat_law, scale=_SQ)

        # backward-FD energy balance along the tube (flow order)
        def energy(v, p):
            hh = v[h]
            prev = torch.cat([v[sin.enth_mol][:, None], hh[:, :-1]], dim=-1)
            return (v[sin.flow_mol][:, None] * (hh - prev)
                    - v[heat]).ravel()

        self.add_eq("energy_balance", energy, scale=_SQ)

        # port closures
        self.add_eq("outlet_flow",
                    lambda v, p: v[sout.flow_mol] - v[sin.flow_mol],
                    scale=_SF)
        self.add_eq("outlet_enth",
                    lambda v, p: v[sout.enth_mol] - v[h][:, -1], scale=_SH)
        self.add_eq("outlet_pressure",
                    lambda v, p: v[sout.pressure] - v[sin.pressure],
                    scale=_SP)

    # -- reference-parity port names ----------------------------------

    @property
    def tube_inlet(self):
        return self.inlet_state.port

    @property
    def tube_outlet(self):
        return self.outlet_state.port

    # ------------------------------------------------------------------

    def initialize(self) -> None:
        """Host-side explicit march along the tube (the role of the
        reference's ``initialize_build`` IPOPT ladder)."""
        fs = self.fs
        S, sat = self.n_segments, self.sat
        T = fs.horizon

        def fixed(name):
            spec = fs.var_specs[name]
            val = spec.fixed_value if spec.fixed else spec.init
            return np.asarray(val, dtype=float)

        F = np.broadcast_to(fixed(self.inlet_state.flow_mol), (T,)).copy()
        h_in = np.broadcast_to(fixed(self.inlet_state.enth_mol), (T,)).copy()
        Twall = np.broadcast_to(fixed(self.v("temperature_wall")),
                                (T, S)).copy()
        htc = np.broadcast_to(
            fixed(self.v("tube_heat_transfer_coefficient")), (T, S)).copy()
        if self.flow_type == "countercurrent":
            Twall = Twall[:, ::-1]
            htc = htc[:, ::-1]
        d_in = float(np.ravel(fixed(self.v("d_tube_inner")))[0])
        L = float(np.ravel(fixed(self.v("tube_length")))[0])
        dx = L / S

        # interpolation tables for the three-region T(h)
        tabs = region_tables(sat)

        def region(hh):
            return region_state(sat, tabs, hh)

        hs = np.zeros((T, S))
        qs = np.zeros((T, S))
        hprev = h_in.copy()
        for s in range(S):
            hh = hprev.copy()
            for _ in range(40):
                T_l, _, T_v, _ = region(hh)
                Tf = T_l + T_v - sat.Tsat
                fval = (F * (hh - hprev)
                        - htc[:, s] * math.pi * d_in * dx
                        * (Twall[:, s] - Tf))
                eps = 5.0
                T_l2, _, T_v2, _ = region(hh + eps)
                dT = (T_l2 + T_v2 - sat.Tsat - Tf) / eps
                dfdh = F + htc[:, s] * math.pi * d_in * dx * dT
                hh = hh - np.clip(fval / np.where(np.abs(dfdh) < 1e-12,
                                                  1e-12, dfdh), -4e3, 4e3)
                if np.max(np.abs(fval)) < 1e-8:
                    break
            hs[:, s] = hh
            qs[:, s] = F * (hh - hprev)
            hprev = hh

        T_l, d_l, T_v, d_v = region(hs)
        fs.set_init(self.v("enth_mol"), hs)
        fs.set_init(self.v("T_liq"), T_l)
        fs.set_init(self.v("delta_liq"), d_l)
        fs.set_init(self.v("T_vap"), T_v)
        fs.set_init(self.v("delta_vap"), d_v)
        fs.set_init(self.v("heat"), qs)
        fs.set_init(self.v("tube_area"), math.pi / 4.0 * d_in ** 2)
        fs.set_init(self.outlet_state.flow_mol, F)
        fs.set_init(self.outlet_state.enth_mol, hs[:, -1])
        fs.set_init(self.outlet_state.pressure, sat.P)
