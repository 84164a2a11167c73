"""Concrete thermal-energy-storage unit model (counterpart of
``dispatches_tpu/models/concrete_tes.py``; the same variables, names,
order, bounds, scales and residual rows).

Counterpart of the reference's ``dispatches/unit_models/concrete_tes.py``:
steam flows through tubes embedded in concrete blocks; per segment, a
convective heat-transfer law couples the fluid to the concrete wall, and
the wall temperature follows an explicit finite-difference update

    T_wall = T_wall_init + dt * q / (rho * cp * V)

with charge flow segment 1 -> n, discharge counter-flow n -> 1,
intra-hour ``num_time_periods`` sub-steps with initial-temperature
linking, a conduction-shape-factor heat-transfer coefficient (``u_tes``,
``htc_from_data``) and plant-side ports scaled by ``num_tubes``.

Every quantity is one tensor shaped ``(horizon, periods, segments)`` and
each physical law is a single vectorized residual; the IAPWS-95 calls
are batched over the whole grid.

**Three-region fluid temperature.**  Tube-side steam crosses
superheated -> two-phase -> subcooled along the tube, and the boundary
moves with operating conditions.  The tube pressure is a design
constant, so the saturation state (Tsat, h_l, h_v) is a build-time
constant (``_SatConstants``, float64 on the host), and the fluid
temperature is composed branchlessly from two single-phase EoS states:

    T_liq solves  h_liq = smooth_min(h, h_l)   on the liquid branch
    T_vap solves  h_vap = smooth_max(h, h_v)   on the vapor branch
    T_fluid = T_liq + T_vap - Tsat

which is exact in all three regions (subcooled: T_vap = Tsat;
superheated: T_liq = Tsat; two-phase: both pin to Tsat) with a smooth
blend of width ``H_BLEND`` at the dome edges.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from dispatches_tpu_torch.core.graph import Flowsheet, UnitModel, tshift
from dispatches_tpu_torch.models.steam_cycle import SteamState
from dispatches_tpu_torch.properties import iapws95 as w95

H_BLEND = 20.0  # J/mol smoothing width at the saturation-dome edges

_SP = 1e-5
_SH = 1e-3
_SF = 1.0
_SQ = 1e-2  # per-tube heat rates are O(1e2..1e3) W
_ST = 1e-1


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else np.sqrt(x)


def smooth_max(a, b, eps=H_BLEND):
    """``max(a, b)`` smoothed over ``eps``; tensors or numbers."""
    return 0.5 * (a + b + _sqrt((a - b) ** 2 + eps ** 2))


def smooth_min(a, b, eps=H_BLEND):
    """``min(a, b)`` smoothed over ``eps``; tensors or numbers."""
    return 0.5 * (a + b - _sqrt((a - b) ** 2 + eps ** 2))


def u_tes(r, k, a, b):
    """Conduction shape factor for a tube in a square concrete block
    (reference ``u_tes``)."""
    zz = r + ((a ** 3 * (4 * b ** 2 - a ** 2)
               + a * b ** 4 * (4 * math.log(b / a) - 3))
              / (4 * k * (b ** 2 - a ** 2) ** 2))
    return 1.0 / zz


def htc_from_data(data: Dict) -> float:
    """Reference ``htc_surrogate``: the tube-to-concrete heat-transfer
    coefficient of the model data's geometry."""
    a = data["tube_diameter"] / 2
    b = math.sqrt(data["face_area"] / math.pi + a ** 2)
    k = data["therm_cond_concrete"] * 0.8
    return u_tes(r=0.0001, k=k, a=a, b=b) / 1.31


class _SatConstants:
    """Build-time saturation data at a fixed tube pressure (host float64)."""

    def __init__(self, P: float):
        self.P = float(P)
        Ts, dl, dv = w95.sat_solve_P(P)
        self.Tsat = float(Ts)
        self.delta_l = float(dl)
        self.delta_v = float(dv)
        self.h_l = float(w95._h_host(dl, Ts))
        self.h_v = float(w95._h_host(dv, Ts))


def region_tables(sat: _SatConstants):
    """Interpolation tables of the three-region T(h) on both branches at
    the side's design pressure: ``(h_l, T_l, delta_l, h_v, T_v, delta_v)``
    grids for the host warm starts."""
    Tl_grid = np.linspace(256.0, sat.Tsat, 120)
    dl_grid = w95.rho_tp(Tl_grid, np.full_like(Tl_grid, sat.P), "liq") / w95.RHOC
    hl_grid = np.asarray(w95._h_host(dl_grid, Tl_grid))
    Tv_grid = np.linspace(sat.Tsat, 1340.0, 160)
    dv_grid = w95.rho_tp(Tv_grid, np.full_like(Tv_grid, sat.P), "vap") / w95.RHOC
    hv_grid = np.asarray(w95._h_host(dv_grid, Tv_grid))
    return hl_grid, Tl_grid, dl_grid, hv_grid, Tv_grid, dv_grid


def region_state(sat: _SatConstants, tabs, h):
    """Host three-region state at enthalpy ``h``: ``(T_liq, delta_liq,
    T_vap, delta_vap)`` interpolated on ``region_tables``' grids."""
    hl_g, Tl_g, dl_g, hv_g, Tv_g, dv_g = tabs
    h_lo = np.minimum(h, sat.h_l)
    h_hi = np.maximum(h, sat.h_v)
    T_l = np.interp(h_lo, hl_g, Tl_g)
    d_l = np.interp(h_lo, hl_g, dl_g)
    T_v = np.interp(h_hi, hv_g, Tv_g)
    d_v = np.interp(h_hi, hv_g, dv_g)
    return T_l, d_l, T_v, d_v


class _TubeSide:
    """One operating side (charge or discharge): fluid enthalpy chain +
    three-region EoS states + per-segment convective heat duty, all in
    flow order (index 0 = first segment the fluid meets)."""

    def __init__(self, tes: "ConcreteTES", mode: str, P_in: float,
                 shape):
        self.mode = mode
        self.sat = _SatConstants(P_in)
        u = tes
        T, Pn, S = shape
        sat = self.sat

        # per-tube molar flow, one value per hour (all intra-hour
        # periods see the same inlet)
        self.flow_tube = u.add_var(f"{mode}.flow_mol_tube", lb=0.0, ub=1e3,
                                   init=0.5)
        self.h_in = u.add_var(f"{mode}.enth_mol_in", lb=100.0, ub=9e4,
                              init=3e4, scale=1e4)
        self.h = u.add_var(f"{mode}.enth_mol", shape=(T, Pn, S),
                           lb=100.0, ub=9e4, init=3e4, scale=1e4)
        self.T_liq = u.add_var(f"{mode}.T_liq", shape=(T, Pn, S),
                               lb=255.0, ub=sat.Tsat + 1.0,
                               init=min(400.0, sat.Tsat), scale=100.0)
        self.d_liq = u.add_var(f"{mode}.delta_liq", shape=(T, Pn, S),
                               lb=max(0.9, sat.delta_l - 1.0), ub=3.95,
                               init=3.0)
        self.T_vap = u.add_var(f"{mode}.T_vap", shape=(T, Pn, S),
                               lb=sat.Tsat - 1.0, ub=1350.0,
                               init=sat.Tsat + 10, scale=100.0)
        self.d_vap = u.add_var(f"{mode}.delta_vap", shape=(T, Pn, S),
                               lb=1e-9, ub=sat.delta_v + 0.2,
                               init=sat.delta_v / 2, scale=0.1)
        self.heat = u.add_var(f"{mode}.segment_heat", shape=(T, Pn, S),
                              lb=-1e6, ub=1e6, init=0.0, scale=1e2)

        h, hin, Tl, dl, Tv, dv = (self.h, self.h_in, self.T_liq,
                                  self.d_liq, self.T_vap, self.d_vap)

        # EoS: pressure consistency + three-region enthalpy links
        u.add_eq(f"{mode}.eos_p_liq",
                 lambda v, p: (w95.p_dT(v[dl], v[Tl]) - sat.P).ravel(),
                 scale=_SP)
        u.add_eq(f"{mode}.eos_p_vap",
                 lambda v, p: (w95.p_dT(v[dv], v[Tv]) - sat.P).ravel(),
                 scale=_SP)
        u.add_eq(f"{mode}.eos_h_liq",
                 lambda v, p: (w95.h_dT(v[dl], v[Tl])
                               - smooth_min(v[h], sat.h_l)).ravel(),
                 scale=_SH)
        u.add_eq(f"{mode}.eos_h_vap",
                 lambda v, p: (w95.h_dT(v[dv], v[Tv])
                               - smooth_max(v[h], sat.h_v)).ravel(),
                 scale=_SH)

        # energy balance along the tube (flow order)
        def energy(v, p):
            hh = v[h]
            prev = torch.cat(
                [v[hin][:, None, None].expand(-1, Pn, 1), hh[:, :, :-1]], dim=-1)
            F = v[self.flow_tube][:, None, None]
            return (F * (hh - prev) - v[self.heat]).ravel()

        u.add_eq(f"{mode}.energy_balance", energy, scale=_SQ)

    def T_fluid(self, v):
        return v[self.T_liq] + v[self.T_vap] - self.sat.Tsat

    def x_fluid(self, v):
        return torch.clamp(
            (v[self.h] - self.sat.h_l) / (self.sat.h_v - self.sat.h_l), 0.0, 1.0)


class ConcreteTES(UnitModel):
    """Concrete TES over a (horizon, periods, segments) grid.

    ``model_data`` uses the reference's schema: num_tubes, num_segments,
    num_time_periods, tube_length, tube_diameter, face_area,
    therm_cond_concrete, dens_mass_concrete, cp_mass_concrete,
    init_temperature_concrete, inlet_pressure_charge /
    inlet_pressure_discharge.

    Ports ``inlet_charge``/``outlet_charge`` and
    ``inlet_discharge``/``outlet_discharge`` carry plant-side totals
    (per-tube quantities x num_tubes).
    """

    def __init__(self, fs: Flowsheet, name: str, model_data: Dict,
                 operating_mode: str = "combined",
                 link_periods_in_time: bool = False):
        super().__init__(fs, name)
        if operating_mode not in ("charge", "discharge", "combined"):
            raise ValueError(f"bad operating_mode {operating_mode!r}")
        data = dict(model_data)
        required = ["num_tubes", "num_segments", "num_time_periods",
                    "tube_length", "tube_diameter", "therm_cond_concrete",
                    "dens_mass_concrete", "cp_mass_concrete",
                    "init_temperature_concrete", "face_area"]
        for k in required:
            if k not in data:
                raise KeyError(f"model_data missing {k!r}")
        self.data = data
        self.operating_mode = operating_mode
        T = fs.horizon
        S = int(data["num_segments"])
        Pn = int(data["num_time_periods"])
        self.n_seg, self.n_periods = S, Pn
        dt = 3600.0 / Pn
        n_tubes = float(data["num_tubes"])
        seg_len = data["tube_length"] / S
        area_seg = math.pi * data["tube_diameter"] * seg_len
        htc = htc_from_data(data)
        self.htc = htc
        vol_seg = data["face_area"] * seg_len
        rho_cp_v = data["dens_mass_concrete"] * data["cp_mass_concrete"] * vol_seg

        # ---- concrete wall --------------------------------------------
        self.wall_init = self.add_var("wall_init_temperature", shape=(T, Pn, S),
                                      lb=300.0, ub=900.0, init=600.0,
                                      scale=100.0)
        self.wall_temp = self.add_var("wall_temperature", shape=(T, Pn, S),
                                      lb=300.0, ub=900.0, init=600.0,
                                      scale=100.0)
        self.heat_rate = self.add_var("heat_rate", shape=(T, Pn, S),
                                      lb=-1e6, ub=1e6, init=0.0, scale=1e2)
        # the hour's starting profile (fixed for a standalone unit;
        # time-linked for multiperiod operation)
        self.inlet_wall_temperature = self.add_var(
            "inlet_wall_temperature", shape=(T, S), lb=300.0, ub=900.0,
            init=600.0, scale=100.0,
        )
        fs.fix(self.v("inlet_wall_temperature"),
               np.broadcast_to(np.asarray(data["init_temperature_concrete"]),
                               (T, S)))

        wi, wt, hr = self.wall_init, self.wall_temp, self.heat_rate

        # explicit FD wall update
        self.add_eq(
            "wall_update",
            lambda v, p: (v[wt] - v[wi]
                          - dt * v[hr] / rho_cp_v).ravel(),
            scale=_ST,
        )

        # intra-hour + (optionally) inter-hour initial-temperature links
        def init_link(v, p):
            w_start = v[wi][:, 0, :]
            w_prev_end = v[wt][:, -1, :]
            if link_periods_in_time:
                target0 = tshift(w_prev_end, v[self.inlet_wall_temperature][0])
            else:
                target0 = v[self.inlet_wall_temperature]
            parts = [(w_start - target0).ravel()]
            if Pn > 1:
                parts.append((v[wi][:, 1:, :] - v[wt][:, :-1, :]).ravel())
            return torch.cat(parts)

        self.add_eq("initial_temperature", init_link, scale=_ST)

        # ---- tube sides ----------------------------------------------
        self.charge: Optional[_TubeSide] = None
        self.discharge: Optional[_TubeSide] = None
        sides = []
        if operating_mode in ("charge", "combined"):
            self.charge = _TubeSide(
                self, "charge", data["inlet_pressure_charge"], (T, Pn, S)
            )
            sides.append(("charge", self.charge, False))
        if operating_mode in ("discharge", "combined"):
            self.discharge = _TubeSide(
                self, "discharge", data["inlet_pressure_discharge"],
                (T, Pn, S),
            )
            sides.append(("discharge", self.discharge, True))

        # convective coupling: Q_seg = htc * A * (T_wall - T_fluid);
        # discharge runs counter-flow, so its flow-order arrays see the
        # wall flipped
        for mode, side, flipped in sides:
            def heat_law(v, p, side=side, flipped=flipped):
                wall = v[wt]
                if flipped:
                    wall = torch.flip(wall, dims=(-1,))
                return (v[side.heat]
                        - htc * area_seg * (wall - side.T_fluid(v))).ravel()

            self.add_eq(f"{mode}.heat_transfer", heat_law, scale=_SQ)

        # wall heat balance: heat_rate = -(Q_charge + Q_discharge)
        def wall_balance(v, p):
            q = torch.zeros_like(v[hr])
            if self.charge is not None:
                q = q + v[self.charge.heat]
            if self.discharge is not None:
                q = q + torch.flip(v[self.discharge.heat], dims=(-1,))
            return (v[hr] + q).ravel()

        self.add_eq("heat_balance", wall_balance, scale=_SQ)

        # ---- plant-side ports (totals = per-tube x num_tubes) --------
        for mode, side, _ in sides:
            st_in = SteamState(self, f"inlet_{mode}", "vap")
            st_out = SteamState(self, f"outlet_{mode}", "vap")
            setattr(self, f"inlet_{mode}_state", st_in)
            setattr(self, f"outlet_{mode}_state", st_out)

            self.add_eq(f"{mode}.port_flow_in",
                        lambda v, p, s=side, st=st_in:
                        v[st.flow_mol] - n_tubes * v[s.flow_tube],
                        scale=_SF)
            self.add_eq(f"{mode}.port_enth_in",
                        lambda v, p, s=side, st=st_in:
                        v[st.enth_mol] - v[s.h_in], scale=_SH)
            # the in-tube EoS is evaluated at the side's DESIGN pressure
            # (model_data inlet_pressure_*); port pressures pass through
            # unchanged, so the plant-side pressure must sit near the
            # design point for the property relation to be accurate.
            # The outlet is the last flow-order segment of the LAST
            # intra-hour period.
            self.add_eq(f"{mode}.port_flow_out",
                        lambda v, p, s=side, st=st_out:
                        v[st.flow_mol] - n_tubes * v[s.flow_tube],
                        scale=_SF)
            self.add_eq(f"{mode}.port_enth_out",
                        lambda v, p, s=side, st=st_out:
                        v[st.enth_mol] - v[s.h][:, -1, -1], scale=_SH)
            self.add_eq(f"{mode}.port_pressure_out",
                        lambda v, p, st=st_out, sti=st_in:
                        v[st.pressure] - v[sti.pressure], scale=_SP)

    # ------------------------------------------------------------------

    @property
    def inlet_charge(self):
        return self.inlet_charge_state.port

    @property
    def outlet_charge(self):
        return self.outlet_charge_state.port

    @property
    def inlet_discharge(self):
        return self.inlet_discharge_state.port

    @property
    def outlet_discharge(self):
        return self.outlet_discharge_state.port

    # ------------------------------------------------------------------

    def fix_inlet(self, mode: str, flow_mol_total=None, enth_mol=None,
                  temperature=None, pressure=None) -> None:
        """Fix a side's plant inlet (flow, pressure and enthalpy, or a
        temperature that sets the enthalpy at the design pressure).

        The in-tube EoS is evaluated at the side's DESIGN pressure
        (``model_data`` inlet_pressure_*), so a ``pressure`` more than 2%
        from the design value is rejected.
        """
        fs = self.fs
        st: SteamState = getattr(self, f"inlet_{mode}_state")
        side: _TubeSide = getattr(self, mode)
        if pressure is not None:
            rel = abs(pressure - side.sat.P) / side.sat.P
            if rel > 0.02:
                raise ValueError(
                    f"{mode} inlet pressure {pressure:.4g} Pa is "
                    f"{rel:.1%} from the design pressure "
                    f"{side.sat.P:.4g} Pa at which the in-tube EoS is "
                    "evaluated; rebuild the TES with the new design "
                    "pressure instead")
        if temperature is not None:
            branch = "vap" if temperature > side.sat.Tsat else "liq"
            enth_mol = float(
                w95.props_tp(temperature, side.sat.P, branch)["h"]
            )
        if flow_mol_total is not None:
            fs.fix(st.flow_mol, flow_mol_total)
        if enth_mol is not None:
            fs.fix(st.enth_mol, enth_mol)
        fs.fix(st.pressure, side.sat.P if pressure is None else pressure)

    def initialize(self) -> None:
        """Host-side warm start: march the explicit tube/wall cascade
        (the reference's per-period per-side initialization ladder,
        without its subprocess solves)."""
        fs = self.fs
        data = self.data
        T, Pn, S = fs.horizon, self.n_periods, self.n_seg
        dt = 3600.0 / Pn
        seg_len = data["tube_length"] / S
        area_seg = math.pi * data["tube_diameter"] * seg_len
        vol_seg = data["face_area"] * seg_len
        rho_cp_v = (data["dens_mass_concrete"] * data["cp_mass_concrete"]
                    * vol_seg)

        sides = []
        if self.charge is not None:
            sides.append(("charge", self.charge, False))
        if self.discharge is not None:
            sides.append(("discharge", self.discharge, True))

        # interpolation tables per side for the three-region warm start
        tabs = {mode: region_tables(side.sat) for mode, side, _ in sides}

        # read fixed inlets (fixed value, else the registered init)
        def fixed(name):
            spec = fs.var_specs[self.v(name)]
            val = spec.fixed_value if spec.fixed else spec.init
            return np.broadcast_to(np.asarray(val, dtype=float), (T,)).copy()

        wall0 = np.broadcast_to(
            np.asarray(
                fs.var_specs[self.v("inlet_wall_temperature")].fixed_value
                if fs.var_specs[self.v("inlet_wall_temperature")].fixed
                else data["init_temperature_concrete"], dtype=float
            ), (T, S),
        ).copy()

        wall_init = np.zeros((T, Pn, S))
        wall_temp = np.zeros((T, Pn, S))
        heat_rate = np.zeros((T, Pn, S))
        hs = {m: np.zeros((T, Pn, S)) for m, _, _ in sides}
        qs = {m: np.zeros((T, Pn, S)) for m, _, _ in sides}
        f_tube = {}
        h_in = {}
        n_tubes = float(data["num_tubes"])
        for mode, side, _ in sides:
            f_tube[mode] = fixed(f"inlet_{mode}.flow_mol") / n_tubes
            h_in[mode] = fixed(f"inlet_{mode}.enth_mol")

        w = wall0.copy()
        for p in range(Pn):
            wall_init[:, p, :] = w
            q_net = np.zeros((T, S))
            for mode, side, flipped in sides:
                wloc = w[:, ::-1] if flipped else w
                hprev = h_in[mode].copy()
                for s in range(S):
                    # implicit per-segment: solve h_out from
                    # F(h_out - h_prev) = htc A (Twall - T(h_out))
                    hh = hprev.copy()
                    for _ in range(30):
                        Tl, _, Tv, _ = region_state(side.sat, tabs[mode], hh)
                        Tf = Tl + Tv - side.sat.Tsat
                        fval = (f_tube[mode] * (hh - hprev)
                                - self.htc * area_seg * (wloc[:, s] - Tf))
                        # secant derivative of the three-region T(h)
                        eps = 5.0
                        Tl2, _, Tv2, _ = region_state(side.sat, tabs[mode], hh + eps)
                        dT = (Tl2 + Tv2 - side.sat.Tsat - Tf) / eps
                        dfdh = f_tube[mode] + self.htc * area_seg * dT
                        step = fval / np.where(np.abs(dfdh) < 1e-12, 1e-12,
                                               dfdh)
                        hh = hh - np.clip(step, -5e3, 5e3)
                        if np.max(np.abs(fval)) < 1e-6:
                            break
                    # store in flow order
                    hs[mode][:, p, s] = hh
                    q = f_tube[mode] * (hh - hprev)
                    qs[mode][:, p, s] = q
                    q_seg = -q
                    if flipped:
                        q_net[:, S - 1 - s] += q_seg
                    else:
                        q_net[:, s] += q_seg
                    hprev = hh
            heat_rate[:, p, :] = q_net
            w = w + dt * q_net / rho_cp_v
            wall_temp[:, p, :] = w

        fs.set_init(self.v("wall_init_temperature"), wall_init)
        fs.set_init(self.v("wall_temperature"), wall_temp)
        fs.set_init(self.v("heat_rate"), heat_rate)
        for mode, side, flipped in sides:
            fs.set_init(side.flow_tube, f_tube[mode])
            fs.set_init(side.h_in, h_in[mode])
            fs.set_init(side.h, hs[mode])
            T_l, d_l, T_v, d_v = region_state(side.sat, tabs[mode], hs[mode])
            fs.set_init(side.T_liq, T_l)
            fs.set_init(side.d_liq, d_l)
            fs.set_init(side.T_vap, T_v)
            fs.set_init(side.d_vap, d_v)
            fs.set_init(side.heat, qs[mode])
            st_out = getattr(self, f"outlet_{mode}_state")
            fs.set_init(st_out.flow_mol, f_tube[mode] * n_tubes)
            fs.set_init(st_out.enth_mol, hs[mode][:, -1, -1])
            fs.set_init(st_out.pressure, side.sat.P)
            st_in = getattr(self, f"inlet_{mode}_state")
            fs.set_init(st_in.flow_mol, f_tube[mode] * n_tubes)
            fs.set_init(st_in.enth_mol, h_in[mode])
            fs.set_init(st_in.pressure, side.sat.P)
