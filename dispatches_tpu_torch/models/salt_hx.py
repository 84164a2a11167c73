"""Molten-salt / steam shell-and-tube heat exchanger, 0D (counterpart of
``dispatches_tpu/models/salt_hx.py``; the same variables, names, order,
bounds, scales and residual rows).

Counterpart of the IDAES ``HeatExchanger`` (counter-current, Underwood
delta-T callback) as configured by the reference's fossil storage
models: the charge exchanger (water hot side, salt cold side) and the
discharge exchanger (salt hot, water cold), with the Sieder-Tate /
Nusselt-correlation overall-heat-transfer-coefficient constraint the
reference layers on top.

The water side is a Helm ``SteamState`` whose transport and caloric
properties (viscosity, conductivity, cp) are evaluated from the state's
IAPWS-95 ``EosBlock`` (delta, T) variables; the salt side is a
(flow_mass, temperature, pressure) triple with the polynomial
``LiquidPackage`` correlations of ``properties/salts.py``.  The
correlation chain (Re -> Pr -> Nu -> film coefficients -> OHTC) is
inlined into one residual, vectorized over the flowsheet horizon.
The film functions take tensors or plain numbers, so the host-side
initialization sweep evaluates the same correlations.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from dispatches_tpu_torch.core.graph import Flowsheet, UnitModel
from dispatches_tpu_torch.models.steam_cycle import SteamState, underwood_lmtd
from dispatches_tpu_torch.properties import iapws95 as w95
from dispatches_tpu_torch.properties import iapws_transport as wtr
from dispatches_tpu_torch.properties.salts import LiquidPackage, SolarSalt

# residual scales (steam_cycle conventions)
_SP = 1e-5
_SF = 1e-2
_SE = 1e-7
_ST = 1e-1


@dataclass(frozen=True)
class HXGeometry:
    """Shell-and-tube geometry (reference ``data_storage_hx``; the same
    numbers in the GDP design files)."""

    tube_thickness: float = 0.004
    tube_inner_dia: float = 0.032
    tube_outer_dia: float = 0.036
    k_steel: float = 21.5
    n_tubes: int = 20
    shell_inner_dia: float = 1.0

    @property
    def tube_cs_area(self) -> float:
        return math.pi / 4.0 * self.tube_inner_dia**2

    @property
    def tube_out_area(self) -> float:
        return math.pi / 4.0 * self.tube_outer_dia**2

    @property
    def shell_eff_area(self) -> float:
        return (
            math.pi / 4.0 * self.shell_inner_dia**2
            - self.n_tubes * self.tube_out_area
        )

    @property
    def dia_ratio(self) -> float:
        return self.tube_outer_dia / self.tube_inner_dia

    @property
    def log_dia_ratio(self) -> float:
        return math.log(self.dia_ratio)


def salt_nusselt(salt_name: str, re, pr, pr_wall, mu_in, mu_out):
    """Storage-fluid Nusselt correlations by fluid (solar salt: 2019 App
    Energy 233-234 p126; Hitec: 2014 He et al, Exp Therm Fl Sci 59 p9;
    Therminol-66), as the reference's design models use them."""
    if salt_name == "hitec_salt":
        return 1.61 * (re * pr * 0.009) ** 0.63 * (mu_in / mu_out) ** 0.25
    if salt_name == "thermal_oil":
        return 0.36 * re**0.55 * pr**0.33 * (pr / pr_wall) ** 0.14
    # solar salt (default)
    return 0.35 * re**0.6 * pr**0.4 * (pr / pr_wall) ** 0.25 * 2.0**0.2


def film_coefficients(g: "HXGeometry", salt: LiquidPackage,
                      F_salt, T_salt_in, T_salt_out,
                      F_w_mol, rho_w_in, T_w_in, mu_w_out,
                      rho_w_film=None):
    """``(h_salt, h_steam)``: salt- and water-side film coefficients from
    the reference's Nusselt correlations (salt per fluid, see
    :func:`salt_nusselt`; steam: 2001 Zavoico).  Shared by the residual
    and the host-side initialization sweep.

    ``rho_w_film`` optionally evaluates the water-side transport
    properties (viscosity, conductivity) at another density than the
    heat capacity: the GDP design models read vapor-phase transport
    properties at a subcooled tube inlet but the unlabeled ``cp_mol`` of
    the actual state (see :class:`SaltSteamHX` ``water_film_phase``)."""
    mu_s, mu_sw = salt.visc_d(T_salt_in), salt.visc_d(T_salt_out)
    cp_s, cp_sw = salt.cp_mass(T_salt_in), salt.cp_mass(T_salt_out)
    k_s, k_sw = salt.therm_cond(T_salt_in), salt.therm_cond(T_salt_out)
    re_s = F_salt * g.tube_outer_dia / (g.shell_eff_area * mu_s)
    pr_s = cp_s * mu_s / k_s
    pr_sw = cp_sw * mu_sw / k_sw
    nu_s = salt_nusselt(salt.name, re_s, pr_s, pr_sw, mu_s, mu_sw)
    h_salt = k_s * nu_s / g.tube_outer_dia

    if rho_w_film is None:
        rho_w_film = rho_w_in
    mu_w = wtr.visc_d(rho_w_film, T_w_in)
    k_w = wtr.therm_cond(rho_w_film, T_w_in)
    cp_w = w95.cp_dT(rho_w_in / w95.RHOC, T_w_in) / w95.MW  # J/kg/K
    re_w = (F_w_mol * w95.MW * g.tube_inner_dia
            / (g.tube_cs_area * g.n_tubes * mu_w))
    pr_w = cp_w * mu_w / k_w
    nu_w = 0.023 * re_w**0.8 * pr_w**0.33 * (mu_w / mu_w_out) ** 0.14
    h_steam = k_w * nu_w / g.tube_inner_dia
    return h_salt, h_steam


def ohtc_terms(g: "HXGeometry", h_salt, h_steam):
    """``(numerator, denominator)`` of the conduction-resistance OHTC
    closure ``U = num / denom`` (reference ``constraint_hxc_ohtc``)."""
    k2 = 2.0 * g.k_steel
    num = k2 * h_salt * h_steam
    denom = (k2 * h_steam
             + g.tube_outer_dia * g.log_dia_ratio * h_salt * h_steam
             + g.dia_ratio * h_salt * k2)
    return num, denom


class SaltState:
    """Molten-salt stream: (flow_mass, temperature, pressure) and a port,
    the state-variable triple of the reference's salt StateBlocks."""

    def __init__(self, unit: UnitModel, local: str, port: bool = True):
        self.unit = unit
        self.local = local
        self.flow_mass = unit.add_var(f"{local}.flow_mass", lb=0.0, ub=1e4,
                                      init=100.0, scale=100.0)
        self.temperature = unit.add_var(f"{local}.temperature", lb=273.15,
                                        ub=1100.0, init=600.0, scale=100.0)
        self.pressure = unit.add_var(f"{local}.pressure", lb=1e3, ub=1e8,
                                     init=101325.0, scale=1e5)
        self.port = (
            unit.add_port(local, {
                "flow_mass": self.flow_mass,
                "temperature": self.temperature,
                "pressure": self.pressure,
            }) if port else None
        )


class SaltSteamHX(UnitModel):
    """Counter-current 0D salt/steam heat exchanger with a
    correlation-based OHTC.

    ``salt_side="tube"`` is the charge configuration (water condensing on
    the shell, the hot side); ``salt_side="shell"`` the discharge one (hot
    salt on the shell, water heated in the tubes).  Port names are the
    reference's (``shell_inlet``, ``tube_inlet``, ...), so arcs read as
    in the reference flowsheet.  Water phases are declared per instance
    (``water_in_phase``/``water_out_phase``).

    ``water_film_phase``: ``"inlet"`` evaluates the water transport
    properties at the actual inlet state; ``"vap"`` on the vapor branch
    at the inlet temperature (the saturated-vapor auxiliary density at
    ``min(T, 0.9999 Tc)``), as the GDP design models do.
    """

    def __init__(self, fs: Flowsheet, name: str,
                 salt: LiquidPackage = SolarSalt,
                 salt_side: str = "tube",
                 water_in_phase: str = "vap",
                 water_out_phase: str = "wet",
                 water_film_phase: str = "inlet",
                 geometry: Optional[HXGeometry] = None):
        super().__init__(fs, name)
        if salt_side not in ("tube", "shell"):
            raise ValueError("salt_side must be 'tube' or 'shell'")
        if water_film_phase not in ("inlet", "vap"):
            raise ValueError("water_film_phase must be 'inlet' or 'vap'")
        self.salt = salt
        self.salt_side = salt_side
        self.water_film_phase = water_film_phase
        self.geom = g = geometry or HXGeometry()

        water_hot = salt_side == "tube"
        self.water_hot = water_hot
        win = SteamState(self, "shell_inlet" if water_hot else "tube_inlet",
                         water_in_phase)
        wout = SteamState(self, "shell_outlet" if water_hot else "tube_outlet",
                          water_out_phase)
        sin = SaltState(self, "tube_inlet" if water_hot else "shell_inlet")
        sout = SaltState(self, "tube_outlet" if water_hot else "shell_outlet")
        self.water_in, self.water_out = win, wout
        self.salt_in, self.salt_out = sin, sout

        # basin bound only: the design envelope (<= 6000 m2) is an outer
        # inequality of the case studies
        A = self.add_var("area", shape=(), lb=1.0, ub=1e5, init=2000.0,
                         scale=1e3)
        U = self.add_var("overall_heat_transfer_coefficient", lb=0.1,
                         ub=1e4, init=300.0, scale=100.0)
        Q = self.add_var("heat_duty", lb=0.0, ub=2e8, init=5e7, scale=1e7)
        # wide default bounds: the case studies' ``add_bounds`` narrows
        # them after initialization, in the reference's order
        dTin = self.add_var("delta_temperature_in", lb=0.01, ub=500.0,
                            init=40.0, scale=10.0)
        dTout = self.add_var("delta_temperature_out", lb=0.01, ub=500.0,
                             init=40.0, scale=10.0)
        self.area, self.htc, self.heat_duty = A, U, Q
        self.delta_temperature_in, self.delta_temperature_out = dTin, dTout

        # ---- balances ------------------------------------------------
        self.add_eq("water_flow",
                    lambda v, p: v[wout.flow_mol] - v[win.flow_mol],
                    scale=_SF)
        self.add_eq("salt_flow",
                    lambda v, p: v[sout.flow_mass] - v[sin.flow_mass],
                    scale=_SF)
        self.add_eq("water_pressure",
                    lambda v, p: v[wout.pressure] - v[win.pressure],
                    scale=_SP)
        self.add_eq("salt_pressure",
                    lambda v, p: v[sout.pressure] - v[sin.pressure],
                    scale=_SP)
        wsgn = -1.0 if water_hot else 1.0
        self.add_eq("water_energy",
                    lambda v, p: v[win.flow_mol]
                    * (v[wout.enth_mol] - v[win.enth_mol]) - wsgn * v[Q],
                    scale=_SE)
        henth = salt.enth_mass
        self.add_eq("salt_energy",
                    lambda v, p: v[sin.flow_mass]
                    * (henth(v[sout.temperature]) - henth(v[sin.temperature]))
                    - (-wsgn) * v[Q], scale=_SE)

        # ---- counter-current delta-T + Underwood LMTD ----------------
        Twin, Twout = win.temperature, wout.temperature
        if water_hot:
            self.add_eq("delta_T_in_def",
                        lambda v, p: v[dTin]
                        - (v[Twin] - v[sout.temperature]), scale=_ST)
            self.add_eq("delta_T_out_def",
                        lambda v, p: v[dTout]
                        - (v[Twout] - v[sin.temperature]), scale=_ST)
        else:
            self.add_eq("delta_T_in_def",
                        lambda v, p: v[dTin]
                        - (v[sin.temperature] - v[Twout]), scale=_ST)
            self.add_eq("delta_T_out_def",
                        lambda v, p: v[dTout]
                        - (v[sout.temperature] - v[Twin]), scale=_ST)
        self.add_eq("heat_transfer",
                    lambda v, p: v[Q]
                    - v[U] * v[A] * underwood_lmtd(v[dTin], v[dTout]),
                    scale=_SE)

        # ---- OHTC correlation ---------------------------------------
        # water-side properties at the water inlet EoS state; the
        # 0.14-power viscosity-ratio factor at the outlet state on its
        # condensed (charge) or vaporized (discharge) branch
        win_eos = win.eos()
        wout_eos = wout.eos()

        def mu_out_water(v):
            if wout_eos.phase == "wet":
                d = v[wout_eos.delta_l] if water_hot else v[wout_eos.delta_v]
            else:
                d = v[wout_eos.delta]
            return wtr.visc_d(d * w95.RHOC, v[wout_eos.T])

        def film_coeffs(v):
            rho_film = None
            if self.water_film_phase == "vap":
                rho_film = w95.sat_rhov_aux(
                    torch.clamp(v[win_eos.T], max=0.9999 * w95.TC))
            return film_coefficients(
                g, salt,
                v[sin.flow_mass], v[sin.temperature], v[sout.temperature],
                v[win.flow_mol], v[win_eos.delta] * w95.RHOC, v[win_eos.T],
                mu_out_water(v),
                rho_w_film=rho_film,
            )

        self._film_coeffs = film_coeffs

        def ohtc_residual(v, p):
            h_salt, h_steam = film_coeffs(v)
            num, denom = ohtc_terms(g, h_salt, h_steam)
            return (v[U] * denom - num) * 1e-8

        self.add_eq("ohtc", ohtc_residual)

    # ---- the reference's port names ---------------------------------

    @property
    def shell_inlet(self):
        return (self.water_in if self.water_hot else self.salt_in).port

    @property
    def shell_outlet(self):
        return (self.water_out if self.water_hot else self.salt_out).port

    @property
    def tube_inlet(self):
        return (self.salt_in if self.water_hot else self.water_in).port

    @property
    def tube_outlet(self):
        return (self.salt_out if self.water_hot else self.water_out).port
