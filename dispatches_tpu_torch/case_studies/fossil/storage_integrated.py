"""Integrated USC plant + molten-salt thermal-energy storage, fixed
design (counterpart of ``dispatches_tpu/case_studies/fossil/
storage_integrated.py``; the same units, arcs, variables, rows, inputs
and initialization).

Counterpart of the reference's ``fossil_case/ultra_supercritical_plant/
storage/integrated_storage_with_ultrasupercritical_power_plant.py``: the
437 MW ultra-supercritical plant with the optimal storage design (solar
salt, HP steam source) integrated as a charge + discharge heat-exchanger
train in one NLP: HP steam diverted after reheater 1 through the charge
HX, condensate returned through a cooler, an HX pump and a recycle mixer
into FWH8, feedwater diverted after the BFP through the discharge HX
into a storage turbine, with Sieder-Tate OHTC correlations, plant and
storage costing, salt inventory balances and the hot_empty / half_full /
hot_full tank scenarios of ``model_analysis``.

* The integration is more residuals on the plant's ``Flowsheet``;
  ``model_analysis`` compiles one NLP with objective and inequalities
  and solves it in reduced space (``solvers/reduced.py``): Newton on the
  square plant on the device, SciPy's ``trust-constr`` over the six
  operating decisions on the host.
* The reference's sequential ``initialize`` ladder (one IPOPT
  subprocess per unit) is a host-side numpy/SciPy sweep writing warm
  starts (``_hx_sweep`` brackets each salt HX's outlet temperature with
  ``brentq`` over the port's numpy flashes), followed by one Newton
  solve of the square system.
* The cooler's saturation-margin constraint uses a two-phase EoS block
  pinned to the cooler outlet pressure, whose temperature variable is
  T_sat(P).
* Checkpoints (``save_initialized``, ``save_analysis_solution``,
  ``main(load_from_file=)``) are the JAX package's files: each package
  reads what the other writes.

Every entry point that solves (``main``, ``model_analysis``) runs on
``device``: ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from scipy import optimize as sopt

from dispatches_tpu_torch import resolve_device
from dispatches_tpu_torch.case_studies.fossil import usc_plant as up
from dispatches_tpu_torch.case_studies.fossil.usc_plant import UscModel
from dispatches_tpu_torch.models.salt_hx import SaltSteamHX, film_coefficients, ohtc_terms
from dispatches_tpu_torch.models.steam_cycle import (
    EosBlock,
    SteamHeater,
    SteamIsentropicCompressor,
    SteamMixer,
    SteamSplitter,
    SteamTurbineStage,
)
from dispatches_tpu_torch.properties import iapws95 as w95
from dispatches_tpu_torch.properties import iapws_transport as wtr
from dispatches_tpu_torch.solvers.newton import NewtonOptions, solve_square
from dispatches_tpu_torch.utils.checkpoint import load_state, save_state

# ---------------------------------------------------------------------
# Storage design data (reference ``set_model_input``, :566-618, and
# ``model_analysis``, :1294-1310)
# ---------------------------------------------------------------------

HXC_AREA_INIT = 2500.0  # m2 (fixed during initialization, :583)
HXD_AREA_INIT = 2000.0  # m2 (:584)
HXC_SALT_FLOW_INIT = 140.0  # kg/s (:589)
HXC_SALT_T_IN = 513.15  # K cold salt (:590)
HXD_SALT_FLOW_INIT = 200.0  # kg/s (:593)
HXD_SALT_T_IN_INIT = 853.15  # K hot salt during init (:594)
SALT_PRESSURE = 101325.0  # Pa (:591,595)
COOLER_ENTH_INIT = 10000.0  # J/mol (:601)
HX_PUMP_EFF = 0.80  # (:605)
ES_TURBINE_RATIO_P = 0.0286  # (:607)
ES_TURBINE_EFF = 0.8  # (:608)
HP_SPLIT_FRAC_INIT = 0.1  # to_hxc (:615)
BFP_SPLIT_FRAC_INIT = 0.12  # to_hxd (:616)

SALT_HOT_TEMPERATURE = 831.0  # K (``model_analysis``, :1305-1310)
# the reference's optimal design areas (``model_analysis`` warm start
# :1306-1307; FIXED design values in the multiperiod model,
# ``usc_unfix_dof`` :191-192 — consumed by ``storage_multiperiod``)
HXC_AREA_GUESS = 1904.0  # m2
HXD_AREA_GUESS = 2830.0  # m2

# costing data (:740-766)
CE_INDEX = 607.5
COAL_PRICE = 2.11e-9  # $/J
COOLING_PRICE = 3.3e-9  # $/J
NUM_OF_YEARS = 30.0
SALT_AMOUNT = 6739292.0  # kg (:801-805)
STORAGE_CAPITAL_COST = 0.407655e6  # $/yr, solar salt, fixed param (:821-823)
OPERATING_HOURS = 365.0 * 3600.0 * 24.0  # s/yr (:828-830, hours_per_day=24)
MAX_BOILER_DUTY = 940.0  # MW (:473-477)

# salt-inventory data (``model_analysis``, :1331-1333)
INVENTORY_MAX = 1e7  # kg
INVENTORY_MIN = 75000.0  # kg
TANK_MAX = SALT_AMOUNT

MAX_STORAGE_POWER = 29.0  # MW (:1272)
MIN_STORAGE_POWER = 1.0  # MW (:1273)

#: the converged hot_empty decisions of ``model_analysis`` (LMP 22, 436 MW,
#: storage free): a warm start for that analysis
HOT_EMPTY_WARM_U = {
    "boiler.inlet.flow_mol": 17899.89506345896,
    "ess_hp_split.split_fraction_2": 0.001000014492280996,
    "ess_bfp_split.split_fraction_2": 0.013236748147097556,
    "hxc.tube_inlet.flow_mass": 1.2809660767209357,
    "hxd.shell_inlet.flow_mass": 20.83321382396634,
    "cooler.outlet.enth_mol": 21998.38312762408,
}

#: one-unit salt HX cases at the initialization checkpoint's inlets:
#: (salt_side, water_in, water_out, steam inlet (F, h, P), salt flow kg/s,
#: salt inlet K, area m2).  The charge HX condenses HP steam from
#: reheater 1 against cold salt, the discharge HX heats supercritical
#: feedwater after the BFP with hot salt.
HX_UNIT_CASES = {
    "charge": ("tube", "vap", "wet", dict(F=1393.728, h=65223.313, P=8604660.3),
               140.0, 513.15, 2500.0),
    "discharge": ("shell", "liq", "sc", dict(F=2244.583, h=16337.657, P=34957588.1),
                  200.0, 853.15, 2000.0),
}


# ---------------------------------------------------------------------
# Model construction
# ---------------------------------------------------------------------

def create_integrated_model(m: UscModel, max_power: float = 436.0) -> UscModel:
    """Add the TES charge/discharge train to a built USC plant model
    (reference ``create_integrated_model``, :78-425)."""
    fs, u = m.fs, m.units

    u["ess_hp_split"] = SteamSplitter(fs, "ess_hp_split", num_outlets=2)
    u["ess_bfp_split"] = SteamSplitter(fs, "ess_bfp_split", num_outlets=2)
    u["cooler"] = SteamHeater(fs, "cooler", inlet_phase="wet",
                              outlet_phase="liq")
    u["hx_pump"] = SteamIsentropicCompressor(fs, "hx_pump")
    u["recycle_mixer"] = SteamMixer(
        fs, "recycle_mixer", inlet_list=["from_bfw_out", "from_hx_pump"],
        outlet_phase="liq", momentum="from_bfw_out",
    )
    # charge HX: condensing HP steam (shell, hot) vs solar salt (tube)
    u["hxc"] = SaltSteamHX(fs, "hxc", salt_side="tube",
                           water_in_phase="vap", water_out_phase="wet")
    # discharge HX: hot salt (shell) vs supercritical feedwater (tube)
    u["hxd"] = SaltSteamHX(fs, "hxd", salt_side="shell",
                           water_in_phase="liq", water_out_phase="sc")
    u["es_turbine"] = SteamTurbineStage(fs, "es_turbine", inlet_phase="sc",
                                        outlet_phase="wet",
                                        isentropic_phase="wet")

    _create_arcs(m)
    _make_constraints(m, max_power)
    return m


def _create_arcs(m: UscModel) -> None:
    """Rewire the plant around the storage train (reference
    ``_create_arcs``, :502-563)."""
    fs, u = m.fs, m.units

    # disconnect reheater1 -> turbine3 and bfp -> fwh8 (:508-512)
    fs.deactivate("rh1_to_turb3")
    fs.deactivate("bfp_to_fwh8")

    fs.connect(u["reheater_1"].outlet, u["ess_hp_split"].inlet,
               name="rh1_to_esshp")
    fs.connect(u["ess_hp_split"].outlet(1), u["turbine_3"].inlet,
               name="esshp_to_turb3")
    fs.connect(u["ess_hp_split"].outlet(2), u["hxc"].shell_inlet,
               name="esshp_to_hxc")
    fs.connect(u["hxc"].shell_outlet, u["cooler"].inlet,
               name="hxc_to_cooler")
    fs.connect(u["cooler"].outlet, u["hx_pump"].inlet,
               name="cooler_to_hxpump")
    fs.connect(u["hx_pump"].outlet, u["recycle_mixer"].inlet("from_hx_pump"),
               name="hxpump_to_recyclemix")
    fs.connect(u["bfp"].outlet, u["ess_bfp_split"].inlet,
               name="bfp_to_essbfp")
    fs.connect(u["ess_bfp_split"].outlet(1),
               u["recycle_mixer"].inlet("from_bfw_out"),
               name="essbfp_to_recyclemix")
    fs.connect(u["ess_bfp_split"].outlet(2), u["hxd"].tube_inlet,
               name="essbfp_to_hxd")
    fs.connect(u["hxd"].tube_outlet, u["es_turbine"].inlet,
               name="hxd_to_esturbine")
    fs.connect(u["recycle_mixer"].outlet, u["fwh_8"].tube_inlet,
               name="recyclemix_to_fwh8")

    # the makeup stream now replenishes the feedwater leaving through
    # the storage turbine (es_turbine outlet is an open stream) — widen
    # the base plant's near-zero makeup bound
    mk = u["condenser_mix"].inlet_states["makeup"]
    fs.set_bounds(mk.flow_mol, lb=0.0, ub=up.MAIN_FLOW)


def _make_constraints(m: UscModel, max_power: float) -> None:
    """Integrated-model constraints (reference ``_make_constraints``,
    :428-499)."""
    fs, u = m.fs, m.units

    # cooler saturation block: T_sat at the cooler outlet pressure via a
    # two-phase EoS block (pressure-consistency + Maxwell rows); its
    # vapor fraction is inert and fixed
    cooler = u["cooler"]
    sat = EosBlock(cooler, "sat", "wet", cooler.outlet_state.pressure)
    fs.fix(sat.x, 0.5)
    cooler.sat_block = sat
    T_out = cooler.outlet_state.temperature
    # subcooling margin (:433-439); inactive for the square solve (the
    # Newton path ignores inequalities) — enforced by the IPM
    fs.add_ineq("cooler.subcooled",
                lambda v, p: v[T_out] - (v[sat.T] - 5.0), scale=1e-1)

    # HX pump discharges at BFP outlet pressure (:442-446) — realized as
    # a fix in set_model_input

    # production constraint now charges the HX pump against the turbines
    # (:455-465)
    fs.deactivate("production_cons")
    tw = [u[f"turbine_{i}"].work_mechanical for i in range(1, 12)]
    Wp = u["hx_pump"].work_mechanical
    fs.add_eq("production_cons_with_storage",
              lambda v, p: -sum(v[w] for w in tw) - v[Wp]
              - v["plant_power_out"] * 1e6, scale=1e-7)

    # net power = plant + storage turbine (:467-471)
    net = fs.add_var("net_power", lb=0.0, ub=2000.0, init=437.0, scale=100.0)
    We = u["es_turbine"].work_mechanical
    fs.add_eq("net_power_def",
              lambda v, p: v[net] - v["plant_power_out"]
              + 1e-6 * v[We], scale=1e-2)

    # coal heat duty through the part-load boiler-efficiency curve
    # (:479-494)
    coal = fs.add_var("coal_heat_duty", lb=0.0, ub=1e5, init=1000.0,
                      scale=1e3)
    fs.add_eq("coal_heat_duty_eq",
              lambda v, p: v[coal]
              * (0.2143 * (v["plant_heat_duty"] / MAX_BOILER_DUTY) + 0.7357)
              - v["plant_heat_duty"], scale=1e-2)


def set_model_input(m: UscModel) -> None:
    """Fix storage DoF for the square initialization problem (reference
    ``set_model_input``, :566-618)."""
    fs, u = m.fs, m.units

    fs.fix(u["hxc"].area, HXC_AREA_INIT)
    fs.fix(u["hxd"].area, HXD_AREA_INIT)

    hxc, hxd = u["hxc"], u["hxd"]
    fs.fix(hxc.salt_in.flow_mass, HXC_SALT_FLOW_INIT)
    fs.fix(hxc.salt_in.temperature, HXC_SALT_T_IN)
    fs.fix(hxc.salt_in.pressure, SALT_PRESSURE)
    fs.fix(hxd.salt_in.flow_mass, HXD_SALT_FLOW_INIT)
    fs.fix(hxd.salt_in.temperature, HXD_SALT_T_IN_INIT)
    fs.fix(hxd.salt_in.pressure, SALT_PRESSURE)

    fs.fix(u["cooler"].outlet_state.enth_mol, COOLER_ENTH_INIT)
    fs.fix(u["cooler"].deltaP, 0.0)
    fs.fix(u["hx_pump"].efficiency_isentropic, HX_PUMP_EFF)
    fs.fix(u["hx_pump"].outlet_state.pressure,
           up.MAIN_STEAM_PRESSURE * up.BFP_PRESSURE_FACTOR)
    fs.fix(u["es_turbine"].ratioP, ES_TURBINE_RATIO_P)
    fs.fix(u["es_turbine"].efficiency_isentropic, ES_TURBINE_EFF)

    fs.fix(u["ess_hp_split"].split_fraction[1], HP_SPLIT_FRAC_INIT)
    fs.fix(u["ess_bfp_split"].split_fraction[1], BFP_SPLIT_FRAC_INIT)


def build_costing(m: UscModel) -> UscModel:
    """Plant + storage cost correlations (reference ``build_costing``,
    :719-888).  All costs are $/yr; the storage capital cost is the
    fixed annualized solar-salt figure (:821-823)."""
    fs, u = m.fs, m.units

    op = fs.add_var("operating_cost", lb=0.0, ub=1e12, init=1e6, scale=1e7)
    Qcool = u["cooler"].heat_duty
    fs.add_eq("op_cost_eq",
              lambda v, p: v[op] - (
                  OPERATING_HOURS * COAL_PRICE * (v["coal_heat_duty"] * 1e6)
                  - COOLING_PRICE * OPERATING_HOURS * v[Qcool]
              ), scale=1e-7)

    cap = fs.add_var("plant_capital_cost", lb=0.0, ub=1e12, init=1e6,
                     scale=1e7)
    fs.add_eq("plant_cap_cost_eq",
              lambda v, p: v[cap]
              - (2688973.0 * v["plant_power_out"] + 618968072.0)
              / NUM_OF_YEARS * (CE_INDEX / 575.4), scale=1e-7)

    fop = fs.add_var("plant_fixed_operating_cost", lb=0.0, ub=1e12,
                     init=1e6, scale=1e6)
    fs.add_eq("op_fixed_plant_cost_eq",
              lambda v, p: v[fop]
              - (16657.5 * v["plant_power_out"] + 6109833.3)
              / NUM_OF_YEARS * (CE_INDEX / 575.4), scale=1e-6)

    vop = fs.add_var("plant_variable_operating_cost", lb=0.0, ub=1e12,
                     init=1e6, scale=1e7)
    fs.add_eq("op_variable_plant_cost_eq",
              lambda v, p: v[vop]
              - 31754.7 * v["plant_power_out"] * (CE_INDEX / 575.4),
              scale=1e-7)
    return m


def add_bounds(m: UscModel) -> None:
    """Storage-train bounds (reference ``add_bounds``, :936-1073)."""
    fs, u = m.fs, m.units
    flow_max = up.MAIN_FLOW * 3.0
    salt_flow_max = 500.0
    heat_duty_max = 200e6

    for hx in (u["hxc"], u["hxd"]):
        win, wout = hx.water_in, hx.water_out
        fs.set_bounds(win.flow_mol, lb=0.0, ub=0.2 * flow_max)
        fs.set_bounds(wout.flow_mol, lb=0.0, ub=0.2 * flow_max)
        sin, sout = hx.salt_in, hx.salt_out
        fs.set_bounds(sin.flow_mass, lb=0.0, ub=salt_flow_max)
        fs.set_bounds(sout.flow_mass, lb=0.0, ub=salt_flow_max)
        fs.set_bounds(sin.pressure, lb=101320.0, ub=101330.0)
        fs.set_bounds(sout.pressure, lb=101320.0, ub=101330.0)
        fs.set_bounds(hx.heat_duty, lb=0.0, ub=heat_duty_max)
        fs.set_bounds(hx.htc, lb=0.1, ub=10000.0)
        fs.set_bounds(hx.area, lb=1.0, ub=6000.0)

    # delta-T envelopes (:977-980, :1009-1012)
    hxc, hxd = u["hxc"], u["hxd"]
    fs.set_bounds(hxc.delta_temperature_in, lb=9.0, ub=80.5)
    fs.set_bounds(hxc.delta_temperature_out, lb=5.0, ub=81.0)
    fs.set_bounds(hxd.delta_temperature_in, lb=4.9, ub=300.0)
    fs.set_bounds(hxd.delta_temperature_out, lb=10.0, ub=300.0)

    for unit in (u["hx_pump"], u["cooler"]):
        fs.set_bounds(unit.inlet_state.flow_mol, lb=0.0, ub=0.2 * flow_max)
        fs.set_bounds(unit.outlet_state.flow_mol, lb=0.0, ub=0.2 * flow_max)
    fs.set_bounds(u["cooler"].heat_duty, lb=-1e10, ub=0.0)
    fs.set_bounds(u["hx_pump"].work_mechanical, lb=0.0, ub=1e10)

    for sp in ("ess_hp_split", "ess_bfp_split"):
        split = u[sp]
        fs.set_bounds(split.inlet_state.flow_mol, lb=0.0, ub=flow_max)
        fs.set_bounds(split.outlet_states[0].flow_mol, lb=0.0, ub=flow_max)
        fs.set_bounds(split.outlet_states[1].flow_mol, lb=0.0,
                      ub=0.2 * flow_max)

    rmix = u["recycle_mixer"]
    fs.set_bounds(rmix.inlet_states["from_bfw_out"].flow_mol, lb=0.0,
                  ub=flow_max)
    fs.set_bounds(rmix.inlet_states["from_hx_pump"].flow_mol, lb=0.0,
                  ub=0.2 * flow_max)
    fs.set_bounds(rmix.outlet_state.flow_mol, lb=0.0, ub=flow_max)


# ---------------------------------------------------------------------
# Host-side initialization
# ---------------------------------------------------------------------

def _iv(fs, name) -> float:
    """Current scalar init value of a variable (first time slot)."""
    spec = fs.var_specs[name]
    val = spec.fixed_value if spec.fixed else spec.init
    return float(np.ravel(np.asarray(val))[0])


def _stream_init(fs, state) -> Dict[str, float]:
    return dict(F=_iv(fs, state.flow_mol), h=_iv(fs, state.enth_mol),
                P=_iv(fs, state.pressure))


def _hx_sweep(fs, hx: SaltSteamHX, steam: Dict[str, float],
              F_salt: float, T_salt_in: float, area: float,
              water_hot: bool) -> Dict[str, float]:
    """Warm-start one salt HX by solving the 1-unknown (T_salt_out)
    steady-state host problem: salt duty == UA * LMTD with the
    correlation-based U — the role of the reference's per-unit
    ``hxc.initialize()`` IPOPT subproblem (:668-696)."""
    salt = hx.salt
    g = hx.geom
    F_w, h_in, P_w = steam["F"], steam["h"], steam["P"]
    st_in = w95.flash_hp(h_in, P_w)
    T_w_in = float(st_in["T"])
    rho_w_in = float(
        (st_in["delta_v"] if st_in["phase"] in ("vap", "two-phase")
         else st_in["delta_l"]) * w95.RHOC
    ) if water_hot else float(st_in["delta_l"] * w95.RHOC)

    def duty(Ts_out):
        return F_salt * float(salt.enth_mass(Ts_out) - salt.enth_mass(T_salt_in))

    def resid(Ts_out):
        Q = duty(Ts_out) if water_hot else -duty(Ts_out)
        # Q > 0 always (salt heats up in charge, cools in discharge)
        Q = abs(Q)
        h_out = h_in + (-Q if water_hot else Q) / F_w
        st_out = w95.flash_hp(h_out, P_w)
        T_w_out = float(st_out["T"])
        if water_hot:
            dTin, dTout = T_w_in - Ts_out, T_w_out - T_salt_in
        else:
            dTin, dTout = T_salt_in - T_w_out, Ts_out - T_w_in
        lmtd = (0.5 * (np.cbrt(dTin) + np.cbrt(dTout))) ** 3
        # film coefficients: the correlation functions the residual uses
        if water_hot:
            rho_out = float(st_out["delta_l"] * w95.RHOC) \
                if st_out["phase"] in ("liq", "two-phase") \
                else float(st_out["delta_v"] * w95.RHOC)
        else:
            rho_out = float(
                (st_out["delta_v"] if st_out["phase"] in ("vap", "two-phase")
                 else st_out["delta_l"]) * w95.RHOC)
        mu_w_out = float(wtr.visc_d(rho_out, float(st_out["T"])))
        rho_film = None
        if getattr(hx, "water_film_phase", "inlet") == "vap":
            rho_film = float(w95.sat_rhov_aux(min(T_w_in, 0.9999 * w95.TC)))
        h_salt, h_steam = film_coefficients(
            g, salt, F_salt, T_salt_in, Ts_out, F_w, rho_w_in, T_w_in,
            mu_w_out, rho_w_film=rho_film)
        num, denom = ohtc_terms(g, float(h_salt), float(h_steam))
        U = num / denom
        return Q - U * area * lmtd, (Q, h_out, U, dTin, dTout, st_out)

    # bracket the salt outlet temperature (permissive: design-envelope
    # delta-T bounds are applied after initialization)
    if water_hot:
        lo, hi = T_salt_in + 0.5, T_w_in - 0.05
    else:
        lo, hi = T_w_in + 0.5, T_salt_in - 0.05
    Ts = sopt.brentq(lambda t: resid(t)[0], lo, hi, xtol=1e-8)
    _, (Q, h_w_out, U, dTin, dTout, st_out) = resid(Ts)

    # write warm starts
    win, wout = hx.water_in, hx.water_out
    up._set_state_init(fs, win, F_w, h_in, P_w)
    up._set_state_init(fs, wout, F_w, h_w_out, P_w)
    sin, sout = hx.salt_in, hx.salt_out
    fs.set_init(sin.flow_mass, F_salt)
    fs.set_init(sin.temperature, T_salt_in)
    fs.set_init(sin.pressure, SALT_PRESSURE)
    fs.set_init(sout.flow_mass, F_salt)
    fs.set_init(sout.temperature, Ts)
    fs.set_init(sout.pressure, SALT_PRESSURE)
    fs.set_init(hx.htc, U)
    fs.set_init(hx.heat_duty, Q)
    fs.set_init(hx.delta_temperature_in, dTin)
    fs.set_init(hx.delta_temperature_out, dTout)
    return dict(F=F_w, h=h_w_out, P=P_w, Q=Q, Ts_out=Ts)


def initialize(m: UscModel) -> None:
    """Host warm-start sweep for the storage train (reference
    ``initialize``, :641-716).  Assumes ``up.initialize(m)`` has already
    seeded the plant side."""
    fs, u = m.fs, m.units

    # --- HP split --------------------------------------------------------
    rh1 = _stream_init(fs, u["reheater_1"].outlet_state)
    sp = u["ess_hp_split"]
    frac = _iv(fs, sp.split_fraction[1])
    up._set_state_init(fs, sp.inlet_state, rh1["F"], rh1["h"], rh1["P"])
    fs.set_init(sp.split_fraction[0], 1.0 - frac)
    up._set_state_init(fs, sp.outlet_states[0], (1.0 - frac) * rh1["F"],
                       rh1["h"], rh1["P"])
    up._set_state_init(fs, sp.outlet_states[1], frac * rh1["F"],
                       rh1["h"], rh1["P"])

    # --- charge HX + cooler + HX pump -----------------------------------
    chg_steam = dict(F=frac * rh1["F"], h=rh1["h"], P=rh1["P"])
    hxc_out = _hx_sweep(fs, u["hxc"], chg_steam,
                        _iv(fs, u["hxc"].salt_in.flow_mass),
                        _iv(fs, u["hxc"].salt_in.temperature),
                        _iv(fs, u["hxc"].area), water_hot=True)

    cooler = u["cooler"]
    h_cool = _iv(fs, cooler.outlet_state.enth_mol)
    up._set_state_init(fs, cooler.inlet_state, hxc_out["F"], hxc_out["h"],
                       hxc_out["P"])
    up._set_state_init(fs, cooler.outlet_state, hxc_out["F"], h_cool,
                       hxc_out["P"])
    fs.set_init(cooler.heat_duty, hxc_out["F"] * (h_cool - hxc_out["h"]))
    # saturation block at the cooler outlet pressure
    Ts, dl, dv = w95.sat_solve_P(hxc_out["P"])
    sat = cooler.sat_block
    fs.set_init(sat.T, Ts)
    fs.set_init(sat.delta_l, dl)
    fs.set_init(sat.delta_v, dv)

    pump = u["hx_pump"]
    P_out = _iv(fs, pump.outlet_state.pressure)
    s_in = w95.flash_hp(h_cool, hxc_out["P"])["s"]
    h_iso = w95.h_ps(P_out, s_in, "liq")
    h_pump_out = h_cool + (h_iso - h_cool) / HX_PUMP_EFF
    up._set_state_init(fs, pump.inlet_state, hxc_out["F"], h_cool,
                       hxc_out["P"])
    up._set_state_init(fs, pump.outlet_state, hxc_out["F"], h_pump_out, P_out)
    up._set_iso_init(fs, pump, h_iso, P_out)
    fs.set_init(pump.work_mechanical, hxc_out["F"] * (h_pump_out - h_cool))
    fs.set_init(pump.ratioP, P_out / hxc_out["P"])
    fs.set_init(pump.deltaP, P_out - hxc_out["P"])

    # --- BFP split + recycle mixer --------------------------------------
    bfp = _stream_init(fs, u["bfp"].outlet_state)
    spb = u["ess_bfp_split"]
    fracb = _iv(fs, spb.split_fraction[1])
    up._set_state_init(fs, spb.inlet_state, bfp["F"], bfp["h"], bfp["P"])
    fs.set_init(spb.split_fraction[0], 1.0 - fracb)
    up._set_state_init(fs, spb.outlet_states[0], (1.0 - fracb) * bfp["F"],
                       bfp["h"], bfp["P"])
    up._set_state_init(fs, spb.outlet_states[1], fracb * bfp["F"],
                       bfp["h"], bfp["P"])

    rmix = u["recycle_mixer"]
    F_bfw = (1.0 - fracb) * bfp["F"]
    F_mix = F_bfw + hxc_out["F"]
    h_mix = (F_bfw * bfp["h"] + hxc_out["F"] * h_pump_out) / F_mix
    up._set_state_init(fs, rmix.inlet_states["from_bfw_out"], F_bfw,
                       bfp["h"], bfp["P"])
    up._set_state_init(fs, rmix.inlet_states["from_hx_pump"], hxc_out["F"],
                       h_pump_out, P_out)
    up._set_state_init(fs, rmix.outlet_state, F_mix, h_mix, bfp["P"])

    # --- discharge HX + storage turbine ---------------------------------
    dis_steam = dict(F=fracb * bfp["F"], h=bfp["h"], P=bfp["P"])
    hxd_out = _hx_sweep(fs, u["hxd"], dis_steam,
                        _iv(fs, u["hxd"].salt_in.flow_mass),
                        _iv(fs, u["hxd"].salt_in.temperature),
                        _iv(fs, u["hxd"].area), water_hot=False)

    est = u["es_turbine"]
    P_es = ES_TURBINE_RATIO_P * hxd_out["P"]
    s_es = w95.flash_hp(hxd_out["h"], hxd_out["P"])["s"]
    h_es_iso = w95.h_ps(P_es, s_es, "vap")
    h_es_out = hxd_out["h"] + ES_TURBINE_EFF * (h_es_iso - hxd_out["h"])
    up._set_state_init(fs, est.inlet_state, hxd_out["F"], hxd_out["h"],
                       hxd_out["P"])
    up._set_state_init(fs, est.outlet_state, hxd_out["F"], h_es_out, P_es)
    up._set_iso_init(fs, est, h_es_iso, P_es)
    W_es = hxd_out["F"] * (h_es_out - hxd_out["h"])
    fs.set_init(est.work_mechanical, W_es)
    fs.set_init(est.deltaP, P_es - hxd_out["P"])

    # --- makeup replaces the open es_turbine outlet stream --------------
    mk = u["condenser_mix"].inlet_states["makeup"]
    fs.set_init(mk.flow_mol, hxd_out["F"])

    # --- reporting / costing warm starts --------------------------------
    fs.set_init("net_power", 437.0 - 1e-6 * W_es)
    heat = _iv(fs, "plant_heat_duty")
    eff = 0.2143 * heat / MAX_BOILER_DUTY + 0.7357
    fs.set_init("coal_heat_duty", heat / eff)


def initialize_costing(m: UscModel) -> None:
    """Warm-start the costing variables from current inits (reference
    ``initialize_with_costing``, :891-917)."""
    fs = m.fs
    coal = _iv(fs, "coal_heat_duty")
    Qcool = _iv(fs, m.units["cooler"].heat_duty)
    power = _iv(fs, "plant_power_out")
    fs.set_init("operating_cost",
                OPERATING_HOURS * COAL_PRICE * coal * 1e6
                - COOLING_PRICE * OPERATING_HOURS * Qcool)
    fs.set_init("plant_capital_cost",
                (2688973.0 * power + 618968072.0) / NUM_OF_YEARS
                * (CE_INDEX / 575.4))
    fs.set_init("plant_fixed_operating_cost",
                (16657.5 * power + 6109833.3) / NUM_OF_YEARS
                * (CE_INDEX / 575.4))
    fs.set_init("plant_variable_operating_cost",
                31754.7 * power * (CE_INDEX / 575.4))


def write_back(fs, nlp, x) -> None:
    """Store a solved state as variable inits (warm start for the next
    compile — the role of the reference's ``to_json`` checkpoint,
    :1076-1096)."""
    sol = nlp.unravel(x)
    for name in nlp.free_names:
        fs.set_init(name, sol[name])


def save_initialized(m: UscModel, path) -> None:
    """Checkpoint every variable's current init/fixed value — the role of
    the reference's ``initialized_integrated_storage_usc.json`` snapshot
    consumed by ``main(load_from_file=...)`` (:1076-1096)."""
    fs = m.fs
    tree = {}
    for name, spec in fs.var_specs.items():
        val = spec.fixed_value if spec.fixed else spec.init
        tree[name] = np.broadcast_to(
            np.asarray(val, dtype=np.float64), spec.shape).copy()
    save_state(path, {"inits": tree})


def save_analysis_solution(out: Dict, path) -> None:
    """Checkpoint a converged ``model_analysis`` solution for warm
    restarts (``model_analysis(load_solution=...)``)."""
    save_state(path, {"inits": {k: np.asarray(v, dtype=np.float64)
                                for k, v in out["sol"].items()}})


def _load_initialized(m: UscModel, path) -> None:
    fs = m.fs
    inits = load_state(path)["inits"]
    for name, val in inits.items():
        if name in fs.var_specs and not fs.var_specs[name].fixed:
            spec = fs.var_specs[name]
            if tuple(np.shape(val)) == tuple(spec.shape):
                fs.set_init(name, val)


# ---------------------------------------------------------------------
# Assembly + analysis
# ---------------------------------------------------------------------

def main(max_power: float = 436.0, solve: bool = True,
         load_from_file=None, device=None) -> UscModel:
    """Build + initialize the integrated model (reference ``main``,
    :1076-1124): plant, storage train, inputs, host init, costing,
    then one square Newton solve on ``device`` (``cuda`` unless given)
    standing in for the reference's initialization solves.
    ``load_from_file`` replaces the host initialization sweeps with a
    saved state (reference :1078-1096; the JAX package's checkpoint files
    load as they are) which the Newton solve then verifies."""
    dev = resolve_device(device)
    m = up.build_plant_model()
    if load_from_file is None:
        up.initialize(m)
    create_integrated_model(m, max_power=max_power)
    set_model_input(m)
    if load_from_file is None:
        initialize(m)
    build_costing(m)
    if load_from_file is None:
        initialize_costing(m)
    else:
        _load_initialized(m, load_from_file)
    if solve:
        nlp = m.fs.compile()
        res = solve_square(nlp, device=dev)
        if not bool(res.converged):
            raise RuntimeError(
                f"integrated-model square initialization did not converge "
                f"(max residual {float(res.max_residual):.3e})")
        write_back(m.fs, nlp, res.x)
        m.init_nlp, m.init_res = nlp, res
    # NOTE the reference applies ``add_bounds`` here (:1122, after the
    # initialization solves).  The reduced-space ``model_analysis``
    # instead enforces the same envelope as explicit inequalities so the
    # inner Newton states keep their wide basin bounds; call
    # ``add_bounds(m)`` only for full-space solves.
    return m


def model_analysis(m: UscModel,
                   power: Optional[float] = None,
                   max_power: float = 436.0,
                   tank_scenario: str = "hot_empty",
                   fix_power: bool = False,
                   lmp: float = 22.0,
                   maxiter: int = 300,
                   warm_start: Optional[Dict[str, float]] = None,
                   load_solution=None,
                   verbose: int = 0,
                   device=None):
    """Storage operating optimization (reference ``model_analysis``,
    :1262-1439): fixed hot/cold salt temperatures, salt-inventory
    balance for the chosen tank scenario, revenue-vs-cost objective.

    Reduced-space formulation: the six operating decisions (boiler
    flow, the two storage split fractions, the two salt flows, the
    cooler outlet enthalpy) drive the ~800-state square plant through
    the Newton inner solver on ``device`` (``cuda`` unless given); the
    reference's variable bounds
    (``add_bounds``, :936-1073, and the power/storage-power limits
    :1280-1291) become outer inequalities with exact adjoint gradients.
    The HX areas are free states (:1316-1324); the salt-inventory end
    states are eliminated: ``inv_hot = prev_hot + 3600(F_hxc − F_hxd)``.
    """
    from dispatches_tpu_torch.solvers.reduced import ReducedSpaceNLP

    dev = resolve_device(device)
    fs, u = m.fs, m.units
    hxc, hxd = u["hxc"], u["hxd"]
    min_power = float(int(0.65 * max_power))

    # repeat calls re-use the registered constraint set with updated
    # params (scenario inventories, LMP, power envelope); the fix_power
    # mode changes the constraint STRUCTURE and must stay consistent
    prev_mode = getattr(m, "_analysis_fix_power", None)
    if prev_mode is not None and prev_mode != bool(fix_power):
        raise ValueError(
            "model_analysis was already configured with "
            f"fix_power={prev_mode}; rebuild the model to switch modes")
    m._analysis_fix_power = bool(fix_power)
    if fix_power and power is None:
        raise ValueError("fix_power=True requires a power demand value")

    fs.add_param("lmp", lmp)
    fs.add_param("plant_power_lo", min_power)
    fs.add_param("plant_power_hi", max_power)
    if power is not None:
        fs.add_param("power_demand", power)

    # fixed salt temperatures; areas become free states, warm-started
    # from the initialization solution (:1304-1324)
    fs.fix(hxc.salt_out.temperature, SALT_HOT_TEMPERATURE)
    fs.fix(hxd.salt_in.temperature, SALT_HOT_TEMPERATURE)
    fs.fix(hxd.salt_out.temperature, HXC_SALT_T_IN)
    for hx in (hxc, hxd):
        spec = fs.var_specs[hx.area]
        if spec.fixed:
            fs.set_init(hx.area, spec.fixed_value)
            fs.unfix(hx.area)

    Fc, Fd = hxc.salt_in.flow_mass, hxd.salt_in.flow_mass
    # inner-feasible starting salt flows: with BOTH salt temperatures now
    # pinned, the initialization flows (140/200 kg/s, :589-593) admit no
    # square solution with positive approach temperatures — the steam
    # sides cannot carry the implied duties at the initialization split
    # fractions.  Start inside the feasible basin instead (the optimum
    # does not depend on the warm start).
    fs.fix(Fc, 100.0)
    fs.fix(Fd, 20.0)
    if warm_start:
        for name, val in warm_start.items():
            fs.fix(name, val)
    We = u["es_turbine"].work_mechanical

    scenarios = {
        "hot_empty": (INVENTORY_MIN, TANK_MAX - INVENTORY_MIN),
        "hot_half_full": (TANK_MAX / 2, TANK_MAX / 2),
        "hot_full": (TANK_MAX - INVENTORY_MIN, INVENTORY_MIN),
    }
    if tank_scenario not in scenarios:
        raise ValueError(
            "tank_scenario must be hot_empty, hot_half_full or hot_full")
    hot0, cold0 = scenarios[tank_scenario]
    fs.add_param("prev_salt_hot", hot0)
    fs.add_param("prev_salt_cold", cold0)

    # ---- outer inequalities (all <= 0); params carry the scenario so a
    # repeat call only changes numbers, never the constraint set -------
    def ineq(name, fn, scale=1.0):
        if not fs.has_constraint(name):
            fs.add_ineq(name, fn, scale=scale)

    if fix_power:
        ineq("power_demand_lo",
             lambda v, p: p["power_demand"] - torch.sum(v["net_power"]),
             scale=1e-2)
        ineq("power_demand_hi",
             lambda v, p: torch.sum(v["net_power"]) - p["power_demand"],
             scale=1e-2)
    else:
        ineq("plant_power_min",
             lambda v, p: p["plant_power_lo"] - v["plant_power_out"],
             scale=1e-2)
        ineq("plant_power_max",
             lambda v, p: v["plant_power_out"] - p["plant_power_hi"],
             scale=1e-2)
        ineq("storage_power_min",
             lambda v, p: v[We] + MIN_STORAGE_POWER * 1e6, scale=_W_SC)
        ineq("storage_power_max",
             lambda v, p: -MAX_STORAGE_POWER * 1e6 - v[We], scale=_W_SC)

    # delta-T envelope (``add_bounds`` :977-980, :1009-1012)
    _envelope_ineqs(fs, hxc, hxd)
    # the cooler may only reject heat (``add_bounds`` :1021) — without
    # this the cooling-price credit in the operating cost would reward
    # HEATING the charge condensate
    Qcool = u["cooler"].heat_duty
    ineq("cooler_duty_max", lambda v, p: v[Qcool], scale=_W_SC)

    # salt inventory (:1336-1391), end-of-period states eliminated
    ineq("salt_maxflow_hot",
         lambda v, p: 3600.0 * v[Fd] - p["prev_salt_hot"], scale=1e-5)
    ineq("salt_maxflow_cold",
         lambda v, p: 3600.0 * v[Fc] - p["prev_salt_cold"], scale=1e-5)
    ineq("salt_inventory_hot_max",
         lambda v, p: p["prev_salt_hot"] + 3600.0 * (v[Fc] - v[Fd])
         - INVENTORY_MAX, scale=1e-5)
    ineq("salt_inventory_hot_min",
         lambda v, p: -(p["prev_salt_hot"] + 3600.0 * (v[Fc] - v[Fd])),
         scale=1e-5)

    # objective: hourly revenue minus hourly-equivalent plant costs
    # (:1406-1423); storage capital cost is a constant and drops out
    def objective(v, p):
        rev = p["lmp"] * torch.sum(v["net_power"])
        cost = torch.sum(
            v["operating_cost"] + v["plant_fixed_operating_cost"]
            + v["plant_variable_operating_cost"]) / (365.0 * 24.0)
        return (rev - cost) * 1e-2

    decisions = [
        u["boiler"].inlet_state.flow_mol,
        u["ess_hp_split"].split_fraction[1],
        u["ess_bfp_split"].split_fraction[1],
        Fc, Fd,
        u["cooler"].outlet_state.enth_mol,
    ]
    if load_solution is not None:
        # seed the inner states from a saved analysis solution (the
        # warm-start twin of the reference's json model checkpoint)
        _load_initialized(m, load_solution)

    nlp = fs.compile(objective=objective, sense="max")
    rs = ReducedSpaceNLP(
        nlp, decisions,
        newton_options=NewtonOptions(max_iter=80),
        u_scales={
            u["ess_hp_split"].split_fraction[1]: 0.01,
            u["ess_bfp_split"].split_fraction[1]: 0.01,
            Fc: 10.0, Fd: 10.0,
        },
        device=dev,
    )
    solver_options = None
    if warm_start is not None:
        # polishing run from a converged decision vector: start the
        # outer interior point at a tiny barrier so it verifies local
        # optimality instead of re-walking the barrier path
        solver_options = dict(initial_barrier_parameter=1e-8,
                              initial_tr_radius=0.1)
    res = rs.solve(
        u_bounds={
            u["boiler"].inlet_state.flow_mol: (11804.0, 3.0 * up.MAIN_FLOW),
            u["ess_hp_split"].split_fraction[1]: (1e-3, 0.45),
            u["ess_bfp_split"].split_fraction[1]: (1e-3, 0.45),
            Fc: (1.0, 500.0), Fd: (1.0, 500.0),
            u["cooler"].outlet_state.enth_mol: (2000.0, 22000.0),
        },
        maxiter=maxiter, solver_options=solver_options, verbose=verbose,
    )
    sol = rs.unravel(res)
    net = float(np.sum(sol["net_power"]))
    inv_hot = hot0 + 3600.0 * float(np.sum(sol[Fc]) - np.sum(sol[Fd]))
    return dict(nlp=nlp, rs=rs, res=res, sol=sol,
                revenue=lmp * net, obj=res.obj, net_power=net,
                hxc_area=float(sol["hxc.area"]),
                hxd_area=float(sol["hxd.area"]),
                salt_inventory_hot=inv_hot,
                salt_inventory_cold=SALT_AMOUNT - inv_hot)


_W_SC = 1e-6  # watt-scale inequality rows


def _envelope_ineqs(fs, hxc, hxd) -> None:
    """The reference's post-init variable bounds that can be active at
    the optimum, as outer inequalities (``add_bounds`` :936-1073).
    Idempotent: repeat calls skip already-registered rows."""
    def ineq(name, fn, scale=1.0):
        if not fs.has_constraint(name):
            fs.add_ineq(name, fn, scale=scale)

    for hx, tag, dlo, dhi in (
        (hxc, "hxc", (9.0, 5.0), (80.5, 81.0)),
        (hxd, "hxd", (4.9, 10.0), (300.0, 300.0)),
    ):
        dTi, dTo = hx.delta_temperature_in, hx.delta_temperature_out
        ineq(f"{tag}_dTin_lo", lambda v, p, dTi=dTi, lo=dlo[0]:
             lo - v[dTi], scale=1e-1)
        ineq(f"{tag}_dTout_lo", lambda v, p, dTo=dTo, lo=dlo[1]:
             lo - v[dTo], scale=1e-1)
        ineq(f"{tag}_dTin_hi", lambda v, p, dTi=dTi, hi=dhi[0]:
             v[dTi] - hi, scale=1e-1)
        ineq(f"{tag}_dTout_hi", lambda v, p, dTo=dTo, hi=dhi[1]:
             v[dTo] - hi, scale=1e-1)
        Q = hx.heat_duty
        ineq(f"{tag}_duty_hi", lambda v, p, Q=Q:
             v[Q] - 200e6, scale=_W_SC)
        A = hx.area
        ineq(f"{tag}_area_hi", lambda v, p, A=A:
             v[A] - 6000.0, scale=1e-3)
