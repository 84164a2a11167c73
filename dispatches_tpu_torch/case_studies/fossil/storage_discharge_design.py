"""Discharge storage-design study: condensate-source selection (GDP)
(counterpart of ``dispatches_tpu/case_studies/fossil/
storage_discharge_design.py``; the same data, models, decisions, polish
and enumeration).

Counterpart of the reference's
``storage/discharge_design_ultra_supercritical_power_plant.py``: the
mirror image of the charge design, a Generalized Disjunctive Program
choosing WHERE in the feedwater train the condensate diverted through
the Solar-salt discharge heat exchanger is tapped (five disjuncts:
condenser pump / FWH4 / booster pump / BFP / FWH9 outlets), with the
tapped stream heated by hot salt (831.15 K) in ``hxd`` and expanded
through a dedicated storage turbine ``es_turbine`` whose exhaust leaves
the cycle (an open stream made up at the condenser mixer), Seider/SSLW
costing (from the charge study, ``storage_charge_design``) and the
capital+operating objective of ``model_analysis`` (plant power fixed at
400 MW, storage duty fixed at 148.5 MW).

The study enumerates the 5 topologies, each one a reduced-space NLP
(the square plant solved by Newton on ``device``, ``cuda`` unless the
caller passes ``device="cpu"``; the split fraction and salt flow driven
by SciPy's ``trust-constr`` on the host with exact adjoint gradients),
and selects the minimum-cost design.  The reference's optimum is the
condenser-pump source with a 1,912.2 m² exchanger.

The storage turbine's saturated-exhaust specification (T_out = T_sat +
1) is realized with a two-phase EoS block pinned to the turbine outlet
pressure, whose temperature variable IS T_sat(P); this closes the
otherwise-free outlet pressure, exactly like the reference.  Its host
warm start (``_es_turbine_host_solve``) is a SciPy root-find.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from scipy import optimize as sopt

from dispatches_tpu_torch import resolve_device
from dispatches_tpu_torch.case_studies.fossil import storage_integrated as isp
from dispatches_tpu_torch.case_studies.fossil import usc_plant as up
from dispatches_tpu_torch.case_studies.fossil.usc_plant import UscModel
from dispatches_tpu_torch.case_studies.fossil.storage_charge_design import (
    COAL_PRICE,
    HOURS_PER_DAY,
    NUM_OF_YEARS,
    OBJ_SCALE,
    _feasible,
    _map_isolated,
    hx_capital_cost,
    isolated_json_call,
    salt_pump_cost_per_year,
)
from dispatches_tpu_torch.models.salt_hx import SaltSteamHX
from dispatches_tpu_torch.models.steam_cycle import (
    EosBlock,
    SteamSplitter,
    SteamTurbineStage,
)
from dispatches_tpu_torch.properties import iapws95 as w95
from dispatches_tpu_torch.properties.salts import SolarSalt
from dispatches_tpu_torch.solvers.newton import NewtonOptions, solve_square
from dispatches_tpu_torch.solvers.reduced import ReducedSpaceNLP

# ---------------------------------------------------------------------
# Design data (reference ``_add_data`` :148-257, ``set_model_input``
# :736-779, ``model_analysis`` :1316-1338)
# ---------------------------------------------------------------------

SALT_PRICE = 0.49            # $/kg Solar salt (:218-227)
SALT_T_HOT = 831.15          # K hot-tank salt (:760)
SALT_T_MIN = 513.15          # K solarsalt stability lower bound
                             # (solarsalt_properties.py:284)
HXD_AREA_INIT = 500.0        # m2 (:754)
HXD_SALT_FLOW_INIT = 200.0   # kg/s (:759)
SPLIT_FRAC_INIT = 0.1        # to_hxd (:774)
ES_TURBINE_EFF = 0.8         # (:779)
POWER_FIXED = 400.0          # MW (``model_analysis``, :1321)
POWER_MAX = 436.0            # MW boiler-efficiency basis (``main``, :1185)
HEAT_DUTY_FIXED = 148.5      # MW (``__main__``, :1344)
AREA_MAX = 5000.0            # m2 (``add_bounds``, :1131)
SALT_FLOW_MAX = 1000.0       # kg/s (:1106)

# condensate sources (reference disjuncts :511-733): tap stream, the
# base-plant arc the tap replaces, and where the un-diverted condensate
# continues ("to_fwh" outlet destination)
SOURCES = ("condpump", "fwh4", "booster", "bfp", "fwh9")


def _source_spec(m: UscModel, source: str):
    u = m.units
    return {
        # (tap outlet port-owner state, original arc name, to_fwh dest)
        "condpump": (u["cond_pump"].outlet_state, "condpump_to_fwh1",
                     u["fwh_1"].tube_inlet),
        "fwh4": (u["fwh_4"].tube_out, "fwh4_to_fwh5",
                 u["fwh_5"].tube_inlet),
        "booster": (u["booster"].outlet_state, "booster_to_fwh6",
                    u["fwh_6"].tube_inlet),
        "bfp": (u["bfp"].outlet_state, "bfp_to_fwh8",
                u["fwh_8"].tube_inlet),
        "fwh9": (u["fwh_9"].tube_out, "fwh9_to_boiler",
                 u["boiler"].inlet),
    }[source]


# ---------------------------------------------------------------------
# Per-source model
# ---------------------------------------------------------------------

def build_discharge_model(source: str, load_from_file=None) -> UscModel:
    """USC plant + one discharge train (the reference's disjunct
    realized as a concrete flowsheet): condensate tap splitter, salt
    discharge HX, storage turbine with saturated exhaust
    (``create_discharge_model`` :70-145 + the selected
    ``*_source_disjunct_equations`` :511-733).  Host work only: the
    solves run in ``design_optimize``."""
    if source not in SOURCES:
        raise ValueError(f"unknown condensate source {source!r}")

    m = up.build_plant_model()
    up.initialize(m)
    fs, u = m.fs, m.units
    m.source = source

    tap_state, orig_arc, dest_port = _source_spec(m, source)
    P_tap = isp._iv(fs, tap_state.pressure)
    # above the critical pressure the tapped feedwater heats into a
    # supercritical state; below it the tube side boils to superheat
    supercritical = P_tap > 0.98 * w95.PC
    m.supercritical = supercritical
    out_phase = "sc" if supercritical else "vap"

    u["es_split"] = SteamSplitter(fs, "es_split", num_outlets=2)
    # water_film_phase="vap": the design model reads tube-side transport
    # properties on the Vap branch even at the subcooled condensate
    # inlet (``discharge_design...py:375-409`` phase labels), unlike the
    # integrated model whose labels match the actual states
    u["hxd"] = SaltSteamHX(fs, "hxd", salt=SolarSalt, salt_side="shell",
                           water_in_phase="liq", water_out_phase=out_phase,
                           water_film_phase="vap")
    u["es_turbine"] = SteamTurbineStage(fs, "es_turbine",
                                        inlet_phase=out_phase,
                                        outlet_phase="vap",
                                        isentropic_phase="wet")

    # rewire the tapped stream through the splitter (:466-485 + the
    # selected disjunct's arcs)
    fs.deactivate(orig_arc)
    fs.connect(tap_state.port, u["es_split"].inlet, name="src_to_essplit")
    fs.connect(u["es_split"].outlet(1), dest_port, name="essplit_to_fwh")
    fs.connect(u["es_split"].outlet(2), u["hxd"].tube_inlet,
               name="essplit_to_hxd")
    fs.connect(u["hxd"].tube_outlet, u["es_turbine"].inlet,
               name="hxd_to_esturbine")

    # the es_turbine exhaust is an open stream; the condenser makeup
    # replenishes it (same treatment as the integrated model)
    mk = u["condenser_mix"].inlet_states["makeup"]
    fs.set_bounds(mk.flow_mol, lb=0.0, ub=up.MAIN_FLOW)

    # saturated turbine exhaust: T_out = T_sat(P_out) + 1
    # (``constraint_esturbine_temperature_out`` :264-272) — closes the
    # free outlet pressure
    est = u["es_turbine"]
    T_out = est.outlet_state.temperature
    sat = EosBlock(est, "sat_out", "wet", est.outlet_state.pressure)
    fs.fix(sat.x, 0.5)
    est.sat_block = sat
    fs.add_eq("es_turbine.saturated_exhaust",
              lambda v, p: v[T_out] - (v[sat.T] + 1.0), scale=1e-1)

    # superheated turbine inlet: T_in >= T_sat(P_in) + 1 (:275-283);
    # meaningful only at subcritical tap pressure
    if not supercritical:
        T_in = est.inlet_state.temperature
        sat_in = EosBlock(est, "sat_in", "wet", est.inlet_state.pressure)
        fs.fix(sat_in.x, 0.5)
        est.sat_in_block = sat_in
        fs.add_ineq("es_turbine.superheated_inlet",
                    lambda v, p: (v[sat_in.T] + 1.0) - v[T_in], scale=1e-1)
    else:
        est.sat_in_block = None

    # net power / boiler efficiency / coal duty (:285-324): the
    # storage turbine work credits the boiler-efficiency curve
    We = est.work_mechanical
    net = fs.add_var("net_power", lb=0.0, ub=2000.0, init=437.0, scale=100.0)
    fs.add_eq("net_power_def",
              lambda v, p: v[net] - v["plant_power_out"] + 1e-6 * v[We],
              scale=1e-2)
    coal = fs.add_var("coal_heat_duty", lb=0.0, ub=1e5, init=1000.0,
                      scale=1e3)
    fs.add_eq("coal_heat_duty_eq",
              lambda v, p: v[coal]
              * (0.2143 * (v[net] / POWER_MAX) + 0.7357)
              - v["plant_heat_duty"], scale=1e-2)

    _set_model_input(m)
    if load_from_file is None:
        _initialize(m)
    else:
        isp._load_initialized(m, load_from_file)
    return m


def _set_model_input(m: UscModel) -> None:
    """Square-model inputs (reference ``set_model_input``, :736-779)."""
    fs, u = m.fs, m.units
    hxd = u["hxd"]
    fs.fix(hxd.area, HXD_AREA_INIT)
    fs.fix(hxd.salt_in.flow_mass, HXD_SALT_FLOW_INIT)
    fs.fix(hxd.salt_in.temperature, SALT_T_HOT)
    fs.fix(hxd.salt_in.pressure, isp.SALT_PRESSURE)
    fs.fix(u["es_split"].split_fraction[1], SPLIT_FRAC_INIT)
    fs.fix(u["es_turbine"].efficiency_isentropic, ES_TURBINE_EFF)


def _es_turbine_host_solve(h_in: float, P_in: float,
                           eta: float = ES_TURBINE_EFF):
    """Host-side storage-turbine warm start: find the outlet pressure at
    which the expanded steam lands exactly 1 K above saturation (the
    role of the reference's ``es_turbine.initialize`` + the saturated-
    exhaust constraint)."""
    s_in = w95.flash_hp(h_in, P_in)["s"]

    def state(P_out):
        h_iso = w95.h_ps(P_out, s_in, "vap")
        h_out = h_in - eta * (h_in - h_iso)
        st = w95.flash_hp(h_out, P_out)
        Ts, dl, dv = w95.sat_solve_P(P_out)
        return float(st["T"]) - (Ts + 1.0), (h_iso, h_out, Ts, dl, dv)

    # bracket in log-pressure: high P_out -> exhaust superheat shrinks
    lo, hi = np.log(4e3), np.log(min(0.9 * P_in, 0.9 * w95.PC))
    f_lo = state(np.exp(lo))[0]
    f_hi = state(np.exp(hi))[0]
    grid = np.linspace(lo, hi, 25)
    lnP_sol = None
    f_prev, ln_prev = f_lo, lo
    for ln in grid[1:]:
        f = state(np.exp(ln))[0]
        if np.sign(f) != np.sign(f_prev):
            lnP_sol = sopt.brentq(lambda x: state(np.exp(x))[0], ln_prev, ln,
                                  xtol=1e-10)
            break
        f_prev, ln_prev = f, ln
    if lnP_sol is None:
        # no crossing: exhaust is superheated everywhere — take the
        # closest-to-saturation end
        lnP_sol = lo if abs(f_lo) < abs(f_hi) else hi
    P_out = float(np.exp(lnP_sol))
    _, (h_iso, h_out, Ts, dl, dv) = state(P_out)
    return P_out, h_iso, h_out, Ts, dl, dv


def _initialize(m: UscModel) -> None:
    """Host warm-start sweep for the discharge train (reference
    ``initialize``, :799-850)."""
    fs, u = m.fs, m.units
    tap_state, _, _ = _source_spec(m, m.source)
    src = isp._stream_init(fs, tap_state)

    sp = u["es_split"]
    frac = isp._iv(fs, sp.split_fraction[1])
    up._set_state_init(fs, sp.inlet_state, src["F"], src["h"], src["P"])
    fs.set_init(sp.split_fraction[0], 1.0 - frac)
    up._set_state_init(fs, sp.outlet_states[0], (1.0 - frac) * src["F"],
                       src["h"], src["P"])
    up._set_state_init(fs, sp.outlet_states[1], frac * src["F"],
                       src["h"], src["P"])

    dis_steam = dict(F=frac * src["F"], h=src["h"], P=src["P"])
    hxd_out = isp._hx_sweep(fs, u["hxd"], dis_steam,
                            isp._iv(fs, u["hxd"].salt_in.flow_mass),
                            isp._iv(fs, u["hxd"].salt_in.temperature),
                            isp._iv(fs, u["hxd"].area), water_hot=False)

    est = u["es_turbine"]
    P_es, h_iso, h_es_out, Ts, dl, dv = _es_turbine_host_solve(
        hxd_out["h"], hxd_out["P"])
    up._set_state_init(fs, est.inlet_state, hxd_out["F"], hxd_out["h"],
                       hxd_out["P"])
    up._set_state_init(fs, est.outlet_state, hxd_out["F"], h_es_out, P_es)
    up._set_iso_init(fs, est, h_iso, P_es)
    fs.set_init(est.work_mechanical, hxd_out["F"] * (h_es_out - hxd_out["h"]))
    fs.set_init(est.ratioP, P_es / hxd_out["P"])
    fs.set_init(est.deltaP, P_es - hxd_out["P"])
    fs.set_init(est.sat_block.T, Ts)
    fs.set_init(est.sat_block.delta_l, dl)
    fs.set_init(est.sat_block.delta_v, dv)
    if est.sat_in_block is not None:
        Tsi, dli, dvi = w95.sat_solve_P(hxd_out["P"])
        fs.set_init(est.sat_in_block.T, Tsi)
        fs.set_init(est.sat_in_block.delta_l, dli)
        fs.set_init(est.sat_in_block.delta_v, dvi)

    # makeup replaces the open es_turbine exhaust
    mk = u["condenser_mix"].inlet_states["makeup"]
    fs.set_init(mk.flow_mol, hxd_out["F"])

    W_es = hxd_out["F"] * (h_es_out - hxd_out["h"])
    fs.set_init("net_power", 437.0 - 1e-6 * W_es)
    heat = isp._iv(fs, "plant_heat_duty")
    eff = 0.2143 * (437.0 - 1e-6 * W_es) / POWER_MAX + 0.7357
    fs.set_init("coal_heat_duty", heat / eff)


# ---------------------------------------------------------------------
# Costing + design optimization (reference ``build_costing`` :853-1075,
# ``model_analysis`` :1316-1338)
# ---------------------------------------------------------------------

def total_cost_expression(m: UscModel):
    """Annualized capital + operating cost ($/yr) of the discharge
    design, as one closed-form expression over the flowsheet states:

    * capital = (salt purchase + salt pump + HX purchase) / 30 yr, with
      the salt amount priced for the full plant life
      (``salt_purchase_cost`` :890-897: flow x 6 h/day x 30 yr),
      Seider centrifugal-pump correlations (:911-1000) and the SSLW
      U-tube exchanger correlation (:885-889);
    * operating = coal cost at the part-load boiler efficiency credit
      from the storage turbine (:1029-1046).
    """
    u = m.units
    hxd = u["hxd"]
    Fsalt = hxd.salt_in.flow_mass
    Tin = hxd.salt_in.temperature
    A = hxd.area
    Psalt = hxd.salt_in.pressure  # shell side = salt at ~1 atm

    def cost(v, p):
        F = torch.sum(v[Fsalt])
        T_in = torch.sum(v[Tin])
        rho = SolarSalt.dens_mass(T_in)
        # full-life salt inventory, annualized (:890-897 / :1015-1021)
        salt_total = (F * HOURS_PER_DAY * NUM_OF_YEARS * 3600.0
                      * SALT_PRICE)
        spump = salt_pump_cost_per_year(F, rho) * NUM_OF_YEARS
        hx_cap = hx_capital_cost(torch.sum(v[A]), torch.sum(v[Psalt]))
        capital = (salt_total + spump + hx_cap) / NUM_OF_YEARS
        op_hours = 365.0 * 3600.0 * HOURS_PER_DAY
        operating = op_hours * COAL_PRICE * v["coal_heat_duty"] * 1e6
        return (capital + torch.sum(operating)) * OBJ_SCALE

    return cost


def design_optimize(m: UscModel, heat_duty_mw: float = HEAT_DUTY_FIXED,
                    power_mw: float = POWER_FIXED, maxiter: int = 200,
                    verbose: int = 0, device=None):
    """Solve one source's design NLP (reference ``model_analysis``
    :1316-1338 restricted to the active disjunct) on ``device`` (``cuda``
    unless given): fixed plant power and storage duty, minimize capital
    + operating cost."""
    dev = resolve_device(device)
    fs, u = m.fs, m.units
    hxd = u["hxd"]

    # re-entrancy: drop a previous call's active-set polish equalities
    # (the decisions get re-fixed below, so leftovers would make the
    # square init over-determined)
    for pol in ("polish_dTin", "polish_saltT"):
        if fs.has_constraint(pol):
            fs.deactivate(pol)

    # square initialization solve
    nlp0 = fs.compile()
    res0 = solve_square(nlp0, device=dev)
    if not bool(res0.converged):
        raise RuntimeError(
            f"discharge-design init for {m.source} did not converge "
            f"({float(res0.max_residual):.2e})")
    isp.write_back(fs, nlp0, res0.x)

    # fix the operating point, free the design states (:1322-1332)
    fs.fix("plant_power_out", power_mw)
    fs.fix(hxd.heat_duty, heat_duty_mw * 1e6)
    fs.unfix(u["boiler"].inlet_state.flow_mol)
    fs.unfix(hxd.area)

    sf = u["es_split"].split_fraction[1]
    Fd = hxd.salt_in.flow_mass

    # duty-consistent starting decisions: size the salt flow and split
    # fraction from the fixed 148.5 MW energy balances
    Q = heat_duty_mw * 1e6
    T_out0 = SALT_T_MIN + 25.0
    dh_salt = float(SolarSalt.enth_mass(SALT_T_HOT)
                    - SolarSalt.enth_mass(T_out0))
    fs.fix(Fd, min(Q / dh_salt, SALT_FLOW_MAX))
    tap_state, _, _ = _source_spec(m, m.source)
    h_src = isp._iv(fs, tap_state.enth_mol)
    F_src = isp._iv(fs, tap_state.flow_mol)
    P_src = isp._iv(fs, tap_state.pressure)
    # steam-side enthalpy rise to ~30 K below the hot salt
    d_out = w95.rho_tp(SALT_T_HOT - 30.0, P_src,
                       "sc" if m.supercritical else "vap") / w95.RHOC
    h_w_out = float(w95._h_host(d_out, SALT_T_HOT - 30.0))
    fs.fix(sf, min(1.05 * Q / ((h_w_out - h_src) * F_src), 0.35))

    # design envelope (``add_bounds``, :1095-1143)
    dTi, dTo = hxd.delta_temperature_in, hxd.delta_temperature_out
    Tso = hxd.salt_out.temperature

    def ineq(name, fn, scale=1.0):
        if not fs.has_constraint(name):
            fs.add_ineq(name, fn, scale=scale)

    ineq("hxd_dTin_lo", lambda v, p: 10.0 - v[dTi], scale=1e-1)
    ineq("hxd_dTin_hi", lambda v, p: v[dTi] - 350.0, scale=1e-1)
    ineq("hxd_dTout_lo", lambda v, p: 20.0 - v[dTo], scale=1e-1)
    ineq("hxd_dTout_hi", lambda v, p: v[dTo] - 500.0, scale=1e-1)
    # salt stays inside the solarsalt stability window
    # (solarsalt_properties.py:284 temperature bounds)
    ineq("salt_T_min", lambda v, p: SALT_T_MIN - v[Tso], scale=1e-1)
    ineq("hxd_area_hi", lambda v, p: v[hxd.area] - AREA_MAX, scale=1e-3)
    We = u["es_turbine"].work_mechanical
    ineq("es_work_neg", lambda v, p: v[We], scale=1e-6)

    cost = total_cost_expression(m)
    nlp = fs.compile(objective=cost, sense="min")
    rs = ReducedSpaceNLP(
        nlp, [sf, Fd],
        newton_options=NewtonOptions(max_iter=80),
        u_scales={sf: 0.01, Fd: 10.0},
        device=dev,
    )
    u_bounds = {sf: (1e-3, 0.35), Fd: (10.0, SALT_FLOW_MAX)}
    res = rs.solve(u_bounds=u_bounds, maxiter=maxiter, verbose=verbose,
                   gtol=1e-6, xtol=1e-9)
    sol = rs.unravel(res)
    cost_val = res.obj / OBJ_SCALE
    out = dict(
        m=m, rs=rs, res=res, sol=sol, source=m.source,
        cost=cost_val,
        hxd_area=float(np.sum(sol["hxd.area"])),
        salt_flow=float(np.sum(sol[Fd])),
        salt_T_out=float(np.sum(sol[Tso])),
        es_power_mw=-1e-6 * float(np.sum(sol[We])),
        converged=res.converged,
    )

    # ---- active-set polish ------------------------------------------
    # The objective valley is nearly flat along the approach-temperature
    # direction (marginal coal credit vs marginal HX capital differ by
    # <0.1% of the objective), and the barrier solver routinely stalls
    # short of the true active set where BOTH the 10 K approach bound
    # and the salt stability floor bind.  Pin those two inequalities as
    # equalities, free the two decisions, and solve the square KKT
    # system once; accept if feasible and cheaper.
    fs.unfix(sf)
    fs.unfix(Fd)
    fs.add_eq("polish_dTin", lambda v, p: v[dTi] - 10.0, scale=1e-1)
    fs.add_eq("polish_saltT", lambda v, p: v[Tso] - SALT_T_MIN, scale=1e-1)
    nlp_pol = fs.compile(objective=cost, sense="min")
    isp.write_back(fs, nlp, res.x)
    fs.set_init(sf, float(np.ravel(sol[sf])[0]))
    fs.set_init(Fd, float(np.ravel(sol[Fd])[0]))
    res_pol = solve_square(nlp_pol, device=dev)
    if bool(res_pol.converged):
        sol_pol = nlp_pol.unravel(res_pol.x)
        params_pol = nlp_pol.default_params()
        cost_pol = float(nlp_pol.objective(res_pol.x, params_pol)) / OBJ_SCALE
        g_pol = nlp_pol.ineq(res_pol.x, params_pol).cpu().numpy()
        if cost_pol <= cost_val and float(np.max(g_pol, initial=0.0)) <= 1e-6:
            out.update(
                sol=sol_pol, cost=cost_pol,
                hxd_area=float(np.sum(sol_pol["hxd.area"])),
                salt_flow=float(np.sum(sol_pol[Fd])),
                salt_T_out=float(np.sum(sol_pol[Tso])),
                es_power_mw=-1e-6 * float(np.sum(sol_pol[We])),
                converged=True,
            )
    return out


def _combo_summary(out) -> Dict:
    return {
        "source": out["source"], "cost": float(out["cost"]),
        "hxd_area": float(out["hxd_area"]),
        "salt_T_out": float(out["salt_T_out"]),
        "es_power_mw": float(out["es_power_mw"]),
        "converged": bool(out["converged"]),
        "inner_failures": int(out["res"].inner_failures),
    }


def _run_source(source: str, maxiter: int, verbose: int = 0, device=None) -> Dict:
    m = build_discharge_model(source)
    return design_optimize(m, maxiter=maxiter, verbose=verbose, device=device)


def _run_source_isolated(source: str, maxiter: int,
                         verbose: int = 0, device=None) -> Dict:
    """One condensate source in a fresh child process on the caller's
    ``device`` (the same restart/fallback rationale as the charge
    study's ``_run_combo_isolated``)."""
    call = (
        "from dispatches_tpu_torch.case_studies.fossil import "
        "storage_discharge_design as dd\n"
        f"out = dd._run_source({source!r}, {maxiter}, verbose={verbose}, device=device)\n"
        "print(json.dumps(dd._combo_summary(out)))"
    )
    return isolated_json_call(call, {"source": source}, resolve_device(device),
                              verbose=verbose)


def run_design_study(sources: Optional[Tuple[str, ...]] = None,
                     maxiter: int = 200, verbose: int = 0,
                     isolate: bool = False, device=None, on_result=None) -> Dict:
    """Enumerate the condensate sources and pick the minimum-cost design
    (the role of the reference's GDPopt RIC loop, ``run_gdp``), each on
    ``device`` (``cuda`` unless given).  The reference's winner is the
    condenser-pump source.  ``isolate=True`` runs each source in a fresh
    child process so one failure cannot take down the enumeration; a
    failed one is recorded with its ``error`` and is not feasible.  The
    isolated children run at once, as the charge study's; ``on_result``
    (optional) is called with each source's result as it ends."""
    dev = resolve_device(device)
    if sources is None:
        sources = SOURCES
    results = _map_isolated(
        lambda source: _run_source_isolated(source, maxiter, verbose, device=dev)
        if isolate else _run_source(source, maxiter, verbose, device=dev),
        sources, isolate, on_result)
    feasible = [r for r in results if _feasible(r)]
    best = min(feasible, key=lambda r: r["cost"]) if feasible else None
    return dict(results=results, best=best)
