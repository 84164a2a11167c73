"""Full hybrid price-taker: wind + battery + PEM + H2 tank + H2 turbine
(counterpart of ``dispatches_tpu/case_studies/renewables/
wind_battery_pem_tank_turbine_lmp.py``): the battery SoC and the tank
holdup are chained with ``tshift`` and periodic, the PEM, tank and
turbine are sized through per-period max constraints, hydrogen revenue
is net of purchased H2, and the NPV is annualized by 52.143 and scaled
by 1e-8.  The turbine's Shomate enthalpy and entropy make the program
nonlinear, so the IPM's Lagrangian Hessian is nonzero in every period.

One stagewise numpy warm start covers the whole horizon (all periods
share the idle operating point).
"""

from __future__ import annotations

import numpy as np
import torch

from dispatches_tpu_torch.case_studies.renewables import load_parameters as lp
from dispatches_tpu_torch.case_studies.renewables.flowsheet import REModel, create_model
from dispatches_tpu_torch.case_studies.renewables.wind_battery_lmp import PriceTakerResult
from dispatches_tpu_torch.models.wind_power import sam_windpower_capacity_factors
from dispatches_tpu_torch.solvers.ipm import IPMOptions, solve_nlp


def _initialize_train(m: REModel, input_params: dict, n: int) -> None:
    """Idle-point warm start: wind to grid, PEM at a small flow filling
    the tank, turbine at the purchased-H2 minimum feed."""
    fs = m.fs
    turb = m.units["h2_turbine"]
    mixer = m.units["mixer"]
    props = turb.props

    # nominal turbine feed: slack H2 at its floor + matching air
    f_h2 = max(lp.h2_turb_min_flow, 1e-2)
    f_air = lp.air_h2_ratio * f_h2
    slack_y = {"hydrogen": 0.99, "oxygen": 0.0025, "argon": 0.0025,
               "nitrogen": 0.0025, "water": 0.0025}
    air_y = {"oxygen": 0.2054, "argon": 0.0032, "nitrogen": 0.7672,
             "water": 0.0240, "hydrogen": 2e-4}
    fc = np.array([
        f_h2 * slack_y[c] + f_air * air_y[c] for c in props.components
    ])
    P_in = lp.pem_bar * 1e5

    for feed, flow in (("air_feed", f_air), ("hydrogen_feed", 0.0),
                       ("purchased_hydrogen_feed", f_h2)):
        sb = mixer.inlet_states[feed]
        fs.set_init(sb.flow_mol, flow)
        y = air_y if feed == "air_feed" else slack_y
        fs.set_init(sb.flow_mol_comp,
                    np.array([flow * y[c] for c in props.components]))
    fs.set_init(mixer.mixed_state.flow_mol, fc.sum())
    fs.set_init(mixer.mixed_state.flow_mol_comp, fc)
    fs.set_init(mixer.mixed_state.temperature, lp.pem_temp)
    fs.set_init(mixer.mixed_state.pressure, P_in)

    turb.initialize(flow_mol_comp=fc, temperature=lp.pem_temp, pressure=P_in)

    tr = m.units["translator"]
    fs.set_init(tr.inlet_state.flow_mol, 0.0)
    fs.set_init(tr.outlet_state.flow_mol, 0.0)
    fs.set_init(tr.outlet_state.flow_mol_comp, np.zeros(props.n_comp))

    tank = m.units["h2_tank"]
    fs.set_init(tank.inlet_state.flow_mol, 1.0)
    fs.set_init(tank.pipeline_state.flow_mol, 1.0)
    fs.set_init(tank.turbine_state.flow_mol, 0.0)
    for sb in (tank.inlet_state, tank.pipeline_state, tank.turbine_state):
        fs.set_init(sb.temperature, lp.pem_temp)
        fs.set_init(sb.pressure, P_in)
    fs.set_init("h2_tank.tank_holdup", 3600.0)
    fs.set_init("pem.outlet.flow_mol", 1.0)
    fs.set_init("pem.electricity", 1.0 / 0.002527406)


def wind_battery_pem_tank_turb_nlp(n_time_points: int, input_params: dict):
    """Build, warm-start and compile the full-hybrid NPV program without
    solving it.  Returns ``(m, nlp)``."""
    T = n_time_points
    tank_type = input_params.get("tank_type", "simple")
    wind_speeds = input_params.get("wind_speeds")
    cfs = input_params.get("capacity_factors")
    if cfs is None:
        cfs = sam_windpower_capacity_factors(wind_speeds[:T])

    m = create_model(
        re_mw=input_params["wind_mw"],
        pem_bar=input_params.get("pem_bar", lp.pem_bar),
        batt_mw=input_params["batt_mw"],
        tank_type=tank_type,
        tank_length_m=input_params.get("tank_size", lp.fixed_tank_size),
        turb_inlet_bar=input_params.get("pem_bar", lp.pem_bar),
        horizon=T,
        capacity_factors=np.asarray(cfs)[:T],
    )
    fs = m.fs

    # initial conditions + periodicity
    fs.fix("battery.initial_energy_throughput", 0.0)
    fs.add_eq(
        "periodic_soc",
        lambda v, p: v["battery.state_of_charge"][-1]
        - v["battery.initial_state_of_charge"],
    )
    fs.add_eq(
        "periodic_holdup",
        lambda v, p: v["h2_tank.tank_holdup"][-1]
        - v["h2_tank.tank_holdup_previous"],
        scale=1e-3,
    )

    _initialize_train(m, input_params, T)

    # design capacity vars
    pem_cap = fs.add_var("pem_system_capacity", shape=(), lb=0, scale=1e3,
                         init=input_params["pem_mw"] * 1e3)
    tank_size = fs.add_var("h2_tank_size", shape=(), lb=0, scale=1e3,
                           init=input_params.get("tank_size_mol", 1e5))
    turb_cap = fs.add_var("turb_system_capacity", shape=(), lb=0, scale=1e3,
                          init=input_params["turb_mw"] * 1e3)

    if input_params.get("design_opt", True):
        fs.unfix("battery.nameplate_power")
    else:
        fs.fix(pem_cap, input_params["pem_mw"] * 1e3)
        fs.fix(tank_size, input_params.get("tank_size_mol", 1e5))
        fs.fix(turb_cap, input_params["turb_mw"] * 1e3)

    turb = m.units["h2_turbine"]

    def turb_elec_kw(v):
        return -(v[turb.turbine_work] + v[turb.compressor_work]) * 1e-3

    fs.add_ineq(
        "pem_max_p", lambda v, p: v["pem.electricity"] - v["pem_system_capacity"]
    )
    fs.add_ineq(
        "tank_max_p",
        lambda v, p: v["h2_tank.tank_holdup"] - v["h2_tank_size"],
        scale=1e-3,
    )
    fs.add_ineq(
        "turb_max_p",
        lambda v, p: turb_elec_kw(v) - v["turb_system_capacity"],
    )

    lmps = np.asarray(input_params["DA_LMPs"][:T], dtype=float)
    fs.add_param("lmp", lmps * 1e-3)
    h2_price = input_params.get("h2_price_per_kg", lp.h2_price_per_kg)
    wind_cap_cost = 0.0 if input_params.get("extant_wind", True) else lp.wind_cap_cost
    n_weeks = T / (7 * 24)
    purch = m.units["mixer"].inlet_states["purchased_hydrogen_feed"].flow_mol

    def objective(v, p):
        grid_kw = (
            v["splitter.grid_elec"] + v["battery.elec_out"] + turb_elec_kw(v)
        )
        elec_revenue = torch.sum(p["lmp"] * grid_kw)
        wind_om = v["windpower.system_capacity"] * lp.wind_op_cost / 8760 * T
        pem_om = (
            v["pem_system_capacity"] * lp.pem_op_cost / 8760 * T
            + lp.pem_var_cost * torch.sum(v["pem.electricity"])
        )
        tank_om = v["h2_tank_size"] * lp.tank_op_cost / 8760 * T
        turb_om = (
            v["turb_system_capacity"] * lp.turbine_op_cost / 8760 * T
            + lp.turbine_var_cost * torch.sum(turb_elec_kw(v))
        )
        # hydrogen sales net of the purchased slack feed
        h2_revenue = (
            h2_price
            / lp.h2_mols_per_kg
            * torch.sum(
                v["h2_tank.outlet_to_pipeline.flow_mol"] - v[purch]
            )
            * 3600.0
        )
        annual = (
            (elec_revenue + h2_revenue - wind_om - pem_om - tank_om - turb_om)
            * 52.143
            / n_weeks
        )
        capex = (
            wind_cap_cost * v["windpower.system_capacity"]
            + lp.batt_cap_cost * v["battery.nameplate_power"]
            + lp.pem_cap_cost * v["pem_system_capacity"]
            + lp.tank_cap_cost_per_kg * v["h2_tank_size"]
            + lp.turbine_cap_cost * v["turb_system_capacity"]
        )
        return (-capex + lp.PA * annual) * 1e-8

    return m, fs.compile(objective=objective, sense="max")


def wind_battery_pem_tank_turb_optimize(
    n_time_points: int, input_params: dict, verbose: bool = False, device=None
) -> PriceTakerResult:
    """NPV-maximal battery, PEM, tank and turbine sizes of the full hybrid
    against a DA LMP signal and a hydrogen price, solved by the IPM on
    ``device`` (``cuda`` unless given)."""
    T = n_time_points
    m, nlp = wind_battery_pem_tank_turb_nlp(T, input_params)
    lmps = np.asarray(input_params["DA_LMPs"][:T], dtype=float)
    h2_price = input_params.get("h2_price_per_kg", lp.h2_price_per_kg)
    wind_cap_cost = 0.0 if input_params.get("extant_wind", True) else lp.wind_cap_cost
    n_weeks = T / (7 * 24)

    res = solve_nlp(
        nlp,
        options=IPMOptions(
            max_iter=int(input_params.get("max_iter", 500)),
            kkt=input_params.get("kkt", "auto"),
        ),
        device=device,
    )
    sol = nlp.unravel(res.x)

    turb_kw = -(sol["h2_turbine.turbine.work_mechanical"]
                + sol["h2_turbine.compressor.work_mechanical"]) * 1e-3
    grid_kw = sol["splitter.grid_elec"] + sol["battery.elec_out"] + turb_kw
    elec_revenue = float(np.sum(lmps * 1e-3 * grid_kw))
    wind_cap = float(np.asarray(sol["windpower.system_capacity"]))
    batt_kw = float(np.asarray(sol["battery.nameplate_power"]))
    pem_kw = float(np.asarray(sol["pem_system_capacity"]))
    tank_mol = float(np.asarray(sol["h2_tank_size"]))
    turb_kw_cap = float(np.asarray(sol["turb_system_capacity"]))
    wind_om = wind_cap * lp.wind_op_cost / 8760 * T
    pem_om = pem_kw * lp.pem_op_cost / 8760 * T + lp.pem_var_cost * float(
        np.sum(sol["pem.electricity"])
    )
    tank_om = tank_mol * lp.tank_op_cost / 8760 * T
    turb_om = turb_kw_cap * lp.turbine_op_cost / 8760 * T + (
        lp.turbine_var_cost * float(np.sum(turb_kw))
    )
    h2_rev = (
        h2_price / lp.h2_mols_per_kg
        * float(np.sum(sol["h2_tank.outlet_to_pipeline.flow_mol"]
                       - sol["mixer.purchased_hydrogen_feed.flow_mol"]))
        * 3600.0
    )
    annual = (
        (elec_revenue + h2_rev - wind_om - pem_om - tank_om - turb_om)
        * 52.143 / n_weeks
    )
    npv = (
        -(wind_cap_cost * wind_cap + lp.batt_cap_cost * batt_kw
          + lp.pem_cap_cost * pem_kw + lp.tank_cap_cost_per_kg * tank_mol
          + lp.turbine_cap_cost * turb_kw_cap)
        + lp.PA * annual
    )
    if verbose:
        print(
            f"[wind_battery_pem_tank_turb_optimize] NPV={npv:,.0f} "
            f"annual={annual:,.0f} batt={batt_kw:,.0f} pem={pem_kw:,.0f} "
            f"tank={tank_mol:,.0f} turb={turb_kw_cap:,.0f} "
            f"converged={bool(res.converged)} iters={int(res.iterations)}"
        )
    return PriceTakerResult(
        npv=npv,
        annual_revenue=annual,
        battery_power_kw=batt_kw,
        wind_capacity_kw=wind_cap,
        converged=bool(res.converged),
        solution=sol,
        nlp=nlp,
        res=res,
    )
