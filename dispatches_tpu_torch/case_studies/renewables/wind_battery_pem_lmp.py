"""Wind + battery + PEM price-taker design optimization (counterpart of
``dispatches_tpu/case_studies/renewables/wind_battery_pem_lmp.py``):
hydrogen revenue joins the electricity market profit in the NPV, the PEM
is sized through a per-period ``pem_max_p`` constraint and pays fixed and
variable O&M, and the battery's initial SoC is free but periodic.  The
program is an LP, solved by the float64 IPM.
"""

from __future__ import annotations

import numpy as np
import torch

from dispatches_tpu_torch.case_studies.renewables import load_parameters as lp
from dispatches_tpu_torch.case_studies.renewables.flowsheet import REModel, create_model
from dispatches_tpu_torch.case_studies.renewables.wind_battery_lmp import PriceTakerResult
from dispatches_tpu_torch.models.wind_power import sam_windpower_capacity_factors
from dispatches_tpu_torch.solvers.ipm import IPMOptions, solve_nlp


def wind_battery_pem_model(
    n_time_points: int, input_params: dict, verbose: bool = False
) -> REModel:
    """The wind + battery + PEM flowsheet over the horizon, with the
    initial throughput fixed and the SoC periodic."""
    wind_speeds = input_params.get("wind_speeds")
    cfs = input_params.get("capacity_factors")
    if cfs is None:
        cfs = sam_windpower_capacity_factors(wind_speeds[:n_time_points])
    m = create_model(
        re_mw=input_params["wind_mw"],
        pem_bar=input_params.get("pem_bar", lp.pem_bar),
        batt_mw=input_params["batt_mw"],
        tank_type=None,
        tank_length_m=None,
        turb_inlet_bar=None,
        horizon=n_time_points,
        capacity_factors=np.asarray(cfs)[:n_time_points],
    )
    fs = m.fs
    # initial throughput fixed; initial SoC free but periodic
    fs.fix("battery.initial_energy_throughput", 0.0)
    fs.add_eq(
        "periodic_soc",
        lambda v, p: v["battery.state_of_charge"][-1]
        - v["battery.initial_state_of_charge"],
    )
    return m


def wind_battery_pem_optimize(
    time_points: int, input_params: dict, verbose: bool = False, device=None
) -> PriceTakerResult:
    """NPV-maximal PEM and battery sizes (wind extant unless
    ``extant_wind`` is False) against a DA LMP signal and a hydrogen
    price, solved by the IPM on ``device`` (``cuda`` unless given)."""
    m = wind_battery_pem_model(time_points, input_params, verbose)
    fs = m.fs
    T = time_points

    pem_cap = fs.add_var("pem_system_capacity", shape=(), lb=0, scale=1e3,
                         init=input_params["pem_mw"] * 1e3)
    if input_params.get("design_opt", True):
        if not input_params.get("extant_wind", True):
            fs.unfix("windpower.system_capacity")
            fs.set_bounds(
                "windpower.system_capacity",
                ub=input_params.get("wind_mw_ub", lp.wind_mw_ub) * 1e3,
            )
        fs.unfix("battery.nameplate_power")
    else:
        fs.fix(pem_cap, input_params["pem_mw"] * 1e3)

    # PEM power bounded by its (design) capacity
    fs.add_ineq(
        "pem_max_p", lambda v, p: v["pem.electricity"] - v["pem_system_capacity"]
    )

    lmps = np.asarray(input_params["DA_LMPs"][:T], dtype=float)
    fs.add_param("lmp", lmps * 1e-3)  # $/kWh
    h2_price = input_params.get("h2_price_per_kg", lp.h2_price_per_kg)

    wind_cap_cost = 0.0 if input_params.get("extant_wind", True) else lp.wind_cap_cost
    n_weeks = T / (7 * 24)

    def pieces(v, p):
        grid_kw = v["splitter.grid_elec"] + v["battery.elec_out"]
        elec_revenue = torch.sum(p["lmp"] * grid_kw)
        wind_om = v["windpower.system_capacity"] * lp.wind_op_cost / 8760 * T
        pem_om = (
            v["pem_system_capacity"] * lp.pem_op_cost / 8760 * T
            + lp.pem_var_cost * torch.sum(v["pem.electricity"])
        )
        # hydrogen revenue: $/kg * mol/s -> kg/hr
        h2_revenue = h2_price * torch.sum(
            v["pem.outlet.flow_mol"] / lp.h2_mols_per_kg * 3600.0
        )
        annual = (elec_revenue + h2_revenue - wind_om - pem_om) * 52 / n_weeks
        capex = (
            wind_cap_cost * v["windpower.system_capacity"]
            + lp.batt_cap_cost * v["battery.nameplate_power"]
            + lp.pem_cap_cost * v["pem_system_capacity"]
        )
        return annual, capex

    def objective(v, p):
        annual, capex = pieces(v, p)
        return (-capex + lp.PA * annual) * 1e-5

    nlp = fs.compile(objective=objective, sense="max")
    res = solve_nlp(
        nlp,
        options=IPMOptions(
            max_iter=int(input_params.get("max_iter", 300)),
            kkt=input_params.get("kkt", "auto"),
        ),
        device=device,
    )
    sol = nlp.unravel(res.x)

    # report at the solution
    grid_kw = sol["splitter.grid_elec"] + sol["battery.elec_out"]
    elec_revenue = float(np.sum(lmps * 1e-3 * grid_kw))
    wind_cap = float(np.asarray(sol["windpower.system_capacity"]))
    batt_kw = float(np.asarray(sol["battery.nameplate_power"]))
    pem_kw = float(np.asarray(sol["pem_system_capacity"]))
    wind_om = wind_cap * lp.wind_op_cost / 8760 * T
    pem_om = pem_kw * lp.pem_op_cost / 8760 * T + lp.pem_var_cost * float(
        np.sum(sol["pem.electricity"])
    )
    h2_rev = h2_price * float(
        np.sum(sol["pem.outlet.flow_mol"] / lp.h2_mols_per_kg * 3600.0)
    )
    annual = (elec_revenue + h2_rev - wind_om - pem_om) * 52 / n_weeks
    npv = (
        -(wind_cap_cost * wind_cap + lp.batt_cap_cost * batt_kw
          + lp.pem_cap_cost * pem_kw)
        + lp.PA * annual
    )
    if verbose:
        print(
            f"[wind_battery_pem_optimize] NPV={npv:,.0f} annual={annual:,.0f} "
            f"batt={batt_kw:,.0f} pem={pem_kw:,.0f} "
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
