"""Wind + battery price-taker program (counterpart of
``dispatches_tpu/case_studies/renewables/wind_battery_lmp.py``).

``wind_battery_pricetaker_nlp`` builds and compiles the NPV program that
the batch PDLP solver sweeps over LMP scenarios; ``wind_battery_optimize``
solves it once with the IPM and reports NPV, revenue and design sizes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from dispatches_tpu_torch.case_studies.renewables import load_parameters as lp
from dispatches_tpu_torch.case_studies.renewables.flowsheet import REModel, create_model
from dispatches_tpu_torch.core.graph import tshift
from dispatches_tpu_torch.models.wind_power import sam_windpower_capacity_factors
from dispatches_tpu_torch.solvers.ipm import IPMOptions, solve_nlp


@dataclass
class PriceTakerResult:
    """The quantities the reference's tests read off the solved model:
    NPV, annual revenue, design sizes and the solution profiles."""

    npv: float
    annual_revenue: float
    battery_power_kw: float
    wind_capacity_kw: float
    converged: bool
    solution: Dict[str, np.ndarray]
    nlp: object
    res: object


def wind_battery_model(
    n_time_points: int, input_params: dict, verbose: bool = False
) -> REModel:
    """Build the wind+battery flowsheet over the horizon with periodic
    SoC and the (optional) battery energy ramp constraints."""
    wind_speeds = input_params.get("wind_speeds")
    cfs = input_params.get("capacity_factors")
    if cfs is None:
        cfs = sam_windpower_capacity_factors(wind_speeds[:n_time_points])
    m = create_model(
        re_mw=input_params["wind_mw"],
        pem_bar=None,
        batt_mw=input_params["batt_mw"],
        tank_type=None,
        tank_length_m=None,
        turb_inlet_bar=None,
        horizon=n_time_points,
        capacity_factors=np.asarray(cfs)[:n_time_points],
    )
    fs = m.fs

    # initial conditions
    fs.fix("battery.initial_state_of_charge", 0.0)
    fs.fix("battery.initial_energy_throughput", 0.0)

    # periodic storage constraint: final SoC returns to the initial SoC
    fs.add_eq(
        "periodic_soc",
        lambda v, p: v["battery.state_of_charge"][-1]
        - v["battery.initial_state_of_charge"],
    )

    # battery energy ramp constraints; the default ramp rate (1e8) is
    # unbinding and adds no rows
    ramp = input_params.get("battery_ramp_rate", lp.battery_ramp_rate)
    if ramp < 1e7:
        fs.add_ineq(
            "battery.energy_down_ramp",
            lambda v, p: (
                tshift(v["battery.state_of_charge"],
                       v["battery.initial_state_of_charge"])
                - v["battery.state_of_charge"]
            ) - ramp,
        )
        fs.add_ineq(
            "battery.energy_up_ramp",
            lambda v, p: (
                v["battery.state_of_charge"]
                - tshift(v["battery.state_of_charge"],
                         v["battery.initial_state_of_charge"])
            ) - ramp,
        )
    return m


def wind_battery_pricetaker_nlp(n_time_points: int, input_params: dict,
                                verbose: bool = False):
    """Build + compile the price-taker NPV program without solving it.
    Returns ``(m, nlp)``; the LMP signal is the ``"lmp"`` param in
    $/kWh."""
    m = wind_battery_model(n_time_points, input_params, verbose)
    fs = m.fs

    if input_params.get("design_opt", True):
        if not input_params.get("extant_wind", True):
            fs.unfix("windpower.system_capacity")
            fs.set_bounds(
                "windpower.system_capacity",
                ub=input_params.get("wind_mw_ub", lp.wind_mw_ub) * 1e3,
            )
        fs.unfix("battery.nameplate_power")

    lmps = np.asarray(input_params["DA_LMPs"][:n_time_points]) * 1e-3  # $/kWh
    fs.add_param("lmp", lmps)

    wind_cap_cost = 0.0 if input_params.get("extant_wind", True) else lp.wind_cap_cost
    n_weeks = n_time_points / (7 * 24)

    def objective(v, p):
        # hourly profit: LMP revenue on grid power + battery discharge,
        # minus wind fixed O&M and battery replacement cost on
        # throughput; NPV scaled 1e-5
        grid_kw = v["splitter.grid_elec"] + v["battery.elec_out"]
        revenue = torch.sum(p["lmp"] * grid_kw)
        wind_om = (
            v["windpower.system_capacity"] * lp.wind_op_cost / 8760 * n_time_points
        )
        batt_var = (
            lp.batt_rep_cost_kwh
            * p["battery.degradation_rate"]
            * (
                v["battery.energy_throughput"][-1]
                - v["battery.initial_energy_throughput"]
            )
        )
        annual_revenue = (revenue - wind_om - batt_var) * 52 / n_weeks
        capex = (
            wind_cap_cost * v["windpower.system_capacity"]
            + lp.batt_cap_cost * v["battery.nameplate_power"]
        )
        return (-capex + lp.PA * annual_revenue) * 1e-5

    nlp = fs.compile(objective=objective, sense="max")
    return m, nlp


def wind_battery_optimize(
    n_time_points: int, input_params: dict, verbose: bool = False, device=None
) -> PriceTakerResult:
    """NPV-maximal design of the battery (wind extant) against a DA LMP
    signal, solved by the IPM on ``device`` (``cuda`` unless given)."""
    m, nlp = wind_battery_pricetaker_nlp(n_time_points, input_params, verbose)
    lmps = np.asarray(input_params["DA_LMPs"][:n_time_points]) * 1e-3
    wind_cap_cost = (0.0 if input_params.get("extant_wind", True)
                     else lp.wind_cap_cost)
    n_weeks = n_time_points / (7 * 24)

    res = solve_nlp(
        nlp,
        options=IPMOptions(
            max_iter=int(input_params.get("max_iter", 300)),
            kkt=input_params.get("kkt", "auto"),
        ),
        device=device,
    )
    sol = nlp.unravel(res.x)

    params = nlp.default_params()
    # recompute the reported quantities at the solution (physical units)
    grid_kw = sol["splitter.grid_elec"] + sol["battery.elec_out"]
    revenue = float(np.sum(lmps * grid_kw))
    wind_cap = float(np.asarray(sol["windpower.system_capacity"]))
    batt_kw = float(np.asarray(sol["battery.nameplate_power"]))
    wind_om = wind_cap * lp.wind_op_cost / 8760 * n_time_points
    deg_rate = float(params["p"]["battery.degradation_rate"])
    batt_var = (
        lp.batt_rep_cost_kwh
        * deg_rate
        * float(sol["battery.energy_throughput"][-1])
    )
    annual_revenue = (revenue - wind_om - batt_var) * 52 / n_weeks
    npv_val = (
        -(wind_cap_cost * wind_cap + lp.batt_cap_cost * batt_kw)
        + lp.PA * annual_revenue
    )

    if verbose:
        print(
            f"[wind_battery_optimize] NPV={npv_val:,.0f} annual_revenue="
            f"{annual_revenue:,.0f} batt={batt_kw:,.0f} kW "
            f"converged={bool(res.converged)} iters={int(res.iterations)}"
        )

    return PriceTakerResult(
        npv=npv_val,
        annual_revenue=annual_revenue,
        battery_power_kw=batt_kw,
        wind_capacity_kw=wind_cap,
        converged=bool(res.converged),
        solution=sol,
        nlp=nlp,
        res=res,
    )
