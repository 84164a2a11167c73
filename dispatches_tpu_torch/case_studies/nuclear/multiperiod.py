"""NE multiperiod model + MultiPeriodNuclear double-loop protocol
(counterpart of ``dispatches_tpu/case_studies/nuclear/multiperiod.py``).

Tank-holdup linking by ``tshift`` chaining, ``unfix_dof``,
``create_multiperiod_nuclear_model`` with fixed/variable hydrogen demand
and the h2-market operating-cost expression treating hydrogen revenue as
negative cost, ``ne_price_taker_optimize`` and the ``MultiPeriodNuclear``
populate/update/record protocol object consumed by the Bidder/Tracker
layer.

The horizon is one flowsheet with a leading time axis; ``update_model``
writes the realized holdup into the fixed values, so rolling-horizon
re-solves reuse one built solver.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from dispatches_tpu_torch.case_studies.nuclear.flowsheet import (
    MW_H2,
    build_ne_flowsheet,
    fix_dof_and_initialize,
)
from dispatches_tpu_torch.core.graph import tshift

# O&M parameters (reference :117-127: $/MWh VOM, normalized FOM)
NPP_FOM = 13.7
NPP_VOM = 2.3
PEM_FOM = 5.47
PEM_VOM = 1.3
TANK_VOM = 0.01


def unfix_dof(m) -> None:
    """Free the operating degrees of freedom (reference :52-66): the
    power-split fractions and the hydrogen flow to the pipeline."""
    fs = m.fs
    split = m.units["np_power_split"]
    for local in ("split_fraction_np_to_grid", "split_fraction_np_to_pem"):
        name = split.v(local)
        if fs.is_fixed(name):
            fs.unfix(name)
    tank = m.units["h2_tank"]
    if fs.is_fixed(tank.pipeline_state.flow_mol):
        fs.unfix(tank.pipeline_state.flow_mol)


def create_multiperiod_nuclear_model(
    n_time_points: int = 4,
    h2_demand: float = 0.35,  # kg/s
    demand_type: str = "variable",
    h2_price: float = 4.0,  # $/kg
    np_capacity: float = 500.0,
    pem_capacity: float = 100.0,
    tank_capacity: float = 5000.0,
    include_turbine: bool = False,
):
    """Build the horizon-wide NE operating model (reference :72-157).
    Returns the model with ``m.operating_cost_expr(v, p) -> (T,)``
    attached (hydrogen sales enter as negative cost)."""
    if demand_type not in ("variable", "fixed"):
        raise ValueError(
            f"demand_type must be 'variable' or 'fixed', got {demand_type!r}"
        )
    m = build_ne_flowsheet(
        horizon=n_time_points,
        np_capacity=np_capacity,
        include_turbine=include_turbine,
        pem_capacity=pem_capacity,
        tank_capacity=tank_capacity,
    )
    fix_dof_and_initialize(
        m,
        split_frac_grid=0.95,
        tank_holdup_previous=0.0,
        flow_mol_to_pipeline=1.0,
        flow_mol_to_turbine=0.0,
    )
    unfix_dof(m)
    fs = m.fs
    tank = m.units["h2_tank"]

    # hydrogen demand (reference :139-146)
    if demand_type == "variable":
        fs.set_bounds(tank.pipeline_state.flow_mol, ub=h2_demand / MW_H2)
    else:
        fs.fix(tank.pipeline_state.flow_mol, h2_demand / MW_H2)

    split = m.units["np_power_split"]
    pem = m.units["pem"]

    def operating_cost_expr(v, p):
        # $/hr per period (reference :149-155); h2 revenue negative
        return (
            v[split.v("electricity")] * 1e-3 * NPP_VOM
            + v[pem.v("electricity")] * 1e-3 * PEM_VOM
            + v[tank.v("tank_holdup")] * MW_H2 * TANK_VOM
            - v[tank.pipeline_state.flow_mol] * MW_H2 * 3600.0 * h2_price
        )

    m.operating_cost_expr = operating_cost_expr
    return m


def ne_price_taker_optimize(
    n_time_points: int,
    lmps,
    h2_demand: float = 0.35,
    demand_type: str = "variable",
    h2_price: float = 4.0,
    np_capacity: float = 500.0,
    pem_capacity: float = 100.0,
    tank_capacity: float = 5000.0,
    max_iter: int = 300,
    verbose: bool = False,
    device=None,
):
    """NE price-taker: maximize electricity-market revenue minus the
    h2-market-aware operating cost over an LMP signal (the driver the
    reference builds around ``create_multiperiod_nuclear_model`` +
    IPOPT; configs per the reference's flowsheet_options :95-100).
    The IPM runs on ``device`` (``cuda`` unless given; without a card it
    raises)."""
    from dispatches_tpu_torch import resolve_device
    from dispatches_tpu_torch.solvers import IPMOptions, solve_nlp

    device = resolve_device(device)

    m = create_multiperiod_nuclear_model(
        n_time_points=n_time_points,
        h2_demand=h2_demand,
        demand_type=demand_type,
        h2_price=h2_price,
        np_capacity=np_capacity,
        pem_capacity=pem_capacity,
        tank_capacity=tank_capacity,
    )
    fs = m.fs
    split = m.units["np_power_split"]
    lmps = np.asarray(lmps, float)[:n_time_points]
    fs.add_param("lmp", lmps)

    def objective(v, p):
        elec_rev = torch.sum(
            p["lmp"] * v[split.v("np_to_grid_elec")] * 1e-3
        )
        return elec_rev - torch.sum(m.operating_cost_expr(v, p))

    nlp = fs.compile(objective=objective, sense="max")
    res = solve_nlp(nlp, options=IPMOptions(max_iter=max_iter), device=device)
    sol = nlp.unravel(res.x)
    if verbose:
        print(
            f"[ne_price_taker] obj={float(res.obj):,.0f} "
            f"converged={bool(res.converged)} iters={int(res.iterations)}"
        )
    return m, nlp, res, sol


class MultiPeriodNuclear:
    """Bidding/tracking protocol object (reference :158-344)."""

    def __init__(self, model_data):
        self.model_data = model_data
        self.p_lower = model_data.p_min
        self.p_upper = model_data.p_max
        self.generator = model_data.gen_name
        self.result_list: List = []

    # -- protocol ------------------------------------------------------

    def populate_model(self, blk, horizon: int) -> None:
        m = create_multiperiod_nuclear_model(n_time_points=horizon)
        fs = m.fs
        tank = m.units["h2_tank"]
        # block-0 initial holdup fixed (reference :203)
        fs.fix(tank.v("tank_holdup_previous"), 0.0)

        blk.m = m
        blk.horizon = horizon
        split = m.units["np_power_split"]
        pem = m.units["pem"]

        def power_output_expr(v, p):
            # MW to the grid (reference P_T, :212)
            return v[split.v("np_to_grid_elec")] * 1e-3

        blk.power_output_expr = power_output_expr
        blk.total_cost_expr = m.operating_cost_expr

        def power_output_values(sol):
            return sol[split.v("np_to_grid_elec")] * 1e-3

        blk.power_output_values = power_output_values
        blk._tank_var = tank.v("tank_holdup")
        blk._pem_var = pem.v("electricity")
        blk._pipeline_var = tank.pipeline_state.flow_mol

    def update_model(self, blk, implemented_tank_holdup) -> None:
        """Advance the realized initial holdup (reference :217-237)."""
        fs = blk.m.fs
        tank = blk.m.units["h2_tank"]
        # fs.fix keeps the float64 dtype/shape contract of the fixed
        # value
        fs.fix(
            tank.v("tank_holdup_previous"),
            float(round(float(implemented_tank_holdup[-1]))),
        )

    @staticmethod
    def get_last_delivered_power(blk, sol, last_implemented_time_step: int):
        return float(blk.power_output_values(sol)[last_implemented_time_step])

    @staticmethod
    def get_implemented_profile(blk, sol, last_implemented_time_step: int):
        t = last_implemented_time_step + 1
        return {
            "implemented_tank_holdup": list(sol[blk._tank_var][:t]),
        }

    def record_results(self, blk, sol, date=None, hour=None, **kwargs):
        import pandas as pd

        prev = float(
            blk.m.fs.var_specs[
                blk.m.units["h2_tank"].v("tank_holdup_previous")
            ].fixed_value
        )
        holdup = np.concatenate([[prev], np.asarray(sol[blk._tank_var])])
        rows = []
        for t in range(blk.horizon):
            rows.append(
                {
                    "Date": date,
                    "Hour": hour,
                    "Horizon [hr]": int(t),
                    "Power to Grid [MW]": round(
                        float(blk.power_output_values(sol)[t]), 2
                    ),
                    "Power to PEM [MW]": round(
                        float(sol[blk._pem_var][t]) * 1e-3, 2
                    ),
                    "Initial holdup [kg]": round(holdup[t] * MW_H2, 2),
                    "Final holdup [kg]": round(holdup[t + 1] * MW_H2, 2),
                    "Hydrogen Market [kg/hr]": round(
                        float(sol[blk._pipeline_var][t]) * MW_H2 * 3600.0, 2
                    ),
                    **kwargs,
                }
            )
        self.result_list.append(pd.DataFrame(rows))

    def write_results(self, path):
        import pandas as pd

        pd.concat(self.result_list).to_csv(path, index=False)

    @property
    def power_output(self):
        return "P_T"

    @property
    def total_cost(self):
        return ("tot_cost", 1)

    @property
    def pmin(self):
        return self.p_lower

    @property
    def pmax(self):
        return self.p_upper
