"""MultiPeriodWindBattery: the bidding/tracking protocol object for the
wind+battery plant (counterpart of ``dispatches_tpu/case_studies/
renewables/wind_battery_double_loop.py``).

``populate_model`` builds the operation model with power/cost
expressions and a curtailment penalty, ``update_model`` advances realized
SoC/throughput and shifts the capacity-factor window,
``get_last_delivered_power``, ``get_implemented_profile``,
``record_results``/``write_results``, and the ``power_output``/
``total_cost`` property protocol.

The operation model is ONE flowsheet over the horizon whose capacity
factors and initial conditions are params — ``update_model`` writes
numbers, never rebuilds, so the rolling horizon reuses one built solver.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from dispatches_tpu_torch.case_studies.renewables import load_parameters as lp
from dispatches_tpu_torch.case_studies.renewables.flowsheet import create_model


class MultiPeriodWindBattery:
    def __init__(
        self,
        model_data,
        wind_capacity_factors: Sequence[float] = None,
        wind_pmax_mw: float = 200.0,
        battery_pmax_mw: float = 25.0,
        battery_energy_capacity_mwh: float = 100.0,
        wind_waste_penalty: float = 1e3,
    ):
        if wind_capacity_factors is None:
            raise ValueError("Please provide wind capacity factors.")
        self.model_data = model_data
        self._wind_capacity_factors = np.asarray(wind_capacity_factors, float)
        self._wind_pmax_mw = wind_pmax_mw
        self._battery_pmax_mw = battery_pmax_mw
        self._battery_energy_capacity_mwh = battery_energy_capacity_mwh
        self._wind_waste_penalty = wind_waste_penalty
        self.result_list: List = []

    # -- protocol ------------------------------------------------------

    def populate_model(self, blk, horizon: int) -> None:
        """Build the fixed-design operation model over ``horizon`` and
        attach power/cost expressions (reference :137-180)."""
        m = create_model(
            re_mw=self._wind_pmax_mw,
            pem_bar=None,
            batt_mw=self._battery_pmax_mw,
            tank_type=None,
            tank_length_m=None,
            turb_inlet_bar=None,
            horizon=horizon,
            capacity_factors=self._wind_capacity_factors[:horizon],
        )
        fs = m.fs
        # operation mode: design fixed (transform_design_model_to_
        # operation_model, reference :55-84); initial conditions fixed
        fs.fix("battery.nameplate_energy",
               self._battery_energy_capacity_mwh * 1e3)
        fs.deactivate("battery.four_hr_battery")
        fs.fix("battery.initial_state_of_charge", 0.0)
        fs.fix("battery.initial_energy_throughput", 0.0)

        blk.m = m
        blk.horizon = horizon
        blk._time_idx = 0
        penalty = self._wind_waste_penalty

        def power_output_expr(v, p):
            # MW delivered to the grid (reference P_T, :172)
            return (v["splitter.grid_elec"] + v["battery.elec_out"]) * 1e-3

        def wind_waste_expr(v, p):
            cap = v["windpower.system_capacity"]
            return (cap * p["windpower.capacity_factor"]
                    - v["windpower.electricity"]) * 1e-3

        def total_cost_expr(v, p):
            from dispatches_tpu_torch.core.graph import tshift

            wind_om = v["windpower.system_capacity"] * lp.wind_op_cost / 8760
            batt_var = (
                lp.batt_rep_cost_kwh
                * p["battery.degradation_rate"]
                * (
                    v["battery.energy_throughput"]
                    - tshift(
                        v["battery.energy_throughput"],
                        v["battery.initial_energy_throughput"],
                    )
                )
            )
            return wind_om + batt_var + penalty * wind_waste_expr(v, p)

        blk.power_output_expr = power_output_expr
        blk.total_cost_expr = total_cost_expr
        blk.wind_waste_expr = wind_waste_expr

        def power_output_values(sol):
            return (sol["splitter.grid_elec"] + sol["battery.elec_out"]) * 1e-3

        blk.power_output_values = power_output_values

    def batch_day_params(self, blk, n_days: int):
        """Deterministic per-day param windows for day-parallel bidding
        (SURVEY §2.7): day ``i`` of the batch sees the capacity-factor
        window ``update_model`` would have rolled to after ``i``
        implemented days.  Realized initial conditions are NOT advanced
        here — they are outcome-dependent and re-sync sequentially
        through ``update_model`` at each window boundary."""
        rows = [self._cf_window(blk._time_idx + 24 * i, blk.horizon)
                for i in range(n_days)]
        return {"windpower.capacity_factor": np.stack(rows)}

    def _cf_window(self, start: int, horizon: int) -> np.ndarray:
        """CF window [start, start+horizon), edge-extended past the data
        end (a clamped start keeps the slice non-empty, so rolling
        fully past the series continues its last value).  Shared by the
        sequential roll and the day-batch so the two paths cannot
        drift."""
        start = min(int(start), len(self._wind_capacity_factors) - 1)
        cfs = self._wind_capacity_factors[start: start + horizon]
        if len(cfs) < horizon:
            cfs = np.pad(cfs, (0, horizon - len(cfs)), mode="edge")
        return np.asarray(cfs, float)

    def update_model(self, blk, realized_soc, realized_energy_throughput):
        """Advance realized initial conditions + CF window
        (reference :182-210)."""
        fs = blk.m.fs
        fs.var_specs["battery.initial_state_of_charge"].fixed_value = np.asarray(
            round(float(realized_soc[-1]), 2)
        )
        fs.var_specs[
            "battery.initial_energy_throughput"
        ].fixed_value = np.asarray(round(float(realized_energy_throughput[-1]), 2))

        blk._time_idx += min(len(realized_soc), 24)
        fs.params["windpower.capacity_factor"] = self._cf_window(
            blk._time_idx, blk.horizon)

    @staticmethod
    def get_last_delivered_power(blk, sol, last_implemented_time_step: int):
        return float(blk.power_output_values(sol)[last_implemented_time_step])

    @staticmethod
    def get_implemented_profile(blk, sol, last_implemented_time_step: int):
        t = last_implemented_time_step + 1
        return {
            "realized_soc": list(sol["battery.state_of_charge"][:t]),
            "realized_energy_throughput": list(
                sol["battery.energy_throughput"][:t]
            ),
        }

    def record_results(self, blk, sol, date=None, hour=None, **kwargs):
        import pandas as pd

        p = blk.m.fs.params
        cfs = np.asarray(p["windpower.capacity_factor"])
        cap = float(blk.m.fs.var_specs["windpower.system_capacity"].fixed_value)
        rows = []
        for t in range(blk.horizon):
            rows.append({
                "Generator": self.model_data.gen_name,
                "Date": date,
                "Hour": hour,
                "Horizon [hr]": t,
                "Total Wind Generation [MW]": round(
                    float(sol["windpower.electricity"][t]) * 1e-3, 2),
                "Total Power Output [MW]": round(
                    float(blk.power_output_values(sol)[t]), 2),
                "Wind Power Output [MW]": round(
                    float(sol["splitter.grid_elec"][t]) * 1e-3, 2),
                "Wind Curtailment [MW]": round(
                    (cap * cfs[t] - float(sol["windpower.electricity"][t]))
                    * 1e-3, 2),
                "Battery Power Output [MW]": round(
                    float(sol["battery.elec_out"][t]) * 1e-3, 2),
                "Wind Power to Battery [MW]": round(
                    float(sol["battery.elec_in"][t]) * 1e-3, 2),
                "State of Charge [MWh]": round(
                    float(sol["battery.state_of_charge"][t]) * 1e-3, 2),
                **kwargs,
            })
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
        return self.model_data.p_min
