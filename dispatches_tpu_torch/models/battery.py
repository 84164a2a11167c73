"""Battery storage unit model (counterpart of
``dispatches_tpu/models/battery.py``): SoC evolution, throughput
accumulation, degradation-linked capacity bound and nameplate power
bounds over the whole horizon, chained with :func:`tshift`."""

from __future__ import annotations

from dispatches_tpu_torch.core.graph import Flowsheet, UnitModel, tshift


class BatteryStorage(UnitModel):
    def __init__(
        self,
        fs: Flowsheet,
        name: str = "battery",
        charging_eta: float = 0.95,
        discharging_eta: float = 0.95,
        degradation_rate: float = 1e-4,
    ):
        super().__init__(fs, name)
        dt = fs.dt_hr

        # sweepable parameters
        eta_c = self.add_param("charging_eta", charging_eta)
        eta_d = self.add_param("discharging_eta", discharging_eta)
        deg = self.add_param("degradation_rate", degradation_rate)

        # design + initial-condition vars
        P = self.add_var("nameplate_power", shape=(), lb=0, ub=1e8, scale=1e3)
        E = self.add_var("nameplate_energy", shape=(), lb=0, ub=1e9, scale=1e3)
        soc0 = self.add_var("initial_state_of_charge", shape=(), lb=0, scale=1e3)
        tp0 = self.add_var("initial_energy_throughput", shape=(), lb=0, scale=1e3)

        # operating vars
        ein = self.add_var("elec_in", lb=0, scale=1e3)
        eout = self.add_var("elec_out", lb=0, scale=1e3)
        soc = self.add_var("state_of_charge", lb=0, scale=1e3)
        tput = self.add_var("energy_throughput", lb=0, scale=1e3)

        # SoC evolution, chained via tshift
        self.add_eq(
            "state_evolution",
            lambda v, p: v[soc]
            - tshift(v[soc], v[soc0])
            - dt * (p[eta_c] * v[ein] - v[eout] / p[eta_d]),
        )
        # throughput accumulation
        self.add_eq(
            "accumulate_energy_throughput",
            lambda v, p: v[tput]
            - tshift(v[tput], v[tp0])
            - dt * (v[ein] + v[eout]) / 2.0,
        )
        # degradation-linked capacity bound
        self.add_ineq(
            "state_of_charge_bounds",
            lambda v, p: v[soc] - (v[E] - p[deg] * v[tput]),
        )
        # nameplate power bounds
        self.add_ineq("power_bound_in", lambda v, p: v[ein] - v[P])
        self.add_ineq("power_bound_out", lambda v, p: v[eout] - v[P])

        self.add_port("power_in", {"electricity": ein})
        self.add_port("power_out", {"electricity": eout})

    def report_columns(self, solution):
        """The battery report's ``kWh`` state column."""
        return {
            "kWh": {
                "initial_state_of_charge":
                    self.v("initial_state_of_charge"),
                "initial_energy_throughput":
                    self.v("initial_energy_throughput"),
                "state_of_charge": self.v("state_of_charge"),
                "energy_throughput": self.v("energy_throughput"),
            }
        }
