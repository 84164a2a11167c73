"""Cost/price/size constants of the renewables case (counterpart of the
constants in ``dispatches_tpu/case_studies/renewables/
load_parameters.py``) and ``data_dir()``, where the renewables case's
data directory is found.  The market and resource file loaders are not
ported yet."""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

timestep_hrs = 1.0
h2_mols_per_kg = 500.0
H2_mass_kg_per_mol = 2.016 / 1000

wind_cap_cost = 1550.0  # $/kW
wind_op_cost = 43.0  # $/kW-yr
batt_cap_cost = 300.0 * 4  # $/kW for a 4-hour battery
batt_rep_cost_kwh = batt_cap_cost * 0.5 / 4  # replacement, $/kWh throughput
pem_cap_cost = 1630.0
pem_op_cost = 47.9
pem_var_cost = 1.3 / 1000  # $/kWh
tank_cap_cost_per_m3 = 29 * 0.8 * 1000
tank_cap_cost_per_kg = 29 * 33.5
tank_op_cost = 0.17 * tank_cap_cost_per_kg
turbine_cap_cost = 1000.0
turbine_op_cost = 11.65
turbine_var_cost = 4.27 / 1000

h2_price_per_kg = 2.0

fixed_wind_mw = 847.0
wind_mw_ub = 10000.0
fixed_batt_mw = 4874.0
fixed_pem_mw = 643.0
turb_p_mw = 1.0
fixed_tank_size = 0.5

pem_bar = 1.01325
pem_temp = 300.0
battery_ramp_rate = 1e8  # effectively unconstrained
h2_turb_min_flow = 1e-3
air_h2_ratio = 10.76
compressor_dp_bar = 24.01
max_pressure_bar = 700.0

discount_rate = 0.05
N_years = 30
#: present value of an annuity / capital recovery factor inverse
PA = ((1 + discount_rate) ** N_years - 1) / (
    discount_rate * (1 + discount_rate) ** N_years
)


# ---------------------------------------------------------------------------
# data location
# ---------------------------------------------------------------------------


def data_dir() -> Optional[Path]:
    """The renewables case's data directory: ``DISPATCHES_TPU_DATA`` when
    it names an existing directory, else None (nothing mounted)."""
    d = os.environ.get("DISPATCHES_TPU_DATA", "")
    if d and Path(d).exists():
        return Path(d)
    return None
