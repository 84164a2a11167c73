"""Cost/price/size parameters and market/resource data loading for the
renewables case (counterpart of ``dispatches_tpu/case_studies/
renewables/load_parameters.py``; the same constants, loaders and
synthetic series).

Counterpart of the reference's ``renewables_case/load_parameters.py``:
the cost constants, the price handling (bus 303 DA LMPs capped at
$200), the capital-recovery factor and the SRW Wind-Toolkit resource
loading, with PySAM replaced by a plain-text SRW parser.

Data files are looked up under ``DISPATCHES_TPU_DATA`` (``data_dir``).
When no data is available, deterministic synthetic price and wind series
are generated, equal to the JAX package's, so every driver stays
runnable.  Host numpy and the standard library only (the RTS-GMLC CSV is
read with ``csv`` and ``datetime``).
"""

from __future__ import annotations

import csv
import os
from datetime import datetime, timedelta
from pathlib import Path
from typing import Optional

import numpy as np

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
# data loading
# ---------------------------------------------------------------------------


def data_dir() -> Optional[Path]:
    """The renewables case's data directory: ``DISPATCHES_TPU_DATA`` when
    it names an existing directory, else None (nothing mounted)."""
    d = os.environ.get("DISPATCHES_TPU_DATA", "")
    if d and Path(d).exists():
        return Path(d)
    return None


def srw_to_wind_speeds(path) -> np.ndarray:
    """Parse an NREL Wind-Toolkit SRW file and return hub-height wind
    speeds (m/s, 8760 values).  Format: 5 header lines (site meta,
    description, column names, units, measurement heights) then hourly
    rows Temperature,Pressure,Speed,Direction; the reference reads the
    Speed column through ``PySAM.ResourceTools.SRW_to_wind_data``."""
    speeds = []
    with open(path) as f:
        rows = list(csv.reader(f))
    cols = [c.strip().lower() for c in rows[2]]
    speed_col = cols.index("speed")
    for row in rows[5:]:
        if row:
            speeds.append(float(row[speed_col]))
    return np.asarray(speeds)


def load_wind_speeds() -> np.ndarray:
    """Hub-height wind speeds from the data directory's first SRW file,
    else the deterministic synthetic resource (8760 hours)."""
    d = data_dir()
    srw = None
    if d:
        hits = sorted(d.glob("data/*.srw")) or sorted(d.glob("*.srw"))
        srw = hits[0] if hits else None
    if srw is not None:
        return srw_to_wind_speeds(srw)
    # deterministic synthetic resource: diurnal + weather-band mix
    t = np.arange(8760)
    return 8.0 + 3.5 * np.sin(2 * np.pi * t / 24 + 1.0) + 2.0 * np.sin(
        2 * np.pi * t / (24 * 5)
    )


def _dispatch_hours():
    """The hours the reference keeps: 365 days hourly from 2020-01-02,
    minus Feb 29 (8736 hours)."""
    start = datetime(2020, 1, 2)
    hours = (start + timedelta(hours=i) for i in range(365 * 24))
    return {h for h in hours if h.day != 29 or h.month != 2}


def load_da_lmps(cap: float = 200.0) -> np.ndarray:
    """Bus 303 DA LMPs from the precompiled RTS-GMLC outputs
    (``data/Wind_Thermal_Dispatch.csv``: a timestamp index column and a
    ``303_DALMP`` column; the rows of ``_dispatch_hours`` in file order),
    capped at $200/MWh; a deterministic synthetic series when the file is
    absent."""
    d = data_dir()
    csv_path = d / "data" / "Wind_Thermal_Dispatch.csv" if d else None
    if csv_path and csv_path.exists():
        keep = _dispatch_hours()
        with open(csv_path, newline="") as f:
            rows = csv.reader(f)
            col = next(rows).index("303_DALMP")
            prices = np.asarray(
                [float(r[col]) for r in rows
                 if r and datetime.fromisoformat(r[0].strip()) in keep],
                dtype=float)
    else:
        t = np.arange(8736)
        prices = (
            30.0
            + 15.0 * np.sin(2 * np.pi * t / 24 - 0.5)
            + 10.0 * np.sin(2 * np.pi * t / (24 * 7))
        )
    return np.minimum(prices, cap)


def load_rts_test_prices(cap: float = 200.0) -> Optional[np.ndarray]:
    """The 8736-h price array the reference's RE regression tests use
    (``tests/rts_results_all_prices.npy``, the second array in the
    file), capped; None when the file is absent."""
    d = data_dir()
    p = d / "tests" / "rts_results_all_prices.npy" if d else None
    if not (p and p.exists()):
        return None
    with open(p, "rb") as f:
        _ = np.load(f)
        prices = np.load(f)
    return np.minimum(prices, cap)


def default_input_params() -> dict:
    """Reference ``default_input_params``: the design and market inputs of
    the renewables case."""
    wind_speeds = load_wind_speeds()
    return {
        "wind_mw": fixed_wind_mw,
        "wind_mw_ub": wind_mw_ub,
        "batt_mw": fixed_batt_mw,
        "pem_mw": fixed_pem_mw,
        "pem_bar": pem_bar,
        "pem_temp": pem_temp,
        "tank_size": fixed_tank_size,
        "tank_type": "simple",
        "turb_mw": turb_p_mw,
        "wind_speeds": wind_speeds,
        "h2_price_per_kg": h2_price_per_kg,
        "DA_LMPs": load_da_lmps(),
        "design_opt": True,
        "extant_wind": True,
    }
