"""RE flowsheet builder (counterpart of ``dispatches_tpu/case_studies/
renewables/flowsheet.py``): wind + battery + electrical splitter with
port connections over one shared horizon.  The PV, PEM, hydrogen tank
and hydrogen turbine branches are not ported yet and raise."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from dispatches_tpu_torch.case_studies.renewables import load_parameters as lp
from dispatches_tpu_torch.core.graph import Flowsheet
from dispatches_tpu_torch.models import BatteryStorage, ElectricalSplitter, WindPower


@dataclass
class REModel:
    """Assembled flowsheet + handles to its units."""

    fs: Flowsheet
    units: Dict[str, object] = field(default_factory=dict)

    def __getattr__(self, name):
        units = object.__getattribute__(self, "units")
        if name in units:
            return units[name]
        raise AttributeError(name)


def add_wind(m: REModel, wind_mw: float, capacity_factors=None, wind_speeds=None):
    """Fixed system capacity, capacity-factor driven."""
    wind = WindPower(
        m.fs, "windpower", capacity_factors=capacity_factors, wind_speeds=wind_speeds
    )
    m.fs.fix(wind.v("system_capacity"), wind_mw * 1e3)  # kW
    m.units["windpower"] = wind
    return wind


def add_battery(m: REModel, batt_mw: float):
    """Fixed power, 4-hour duration tying nameplate_energy to
    nameplate_power."""
    batt = BatteryStorage(m.fs, "battery")
    m.fs.fix(batt.v("nameplate_power"), batt_mw * 1e3)
    m.fs.add_eq(
        "battery.four_hr_battery",
        lambda v, p: v["battery.nameplate_power"] * 4.0
        - v["battery.nameplate_energy"],
    )
    m.units["battery"] = batt
    return batt


def _not_ported(what: str):
    raise ValueError(f"{what} is not ported to dispatches_tpu_torch yet")


def create_model(
    re_mw: float,
    pem_bar: Optional[float],
    batt_mw: Optional[float],
    tank_type: Optional[str],
    tank_length_m: Optional[float],
    turb_inlet_bar: Optional[float],
    horizon: int = 1,
    capacity_factors=None,
    wind_speeds=None,
    re_type: str = "wind",
) -> REModel:
    """Assemble the chosen units over one shared horizon.  Only the wind
    and battery units are ported: ``pem_bar``, ``tank_type`` and
    ``turb_inlet_bar`` must be None and ``re_type`` must be "wind"."""
    if re_type != "wind":
        _not_ported(f"re_type {re_type!r}")
    if pem_bar is not None:
        _not_ported("the PEM electrolyzer branch")
    if tank_type is not None:
        _not_ported("the hydrogen tank branch")
    if turb_inlet_bar is not None:
        _not_ported("the hydrogen turbine branch")

    fs = Flowsheet(horizon=horizon, dt_hr=lp.timestep_hrs)
    m = REModel(fs=fs)
    re = add_wind(m, re_mw, capacity_factors=capacity_factors,
                  wind_speeds=wind_speeds)

    if batt_mw is not None:
        batt = add_battery(m, batt_mw)
        splitter = ElectricalSplitter(fs, "splitter", outlet_list=["grid", "battery"])
        m.units["splitter"] = splitter
        fs.connect(re.port("electricity_out"), splitter.port("electricity_in"),
                   name="re_to_splitter")
        fs.connect(splitter.port("battery_port"), batt.port("power_in"),
                   name="splitter_to_battery")
    return m
