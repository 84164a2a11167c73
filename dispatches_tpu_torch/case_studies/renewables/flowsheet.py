"""RE flowsheet assembly (counterpart of ``dispatches_tpu/case_studies/
renewables/flowsheet.py``): wind or PV + battery + PEM electrolyzer +
hydrogen tank (simple or detailed) + hydrogen turbine train, composed by
``add_*`` functions with port connections over one shared horizon.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from dispatches_tpu_torch.case_studies.renewables import load_parameters as lp
from dispatches_tpu_torch.core.graph import Flowsheet
from dispatches_tpu_torch.models import (
    BatteryStorage,
    ElectricalSplitter,
    HydrogenTank,
    HydrogenTurbine,
    Mixer,
    PEMElectrolyzer,
    SimpleHydrogenTank,
    SolarPV,
    Translator,
    WindPower,
)
from dispatches_tpu_torch.properties import (
    H2CombustionReaction,
    h2_ideal_vap,
    hturbine_ideal_vap,
)


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


def add_pv(m: REModel, pv_mw: float, capacity_factors=None):
    """Fixed system capacity, capacity-factor driven."""
    pv = SolarPV(m.fs, "pv", capacity_factors=capacity_factors)
    m.fs.fix(pv.v("system_capacity"), pv_mw * 1e3)
    m.units["pv"] = pv
    return pv


def add_pem(m: REModel, outlet_pressure_bar: float):
    """Fixed conversion 0.002527406 mol/s per kW, fixed outlet T/P."""
    pem = PEMElectrolyzer(m.fs, "pem", props=h2_ideal_vap)
    m.fs.fix(pem.outlet_state.pressure, outlet_pressure_bar * 1e5)
    m.fs.fix(pem.outlet_state.temperature, lp.pem_temp)
    m.units["pem"] = pem
    return pem


def add_h2_tank(m: REModel, tank_type="simple", valve_outlet_bar=None, length_m=None):
    """The ``simple`` tank, or the ``detailed`` energy-balanced compressed
    tank with fixed geometry."""
    if tank_type == "simple":
        tank = SimpleHydrogenTank(m.fs, "h2_tank", props=h2_ideal_vap)
    elif "detailed" in tank_type:
        tank = HydrogenTank(m.fs, "h2_tank", props=h2_ideal_vap)
        m.fs.fix(tank.v("tank_diameter"), 0.1)
        m.fs.fix(tank.v("tank_length"), length_m)
        for sb in (tank.inlet_state, tank.outlet_state):
            m.fs.set_bounds(sb.pressure, ub=lp.max_pressure_bar * 1e5)
    else:
        raise ValueError(f"Unrecognized tank_type {tank_type}")
    m.units["h2_tank"] = tank
    return tank


def add_h2_turbine(m: REModel, inlet_pres_bar: float):
    """Translator → Mixer (air feed at a fixed air/H2 ratio + a
    purchased-H2 slack feed) → hydrogen turbine with fixed
    deltaP/efficiencies/conversion."""
    fs = m.fs
    slack_y = {"hydrogen": 0.99, "oxygen": 0.0025, "argon": 0.0025,
               "nitrogen": 0.0025, "water": 0.0025}

    translator = Translator(
        fs, "translator",
        inlet_props=h2_ideal_vap,
        outlet_props=hturbine_ideal_vap,
        outlet_mole_fracs=slack_y,
    )
    m.units["translator"] = translator

    mixer = Mixer(
        fs, "mixer",
        props=hturbine_ideal_vap,
        inlet_list=["air_feed", "hydrogen_feed", "purchased_hydrogen_feed"],
    )
    m.units["mixer"] = mixer

    # air feed: fixed T/P/composition
    air_y = {"oxygen": 0.2054, "argon": 0.0032, "nitrogen": 0.7672,
             "water": 0.0240, "hydrogen": 2e-4}
    mixer.fix_feed_composition("air_feed", air_y)
    fs.fix(mixer.inlet_states["air_feed"].temperature, lp.pem_temp)
    fs.fix(mixer.inlet_states["air_feed"].pressure, inlet_pres_bar * 1e5)
    # purchased-hydrogen slack feed: nonzero lb so the turbine inlet flow
    # never vanishes
    mixer.fix_feed_composition("purchased_hydrogen_feed", slack_y)
    fs.fix(mixer.inlet_states["purchased_hydrogen_feed"].temperature, lp.pem_temp)
    fs.fix(mixer.inlet_states["purchased_hydrogen_feed"].pressure,
           inlet_pres_bar * 1e5)
    fs.set_bounds(mixer.inlet_states["purchased_hydrogen_feed"].flow_mol,
                  lb=lp.h2_turb_min_flow / 2)

    # air/H2 ratio
    fs.add_eq(
        "mixer.air_h2_ratio",
        lambda v, p: v[mixer.inlet_states["air_feed"].flow_mol]
        - lp.air_h2_ratio
        * (
            v[mixer.inlet_states["purchased_hydrogen_feed"].flow_mol]
            + v[mixer.inlet_states["hydrogen_feed"].flow_mol]
        ),
    )

    turbine = HydrogenTurbine(
        fs, "h2_turbine",
        props=hturbine_ideal_vap,
        reaction=H2CombustionReaction(hturbine_ideal_vap),
    )
    fs.fix(turbine.v("compressor.deltaP"), lp.compressor_dp_bar * 1e5)
    fs.fix(turbine.v("compressor.efficiency_isentropic"), 0.86)
    fs.fix(turbine.v("reactor.conversion"), 0.99)
    fs.fix(turbine.v("turbine.deltaP"), -lp.compressor_dp_bar * 1e5)
    fs.fix(turbine.v("turbine.efficiency_isentropic"), 0.89)
    m.units["h2_turbine"] = turbine

    fs.connect(translator.outlet, mixer.inlet_port("hydrogen_feed"),
               name="translator_to_mixer")
    fs.connect(mixer.outlet, turbine.inlet, name="mixer_to_turbine")
    return turbine, mixer, translator


def h2_turbine_electricity(turbine: HydrogenTurbine):
    """kW produced by the turbine train, as a function of the vals."""

    def expr(v):
        return (-v[turbine.turbine_work] - v[turbine.compressor_work]) * 1e-3

    return expr


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
    """Assemble the chosen units over one shared horizon: ``None`` leaves
    a unit out.  The turbine train needs the tank, and a tank of type
    other than ``"simple"`` needs ``tank_length_m``."""
    fs = Flowsheet(horizon=horizon, dt_hr=lp.timestep_hrs)
    m = REModel(fs=fs)

    if re_type == "wind":
        re = add_wind(m, re_mw, capacity_factors=capacity_factors,
                      wind_speeds=wind_speeds)
    elif re_type == "pv":
        re = add_pv(m, re_mw, capacity_factors=capacity_factors)
    else:
        raise ValueError(f"unknown re_type {re_type}")

    dests = ["grid"]
    if pem_bar is not None:
        pem = add_pem(m, pem_bar)
        dests.append("pem")
    if batt_mw is not None:
        batt = add_battery(m, batt_mw)
        dests.append("battery")
    if tank_type is not None and (tank_length_m is not None or tank_type == "simple"):
        add_h2_tank(m, tank_type, pem_bar, tank_length_m)
    if turb_inlet_bar is not None and "h2_tank" in m.units:
        add_h2_turbine(m, turb_inlet_bar)

    if len(dests) > 1:
        splitter = ElectricalSplitter(fs, "splitter", outlet_list=dests)
        m.units["splitter"] = splitter
        fs.connect(re.port("electricity_out"), splitter.port("electricity_in"),
                   name="re_to_splitter")
        if "pem" in dests:
            fs.connect(splitter.port("pem_port"), pem.port("electricity_in"),
                       name="splitter_to_pem")
        if "battery" in dests:
            fs.connect(splitter.port("battery_port"), batt.port("power_in"),
                       name="splitter_to_battery")

    if "h2_tank" in m.units and "pem" in m.units:
        fs.connect(m.units["pem"].outlet, m.units["h2_tank"].inlet,
                   name="pem_to_tank")
    if "h2_turbine" in m.units and tank_type == "simple":
        fs.connect(m.units["h2_tank"].outlet_to_turbine,
                   m.units["translator"].inlet, name="h2_tank_to_turb")

    return m
