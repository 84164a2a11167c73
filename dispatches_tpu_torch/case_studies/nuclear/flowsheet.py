"""NE flowsheet builder + initialization (counterpart of
``dispatches_tpu/case_studies/nuclear/flowsheet.py``).

``build_ne_flowsheet`` assembles an ElectricalSplitter (np_to_grid /
np_to_pem with split-fraction vars), PEM electrolyzer, simple H2 tank,
and the translator -> mixer (air + hydrogen feeds) -> H2 turbine train;
``fix_dof_and_initialize`` fixes the same degrees of freedom and gives
warm starts (a host-side stagewise precompute).

Optional capacity limits: PEM electricity upper bound, tank holdup
bound, turbine work bound.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from dispatches_tpu_torch.core.graph import Flowsheet
from dispatches_tpu_torch.case_studies.renewables.flowsheet import REModel
from dispatches_tpu_torch.models import (
    ElectricalSplitter,
    Mixer,
    PEMElectrolyzer,
    SimpleHydrogenTank,
    Translator,
)
from dispatches_tpu_torch.models.hydrogen_turbine import HydrogenTurbine
from dispatches_tpu_torch.properties import (
    H2CombustionReaction,
    h2_ideal_vap,
    hturbine_ideal_vap,
)

MW_H2 = 2.016e-3  # kg/mol

SLACK_Y = {"hydrogen": 0.99, "oxygen": 0.0025, "argon": 0.0025,
           "nitrogen": 0.0025, "water": 0.0025}
AIR_Y = {"oxygen": 0.2054, "argon": 0.0032, "nitrogen": 0.7672,
         "water": 0.0240, "hydrogen": 2e-4}


def build_ne_flowsheet(
    horizon: int = 1,
    np_capacity: float = 500.0,
    include_pem: bool = True,
    include_tank: bool = True,
    include_turbine: bool = True,
    pem_capacity: Optional[float] = None,
    tank_capacity: Optional[float] = None,
    turbine_capacity: Optional[float] = None,
) -> REModel:
    """Assemble the NE flowsheet (reference :74-228).  Capacities in MW
    (tank in kg H2)."""
    fs = Flowsheet(horizon=horizon)
    m = REModel(fs=fs)

    split = ElectricalSplitter(
        fs, "np_power_split",
        outlet_list=["np_to_grid", "np_to_pem"],
        add_split_fraction_vars=True,
    )
    m.units["np_power_split"] = split
    fs.fix(split.v("electricity"), np_capacity * 1e3)  # MW -> kW

    if not include_pem:
        fs.fix(split.v("split_fraction_np_to_pem"), 0.0)
        return m

    pem = PEMElectrolyzer(fs, "pem", props=h2_ideal_vap)
    m.units["pem"] = pem
    fs.connect(split.port("np_to_pem_port"), pem.port("electricity_in"),
               name="arc_np_to_pem")
    if pem_capacity is not None:
        fs.set_bounds(pem.v("electricity"), ub=pem_capacity * 1e3)

    if not include_tank:
        return m

    tank = SimpleHydrogenTank(fs, "h2_tank", props=h2_ideal_vap)
    m.units["h2_tank"] = tank
    fs.connect(pem.outlet, tank.inlet, name="arc_pem_to_h2_tank")
    if tank_capacity is not None:
        fs.set_bounds(tank.v("tank_holdup_previous"),
                      ub=tank_capacity / MW_H2)
        fs.set_bounds(tank.v("tank_holdup"), ub=tank_capacity / MW_H2)

    if not include_turbine:
        return m

    translator = Translator(
        fs, "translator",
        inlet_props=h2_ideal_vap,
        outlet_props=hturbine_ideal_vap,
        outlet_mole_fracs=SLACK_Y,
    )
    m.units["translator"] = translator

    mixer = Mixer(
        fs, "mixer", props=hturbine_ideal_vap,
        inlet_list=["air_feed", "hydrogen_feed"],
    )
    m.units["mixer"] = mixer
    mixer.fix_feed_composition("air_feed", AIR_Y)

    turbine = HydrogenTurbine(
        fs, "h2_turbine",
        props=hturbine_ideal_vap,
        reaction=H2CombustionReaction(hturbine_ideal_vap),
    )
    m.units["h2_turbine"] = turbine

    fs.connect(tank.outlet_to_turbine, translator.inlet,
               name="arc_h2_tank_to_translator")
    fs.connect(translator.outlet, mixer.inlet_port("hydrogen_feed"),
               name="arc_translator_to_mixer")
    fs.connect(mixer.outlet, turbine.inlet, name="arc_mixer_to_h2_turbine")

    if turbine_capacity is not None:
        # -work_mechanical <= capacity (reference :219-222, MW -> W)
        fs.add_ineq(
            "h2_turbine.turbine_capacity",
            lambda v, p: -(v[turbine.compressor_work] + v[turbine.turbine_work])
            - turbine_capacity * 1e6,
            scale=1e-6,
        )
    return m


def fix_dof_and_initialize(
    m: REModel,
    pem_outlet_pressure: float = 1.01325,
    pem_outlet_temperature: float = 300.0,
    air_h2_ratio: float = 10.76,
    compressor_dp: float = 24.01,
    split_frac_grid: float = 0.99,
    tank_holdup_previous: float = 0.0,
    flow_mol_to_turbine: float = 1.0,
    flow_mol_to_pipeline: float = 1.0,
) -> None:
    """Fix degrees of freedom + warm-start (reference :229-333)."""
    fs = m.fs
    units = m.units

    split = units["np_power_split"]
    np_kw = np.asarray(fs.var_specs[split.v("electricity")].fixed_value)
    if "pem" not in units:
        return
    fs.fix(split.v("split_fraction_np_to_grid"), split_frac_grid)

    pem = units["pem"]
    pem_kw = (1.0 - split_frac_grid) * np_kw
    h2_out = pem_kw * 0.002527406
    fs.fix(pem.outlet_state.pressure, pem_outlet_pressure * 1e5)
    fs.fix(pem.outlet_state.temperature, pem_outlet_temperature)
    fs.set_init(pem.v("electricity"), pem_kw)
    fs.set_init(pem.outlet_state.flow_mol, h2_out)
    fs.set_init(split.v("np_to_pem_elec"), pem_kw)
    fs.set_init(split.v("np_to_grid_elec"), split_frac_grid * np_kw)
    fs.set_init(split.v("split_fraction_np_to_pem"), 1 - split_frac_grid)

    if "h2_tank" not in units:
        return
    tank = units["h2_tank"]
    fs.fix(tank.v("tank_holdup_previous"), tank_holdup_previous)
    fs.fix(tank.pipeline_state.flow_mol, flow_mol_to_pipeline)
    if "h2_turbine" not in units:
        fs.fix(tank.turbine_state.flow_mol, 0.0)
        flow_mol_to_turbine = 0.0
    else:
        fs.fix(tank.turbine_state.flow_mol, flow_mol_to_turbine)
    for sb in (tank.inlet_state, tank.pipeline_state, tank.turbine_state):
        fs.set_init(sb.temperature, pem_outlet_temperature)
        fs.set_init(sb.pressure, pem_outlet_pressure * 1e5)
    fs.set_init(tank.inlet_state.flow_mol, h2_out)
    T = fs.horizon
    net = h2_out - flow_mol_to_pipeline - flow_mol_to_turbine
    fs.set_init(
        tank.v("tank_holdup"),
        tank_holdup_previous + 3600.0 * net * np.arange(1, T + 1),
    )

    if "h2_turbine" not in units:
        return

    translator = units["translator"]
    fs.set_init(translator.inlet_state.flow_mol, flow_mol_to_turbine)
    fs.set_init(translator.inlet_state.temperature, pem_outlet_temperature)
    fs.set_init(translator.inlet_state.pressure, pem_outlet_pressure * 1e5)
    fs.set_init(translator.outlet_state.flow_mol, flow_mol_to_turbine)
    fs.set_init(translator.outlet_state.temperature, pem_outlet_temperature)
    fs.set_init(translator.outlet_state.pressure, pem_outlet_pressure * 1e5)

    mixer = units["mixer"]
    turbine = units["h2_turbine"]
    comps = turbine.props.components
    air_flow = flow_mol_to_turbine * air_h2_ratio
    fs.fix(mixer.inlet_states["air_feed"].flow_mol, air_flow)
    fs.fix(mixer.inlet_states["air_feed"].temperature, pem_outlet_temperature)
    fs.fix(mixer.inlet_states["air_feed"].pressure, pem_outlet_pressure * 1e5)

    fc_h2 = np.array([flow_mol_to_turbine * SLACK_Y[c] for c in comps])
    fc_air = np.array([air_flow * AIR_Y[c] for c in comps])
    fs.set_init(translator.outlet_state.flow_mol_comp, fc_h2)
    fs.set_init(mixer.inlet_states["hydrogen_feed"].flow_mol, flow_mol_to_turbine)
    fs.set_init(mixer.inlet_states["hydrogen_feed"].flow_mol_comp, fc_h2)
    fs.set_init(mixer.inlet_states["hydrogen_feed"].temperature,
                pem_outlet_temperature)
    fs.set_init(mixer.inlet_states["hydrogen_feed"].pressure,
                pem_outlet_pressure * 1e5)
    fc_mix = fc_h2 + fc_air
    fs.set_init(mixer.mixed_state.flow_mol, fc_mix.sum())
    fs.set_init(mixer.mixed_state.flow_mol_comp, fc_mix)
    fs.set_init(mixer.mixed_state.temperature, pem_outlet_temperature)
    fs.set_init(mixer.mixed_state.pressure, pem_outlet_pressure * 1e5)

    fs.fix(turbine.v("compressor.deltaP"), compressor_dp * 1e5)
    fs.fix(turbine.v("compressor.efficiency_isentropic"), 0.86)
    fs.fix(turbine.v("reactor.conversion"), 0.99)
    fs.fix(turbine.v("turbine.deltaP"), -compressor_dp * 1e5)
    fs.fix(turbine.v("turbine.efficiency_isentropic"), 0.89)
    turbine.initialize(
        flow_mol_comp=fc_mix,
        temperature=pem_outlet_temperature,
        pressure=pem_outlet_pressure * 1e5,
    )
