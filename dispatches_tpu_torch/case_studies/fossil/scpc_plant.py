"""692 MW supercritical pulverized-coal plant with optional ConcreteTES
(counterpart of ``dispatches_tpu/case_studies/fossil/scpc_plant.py``; the
same units, arcs, constraints, inputs, bounds and initialization).

Counterpart of the reference's
``fossil_case/supercritical_plant/supercritical_powerplant.py``: 9 lumped
turbine stages with outlet splitters, boiler + one reheater (outlet
temperature pinned at 866.15 K), 7 feed-water heaters with drain-mixer
cascades (deaerator = mixer 5), a shell/tube condenser with cooling
water, condensate/boiler-feed pumps, the boiler-feed-pump turbine whose
work balances the BFP, and the concrete thermal-energy-storage
integration (``append_tes_unit_models``: HP steam diverted from the
boiler outlet through the TES charge side into FWH-mixer 7, a
fixed-state feedwater stream through the discharge side into a dedicated
discharge turbine exhausting at 6,644 Pa).

Anchors: 692 MW net power without TES, 625 MW with the TES charging at
a 0.1 HP split fraction (the reference's ``test_scpc_flowsheet.py``).
The JAX package's build lands at ``JAX_NET_POWER_MW``; the port lands on
those values.

Same architecture as ``usc_plant``: one square NLP over Helm-style
stream states with explicit IAPWS-95 EoS variables, horizon-vectorized,
initialized by a host-side sequential sweep (``initialize``) instead of
the reference's per-unit IPOPT ladder, and solved by Newton on
``device`` (``solve_plant``: ``cuda`` unless the caller passes
``device="cpu"``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

from dispatches_tpu_torch import resolve_device
from dispatches_tpu_torch.case_studies.fossil.usc_plant import _set_iso_init, _set_state_init
from dispatches_tpu_torch.core.graph import Flowsheet, UnitModel
from dispatches_tpu_torch.models.concrete_tes import ConcreteTES
from dispatches_tpu_torch.models.steam_cycle import (
    SteamFWH,
    SteamHeater,
    SteamIsentropicCompressor,
    SteamMixer,
    SteamSplitter,
    SteamState,
    SteamTurbineStage,
    underwood_lmtd,
)
from dispatches_tpu_torch.properties import iapws95 as w95

# ---------------------------------------------------------------------
# Design data (reference ``fix_dof_and_initialize``, :624-700)
# ---------------------------------------------------------------------

MAIN_STEAM_PRESSURE = 24235081.4   # Pa
BOILER_FLOW = 29111.0              # mol/s
BOILER_OUT_T = 866.15              # K (:208-215)
REHEATER_DP = -96526.64            # Pa (NETL baseline)

TURBINE_DOF = {1: (0.80 ** 5, 0.94), 2: (0.80 ** 2, 0.94),
               3: (0.79 ** 4, 0.88), 4: (0.79 ** 6, 0.88),
               5: (0.64 ** 2, 0.78), 6: (0.64 ** 2, 0.78),
               7: (0.64 ** 2, 0.78), 8: (0.64 ** 2, 0.78),
               9: (0.50, 0.78)}

FWH_SET = (1, 2, 3, 4, 6, 7, 8)
FWH_MIX_SET = (1, 2, 3, 5, 6, 7)   # 5 = deaerator
FWH_DOF = {1: (400.0, 2000.0), 2: (300.0, 2900.0), 3: (200.0, 2900.0),
           4: (200.0, 2900.0), 6: (600.0, 2900.0), 7: (400.0, 2900.0),
           8: (400.0, 2900.0)}
# shell-side condensate pressure rule factors (:243-249)
FWH_PRESS_RATIO = {1: 0.5, 2: 0.64 ** 2, 3: 0.64 ** 2, 4: 0.64 ** 2,
                   6: 0.79 ** 6, 7: 0.79 ** 4, 8: 0.8 ** 2}

# t_splitter outlet_2 destinations (``create_arcs``, :461-474)
SPLIT_FWH_MAP = {1: ("fwh", 8), 2: ("fwh_mix", 7), 3: ("fwh_mix", 6),
                 4: ("fwh_mix", 5), 5: ("fwh", 4), 6: ("fwh_mix", 3),
                 7: ("fwh_mix", 2), 8: ("fwh_mix", 1)}

SPLITTER4_FRAC2 = 0.050331         # to deaerator (:656)
PUMP_EFF = 0.80
COND_PUMP_DP = 1e6
BFP_PRESSURE_FACTOR = 1.15
CONDENSER_CW_P = 500000.0
CONDENSER_CW_H = 1800.0
CONDENSER_AREA = 34000.0
CONDENSER_U = 3100.0
MAKEUP_PRESSURE = 103421.4
MAKEUP_ENTH = 1131.69204

DIS_TURBINE_EFF = 0.75
DIS_TURBINE_P_OUT = 6644.0         # Pa (:443-449)
DIS_IN_PRES = 8.5e5
DIS_IN_TEMP = 355.0

#: net power (MW) at which the JAX package's Newton solve of this build
#: lands, keyed by ``include_concrete_tes`` (the TES at a 0.1 HP split);
#: reproduced on the CPU by tests/test_torch_scpc.py::test_solves_match_jax,
#: and the port's solves land within 1e-6 relative of them
JAX_NET_POWER_MW = {False: 690.3820063421963, True: 628.2377663434456}

# initialization seeds (:715-740)
SPLIT_FRAC_SEED = {1: 0.12812, 2: 0.061824, 3: 0.03815,
                   5: 0.0381443, 6: 0.017535, 7: 0.0154, 8: 0.00121}
SPLITTER4_FRAC1_SEED = 0.9019

CONC_TES_DATA = {
    "num_tubes": 10000,
    "num_segments": 20,
    "num_time_periods": 2,
    "tube_length": 64.9,
    "tube_diameter": 0.0105664,
    "face_area": 0.00847,
    "therm_cond_concrete": 1,
    "dens_mass_concrete": 2240,
    "cp_mass_concrete": 900,
    "init_temperature_concrete": [
        750, 732.631579, 715.2631579, 697.8947368, 680.5263158,
        663.1578947, 645.7894737, 628.4210526, 611.0526316, 593.6842105,
        576.3157895, 558.9473684, 541.5789474, 524.2105263, 506.8421053,
        489.4736842, 472.1052632, 454.7368421, 437.3684211, 420,
    ],
    "inlet_pressure_charge": 19600000.0,
    "inlet_pressure_discharge": DIS_IN_PRES,
}


@dataclass
class ScpcModel:
    fs: Flowsheet
    units: Dict[str, object] = field(default_factory=dict)
    include_concrete_tes: bool = True

    def __getitem__(self, name):
        return self.units[name]


class SteamCondenser(UnitModel):
    """Shell/tube surface condenser (the reference's ``CondenserHelm``
    consumption, :337-346): condensing steam on the shell leaves as
    saturated liquid (vapor fraction pinned to 0), cooling water on the
    tube side with fixed inlet state; the cooling-water flow is FREE —
    the energy balance determines it."""

    def __init__(self, fs: Flowsheet, name: str = "condenser"):
        super().__init__(fs, name)
        self.shell_in = SteamState(self, "shell_inlet", "wet")
        self.shell_out = SteamState(self, "shell_outlet", "wet")
        self.tube_in = SteamState(self, "tube_inlet", "liq")
        self.tube_out = SteamState(self, "tube_outlet", "liq")
        A = self.add_var("area", shape=(), lb=1.0, ub=1e6, init=34000.0,
                         scale=1e4)
        U = self.add_var("overall_heat_transfer_coefficient", shape=(),
                         lb=1.0, ub=1e5, init=3100.0, scale=1e3)
        Q = self.add_var("heat_duty", lb=0.0, ub=5e10, init=8e8, scale=1e8)
        self.area, self.htc, self.heat_duty = A, U, Q

        si, so, ti, to = (self.shell_in, self.shell_out,
                          self.tube_in, self.tube_out)
        self.add_eq("shell_flow",
                    lambda v, p: v[so.flow_mol] - v[si.flow_mol], scale=1e-2)
        self.add_eq("tube_flow",
                    lambda v, p: v[to.flow_mol] - v[ti.flow_mol], scale=1e-2)
        self.add_eq("shell_pressure",
                    lambda v, p: v[so.pressure] - v[si.pressure], scale=1e-5)
        self.add_eq("tube_pressure",
                    lambda v, p: v[to.pressure] - v[ti.pressure], scale=1e-5)
        self.add_eq("shell_energy",
                    lambda v, p: v[si.flow_mol]
                    * (v[so.enth_mol] - v[si.enth_mol]) + v[Q], scale=1e-8)
        self.add_eq("tube_energy",
                    lambda v, p: v[ti.flow_mol]
                    * (v[to.enth_mol] - v[ti.enth_mol]) - v[Q], scale=1e-8)
        Tsi, Tso = si.temperature, so.temperature
        Tti, Tto = ti.temperature, to.temperature
        self.add_eq("heat_transfer",
                    lambda v, p: v[Q] - v[U] * v[A] * underwood_lmtd(
                        v[Tsi] - v[Tto], v[Tso] - v[Tti]), scale=1e-8)
        # saturated-liquid condensate (x == 0)
        fs.fix(so.vapor_frac, 0.0)

    @property
    def shell_inlet(self):
        return self.shell_in.port

    @property
    def shell_outlet(self):
        return self.shell_out.port


def build_scpc_flowsheet(include_concrete_tes: bool = True,
                         conc_tes_data: Dict = None,
                         horizon: int = 1) -> ScpcModel:
    """Assemble the SCPC flowsheet (reference ``build_scpc_flowsheet``,
    :106-403 + ``create_arcs`` :455-581)."""
    fs = Flowsheet(horizon=horizon)
    m = ScpcModel(fs=fs, include_concrete_tes=include_concrete_tes)
    u = m.units

    # ---- units ------------------------------------------------------
    u["boiler"] = SteamHeater(fs, "boiler", inlet_phase="liq",
                              outlet_phase="sc")
    u["reheater"] = SteamHeater(fs, "reheater", inlet_phase="vap",
                                outlet_phase="vap")
    u["hp_splitter"] = SteamSplitter(fs, "hp_splitter", num_outlets=2)
    u["bfp_splitter"] = SteamSplitter(fs, "bfp_splitter", num_outlets=2)
    for i in range(1, 10):
        out_ph = "wet" if i == 9 else "vap"
        u[f"turbine_{i}"] = SteamTurbineStage(
            fs, f"turbine_{i}", inlet_phase="sc" if i == 1 else "vap",
            outlet_phase=out_ph,
            isentropic_phase="wet" if i == 9 else "vap")
    for i in range(1, 9):
        u[f"t_splitter_{i}"] = SteamSplitter(
            fs, f"t_splitter_{i}", num_outlets=3 if i == 4 else 2)
    u["bfpt"] = SteamTurbineStage(fs, "bfpt", inlet_phase="vap",
                                  outlet_phase="wet",
                                  isentropic_phase="wet")
    for i in FWH_SET:
        u[f"fwh_{i}"] = SteamFWH(
            fs, f"fwh_{i}",
            shell_inlet_phase="vap" if i in (4, 8) else "wet",
            turb_press_ratio=FWH_PRESS_RATIO[i])
    for i in FWH_MIX_SET:
        if i == 5:
            inlets = ["steam", "drain", "feedwater"]
            momentum = "feedwater"
        elif i == 7:
            inlets = ["steam", "drain", "from_storage"]
            momentum = "steam"
        else:
            inlets = ["steam", "drain"]
            momentum = "steam"
        u[f"fwh_mix_{i}"] = SteamMixer(
            fs, f"fwh_mix_{i}", inlet_list=inlets, outlet_phase="wet",
            momentum=momentum,
            inlet_phases={"drain": "wet"})
    u["condenser_mix"] = SteamMixer(
        fs, "condenser_mix", inlet_list=["main", "bfpt", "drain", "makeup"],
        outlet_phase="wet", momentum="main",
        inlet_phases={"main": "wet", "bfpt": "wet", "drain": "wet",
                      "makeup": "liq"})
    u["condenser"] = SteamCondenser(fs, "condenser")
    u["cond_pump"] = SteamIsentropicCompressor(fs, "cond_pump")
    u["bfp"] = SteamIsentropicCompressor(fs, "bfp")

    if include_concrete_tes:
        u["tes"] = ConcreteTES(fs, "tes", conc_tes_data or CONC_TES_DATA,
                               operating_mode="combined")
        u["discharge_turbine"] = SteamTurbineStage(
            fs, "discharge_turbine", inlet_phase="vap", outlet_phase="wet",
            isentropic_phase="wet")

    _create_arcs(m)
    _make_constraints(m)
    _set_model_input(m)
    return m


def _create_arcs(m: ScpcModel) -> None:
    fs, u = m.fs, m.units

    def con(a, b, name):
        fs.connect(a, b, name=name)

    con(u["boiler"].outlet, u["hp_splitter"].inlet, "boiler_to_hpsplit")
    con(u["hp_splitter"].outlet(1), u["turbine_1"].inlet, "hpsplit_to_turb1")
    for i in range(1, 9):
        con(u[f"turbine_{i}"].outlet, u[f"t_splitter_{i}"].inlet,
            f"turb{i}_to_split{i}")
        if i == 2:
            con(u["t_splitter_2"].outlet(1), u["reheater"].inlet,
                "split2_to_reheater")
        else:
            con(u[f"t_splitter_{i}"].outlet(1), u[f"turbine_{i + 1}"].inlet,
                f"split{i}_to_turb{i + 1}")
        kind, j = SPLIT_FWH_MAP[i]
        if kind == "fwh":
            con(u[f"t_splitter_{i}"].outlet(2), u[f"fwh_{j}"].shell_inlet,
                f"split{i}_to_fwh{j}")
        else:
            con(u[f"t_splitter_{i}"].outlet(2), u[f"fwh_mix_{j}"].inlet("steam"),
                f"split{i}_to_fwhmix{j}")
    con(u["reheater"].outlet, u["turbine_3"].inlet, "reheater_to_turb3")
    con(u["t_splitter_4"].outlet(3), u["bfpt"].inlet, "split4_to_bfpt")

    # drains: fwh[i+1] shell outlet -> fwh_mix[i] drain
    for i in FWH_MIX_SET:
        con(u[f"fwh_{i + 1}"].shell_outlet, u[f"fwh_mix_{i}"].inlet("drain"),
            f"fwh{i + 1}_to_fwhmix{i}")
        if i != 5:
            con(u[f"fwh_mix_{i}"].outlet, u[f"fwh_{i}"].shell_inlet,
                f"fwhmix{i}_to_fwh{i}")

    # condenser train
    con(u["turbine_9"].outlet, u["condenser_mix"].inlet("main"),
        "turb9_to_condmix")
    con(u["fwh_1"].shell_outlet, u["condenser_mix"].inlet("drain"),
        "fwh1_to_condmix")
    con(u["bfpt"].outlet, u["condenser_mix"].inlet("bfpt"),
        "bfpt_to_condmix")
    con(u["condenser_mix"].outlet, u["condenser"].shell_inlet,
        "condmix_to_cond")
    con(u["condenser"].shell_outlet, u["cond_pump"].inlet, "cond_to_condpump")

    # feedwater chain
    con(u["cond_pump"].outlet, u["fwh_1"].tube_inlet, "condpump_to_fwh1")
    for i in (1, 2, 3):
        con(u[f"fwh_{i}"].tube_outlet, u[f"fwh_{i + 1}"].tube_inlet,
            f"fwh{i}_to_fwh{i + 1}")
    con(u["fwh_4"].tube_outlet, u["fwh_mix_5"].inlet("feedwater"),
        "fwh4_to_deaerator")
    con(u["fwh_mix_5"].outlet, u["bfp_splitter"].inlet,
        "deaerator_to_bfpsplit")
    con(u["bfp_splitter"].outlet(1), u["bfp"].inlet, "bfpsplit_to_bfp")
    con(u["bfp"].outlet, u["fwh_6"].tube_inlet, "bfp_to_fwh6")
    for i in (6, 7):
        con(u[f"fwh_{i}"].tube_outlet, u[f"fwh_{i + 1}"].tube_inlet,
            f"fwh{i}_to_fwh{i + 1}")
    con(u["fwh_8"].tube_outlet, u["boiler"].inlet, "fwh8_to_boiler")

    if m.include_concrete_tes:
        con(u["hp_splitter"].outlet(2), u["tes"].inlet_charge,
            "hpsplit_to_tes")
        con(u["tes"].outlet_charge, u["fwh_mix_7"].inlet("from_storage"),
            "tes_to_fwhmix7")
        con(u["tes"].outlet_discharge, u["discharge_turbine"].inlet,
            "tes_to_disturbine")


def _make_constraints(m: ScpcModel) -> None:
    fs, u = m.fs, m.units

    # boiler + reheater outlet temperature pinned (:208-215)
    for unit in ("boiler", "reheater"):
        fs.fix(u[unit].outlet_state.temperature, BOILER_OUT_T)

    # bfpt exhausts at the condenser-mixer pressure (:374-377)
    p_bfpt = u["bfpt"].outlet_state.pressure
    p_main = u["condenser_mix"].outlet_state.pressure
    fs.add_eq("bfpt_out_pressure",
              lambda v, p: v[p_bfpt] - v[p_main], scale=1e-4)
    # bfpt work balances the bfp (:383-387)
    Wt = u["bfpt"].work_mechanical
    Wp = u["bfp"].work_mechanical
    fs.add_eq("bfp_power_balance",
              lambda v, p: v[Wt] + v[Wp], scale=1e-6)

    # net power (:389-399): turbine train + condensate pump work
    net = fs.add_var("net_power_output", shape=(), lb=0.0, ub=2e3,
                     init=692.0, scale=100.0)
    tw = [u[f"turbine_{i}"].work_mechanical for i in range(1, 10)]
    Wc = u["cond_pump"].work_mechanical
    fs.add_eq("production_cons",
              lambda v, p: -sum(v[w] for w in tw) - v[Wc]
              - v[net] * 1e6, scale=1e-8)


def _set_model_input(m: ScpcModel,
                     hp_split_fraction: float = 0.1,
                     discharge_flow: float = 1.0) -> None:
    """Fix design degrees of freedom (reference
    ``fix_dof_and_initialize``, :624-700)."""
    fs, u = m.fs, m.units

    for i, (pr, eta) in TURBINE_DOF.items():
        fs.fix(u[f"turbine_{i}"].ratioP, pr)
        fs.fix(u[f"turbine_{i}"].efficiency_isentropic, eta)
    fs.fix(u["bfpt"].efficiency_isentropic, PUMP_EFF)
    fs.fix(u["t_splitter_4"].split_fraction[1], SPLITTER4_FRAC2)

    fs.fix(u["boiler"].inlet_state.flow_mol, BOILER_FLOW)
    fs.fix(u["boiler"].outlet_state.pressure, MAIN_STEAM_PRESSURE)
    fs.fix(u["reheater"].deltaP, REHEATER_DP)

    for i, (area, htc) in FWH_DOF.items():
        fs.fix(u[f"fwh_{i}"].area, area)
        fs.fix(u[f"fwh_{i}"].htc, htc)

    mk = u["condenser_mix"].inlet_states["makeup"]
    fs.fix(mk.pressure, MAKEUP_PRESSURE)
    fs.fix(mk.enth_mol, MAKEUP_ENTH)
    fs.set_bounds(mk.flow_mol, lb=0.0, ub=100.0)
    fs.set_init(mk.flow_mol, 1e-6)

    cond = u["condenser"]
    fs.fix(cond.tube_in.pressure, CONDENSER_CW_P)
    fs.fix(cond.tube_in.enth_mol, CONDENSER_CW_H)
    fs.fix(cond.area, CONDENSER_AREA)
    fs.fix(cond.htc, CONDENSER_U)

    fs.fix(u["cond_pump"].efficiency_isentropic, PUMP_EFF)
    fs.fix(u["cond_pump"].deltaP, COND_PUMP_DP)
    fs.fix(u["bfp"].efficiency_isentropic, PUMP_EFF)
    fs.fix(u["bfp"].outlet_state.pressure,
           MAIN_STEAM_PRESSURE * BFP_PRESSURE_FACTOR)

    if m.include_concrete_tes:
        fs.fix(u["hp_splitter"].split_fraction[1], hp_split_fraction)
        fs.fix(u["bfp_splitter"].split_fraction[1], 0.0)
        tes = u["tes"]
        h_dis = float(w95.props_tp(DIS_IN_TEMP, DIS_IN_PRES, "liq")["h"])
        fs.fix(tes.inlet_discharge_state.flow_mol, discharge_flow)
        fs.fix(tes.inlet_discharge_state.enth_mol, h_dis)
        fs.fix(tes.inlet_discharge_state.pressure, DIS_IN_PRES)
        fs.fix(u["discharge_turbine"].efficiency_isentropic,
               DIS_TURBINE_EFF)
        fs.fix(u["discharge_turbine"].outlet_state.pressure,
               DIS_TURBINE_P_OUT)
    else:
        # close the storage ports (:359-366)
        fs.fix(u["hp_splitter"].split_fraction[1], 0.0)
        fs.fix(u["bfp_splitter"].split_fraction[1], 0.0)
        strg = u["fwh_mix_7"].inlet_states["from_storage"]
        fs.fix(strg.flow_mol, 0.0)
        fs.fix(strg.pressure, MAIN_STEAM_PRESSURE)
        fs.fix(strg.enth_mol, 40000.0)

    # flow bounds (reference add_bounds analog); the condenser cooling
    # water is NOT steam-cycle inventory — at ~13 K LMTD it runs
    # O(1e6) mol/s and gets its own wide bound
    flow_max = BOILER_FLOW * 3
    for name, spec in fs.var_specs.items():
        if (name.endswith(".flow_mol")
                and not name.endswith("makeup.flow_mol")
                and not name.startswith("tes.")
                and not name.startswith("condenser.tube")):
            spec.lb, spec.ub = 0.0, flow_max
    for st in (cond.tube_in, cond.tube_out):
        fs.set_bounds(st.flow_mol, lb=0.0, ub=1e7)


# ---------------------------------------------------------------------
# Host-side initialization
# ---------------------------------------------------------------------

def initialize(m: ScpcModel, hp_split_fraction: float = 0.1,
               discharge_flow: float = 1.0) -> None:
    """Sequential host sweep (reference ``fix_dof_and_initialize``
    :700-926, without subprocess solves)."""
    fs, u = m.fs, m.units
    tes_frac = hp_split_fraction if m.include_concrete_tes else 0.0

    h_b = float(w95.props_tp(BOILER_OUT_T, MAIN_STEAM_PRESSURE, "sc")["h"])

    # hp splitter
    hp = u["hp_splitter"]
    _set_state_init(fs, hp.inlet_state, BOILER_FLOW, h_b, MAIN_STEAM_PRESSURE)
    fs.set_init(hp.split_fraction[0], 1.0 - tes_frac)
    fs.set_init(hp.split_fraction[1], tes_frac)
    _set_state_init(fs, hp.outlet_states[0], (1.0 - tes_frac) * BOILER_FLOW,
                    h_b, MAIN_STEAM_PRESSURE)
    _set_state_init(fs, hp.outlet_states[1], tes_frac * BOILER_FLOW,
                    h_b, MAIN_STEAM_PRESSURE)

    # ---- turbine train ----------------------------------------------
    F = (1.0 - tes_frac) * BOILER_FLOW
    h, P = h_b, MAIN_STEAM_PRESSURE
    extr: Dict = {}
    outs: Dict = {}
    for i in range(1, 10):
        t = u[f"turbine_{i}"]
        pr, eta = TURBINE_DOF[i]
        P_out = pr * P
        s_in = w95.flash_hp(h, P)["s"]
        h_iso = w95.h_ps(P_out, s_in, "vap")
        h_out = h + eta * (h_iso - h)
        _set_state_init(fs, t.inlet_state, F, h, P)
        _set_state_init(fs, t.outlet_state, F, h_out, P_out)
        _set_iso_init(fs, t, h_iso, P_out)
        fs.set_init(t.work_mechanical, F * (h_out - h))
        fs.set_init(t.deltaP, P_out - P)
        outs[i] = dict(F=F, h=h_out, P=P_out)
        h, P = h_out, P_out
        if i <= 8:
            sp = u[f"t_splitter_{i}"]
            if i == 4:
                f1 = SPLITTER4_FRAC1_SEED
                f2 = SPLITTER4_FRAC2
                fracs = [f1, f2, 1.0 - f1 - f2]
            else:
                f2 = SPLIT_FRAC_SEED[i]
                fracs = [1.0 - f2, f2]
            _set_state_init(fs, sp.inlet_state, F, h, P)
            for k, fr in enumerate(fracs):
                fs.set_init(sp.split_fraction[k], fr)
                _set_state_init(fs, sp.outlet_states[k], fr * F, h, P)
            extr[i] = dict(F=fracs[1] * F, h=h, P=P)
            if i == 4:
                extr["bfpt"] = dict(F=fracs[2] * F, h=h, P=P)
            F = F * fracs[0]
        if i == 2:
            rh = u["reheater"]
            P_rh = P + REHEATER_DP
            h_rh = float(w95.props_tp(BOILER_OUT_T, P_rh, "vap")["h"])
            _set_state_init(fs, rh.inlet_state, F, h, P)
            _set_state_init(fs, rh.outlet_state, F, h_rh, P_rh)
            fs.set_init(rh.heat_duty, F * (h_rh - h))
            h, P = h_rh, P_rh

    F9, P_cond = F, P

    # ---- bfpt -------------------------------------------------------
    bfpt = u["bfpt"]
    e = extr["bfpt"]
    s_in = w95.flash_hp(e["h"], e["P"])["s"]
    h_iso = w95.h_ps(P_cond, s_in, "vap")
    h_bfpt = e["h"] + PUMP_EFF * (h_iso - e["h"])
    _set_state_init(fs, bfpt.inlet_state, e["F"], e["h"], e["P"])
    _set_state_init(fs, bfpt.outlet_state, e["F"], h_bfpt, P_cond)
    _set_iso_init(fs, bfpt, h_iso, P_cond)
    fs.set_init(bfpt.work_mechanical, e["F"] * (h_bfpt - e["h"]))
    fs.set_init(bfpt.ratioP, P_cond / e["P"])
    fs.set_init(bfpt.deltaP, P_cond - e["P"])

    # ---- TES + discharge turbine ------------------------------------
    tes_out = None
    if m.include_concrete_tes:
        tes = u["tes"]
        _set_state_init(fs, tes.inlet_charge_state, tes_frac * BOILER_FLOW,
                        h_b, MAIN_STEAM_PRESSURE)
        h_dis = float(w95.props_tp(DIS_IN_TEMP, DIS_IN_PRES, "liq")["h"])
        _set_state_init(fs, tes.inlet_discharge_state, discharge_flow,
                        h_dis, DIS_IN_PRES)
        tes.initialize()
        tes_out = {
            "charge_h": float(np.ravel(np.asarray(
                fs.var_specs[tes.outlet_charge_state.enth_mol].init))[0]),
            "discharge_h": float(np.ravel(np.asarray(
                fs.var_specs[tes.outlet_discharge_state.enth_mol].init))[0]),
        }
        dt_ = u["discharge_turbine"]
        F_d, h_d, P_d = (discharge_flow, tes_out["discharge_h"],
                         DIS_IN_PRES)
        s_d = w95.flash_hp(h_d, P_d)["s"]
        h_iso_d = w95.h_ps(DIS_TURBINE_P_OUT, s_d, "vap")
        h_out_d = h_d + DIS_TURBINE_EFF * (h_iso_d - h_d)
        _set_state_init(fs, dt_.inlet_state, F_d, h_d, P_d)
        _set_state_init(fs, dt_.outlet_state, F_d, h_out_d,
                        DIS_TURBINE_P_OUT)
        _set_iso_init(fs, dt_, h_iso_d, DIS_TURBINE_P_OUT)
        fs.set_init(dt_.work_mechanical, F_d * (h_out_d - h_d))
        fs.set_init(dt_.ratioP, DIS_TURBINE_P_OUT / P_d)
        fs.set_init(dt_.deltaP, DIS_TURBINE_P_OUT - P_d)

    # ---- FWH shell cascades -----------------------------------------
    def fwh_shell(i, F, h, P):
        f = u[f"fwh_{i}"]
        P_out = 1.1 * FWH_PRESS_RATIO[i] * P
        Ts, dl, dv = w95.sat_solve_P(P_out)
        h_out = float(w95._h_host(dl, Ts))
        Q = F * (h - h_out)
        _set_state_init(fs, f.shell_in, F, h, P)
        _set_state_init(fs, f.shell_out, F, h_out, P_out)
        fs.set_init(f.heat_duty, Q)
        return dict(F=F, h=h_out, P=P_out, Q=Q)

    def mixer(name, named_streams):
        mx = u[name]
        streams = list(named_streams.values())
        F = sum(s["F"] for s in streams)
        h = sum(s["F"] * s["h"] for s in streams) / F
        for nm, s in named_streams.items():
            _set_state_init(fs, mx.inlet_states[nm], s["F"], s["h"], s["P"])
        # pressure: per the mixer's momentum basis
        if name == "fwh_mix_5":
            P = named_streams["feedwater"]["P"]
        elif name == "condenser_mix":
            P = named_streams["main"]["P"]
        else:
            P = named_streams["steam"]["P"]
        _set_state_init(fs, mx.outlet_state, F, h, P)
        return dict(F=F, h=h, P=P)

    # storage return stream into fwh_mix_7
    if m.include_concrete_tes:
        strg = dict(F=tes_frac * BOILER_FLOW, h=tes_out["charge_h"],
                    P=CONC_TES_DATA["inlet_pressure_charge"])
    else:
        strg = dict(F=0.0, h=40000.0, P=MAIN_STEAM_PRESSURE)

    sh = {}
    sh[8] = fwh_shell(8, **extr[1])
    mx7 = mixer("fwh_mix_7", {"steam": extr[2], "drain": sh[8],
                              "from_storage": strg})
    sh[7] = fwh_shell(7, **mx7)
    mx6 = mixer("fwh_mix_6", {"steam": extr[3], "drain": sh[7]})
    sh[6] = fwh_shell(6, **mx6)
    sh[4] = fwh_shell(4, **extr[5])
    mx3 = mixer("fwh_mix_3", {"steam": extr[6], "drain": sh[4]})
    sh[3] = fwh_shell(3, **mx3)
    mx2 = mixer("fwh_mix_2", {"steam": extr[7], "drain": sh[3]})
    sh[2] = fwh_shell(2, **mx2)
    mx1 = mixer("fwh_mix_1", {"steam": extr[8], "drain": sh[2]})
    sh[1] = fwh_shell(1, **mx1)

    # ---- condenser train --------------------------------------------
    cm = mixer("condenser_mix", {
        "main": dict(F=F9, h=outs[9]["h"], P=P_cond),
        "bfpt": dict(F=extr["bfpt"]["F"], h=h_bfpt, P=P_cond),
        "drain": sh[1],
        "makeup": dict(F=1e-6, h=MAKEUP_ENTH, P=MAKEUP_PRESSURE),
    })
    cond = u["condenser"]
    Ts, dl, dv = w95.sat_solve_P(cm["P"])
    h_cond_out = float(w95._h_host(dl, Ts))
    Q_cond = cm["F"] * (cm["h"] - h_cond_out)
    _set_state_init(fs, cond.shell_in, cm["F"], cm["h"], cm["P"])
    _set_state_init(fs, cond.shell_out, cm["F"], h_cond_out, cm["P"])
    fs.set_init(cond.heat_duty, Q_cond)
    # cooling water: ~10 K rise
    dh_cw = 10.0 * 75.3
    F_cw = Q_cond / dh_cw
    _set_state_init(fs, cond.tube_in, F_cw, CONDENSER_CW_H, CONDENSER_CW_P)
    _set_state_init(fs, cond.tube_out, F_cw, CONDENSER_CW_H + dh_cw,
                    CONDENSER_CW_P)

    def pump(name, F, h_in, P_in, dP=None, P_out=None):
        pu = u[name]
        if P_out is None:
            P_out = P_in + dP
        s_in = w95.flash_hp(h_in, P_in)["s"]
        h_iso = w95.h_ps(P_out, s_in, "liq")
        h_out = h_in + (h_iso - h_in) / PUMP_EFF
        _set_state_init(fs, pu.inlet_state, F, h_in, P_in)
        _set_state_init(fs, pu.outlet_state, F, h_out, P_out)
        _set_iso_init(fs, pu, h_iso, P_out)
        fs.set_init(pu.work_mechanical, F * (h_out - h_in))
        fs.set_init(pu.ratioP, P_out / P_in)
        fs.set_init(pu.deltaP, P_out - P_in)
        return dict(F=F, h=h_out, P=P_out)

    cp = pump("cond_pump", cm["F"], h_cond_out, cm["P"], dP=COND_PUMP_DP)

    def tube(i, s_in):
        f = u[f"fwh_{i}"]
        P_out = 0.96 * s_in["P"]
        h_out = s_in["h"] + sh[i]["Q"] / s_in["F"]
        _set_state_init(fs, f.tube_in, s_in["F"], s_in["h"], s_in["P"])
        _set_state_init(fs, f.tube_out, s_in["F"], h_out, P_out)
        return dict(F=s_in["F"], h=h_out, P=P_out)

    t = cp
    for i in (1, 2, 3, 4):
        t = tube(i, t)
    da = mixer("fwh_mix_5", {"steam": extr[4], "drain": sh[6],
                             "feedwater": t})
    spb = u["bfp_splitter"]
    _set_state_init(fs, spb.inlet_state, da["F"], da["h"], da["P"])
    fs.set_init(spb.split_fraction[0], 1.0)
    fs.set_init(spb.split_fraction[1], 0.0)
    _set_state_init(fs, spb.outlet_states[0], da["F"], da["h"], da["P"])
    _set_state_init(fs, spb.outlet_states[1], 0.0, da["h"], da["P"])
    bf = pump("bfp", da["F"], da["h"], da["P"],
              P_out=MAIN_STEAM_PRESSURE * BFP_PRESSURE_FACTOR)
    t = bf
    for i in (6, 7, 8):
        t = tube(i, t)

    boiler = u["boiler"]
    _set_state_init(fs, boiler.inlet_state, BOILER_FLOW, t["h"], t["P"])
    _set_state_init(fs, boiler.outlet_state, BOILER_FLOW, h_b,
                    MAIN_STEAM_PRESSURE)
    fs.set_init(boiler.heat_duty, BOILER_FLOW * (h_b - t["h"]))
    fs.set_init(boiler.deltaP, MAIN_STEAM_PRESSURE - t["P"])

    fs.set_init("net_power_output", 692.0 if not m.include_concrete_tes
                else 625.0)


def solve_plant(m: ScpcModel, device=None, **opts):
    """Compile and solve the square flowsheet with the damped Newton
    solver on ``device`` (``cuda`` unless given); returns ``(nlp, res)``
    and writes a converged solution back as the variables' inits."""
    from dispatches_tpu_torch.case_studies.fossil import storage_integrated as isp
    from dispatches_tpu_torch.solvers.newton import solve_square

    dev = resolve_device(device)
    nlp = m.fs.compile()
    res = solve_square(nlp, device=dev, **opts)
    if bool(res.converged):
        isp.write_back(m.fs, nlp, res.x)
    return nlp, res


def unfix_dof_for_optimization(m: ScpcModel) -> None:
    """Free the operational degrees of freedom (reference
    ``unfix_dof_for_optimization``, :1031-1090): boiler flow and the
    storage split fractions become decisions."""
    fs, u = m.fs, m.units
    fs.unfix(u["boiler"].inlet_state.flow_mol)
    if m.include_concrete_tes:
        fs.unfix(u["hp_splitter"].split_fraction[1])
        fs.unfix(u["tes"].inlet_discharge_state.flow_mol)
