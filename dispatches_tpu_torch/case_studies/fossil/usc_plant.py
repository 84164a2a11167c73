"""437 MW ultra-supercritical pulverized-coal plant flowsheet
(counterpart of ``dispatches_tpu/case_studies/fossil/usc_plant.py``;
the same units, arcs, constraints, inputs, bounds and initialization).

Counterpart of the reference's
``fossil_case/ultra_supercritical_plant/ultra_supercritical_powerplant.py``
(:71-1353): 11 lumped turbine stages with outlet splitters, boiler + two
reheaters (outlet temperature pinned at 866.15 K, :226-240), a condenser
train (4-inlet minimum-pressure mixer, saturated-liquid condenser,
condensate pump), 9 condensing feed-water heaters with drain cascades,
deaerator, booster/boiler-feed pumps and the boiler-feed-pump turbine
whose work balances the pump train (:360-379).

* one square NLP over Helm-style stream states (flow_mol, enth_mol,
  pressure) with explicit IAPWS-95 auxiliary variables (see
  ``models/steam_cycle.py``), solved by ``solvers/newton.solve_square``
  or, through ``solve_plant``, by the IPM — on ``cuda`` unless the
  caller passes ``device="cpu"``;
* the reference's per-unit ``initialize()`` ladder (:832-1110) is a
  host-side numpy sweep (`initialize`) that walks the turbine train,
  FWH cascades and feedwater chain once and writes warm starts for every
  variable (EoS auxiliaries by host flashes);
* saturated-drain specs are vapor-fraction variable fixes on
  "wet"-declared states;
* the flowsheet is horizon-vectorized: every stream variable carries a
  leading time axis, so multiperiod storage models reuse
  ``build_plant_model``.

Stream phase declarations (from the nominal-point envelope): turbine
exhausts 1-10 superheated, turbine 11 / bfpt wet; FWH drain-mixer
outlets wet; feedwater/condensate liquid.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

from dispatches_tpu_torch.core.graph import Flowsheet
from dispatches_tpu_torch.models.steam_cycle import (
    SteamFWH,
    SteamHeater,
    SteamIsentropicCompressor,
    SteamMixer,
    SteamSplitter,
    SteamState,
    SteamTurbineStage,
)
from dispatches_tpu_torch.properties import iapws95 as w95

# ---------------------------------------------------------------------
# Design data (reference ``set_model_input``, :714-805)
# ---------------------------------------------------------------------

MAIN_FLOW = 17854.0  # mol/s
MAIN_STEAM_PRESSURE = 31125980.0  # Pa
BOILER_OUT_T = 866.15  # K (boiler + both reheaters, :232-240)
REHEATER_DP = {1: -742845.0, 2: -210952.0}  # Pa

TURBINE_RATIO_P = {1: 0.388, 2: 0.774, 3: 0.498, 4: 0.609, 5: 0.523,
                   6: 0.495, 7: 0.514, 8: 0.389, 9: 0.572, 10: 0.476,
                   11: 0.204}
TURBINE_EFF = {1: 0.94, 2: 0.94, 3: 0.94, 4: 0.94, 5: 0.88, 6: 0.88,
               7: 0.78, 8: 0.78, 9: 0.78, 10: 0.78, 11: 0.78}
PUMP_EFF = 0.8

# FWH shell-outlet pressure cascade (:320-340) and areas/U (:789-805)
FWH_PRESS_RATIO = {1: 0.204, 2: 0.476, 3: 0.572, 4: 0.389, 5: 0.514,
                   6: 0.523, 7: 0.609, 8: 0.498, 9: 0.774}
FWH_PRESS_DIFF = {1: 0.0, 2: 0.0, 3: 0.0, 4: 0.0, 5: 0.0, 6: 210952.0,
                  7: 0.0, 8: 742845.0, 9: 0.0}
FWH_AREA = {1: 250.0, 2: 195.0, 3: 164.0, 4: 208.0, 5: 152.0, 6: 207.0,
            7: 202.0, 8: 715.0, 9: 175.0}
FWH_OHTC = 3000.0

COND_PUMP_DP = 2313881.0
BOOSTER_DP = 5715067.0
BFP_PRESSURE_FACTOR = 1.1231
DEAERATOR_SPLIT_FRAC = 0.017885  # turbine_splitter[5] outlet_2 (:771)
MAKEUP_PRESSURE = 103421.4
MAKEUP_ENTH = 1131.69204

# initialization seeds for extraction fractions (:857-866)
SPLIT_FRAC_SEED = {1: 0.073444, 2: 0.140752, 3: 0.032816, 4: 0.012425,
                   5: DEAERATOR_SPLIT_FRAC, 6: 0.081155, 7: 0.036058,
                   8: 0.026517, 9: 0.029888, 10: 0.003007}
BFPT_FRAC_SEED = 0.091274  # splitter 6 outlet_3 (:862)

# FWH wiring: fwh index -> (splitter feeding it, via mixer?, drain source)
# (:421-711 arc census)
FWH_STEAM_SPLIT = {9: 1, 8: 2, 7: 3, 6: 4, 5: 6, 4: 7, 3: 8, 2: 9, 1: 10}
MIXER_FWHS = (1, 2, 3, 4, 6, 7, 8)  # fwh_mixer set (:168)


@dataclass
class UscModel:
    fs: Flowsheet
    units: Dict[str, object] = field(default_factory=dict)

    def __getitem__(self, name):
        return self.units[name]


def build_plant_model(horizon: int = 1) -> UscModel:
    """Assemble the USC flowsheet (reference ``build_plant_model``,
    :1294-1311: declare units, arcs, inputs; DoF = 0)."""
    fs = Flowsheet(horizon=horizon)
    m = UscModel(fs=fs)
    u = m.units

    # ---- units ------------------------------------------------------
    u["boiler"] = SteamHeater(fs, "boiler", inlet_phase="liq",
                              outlet_phase="vap")
    for r in (1, 2):
        u[f"reheater_{r}"] = SteamHeater(fs, f"reheater_{r}",
                                         inlet_phase="vap",
                                         outlet_phase="vap")
    for i in range(1, 12):
        out_ph = "wet" if i == 11 else "vap"
        u[f"turbine_{i}"] = SteamTurbineStage(
            fs, f"turbine_{i}", inlet_phase="vap", outlet_phase=out_ph,
            isentropic_phase="wet" if i == 11 else "vap",
        )
    for i in range(1, 11):
        u[f"turbine_splitter_{i}"] = SteamSplitter(
            fs, f"turbine_splitter_{i}", num_outlets=3 if i == 6 else 2
        )
    u["condenser_mix"] = SteamMixer(
        fs, "condenser_mix", inlet_list=["main", "bfpt", "drain", "makeup"]
    )
    u["condenser"] = SteamHeater(fs, "condenser", inlet_phase="wet",
                                 outlet_phase="wet",
                                 has_pressure_change=False)
    u["cond_pump"] = SteamIsentropicCompressor(fs, "cond_pump")
    u["booster"] = SteamIsentropicCompressor(fs, "booster")
    u["bfp"] = SteamIsentropicCompressor(fs, "bfp")
    u["bfpt"] = SteamTurbineStage(fs, "bfpt", inlet_phase="vap",
                                  outlet_phase="wet",
                                  isentropic_phase="wet")
    for i in MIXER_FWHS:
        u[f"fwh_mixer_{i}"] = SteamMixer(fs, f"fwh_mixer_{i}",
                                         inlet_list=["steam", "drain"])
    for i in range(1, 10):
        u[f"fwh_{i}"] = SteamFWH(
            fs, f"fwh_{i}",
            shell_inlet_phase="vap" if i in (5, 9) else "wet",
            turb_press_ratio=FWH_PRESS_RATIO[i],
            reheater_press_diff=FWH_PRESS_DIFF[i],
        )
    u["deaerator"] = SteamMixer(fs, "deaerator",
                                inlet_list=["steam", "drain", "feedwater"])

    _create_arcs(m)
    _make_constraints(m)
    _set_model_input(m)
    _add_bounds(m)
    return m


def _create_arcs(m: UscModel) -> None:
    """Stream connections (reference ``_create_arcs``, :421-711)."""
    fs, u = m.fs, m.units

    def con(a, b, name):
        fs.connect(a, b, name=name)

    con(u["boiler"].outlet, u["turbine_1"].inlet, "boiler_to_turb1")
    # turbine chain with splitters; splitter outlet_1 continues the train
    for i in range(1, 11):
        con(u[f"turbine_{i}"].outlet, u[f"turbine_splitter_{i}"].inlet,
            f"turb{i}_to_split{i}")
    # reheater insertions: splitter2 -> reheater1 -> turbine3;
    # splitter4 -> reheater2 -> turbine5
    con(u["turbine_splitter_1"].outlet(1), u["turbine_2"].inlet,
        "t1split_to_turb2")
    con(u["turbine_splitter_2"].outlet(1), u["reheater_1"].inlet,
        "t2split_to_rh1")
    con(u["reheater_1"].outlet, u["turbine_3"].inlet, "rh1_to_turb3")
    con(u["turbine_splitter_3"].outlet(1), u["turbine_4"].inlet,
        "t3split_to_turb4")
    con(u["turbine_splitter_4"].outlet(1), u["reheater_2"].inlet,
        "t4split_to_rh2")
    con(u["reheater_2"].outlet, u["turbine_5"].inlet, "rh2_to_turb5")
    for i in range(5, 11):
        con(u[f"turbine_splitter_{i}"].outlet(1), u[f"turbine_{i + 1}"].inlet,
            f"t{i}split_to_turb{i + 1}")

    # extractions: splitter outlet_2 -> fwh (direct or via mixer);
    # splitter 5 outlet_2 -> deaerator steam; splitter 6 outlet_3 -> bfpt
    con(u["turbine_splitter_1"].outlet(2), u["fwh_9"].shell_inlet,
        "t1split_to_fwh9")
    con(u["turbine_splitter_5"].outlet(2), u["deaerator"].inlet("steam"),
        "t5split_to_deaerator")
    con(u["turbine_splitter_6"].outlet(2), u["fwh_5"].shell_inlet,
        "t6split_to_fwh5")
    con(u["turbine_splitter_6"].outlet(3), u["bfpt"].inlet,
        "t6split_to_bfpt")
    for fwh_i, sp_i in FWH_STEAM_SPLIT.items():
        if fwh_i in (9, 5):
            continue
        con(u[f"turbine_splitter_{sp_i}"].outlet(2),
            u[f"fwh_mixer_{fwh_i}"].inlet("steam"),
            f"t{sp_i}split_to_fwh{fwh_i}mix")
    for i in MIXER_FWHS:
        con(u[f"fwh_mixer_{i}"].outlet, u[f"fwh_{i}"].shell_inlet,
            f"fwh{i}mix_to_fwh{i}")

    # drain cascades: fwh[n] shell outlet -> fwh_mixer[n-1] drain
    for i in (2, 3, 4):
        con(u[f"fwh_{i}"].shell_outlet, u[f"fwh_mixer_{i - 1}"].inlet("drain"),
            f"fwh{i}_to_fwh{i - 1}mix")
    con(u["fwh_5"].shell_outlet, u["fwh_mixer_4"].inlet("drain"),
        "fwh5_to_fwh4mix")
    for i in (7, 8, 9):
        con(u[f"fwh_{i}"].shell_outlet, u[f"fwh_mixer_{i - 1}"].inlet("drain"),
            f"fwh{i}_to_fwh{i - 1}mix")
    con(u["fwh_6"].shell_outlet, u["deaerator"].inlet("drain"),
        "fwh6_to_deaerator")

    # condenser train
    con(u["turbine_11"].outlet, u["condenser_mix"].inlet("main"),
        "turb11_to_condmix")
    con(u["fwh_1"].shell_outlet, u["condenser_mix"].inlet("drain"),
        "fwh1_to_condmix")
    con(u["bfpt"].outlet, u["condenser_mix"].inlet("bfpt"),
        "bfpt_to_condmix")
    con(u["condenser_mix"].outlet, u["condenser"].inlet, "condmix_to_cond")
    con(u["condenser"].outlet, u["cond_pump"].inlet, "cond_to_condpump")

    # feedwater tube-side chain
    con(u["cond_pump"].outlet, u["fwh_1"].tube_inlet, "condpump_to_fwh1")
    for i in range(1, 5):
        con(u[f"fwh_{i}"].tube_outlet, u[f"fwh_{i + 1}"].tube_inlet,
            f"fwh{i}_to_fwh{i + 1}")
    con(u["fwh_5"].tube_outlet, u["deaerator"].inlet("feedwater"),
        "fwh5_to_deaerator")
    con(u["deaerator"].outlet, u["booster"].inlet, "deaerator_to_booster")
    con(u["booster"].outlet, u["fwh_6"].tube_inlet, "booster_to_fwh6")
    con(u["fwh_6"].tube_outlet, u["fwh_7"].tube_inlet, "fwh6_to_fwh7")
    con(u["fwh_7"].tube_outlet, u["bfp"].inlet, "fwh7_to_bfp")
    con(u["bfp"].outlet, u["fwh_8"].tube_inlet, "bfp_to_fwh8")
    con(u["fwh_8"].tube_outlet, u["fwh_9"].tube_inlet, "fwh8_to_fwh9")
    con(u["fwh_9"].tube_outlet, u["boiler"].inlet, "fwh9_to_boiler")


def _make_constraints(m: UscModel) -> None:
    """Flowsheet-level constraints (reference ``_make_constraints``,
    :226-418)."""
    fs, u = m.fs, m.units

    # boiler/reheater outlet temperature pinned to 866.15 K — realized
    # as fixes of the outlet EoS temperature variables
    for unit in ("boiler", "reheater_1", "reheater_2"):
        fs.fix(u[unit].outlet_state.temperature, BOILER_OUT_T)
    # condenser outlet is saturated liquid (:246-251)
    fs.fix(u["condenser"].outlet_state.vapor_frac, 0.0)

    # bfpt discharges at condenser-mixer main pressure (:360-365)
    p_bfpt = u["bfpt"].outlet_state.pressure
    p_main = u["condenser_mix"].inlet_states["main"].pressure
    fs.add_eq("constraint_out_pressure",
              lambda v, p: v[p_bfpt] - v[p_main], scale=1e-5)

    # pump train powered by the bfpt (:371-379)
    works = [u["booster"].work_mechanical, u["bfp"].work_mechanical,
             u["bfpt"].work_mechanical, u["cond_pump"].work_mechanical]
    fs.add_eq("constraint_bfp_power",
              lambda v, p: sum(v[w] for w in works), scale=1e-6)

    # plant power / heat duty reporting vars (:384-418), MW
    fs.add_var("plant_power_out", lb=0.0, ub=2000.0, init=437.0,
               scale=100.0)
    fs.add_var("plant_heat_duty", lb=0.0, ub=4000.0, init=917.0,
               scale=100.0)
    tw = [u[f"turbine_{i}"].work_mechanical for i in range(1, 12)]
    fs.add_eq("production_cons",
              lambda v, p: -sum(v[w] for w in tw)
              - v["plant_power_out"] * 1e6, scale=1e-7)
    qd = [u["boiler"].heat_duty, u["reheater_1"].heat_duty,
          u["reheater_2"].heat_duty]
    fs.add_eq("heatduty_cons",
              lambda v, p: sum(v[q] for q in qd)
              - v["plant_heat_duty"] * 1e6, scale=1e-7)


def _set_model_input(m: UscModel) -> None:
    """Fix design degrees of freedom (reference ``set_model_input``,
    :714-805)."""
    fs, u = m.fs, m.units

    fs.fix(u["boiler"].inlet_state.flow_mol, MAIN_FLOW)
    fs.fix(u["boiler"].outlet_state.pressure, MAIN_STEAM_PRESSURE)
    for r in (1, 2):
        fs.fix(u[f"reheater_{r}"].deltaP, REHEATER_DP[r])
    for i in range(1, 12):
        t = u[f"turbine_{i}"]
        fs.fix(t.ratioP, TURBINE_RATIO_P[i])
        fs.fix(t.efficiency_isentropic, TURBINE_EFF[i])

    fs.fix(u["cond_pump"].deltaP, COND_PUMP_DP)
    fs.fix(u["turbine_splitter_5"].split_fraction[1], DEAERATOR_SPLIT_FRAC)
    fs.fix(u["bfp"].outlet_state.pressure,
           MAIN_STEAM_PRESSURE * BFP_PRESSURE_FACTOR)
    fs.fix(u["booster"].deltaP, BOOSTER_DP)
    for unit in ("cond_pump", "booster", "bfp", "bfpt"):
        fs.fix(u[unit].efficiency_isentropic, PUMP_EFF)

    mk = u["condenser_mix"].inlet_states["makeup"]
    fs.fix(mk.pressure, MAKEUP_PRESSURE)
    fs.fix(mk.enth_mol, MAKEUP_ENTH)
    fs.set_bounds(mk.flow_mol, lb=0.0, ub=1.0)
    fs.set_init(mk.flow_mol, 1e-6)

    for i in range(1, 10):
        f = u[f"fwh_{i}"]
        fs.fix(f.area, FWH_AREA[i])
        fs.fix(f.htc, FWH_OHTC)


def _add_bounds(m: UscModel) -> None:
    """Flow bounds (reference ``add_bounds``, :1113-1159)."""
    fs = m.fs
    flow_max = MAIN_FLOW * 3
    for name, spec in fs.var_specs.items():
        if name.endswith(".flow_mol") and not name.endswith("makeup.flow_mol"):
            spec.lb, spec.ub = 0.0, flow_max


# ---------------------------------------------------------------------
# Host-side initialization ladder
# ---------------------------------------------------------------------

def _init_eos_block(fs: Flowsheet, eb, h, P) -> None:
    """Warm-start an EosBlock's auxiliaries from a host flash."""
    st = w95.flash_hp(h, P)
    if eb._s_var is not None:
        fs.set_init(eb._s_var, st["s"])
    if eb.phase == "wet":
        if st["phase"] == "two-phase":
            fs.set_init(eb.T, st["T"])
            fs.set_init(eb.x, st["x"])
            fs.set_init(eb.delta_l, st["delta_l"])
            fs.set_init(eb.delta_v, st["delta_v"])
        else:
            # off-dome warm start: saturation point at P
            Ts, dl, dv = w95.sat_solve_P(min(P, w95.PC * 0.98))
            hl = float(w95._h_host(dl, Ts))
            hv = float(w95._h_host(dv, Ts))
            fs.set_init(eb.T, Ts)
            fs.set_init(eb.x, (h - hl) / max(hv - hl, 1.0))
            fs.set_init(eb.delta_l, dl)
            fs.set_init(eb.delta_v, dv)
    else:
        d = st["delta_l"] if st["phase"] == "liq" else st["delta_v"]
        if st["phase"] == "two-phase":
            d = st["delta_l"] if eb.phase == "liq" else st["delta_v"]
        fs.set_init(eb.T, st["T"])
        fs.set_init(eb.delta, d)


def _set_state_init(fs: Flowsheet, state: SteamState, F, h, P) -> None:
    """Warm-start a stream state (and its EoS auxiliaries if built)."""
    fs.set_init(state.flow_mol, F)
    fs.set_init(state.enth_mol, h)
    fs.set_init(state.pressure, P)
    if state._eos is not None:
        _init_eos_block(fs, state._eos, h, P)


def _set_iso_init(fs: Flowsheet, unit, h_iso, P_out) -> None:
    """Warm-start the isentropic reference EosBlock (incl. its enthalpy
    variable, which the work-definition residual reads)."""
    eb = unit.isentropic
    if eb._h_var is not None:
        fs.set_init(eb._h_var, h_iso)
    _init_eos_block(fs, eb, h_iso, P_out)


def initialize(m: UscModel, main_flow: float = MAIN_FLOW,
               main_pressure: float = MAIN_STEAM_PRESSURE) -> None:
    """Sequential-modular warm-start sweep (the reference's
    ``initialize``, :832-1110, without subprocess solves): walk the
    turbine train, FWH drain cascades, condenser train and feedwater
    chain once with the seeded extraction fractions, host-flash every
    stream, and write inits for all variables."""
    fs, u = m.fs, m.units

    def props_vap(T, P):
        return w95.props_tp(T, P, "vap")

    h_b = float(props_vap(BOILER_OUT_T, main_pressure)["h"])

    # -- turbine train -------------------------------------------------
    h, P, F = h_b, main_pressure, main_flow
    extr: Dict = {}
    outs: Dict = {}
    for i in range(1, 12):
        t = u[f"turbine_{i}"]
        P_out = TURBINE_RATIO_P[i] * P
        s_in = w95.flash_hp(h, P)["s"]
        h_iso = w95.h_ps(P_out, s_in, "vap")
        h_out = h + TURBINE_EFF[i] * (h_iso - h)
        W = F * (h_out - h)
        _set_state_init(fs, t.inlet_state, F, h, P)
        _set_state_init(fs, t.outlet_state, F, h_out, P_out)
        _set_iso_init(fs, t, h_iso, P_out)
        fs.set_init(t.work_mechanical, W)
        fs.set_init(t.deltaP, P_out - P)
        outs[i] = dict(h=h_out, P=P_out, F=F)
        h, P = h_out, P_out
        if i <= 10:
            sp = u[f"turbine_splitter_{i}"]
            frac2 = SPLIT_FRAC_SEED[i]
            fracs = [1.0 - frac2, frac2]
            if i == 6:
                fracs = [1.0 - frac2 - BFPT_FRAC_SEED, frac2, BFPT_FRAC_SEED]
            _set_state_init(fs, sp.inlet_state, F, h, P)
            for k, fr in enumerate(fracs):
                fs.set_init(sp.split_fraction[k], fr)
                _set_state_init(fs, sp.outlet_states[k], fr * F, h, P)
            extr[i] = dict(F=frac2 * F, h=h, P=P)
            if i == 6:
                extr["bfpt"] = dict(F=BFPT_FRAC_SEED * F, h=h, P=P)
            F = F * fracs[0]
        if i in (2, 4):
            rh = u[f"reheater_{i // 2}"]
            P_rh = P + REHEATER_DP[i // 2]
            h_rh = float(props_vap(BOILER_OUT_T, P_rh)["h"])
            _set_state_init(fs, rh.inlet_state, F, h, P)
            _set_state_init(fs, rh.outlet_state, F, h_rh, P_rh)
            fs.set_init(rh.heat_duty, F * (h_rh - h))
            h, P = h_rh, P_rh

    F11, P_cond = F, P

    # -- bfpt ----------------------------------------------------------
    bfpt = u["bfpt"]
    e = extr["bfpt"]
    s_in = w95.flash_hp(e["h"], e["P"])["s"]
    h_iso = w95.h_ps(P_cond, s_in, "vap")
    h_bfpt = e["h"] + PUMP_EFF * (h_iso - e["h"])
    W_bfpt = e["F"] * (h_bfpt - e["h"])
    _set_state_init(fs, bfpt.inlet_state, e["F"], e["h"], e["P"])
    _set_state_init(fs, bfpt.outlet_state, e["F"], h_bfpt, P_cond)
    _set_iso_init(fs, bfpt, h_iso, P_cond)
    fs.set_init(bfpt.work_mechanical, W_bfpt)
    fs.set_init(bfpt.ratioP, P_cond / e["P"])
    fs.set_init(bfpt.deltaP, P_cond - e["P"])

    # -- FWH shell cascades -------------------------------------------
    def fwh_shell(i, F, h, P):
        F_s, h_s, P_s = F, h, P
        f = u[f"fwh_{i}"]
        P_out = 1.1 * FWH_PRESS_RATIO[i] * (P_s - FWH_PRESS_DIFF[i])
        Ts, dl, dv = w95.sat_solve_P(P_out)
        h_out = float(w95._h_host(dl, Ts))
        Q = F_s * (h_s - h_out)
        _set_state_init(fs, f.shell_in, F_s, h_s, P_s)
        _set_state_init(fs, f.shell_out, F_s, h_out, P_out)
        fs.set_init(f.heat_duty, Q)
        return dict(F=F_s, h=h_out, P=P_out, Q=Q)

    def mixer(name, streams):
        mx = u[name]
        F = sum(s["F"] for s in streams)
        h = sum(s["F"] * s["h"] for s in streams) / F
        P = min(s["P"] for s in streams)
        for nm, s in zip(mx.inlet_names, streams):
            _set_state_init(fs, mx.inlet_states[nm], s["F"], s["h"], s["P"])
        _set_state_init(fs, mx.outlet_state, F, h, P)
        return dict(F=F, h=h, P=P)

    sh = {}
    sh[9] = fwh_shell(9, **extr[1])
    mx8 = mixer("fwh_mixer_8", [extr[2], sh[9]])
    sh[8] = fwh_shell(8, **mx8)
    mx7 = mixer("fwh_mixer_7", [extr[3], sh[8]])
    sh[7] = fwh_shell(7, **mx7)
    mx6 = mixer("fwh_mixer_6", [extr[4], sh[7]])
    sh[6] = fwh_shell(6, **mx6)
    sh[5] = fwh_shell(5, **extr[6])
    mx4 = mixer("fwh_mixer_4", [extr[7], sh[5]])
    sh[4] = fwh_shell(4, **mx4)
    mx3 = mixer("fwh_mixer_3", [extr[8], sh[4]])
    sh[3] = fwh_shell(3, **mx3)
    mx2 = mixer("fwh_mixer_2", [extr[9], sh[3]])
    sh[2] = fwh_shell(2, **mx2)
    mx1 = mixer("fwh_mixer_1", [extr[10], sh[2]])
    sh[1] = fwh_shell(1, **mx1)

    # -- condenser train ----------------------------------------------
    cm = mixer("condenser_mix",
               [dict(F=F11, h=outs[11]["h"], P=P_cond),
                dict(F=extr["bfpt"]["F"], h=h_bfpt, P=P_cond),
                sh[1],
                dict(F=1e-6, h=MAKEUP_ENTH, P=MAKEUP_PRESSURE)])
    cond = u["condenser"]
    Ts, dl, dv = w95.sat_solve_P(cm["P"])
    h_cw = float(w95._h_host(dl, Ts))
    _set_state_init(fs, cond.inlet_state, cm["F"], cm["h"], cm["P"])
    _set_state_init(fs, cond.outlet_state, cm["F"], h_cw, cm["P"])
    fs.set_init(cond.heat_duty, cm["F"] * (h_cw - cm["h"]))

    def pump(name, F, h_in, P_in, dP=None, P_out=None):
        pu = u[name]
        if P_out is None:
            P_out = P_in + dP
        s_in = w95.flash_hp(h_in, P_in)["s"]
        h_iso = w95.h_ps(P_out, s_in, "liq")
        h_out = h_in + (h_iso - h_in) / PUMP_EFF
        W = F * (h_out - h_in)
        _set_state_init(fs, pu.inlet_state, F, h_in, P_in)
        _set_state_init(fs, pu.outlet_state, F, h_out, P_out)
        _set_iso_init(fs, pu, h_iso, P_out)
        fs.set_init(pu.work_mechanical, W)
        fs.set_init(pu.ratioP, P_out / P_in)
        fs.set_init(pu.deltaP, P_out - P_in)
        return dict(F=F, h=h_out, P=P_out, W=W)

    cp = pump("cond_pump", cm["F"], h_cw, cm["P"], dP=COND_PUMP_DP)

    def tube(i, s_in):
        f = u[f"fwh_{i}"]
        P_out = 0.96 * s_in["P"]
        h_out = s_in["h"] + sh[i]["Q"] / s_in["F"]
        _set_state_init(fs, f.tube_in, s_in["F"], s_in["h"], s_in["P"])
        _set_state_init(fs, f.tube_out, s_in["F"], h_out, P_out)
        return dict(F=s_in["F"], h=h_out, P=P_out)

    t = cp
    for i in range(1, 6):
        t = tube(i, t)
    da = mixer("deaerator", [extr[5], sh[6], t])
    bo = pump("booster", da["F"], da["h"], da["P"], dP=BOOSTER_DP)
    t = bo
    for i in (6, 7):
        t = tube(i, t)
    bf = pump("bfp", t["F"], t["h"], t["P"],
              P_out=MAIN_STEAM_PRESSURE * BFP_PRESSURE_FACTOR)
    t = bf
    for i in (8, 9):
        t = tube(i, t)

    # -- boiler -------------------------------------------------------
    boiler = u["boiler"]
    _set_state_init(fs, boiler.inlet_state, main_flow, t["h"], t["P"])
    _set_state_init(fs, boiler.outlet_state, main_flow, h_b, main_pressure)
    fs.set_init(boiler.heat_duty, main_flow * (h_b - t["h"]))
    fs.set_init(boiler.deltaP, main_pressure - t["P"])

    # -- reporting vars -----------------------------------------------
    fs.set_init("plant_power_out", 437.0)
    fs.set_init("plant_heat_duty", 917.0)


def solve_plant(m: UscModel, tee: bool = False, device=None, **opts):  # tee kept for API parity
    """Compile the square system and solve it on the IPM, on ``device``
    (``cuda`` unless given)."""
    from dispatches_tpu_torch.solvers import IPMOptions, solve_nlp

    nlp = m.fs.compile()
    res = solve_nlp(nlp, options=IPMOptions(**opts) if opts else None, device=device)
    return nlp, res


def model_analysis(m: UscModel, flow_frac: float = 1.0,
                   pres_frac: float = 1.0, tee: bool = False, device=None):
    """Reference ``model_analysis`` (:1314-1328): set boiler flow and
    main-steam pressure, solve on the IPM (on ``device``, ``cuda`` unless
    given), report power + heat duty (MW)."""
    fs, u = m.fs, m.units
    fs.fix(u["boiler"].inlet_state.flow_mol, flow_frac * MAIN_FLOW)
    fs.fix(u["boiler"].outlet_state.pressure,
           pres_frac * MAIN_STEAM_PRESSURE)
    nlp, res = solve_plant(m, tee=tee, device=device)
    sol = nlp.unravel(res.x)
    return {
        "nlp": nlp,
        "res": res,
        "sol": sol,
        "plant_power_mw": np.asarray(sol["plant_power_out"]),
        "plant_heat_duty_mw": np.asarray(sol["plant_heat_duty"]),
    }
