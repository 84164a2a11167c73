"""Helm-equivalent steam-cycle unit models on IAPWS-95 (counterpart of
``dispatches_tpu/models/steam_cycle.py``; the same variables, names,
order, bounds, scales and phase declarations).

Counterparts of the IDAES power-generation "Helm" models of the
reference's fossil case: ``HelmTurbineStage``,
``HelmIsentropicCompressor``, ``HelmSplitter``, ``HelmMixer``
(momentum_mixing_type=minimize), ``Heater`` and the 0D
``HeatExchanger`` with the Underwood delta-T callback used for
feed-water heaters.

A steam stream is the Helm state triple ``(flow_mol, enth_mol,
pressure)``; thermodynamics enter through :class:`EosBlock` auxiliary
variables — (T, delta) for declared single-phase states, (T, x,
delta_l, delta_v) for two-phase-capable states — whose defining
residuals are the explicit IAPWS-95 relations
(``properties/iapws95.py``), so the flowsheet is one square system with
no nested Newton inside its residuals.

**One batched EoS evaluation per flowsheet.**  Every EosBlock registers
its (delta, T) pairs with the flowsheet; at compile time one finalizer
emits a handful of *stacked* residuals (pressure consistency, Maxwell
equilibrium, enthalpy links, entropy definitions) that evaluate the
56-term Helmholtz field once over an (n_states, horizon) tensor: a
handful of launches per residual pass on the card, however many steam
states the flowsheet has.

Phase declarations replace runtime phase dispatch: each state names its
regime ("vap" / "liq" / "sc" / "wet") at build time.  A "wet" state
carries a vapor-fraction variable ``x``; saturated-liquid specs become
``x == 0`` variable fixes.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from dispatches_tpu_torch.core.graph import Flowsheet, Port, UnitModel
from dispatches_tpu_torch.properties import iapws95 as w95

# residual scales (roles of IDAES iscale factors,
# ultra_supercritical_powerplant.py:808-829)
_SP = 1e-5  # pressure residuals [Pa]
_SH = 1e-3  # molar enthalpy / Gibbs residuals [J/mol]
_SS = 1e-1  # molar entropy residuals [J/mol/K]
_SF = 1e-3  # molar flow residuals [mol/s]
_SE = 1e-7  # energy-flow / work residuals [W]

_PHASE_DELTA = {
    # phase -> (lb, ub, init) for the reduced density delta = rho/rho_c
    "vap": (1e-9, 1.5, 0.1),
    "liq": (0.9, 3.95, 3.0),
    "sc": (1e-9, 3.95, 1.0),  # supercritical: single phase, either branch
}


def smooth_min(a, b, eps: float = 1.0):
    """Smooth minimum (HelmMixer momentum_mixing_type=minimize)."""
    return 0.5 * (a + b - torch.sqrt((a - b) ** 2 + eps ** 2))


# ---------------------------------------------------------------------
# Batched EoS registry
# ---------------------------------------------------------------------

def _registry(fs: Flowsheet) -> Dict:
    reg = getattr(fs, "_steam_eos", None)
    if reg is None:
        reg = {"blocks": [], "finalized": False}
        fs._steam_eos = reg
        fs._finalizers.append(_finalize_eos)
    if reg["finalized"]:
        raise RuntimeError(
            "steam EoS kernel already finalized (flowsheet was compiled); "
            "build all steam units before the first compile()"
        )
    return reg


def _finalize_eos(fs: Flowsheet) -> None:
    """Emit the stacked IAPWS-95 residuals for every registered block."""
    reg = fs._steam_eos
    reg["finalized"] = True
    blocks: List[EosBlock] = reg["blocks"]
    singles = [b for b in blocks if b.phase != "wet"]
    wets = [b for b in blocks if b.phase == "wet"]

    # ---- pressure consistency: p(delta_i, T_i) == P_i ----------------
    def eos_pressure(v, p):
        ds, Ts, Ps = [], [], []
        for b in singles:
            ds.append(v[b.delta]); Ts.append(v[b.T]); Ps.append(v[b.pressure])
        for b in wets:
            ds.append(v[b.delta_l]); Ts.append(v[b.T]); Ps.append(v[b.pressure])
            ds.append(v[b.delta_v]); Ts.append(v[b.T]); Ps.append(v[b.pressure])
        d = torch.stack(ds); T = torch.stack(Ts); P = torch.stack(Ps)
        return (w95.p_dT(d, T) - P).ravel()

    fs.add_eq("steam_eos.pressure", eos_pressure, scale=_SP)

    # ---- Maxwell phase equilibrium for wet states --------------------
    if wets:
        def eos_maxwell(v, p):
            dl = torch.stack([v[b.delta_l] for b in wets])
            dv = torch.stack([v[b.delta_v] for b in wets])
            T = torch.stack([v[b.T] for b in wets])
            return (w95.g_dT(dl, T) - w95.g_dT(dv, T)).ravel()

        fs.add_eq("steam_eos.maxwell", eos_maxwell, scale=_SH)

    # ---- enthalpy links ---------------------------------------------
    sh = [b for b in singles if b.h_target is not None]
    wh = [b for b in wets if b.h_target is not None]
    if sh or wh:
        def eos_enthalpy(v, p):
            parts = []
            if sh:
                d = torch.stack([v[b.delta] for b in sh])
                T = torch.stack([v[b.T] for b in sh])
                h = torch.stack([v[b.h_target] for b in sh])
                parts.append((w95.h_dT(d, T) - h).ravel())
            if wh:
                dl = torch.stack([v[b.delta_l] for b in wh])
                dv = torch.stack([v[b.delta_v] for b in wh])
                T = torch.stack([v[b.T] for b in wh])
                x = torch.stack([v[b.x] for b in wh])
                h = torch.stack([v[b.h_target] for b in wh])
                hl = w95.h_dT(dl, T)
                hv = w95.h_dT(dv, T)
                parts.append(((1.0 - x) * hl + x * hv - h).ravel())
            return torch.cat(parts)

        fs.add_eq("steam_eos.enthalpy", eos_enthalpy, scale=_SH)

    # ---- entropy definitions ----------------------------------------
    ss = [b for b in singles if b._s_var is not None]
    ws = [b for b in wets if b._s_var is not None]
    if ss or ws:
        def eos_entropy(v, p):
            parts = []
            if ss:
                d = torch.stack([v[b.delta] for b in ss])
                T = torch.stack([v[b.T] for b in ss])
                s = torch.stack([v[b._s_var] for b in ss])
                parts.append((w95.s_dT(d, T) - s).ravel())
            if ws:
                dl = torch.stack([v[b.delta_l] for b in ws])
                dv = torch.stack([v[b.delta_v] for b in ws])
                T = torch.stack([v[b.T] for b in ws])
                x = torch.stack([v[b.x] for b in ws])
                s = torch.stack([v[b._s_var] for b in ws])
                sl = w95.s_dT(dl, T)
                sv = w95.s_dT(dv, T)
                parts.append(((1.0 - x) * sl + x * sv - s).ravel())
            return torch.cat(parts)

        fs.add_eq("steam_eos.entropy", eos_entropy, scale=_SS)


class EosBlock:
    """IAPWS-95 auxiliary variables for one stream state, registered
    into the flowsheet's batched EoS kernel.

    ``phase``:
      * ``"vap"`` — single-phase vapor;  ``"liq"`` — compressed liquid;
        ``"sc"`` — supercritical (wide density bounds): vars (T, d)
      * ``"wet"`` — two-phase capable: vars (T, x, d_l, d_v) with the
        Maxwell condition g_l == g_v, so T is the saturation temperature
        at the state pressure and ``x`` the vapor fraction.

    The caller closes the block with either ``h_target`` (ordinary
    stream state: the state enthalpy var defines it) or an entropy
    variable obtained from :meth:`s_var` tied elsewhere (isentropic
    reference states).
    """

    def __init__(self, unit: UnitModel, local: str, phase: str,
                 pressure_var: str, h_target: Optional[str] = None):
        if phase not in ("vap", "liq", "sc", "wet"):
            raise ValueError(f"unknown phase {phase!r}")
        self.unit = unit
        self.local = local
        self.phase = phase
        self.pressure = pressure_var
        self.h_target = h_target
        self._s_var: Optional[str] = None
        self._h_var: Optional[str] = None

        self.T = unit.add_var(f"{local}.temperature", lb=255.0, ub=1350.0,
                              init=400.0, scale=100.0)
        if phase == "wet":
            self.x = unit.add_var(f"{local}.vapor_frac", lb=-0.5, ub=1.5,
                                  init=0.5)
            self.delta_l = unit.add_var(f"{local}.delta_liq", lb=0.9, ub=3.95,
                                        init=3.0)
            self.delta_v = unit.add_var(f"{local}.delta_vap", lb=1e-9, ub=1.05,
                                        init=1e-3, scale=0.1)
            self.delta = None
        else:
            lb, ub, init = _PHASE_DELTA[phase]
            self.delta = unit.add_var(f"{local}.delta", lb=lb, ub=ub, init=init)
            self.x = None
        _registry(unit.fs)["blocks"].append(self)

    # ---- derived-property variables ----------------------------------

    def s_var(self) -> str:
        """Molar-entropy variable defined by the batched kernel."""
        if self._s_var is None:
            self._s_var = self.unit.add_var(
                f"{self.local}.entr_mol", lb=-50.0, ub=250.0, init=100.0,
                scale=10.0,
            )
        return self._s_var

    def h_var(self) -> str:
        """Molar-enthalpy variable (for blocks not tied to a stream
        enthalpy, e.g. isentropic reference states)."""
        if self._h_var is None:
            if self.h_target is not None:
                return self.h_target
            self._h_var = self.unit.add_var(
                f"{self.local}.enth_mol", lb=100.0, ub=9e4, init=3e4,
                scale=1e4,
            )
            self.h_target = self._h_var
        return self._h_var


class SteamState:
    """Helm steam stream: (flow_mol, enth_mol, pressure) + optional port
    + lazily-built :class:`EosBlock` (only states whose temperature or
    entropy is actually referenced pay for auxiliary EoS variables)."""

    def __init__(self, unit: UnitModel, local: str, phase: str = "vap",
                 port: bool = True):
        self.unit = unit
        self.local = local
        self.phase = phase
        self.flow_mol = unit.add_var(f"{local}.flow_mol", lb=0.0, ub=6e4,
                                     init=1e4, scale=1e4)
        self.enth_mol = unit.add_var(f"{local}.enth_mol", lb=100.0, ub=9e4,
                                     init=3e4, scale=1e4)
        self.pressure = unit.add_var(f"{local}.pressure", lb=1e3, ub=6e7,
                                     init=1e6, scale=1e6)
        self._eos: Optional[EosBlock] = None
        self.port: Optional[Port] = (
            unit.add_port(local, {
                "flow_mol": self.flow_mol,
                "enth_mol": self.enth_mol,
                "pressure": self.pressure,
            }) if port else None
        )

    def eos(self) -> EosBlock:
        if self._eos is None:
            self._eos = EosBlock(self.unit, f"{self.local}.eos", self.phase,
                                 self.pressure, h_target=self.enth_mol)
        return self._eos

    @property
    def temperature(self) -> str:
        return self.eos().T

    @property
    def vapor_frac(self) -> str:
        if self.phase != "wet":
            raise ValueError(f"{self.local} is declared {self.phase!r}")
        return self.eos().x

    def entropy(self) -> str:
        """Molar-entropy variable of this stream's state."""
        return self.eos().s_var()


class SteamTurbineStage(UnitModel):
    """Single isentropic turbine stage (HelmTurbineStage counterpart;
    consumed at ``ultra_supercritical_powerplant.py:89-92`` and the bfpt
    ``:213-215``).  Fix ``efficiency_isentropic`` and one of
    ``ratioP``/``deltaP`` (or pin the outlet pressure externally, as the
    reference's ``constraint_out_pressure`` does for the bfpt)."""

    def __init__(self, fs: Flowsheet, name: str,
                 inlet_phase: str = "vap", outlet_phase: str = "vap",
                 isentropic_phase: Optional[str] = None):
        super().__init__(fs, name)
        self.inlet_state = SteamState(self, "inlet", inlet_phase)
        self.outlet_state = SteamState(self, "outlet", outlet_phase)
        _pressure_changer_eqs(self, self.inlet_state, self.outlet_state,
                              isentropic_phase or outlet_phase,
                              compressor=False)

    @property
    def inlet(self):
        return self.inlet_state.port

    @property
    def outlet(self):
        return self.outlet_state.port


class SteamIsentropicCompressor(UnitModel):
    """Pump/compressor stage (HelmIsentropicCompressor counterpart,
    ``ultra_supercritical_powerplant.py:154-156,207-212``)."""

    def __init__(self, fs: Flowsheet, name: str,
                 inlet_phase: str = "liq", outlet_phase: str = "liq",
                 isentropic_phase: Optional[str] = None):
        super().__init__(fs, name)
        self.inlet_state = SteamState(self, "inlet", inlet_phase)
        self.outlet_state = SteamState(self, "outlet", outlet_phase)
        _pressure_changer_eqs(self, self.inlet_state, self.outlet_state,
                              isentropic_phase or outlet_phase,
                              compressor=True)

    @property
    def inlet(self):
        return self.inlet_state.port

    @property
    def outlet(self):
        return self.outlet_state.port


def _pressure_changer_eqs(unit: UnitModel, sin: SteamState, sout: SteamState,
                          isentropic_phase: str, compressor: bool) -> None:
    eta = unit.add_var("efficiency_isentropic", shape=(), lb=0.05, ub=1.0,
                       init=0.85)
    rP = unit.add_var("ratioP", lb=1e-4, ub=1e3, init=1.0)
    dP = unit.add_var("deltaP", lb=-6e7, ub=6e7, init=0.0, scale=1e6)
    W = unit.add_var("work_mechanical", lb=-2e9, ub=2e9, init=0.0, scale=1e7)
    unit.work_mechanical = W
    unit.efficiency_isentropic = eta
    unit.ratioP = rP
    unit.deltaP = dP

    unit.add_eq("flow_balance",
                lambda v, p: v[sout.flow_mol] - v[sin.flow_mol], scale=_SF)
    unit.add_eq("pressure_ratio",
                lambda v, p: v[sout.pressure] - v[rP] * v[sin.pressure],
                scale=_SP)
    unit.add_eq("pressure_delta",
                lambda v, p: v[sout.pressure] - v[sin.pressure] - v[dP],
                scale=_SP)

    # isentropic reference state at the outlet pressure: its entropy
    # equals the inlet entropy (both entropy vars live in the batched
    # EoS kernel; this residual is linear)
    s_in = sin.entropy()
    iso = EosBlock(unit, "isentropic", isentropic_phase, sout.pressure)
    s_iso = iso.s_var()
    h_iso = iso.h_var()
    unit.isentropic = iso
    unit.add_eq("isentropic",
                lambda v, p: v[s_iso] - v[s_in], scale=_SS)

    def w_isen(v):
        return v[sin.flow_mol] * (v[h_iso] - v[sin.enth_mol])

    if compressor:
        unit.add_eq("work_definition",
                    lambda v, p: v[W] * v[eta] - w_isen(v), scale=_SE)
    else:
        unit.add_eq("work_definition",
                    lambda v, p: v[W] - v[eta] * w_isen(v), scale=_SE)
    unit.add_eq("energy_balance",
                lambda v, p: v[sin.flow_mol]
                * (v[sout.enth_mol] - v[sin.enth_mol]) - v[W],
                scale=_SE)


class SteamSplitter(UnitModel):
    """Flow splitter (HelmSplitter counterpart,
    ``ultra_supercritical_powerplant.py:101-111``): same (h, P) on every
    outlet, split-fraction vars summing to 1."""

    def __init__(self, fs: Flowsheet, name: str, num_outlets: int = 2):
        super().__init__(fs, name)
        self.inlet_state = SteamState(self, "inlet", "vap")
        self.num_outlets = num_outlets
        self.outlet_states: List[SteamState] = []
        self.split_fraction: List[str] = []
        sin = self.inlet_state
        for k in range(1, num_outlets + 1):
            so = SteamState(self, f"outlet_{k}", "vap")
            sf = self.add_var(f"split_fraction_{k}", lb=0.0, ub=1.0,
                              init=1.0 / num_outlets)
            self.outlet_states.append(so)
            self.split_fraction.append(sf)
            self.add_eq(f"flow_split_{k}",
                        lambda v, p, so=so, sf=sf: v[so.flow_mol]
                        - v[sf] * v[sin.flow_mol], scale=_SF)
            self.add_eq(f"enth_pass_{k}",
                        lambda v, p, so=so: v[so.enth_mol] - v[sin.enth_mol],
                        scale=_SH)
            self.add_eq(f"pressure_pass_{k}",
                        lambda v, p, so=so: v[so.pressure] - v[sin.pressure],
                        scale=_SP)
        self.add_eq("split_fraction_sum",
                    lambda v, p: sum(v[sf] for sf in self.split_fraction) - 1.0)

    @property
    def inlet(self):
        return self.inlet_state.port

    def outlet(self, k: int):
        """1-based outlet port (reference outlet_1, outlet_2, ...)."""
        return self.outlet_states[k - 1].port


class SteamMixer(UnitModel):
    """Stream mixer (HelmMixer counterpart,
    ``ultra_supercritical_powerplant.py:141-145,169-174,198-202``).

    ``momentum="minimize"`` gives the Helm smooth-minimum outlet pressure;
    passing an inlet name instead pins the outlet pressure to that inlet
    (the reference's ``momentum_mixing_type=none`` + explicit equality,
    e.g. the integrated-storage recycle mixer,
    ``integrated_storage...py:125-129,449-453``).

    ``inlet_phases`` maps inlet names to their declared phase; inlets
    whose temperature is never referenced build no EoS block, so the
    declaration only matters for inlets used in temperature/entropy
    expressions (condenser drains are "wet", extraction steam "vap").
    """

    def __init__(self, fs: Flowsheet, name: str, inlet_list: List[str],
                 outlet_phase: str = "liq",
                 inlet_phases: Optional[Dict[str, str]] = None,
                 momentum: str = "minimize"):
        super().__init__(fs, name)
        self.inlet_names = list(inlet_list)
        phases = inlet_phases or {}
        unknown = set(phases) - set(inlet_list)
        if unknown:
            raise ValueError(f"inlet_phases keys not in inlet_list: "
                             f"{sorted(unknown)}")
        bad = {nm: ph for nm, ph in phases.items()
               if ph not in ("vap", "liq", "sc", "wet")}
        if bad:
            raise ValueError(f"invalid inlet phases: {bad}")
        self.inlet_states: Dict[str, SteamState] = {
            nm: SteamState(self, nm, phases.get(nm, "vap"))
            for nm in inlet_list
        }
        self.outlet_state = SteamState(self, "outlet", outlet_phase)
        ins = list(self.inlet_states.values())
        out = self.outlet_state

        self.add_eq("flow_balance",
                    lambda v, p: sum(v[s.flow_mol] for s in ins)
                    - v[out.flow_mol], scale=_SF)
        self.add_eq("energy_balance",
                    lambda v, p: sum(v[s.flow_mol] * v[s.enth_mol] for s in ins)
                    - v[out.flow_mol] * v[out.enth_mol], scale=_SE)

        if momentum == "minimize":
            def min_p(v):
                m = v[ins[0].pressure]
                for s in ins[1:]:
                    m = smooth_min(m, v[s.pressure])
                return m

            self.add_eq("pressure_minimize",
                        lambda v, p: v[out.pressure] - min_p(v), scale=_SP)
        else:
            if momentum not in self.inlet_states:
                raise ValueError(
                    f"momentum must be 'minimize' or an inlet name, got "
                    f"{momentum!r}")
            ref = self.inlet_states[momentum]
            self.add_eq("pressure_equality",
                        lambda v, p: v[out.pressure] - v[ref.pressure],
                        scale=_SP)

    def inlet(self, name: str):
        return self.inlet_states[name].port

    @property
    def outlet(self):
        return self.outlet_state.port


class SteamHeater(UnitModel):
    """Heater block on water/steam (boiler, reheaters, condenser:
    ``ultra_supercritical_powerplant.py:121-151``).  ``heat_duty`` > 0
    heats the stream; fix ``deltaP`` (or set
    ``has_pressure_change=False`` for P_out == P_in)."""

    def __init__(self, fs: Flowsheet, name: str,
                 inlet_phase: str = "liq", outlet_phase: str = "vap",
                 has_pressure_change: bool = True):
        super().__init__(fs, name)
        self.inlet_state = SteamState(self, "inlet", inlet_phase)
        self.outlet_state = SteamState(self, "outlet", outlet_phase)
        sin, sout = self.inlet_state, self.outlet_state
        Q = self.add_var("heat_duty", lb=-5e9, ub=5e9, init=0.0, scale=1e8)
        self.heat_duty = Q
        self.add_eq("flow_balance",
                    lambda v, p: v[sout.flow_mol] - v[sin.flow_mol], scale=_SF)
        self.add_eq("energy_balance",
                    lambda v, p: v[sin.flow_mol]
                    * (v[sout.enth_mol] - v[sin.enth_mol]) - v[Q], scale=_SE)
        if has_pressure_change:
            dP = self.add_var("deltaP", lb=-6e7, ub=6e7, init=0.0, scale=1e6)
            self.deltaP = dP
            self.add_eq("pressure_balance",
                        lambda v, p: v[sout.pressure] - v[sin.pressure] - v[dP],
                        scale=_SP)
        else:
            self.add_eq("pressure_balance",
                        lambda v, p: v[sout.pressure] - v[sin.pressure],
                        scale=_SP)

    @property
    def inlet(self):
        return self.inlet_state.port

    @property
    def outlet(self):
        return self.outlet_state.port


def underwood_lmtd(dT1, dT2):
    """Underwood (1970) LMTD approximation — the
    ``delta_temperature_underwood_callback`` the reference requests for
    every FWH (``ultra_supercritical_powerplant.py:61-62,178-181``)."""
    return (0.5 * (_cbrt(dT1) + _cbrt(dT2))) ** 3


def _cbrt(x):
    """Real cube root (odd in x)."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


class SteamFWH(UnitModel):
    """0D condensing feed-water heater: IDAES ``HeatExchanger`` with
    shell (hot, condensing steam) and tube (cold feedwater) sides,
    counter-current Underwood LMTD, saturated-liquid drain
    (``ultra_supercritical_powerplant.py:176-193`` + the constraint block
    ``:253-356``).

    * drain saturation:  shell outlet is "wet" with ``x`` fixed to 0
      (the reference's ``fwh_vaporfrac_constraint``)
    * tube side 4% pressure drop (``fwh_s2pdrop_constraint``)
    * shell outlet pressure from the next-lower extraction stage
      pressure ratio (``fwh_s1pdrop_constraint``), parameters
      ``turb_press_ratio`` / ``reheater_press_diff``.
    """

    def __init__(self, fs: Flowsheet, name: str,
                 shell_inlet_phase: str = "wet",
                 turb_press_ratio: float = 1.0,
                 reheater_press_diff: float = 0.0):
        super().__init__(fs, name)
        self.shell_in = SteamState(self, "shell_inlet", shell_inlet_phase)
        self.shell_out = SteamState(self, "shell_outlet", "wet")
        self.tube_in = SteamState(self, "tube_inlet", "liq")
        self.tube_out = SteamState(self, "tube_outlet", "liq")

        A = self.add_var("area", shape=(), lb=1.0, ub=1e5, init=200.0,
                         scale=100.0)
        U = self.add_var("overall_heat_transfer_coefficient", shape=(),
                         lb=1.0, ub=1e5, init=3000.0, scale=1e3)
        Q = self.add_var("heat_duty", lb=0.0, ub=5e9, init=1e7, scale=1e7)
        self.area, self.htc, self.heat_duty = A, U, Q

        si, so, ti, to = self.shell_in, self.shell_out, self.tube_in, self.tube_out
        self.add_eq("shell_flow",
                    lambda v, p: v[so.flow_mol] - v[si.flow_mol], scale=_SF)
        self.add_eq("tube_flow",
                    lambda v, p: v[to.flow_mol] - v[ti.flow_mol], scale=_SF)
        self.add_eq("shell_energy",
                    lambda v, p: v[si.flow_mol]
                    * (v[so.enth_mol] - v[si.enth_mol]) + v[Q], scale=_SE)
        self.add_eq("tube_energy",
                    lambda v, p: v[ti.flow_mol]
                    * (v[to.enth_mol] - v[ti.enth_mol]) - v[Q], scale=_SE)

        Tsi, Tso = si.temperature, so.temperature
        Tti, Tto = ti.temperature, to.temperature
        self.add_eq(
            "heat_transfer",
            lambda v, p: v[Q] - v[U] * v[A] * underwood_lmtd(
                v[Tsi] - v[Tto], v[Tso] - v[Tti]
            ),
            scale=_SE,
        )

        # saturated-liquid drain: x == 0 (vfrac constraint); callers may
        # unfix during relaxed initialization sweeps
        fs.fix(so.vapor_frac, 0.0)

        # tube-side 4% pressure drop
        self.add_eq("tube_pressure_drop",
                    lambda v, p: v[to.pressure] - 0.96 * v[ti.pressure],
                    scale=_SP)
        # shell-side outlet pressure (cascade rule)
        self.add_param("turb_press_ratio", turb_press_ratio)
        self.add_param("reheater_press_diff", reheater_press_diff)
        rp, rd = self.v("turb_press_ratio"), self.v("reheater_press_diff")
        self.add_eq("shell_pressure_out",
                    lambda v, p: v[so.pressure]
                    - 1.1 * p[rp] * (v[si.pressure] - p[rd]), scale=_SP)

    @property
    def shell_inlet(self):
        return self.shell_in.port

    @property
    def shell_outlet(self):
        return self.shell_out.port

    @property
    def tube_inlet(self):
        return self.tube_in.port

    @property
    def tube_outlet(self):
        return self.tube_out.port
