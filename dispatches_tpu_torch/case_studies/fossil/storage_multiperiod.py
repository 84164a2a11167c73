"""Multiperiod integrated USC + TES model and the 24-h price-taker
(counterpart of ``dispatches_tpu/case_studies/fossil/
storage_multiperiod.py``).

Counterpart of the reference's ``storage/multiperiod_integrated_storage_
usc.py`` (coupling variables ``previous_power`` with a +-60 MW ramp,
hot/cold salt-inventory balances, linking and periodic pairs) and
``storage/pricetaker_with_multiperiod_integrated_storage_usc.py`` (24-h
LMP signal, hourly revenue - operating-cost objective, tank scenarios).

The reference clones the full integrated model once per hour and links
the clones with equality constraints inside one IPOPT solve.  Here each
hour is an independent square plant solve (the ~800-state horizon-1
integrated flowsheet of ``storage_integrated``), the T hours run along
one lane axis of ``solvers/reduced.BatchedReducedSpaceNLP`` (the
lane-batched Newton, one batched adjoint solve), and the coupling layer
(ramps, salt inventory, periodicity) lives in the small outer decision
space: the linking constraints never touch the physics Jacobian.

DoF note (vs the reference's ``usc_unfix_dof``): with the HX areas
(1904 / 2830 m2) and both salt temperatures fixed, the salt flows are
implied by the heat-exchanger physics: given the steam-side split
fractions, the duty and therefore the salt flow follow.  The decisions
per hour are (boiler flow, HP split fraction, BFP split fraction, cooler
outlet enthalpy); the salt flows join the square state vector, and the
inventory constraints read them as states.

``MultiPeriodUscModel`` and ``run_pricetaker_analysis`` run on ``device``:
``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dispatches_tpu_torch import resolve_device
from dispatches_tpu_torch.case_studies.fossil import storage_integrated as isp
from dispatches_tpu_torch.case_studies.fossil import usc_plant as up
from dispatches_tpu_torch.case_studies.fossil.usc_plant import UscModel
from dispatches_tpu_torch.core.graph import tshift
from dispatches_tpu_torch.solvers.newton import NewtonOptions
from dispatches_tpu_torch.solvers.reduced import BatchedReducedSpaceNLP

MAX_POWER = 436.0
MIN_POWER = float(int(0.65 * MAX_POWER))          # 283 (reference :50)
PMIN_DEFAULT = float(int(0.65 * 436) + 1)         # 284 (:52)
PMAX_DEFAULT = 436.0 + 30.0                       # 466 (:54)
MIN_STORAGE_HEAT_DUTY = 10.0e6                    # W (:46)
MAX_STORAGE_HEAT_DUTY = 200.0e6                   # W (:47)
HXC_AREA_FIXED = isp.HXC_AREA_GUESS               # 1904 m2 (:191)
HXD_AREA_FIXED = isp.HXD_AREA_GUESS               # 2830 m2 (:192)
RAMP_MW = 60.0                                    # (:125-135)

INVENTORY_MAX = isp.INVENTORY_MAX
INVENTORY_MIN = isp.INVENTORY_MIN
TANK_MAX = isp.TANK_MAX

# 24-h modified RTS LMP signal (`pricetaker...py:51-56`)
MOD_RTS_LMP = np.array([
    22.9684, 21.1168, 20.4, 20.419, 20.419, 21.2877, 23.07, 25.0,
    18.4634, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
    19.0342, 23.07, 200.0, 200.0, 200.0, 200.0, 200.0, 200.0,
])
PREVIOUS_POWER_0 = 447.66                         # MW (:123)
HOT_EMPTY_INITIAL = 1103053.48                    # kg (:112)
OBJ_SCALE = 1e-3                                  # outer conditioning only


def create_usc_model(pmin: Optional[float] = None,
                     pmax: Optional[float] = None,
                     load_from_file=None, device=None) -> UscModel:
    """Integrated model configured for multiperiod operation (reference
    ``create_usc_model`` :40-166 + ``usc_unfix_dof`` :169-195): fixed
    HX areas and salt temperatures, per-hour operating envelope as
    inequalities, salt flows as implied states.

    ``pmin``/``pmax`` tighten the plant-power envelope the way the
    reference's ``previous_power`` bounds do through the linking pairs
    (:89-94 + :334-342): effective range
    ``[max(MIN_POWER, pmin), min(MAX_POWER, pmax)]``.  Without
    ``load_from_file`` the square initialization solves on ``device``
    (``cuda`` unless given)."""
    m = isp.main(max_power=MAX_POWER, solve=load_from_file is None,
                 load_from_file=load_from_file, device=device)
    fs, u = m.fs, m.units
    hxc, hxd = u["hxc"], u["hxd"]

    power_lo = MIN_POWER if pmin is None else max(MIN_POWER, float(pmin))
    power_hi = MAX_POWER if pmax is None else min(MAX_POWER, float(pmax))

    fs.fix(hxc.area, HXC_AREA_FIXED)
    fs.fix(hxd.area, HXD_AREA_FIXED)
    fs.fix(hxc.salt_out.temperature, isp.SALT_HOT_TEMPERATURE)
    fs.fix(hxd.salt_in.temperature, isp.SALT_HOT_TEMPERATURE)
    fs.fix(hxd.salt_out.temperature, isp.HXC_SALT_T_IN)
    # salt flows become implied states (see module docstring)
    for name, init in ((hxc.salt_in.flow_mass, 50.0),
                       (hxd.salt_in.flow_mass, 50.0)):
        fs.set_init(name, init)
        fs.unfix(name)

    # per-hour envelope (reference :75-86 + add_bounds rows that can be
    # active; all <= 0)
    fs.add_ineq("plant_power_min",
                lambda v, p: power_lo - v["plant_power_out"], scale=1e-2)
    fs.add_ineq("plant_power_max",
                lambda v, p: v["plant_power_out"] - power_hi, scale=1e-2)
    for hx, tag in ((hxc, "hxc"), (hxd, "hxd")):
        Q = hx.heat_duty
        fs.add_ineq(f"{tag}_duty_min",
                    lambda v, p, Q=Q: MIN_STORAGE_HEAT_DUTY - v[Q],
                    scale=1e-6)
        fs.add_ineq(f"{tag}_duty_max",
                    lambda v, p, Q=Q: v[Q] - MAX_STORAGE_HEAT_DUTY,
                    scale=1e-6)
        F = hx.salt_in.flow_mass
        fs.add_ineq(f"{tag}_salt_flow_max",
                    lambda v, p, F=F: v[F] - 500.0, scale=1e-2)
        fs.add_ineq(f"{tag}_salt_flow_min",
                    lambda v, p, F=F: -v[F], scale=1e-2)
    # approach-temperature envelope + cooler rejection-only
    isp._envelope_ineqs(fs, hxc, hxd)
    Qcool = u["cooler"].heat_duty
    fs.add_ineq("cooler_duty_max", lambda v, p: v[Qcool], scale=1e-6)
    return m


DECISIONS: Tuple[str, ...] = (
    "boiler.inlet.flow_mol",
    "ess_hp_split.split_fraction_2",
    "ess_bfp_split.split_fraction_2",
    "cooler.outlet.enth_mol",
)

U_BOUNDS: Dict[str, Tuple[float, float]] = {
    "boiler.inlet.flow_mol": (11804.0, 3.0 * up.MAIN_FLOW),
    "ess_hp_split.split_fraction_2": (1e-3, 0.45),
    "ess_bfp_split.split_fraction_2": (1e-3, 0.45),
    "cooler.outlet.enth_mol": (2000.0, 22000.0),
}

#: decisions with an inner solution from the initialization checkpoint.
#: At the defaults (HP split 0.1) the hour-plant has none inside its
#: variable bounds: the charge HX's outlet would need a vapor fraction
#: below the wet state's -0.5 bound, and Newton stalls at a max residual
#: of 7.057 after 80 iterations.
FEASIBLE_DECISIONS: Dict[str, float] = {"ess_hp_split.split_fraction_2": 0.3}


def feasible_U(brs: BatchedReducedSpaceNLP, T: int,
               boiler_fracs=None) -> np.ndarray:
    """(T, m_u) scaled decisions for ``brs``: its defaults with
    ``FEASIBLE_DECISIONS``, and per-hour boiler flows ``boiler_fracs`` x
    the design flow where given."""
    base = brs.base
    u = base.u0.copy()
    for d, v in FEASIBLE_DECISIONS.items():
        a, b, _, scale = base._u_layout[d]
        u[a:b] = v / scale
    U = np.tile(u, (T, 1))
    if boiler_fracs is not None:
        a, _, _, scale = base._u_layout["boiler.inlet.flow_mol"]
        U[:, a] = np.asarray(boiler_fracs) * up.MAIN_FLOW / scale
    return U


class MultiPeriodUscModel:
    """The multiperiod model object (role of the reference's
    ``create_multiperiod_usc_model`` return value, :362-381): one
    compiled hour-plant + the time-coupling layer, solved as a batched
    reduced-space NLP on ``device`` (``cuda`` unless given)."""

    def __init__(self, n_time_points: int = 4,
                 pmin: Optional[float] = None,
                 pmax: Optional[float] = None,
                 load_from_file=None,
                 previous_power: float = PREVIOUS_POWER_0,
                 initial_hot_inventory: float = HOT_EMPTY_INITIAL,
                 periodic: bool = True,
                 lmp: Optional[np.ndarray] = None,
                 salt_amount: float = isp.SALT_AMOUNT,
                 inventory_max: float = INVENTORY_MAX,
                 device=None):
        self.device = resolve_device(device)
        self.n_time_points = int(n_time_points)
        self.pmin = PMIN_DEFAULT if pmin is None else float(pmin)
        self.pmax = PMAX_DEFAULT if pmax is None else float(pmax)
        self.previous_power = float(previous_power)
        self.initial_hot_inventory = float(initial_hot_inventory)
        self.salt_amount = float(salt_amount)
        self.inventory_max = float(inventory_max)
        self.periodic = periodic
        self.lmp = np.asarray(
            np.resize(MOD_RTS_LMP, self.n_time_points) if lmp is None
            else lmp,
            dtype=np.float64)
        if self.lmp.shape[0] != self.n_time_points:
            raise ValueError("lmp length must equal n_time_points")

        self.m = create_usc_model(self.pmin, self.pmax,
                                  load_from_file=load_from_file,
                                  device=self.device)
        self.nlp = self.m.fs.compile()
        self._build_batched()

    # -- coupling layer ------------------------------------------------

    @staticmethod
    def _hot_inventory(vb, p):
        """Hot-inventory trajectory: ``inv_t = inv0 + 3600·Σ(Fc − Fd)``
        (reference ``constraint_salt_inventory_hot``, :137-144)."""
        Fc = vb["hxc.tube_inlet.flow_mass"][:, 0]
        Fd = vb["hxd.shell_inlet.flow_mass"][:, 0]
        return p["initial_hot_inventory"] + 3600.0 * torch.cumsum(Fc - Fd, 0)

    def _build_batched(self) -> None:
        T = self.n_time_points
        hot_inv = self._hot_inventory

        # LMP signal, initial conditions and the dispatch-tracking terms
        # are RUNTIME parameters: the rolling-horizon double loop
        # (``multiperiod_double_loop.MultiPeriodUsc``) rebinds them every
        # market hour on the same batched evaluation
        runtime = {
            "lmp": np.asarray(self.lmp),
            "previous_power": np.asarray(self.previous_power),
            "initial_hot_inventory": np.asarray(
                self.initial_hot_inventory),
            "market_dispatch": np.zeros(T),
            "dispatch_penalty": np.asarray(0.0),
        }

        def objective(vb, p):
            # reference `pricetaker...py:94-107` (their scaling factors
            # are 1; the 1e-3 here only conditions the outer trust
            # region — reported objectives are unscaled).  The
            # dispatch-deviation term (off in price-taker mode) is the
            # tracker's penalized |P - dispatch| in smooth form.
            net = vb["net_power"][:, 0]
            rev = torch.sum(p["lmp"] * net)
            cost = torch.sum(
                vb["operating_cost"] + vb["plant_fixed_operating_cost"]
                + vb["plant_variable_operating_cost"]) / (365.0 * 24.0)
            dev = torch.sum(torch.sqrt(
                (net - p["market_dispatch"]) ** 2 + 1e-4))
            return (rev - cost - p["dispatch_penalty"] * dev) * OBJ_SCALE

        def ramp_rows(vb, p):
            # ±60 MW/h on plant power, seeded by previous_power
            # (reference :125-135 + linking pairs :334-342)
            power = vb["plant_power_out"][:, 0]
            prev = tshift(power, p["previous_power"])
            return torch.cat([
                (power - prev - RAMP_MW) * 1e-2,
                (prev - power - RAMP_MW) * 1e-2,
            ])

        salt_amount = self.salt_amount
        inventory_max = self.inventory_max

        def inventory_rows(vb, p):
            # discharge limited by the hot inventory at the START of the
            # hour, charge by the cold inventory; levels within the tank
            # (reference :146-164)
            Fc = vb["hxc.tube_inlet.flow_mass"][:, 0]
            Fd = vb["hxd.shell_inlet.flow_mass"][:, 0]
            inv = hot_inv(vb, p)
            prev_inv = tshift(inv, p["initial_hot_inventory"])
            cold_prev = salt_amount - prev_inv
            return torch.cat([
                (3600.0 * Fd - prev_inv) * 1e-5,
                (3600.0 * Fc - cold_prev) * 1e-5,
                (inv - inventory_max) * 1e-5,
                (-inv) * 1e-5,
            ])

        coupling_eqs = []
        if self.periodic:
            def periodic_row(vb, p):
                # hot inventory returns to its initial level
                # (reference ``periodic_variable_pair`` /
                # `pricetaker...py:88-90`)
                return (hot_inv(vb, p)[-1]
                        - p["initial_hot_inventory"]) * 1e-5
            coupling_eqs.append(("periodic_hot_inventory", periodic_row))

        self.brs = BatchedReducedSpaceNLP(
            self.nlp, list(DECISIONS), T,
            objective=objective, sense="max",
            coupling_ineqs=[("ramp", ramp_rows),
                            ("inventory", inventory_rows)],
            coupling_eqs=coupling_eqs,
            newton_options=NewtonOptions(max_iter=80),
            u_scales={"ess_hp_split.split_fraction_2": 0.01,
                      "ess_bfp_split.split_fraction_2": 0.01},
            runtime_params=runtime,
            device=self.device,
        )

    # ------------------------------------------------------------------

    def solve(self, U0: Optional[np.ndarray] = None, maxiter: int = 300,
              verbose: int = 0, X0: Optional[np.ndarray] = None,
              lmp: Optional[np.ndarray] = None,
              previous_power: Optional[float] = None,
              initial_hot_inventory: Optional[float] = None,
              market_dispatch: Optional[np.ndarray] = None,
              dispatch_penalty: Optional[float] = None):
        """Solve the multiperiod program.  The keyword overrides rebind
        the runtime parameters (LMP signal, carried state, tracking
        terms) on the same model: the double-loop wrappers call this
        every market hour."""
        if lmp is not None:
            self.lmp = np.asarray(lmp, dtype=np.float64)
        if previous_power is not None:
            self.previous_power = float(previous_power)
        if initial_hot_inventory is not None:
            self.initial_hot_inventory = float(initial_hot_inventory)
        # the instance attributes are authoritative for the carried
        # state and the LMP signal — rebind them every solve so callers
        # that mutate the attributes (the double-loop protocol) never
        # solve on stale build-time values
        rp = {
            "lmp": np.asarray(self.lmp, dtype=np.float64),
            "previous_power": float(self.previous_power),
            "initial_hot_inventory": float(self.initial_hot_inventory),
        }
        if market_dispatch is not None:
            rp["market_dispatch"] = np.asarray(market_dispatch,
                                               dtype=np.float64)
        if dispatch_penalty is not None:
            rp["dispatch_penalty"] = float(dispatch_penalty)
        res = self.brs.solve(U0=U0, X0=X0, u_bounds=dict(U_BOUNDS),
                             maxiter=maxiter, verbose=verbose,
                             gtol=1e-6, xtol=1e-9, runtime_params=rp)
        res = res._replace(obj=res.obj / OBJ_SCALE)
        sol = self.brs.stack_solution(res.X, res.U)
        inv = np.asarray(self.initial_hot_inventory + 3600.0 * np.cumsum(
            sol["hxc.tube_inlet.flow_mass"][:, 0]
            - sol["hxd.shell_inlet.flow_mass"][:, 0]))
        return dict(
            res=res, sol=sol, obj=res.obj,
            net_power=np.asarray(sol["net_power"][:, 0]),
            plant_power=np.asarray(sol["plant_power_out"][:, 0]),
            hot_tank_level=inv,
            cold_tank_level=self.salt_amount - inv,
            hxc_duty=np.asarray(sol["hxc.heat_duty"][:, 0]) * 1e-6,
            hxd_duty=np.asarray(sol["hxd.heat_duty"][:, 0]) * 1e-6,
            revenue=float(np.sum(self.lmp * sol["net_power"][:, 0])),
        )


def create_multiperiod_usc_model(n_time_points: int = 4,
                                 pmin: Optional[float] = None,
                                 pmax: Optional[float] = None,
                                 **kw) -> MultiPeriodUscModel:
    """Reference-parity entry point (:362-381)."""
    return MultiPeriodUscModel(n_time_points=n_time_points, pmin=pmin,
                               pmax=pmax, **kw)


def run_pricetaker_analysis(ndays: int = 1, nweeks: int = 1,
                            tank_status: str = "hot_empty",
                            tank_min: float = INVENTORY_MIN,
                            tank_max: float = TANK_MAX,
                            load_from_file=None,
                            maxiter: int = 300,
                            verbose: int = 0,
                            device=None):
    """24-h price-taker (reference ``run_pricetaker_analysis``,
    `pricetaker...py:69-156`) on ``device`` (``cuda`` unless given).  The
    horizon is ``nweeks × 24 × ndays`` (reference :72-73)."""
    dev = resolve_device(device)
    number_hours = 24 * ndays * nweeks
    initial = {
        "hot_empty": HOT_EMPTY_INITIAL,
        "half_full": tank_max / 2.0,
        "hot_half_full": tank_max / 2.0,  # storage_integrated spelling
        "hot_full": tank_max - tank_min,
    }
    if tank_status not in initial:
        raise ValueError(
            "tank_status must be hot_empty, half_full or hot_full")
    lmp = np.tile(MOD_RTS_LMP, ndays * nweeks)[:number_hours]
    mp = MultiPeriodUscModel(
        n_time_points=number_hours,
        load_from_file=load_from_file,
        previous_power=PREVIOUS_POWER_0,
        initial_hot_inventory=initial[tank_status],
        periodic=True, lmp=lmp,
        salt_amount=tank_max,
        device=dev,
    )
    out = mp.solve(maxiter=maxiter, verbose=verbose)
    out["mp"] = mp
    out["lmp"] = lmp
    return out
