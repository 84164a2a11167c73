"""Minimal RUC/SCED market co-simulator over RTS-GMLC-format data
(counterpart of ``dispatches_tpu/grid/market.py``).

Scope is what the double-loop workflow needs: the daily RUC / hourly
SCED cadence, DC-network LMPs, two-settlement accounting, hooks for a
double-loop participant, and Prescient-schema output CSVs.

Solver mapping:
* **RUC (unit commitment, MILP)** runs host-side: exact branch-and-cut
  via ``scipy.optimize.milp`` (HiGHS), else LP relaxation + rounding with
  a feasibility repair — the JAX package's function, line for line, so
  the same case gives the same commitment.
* **Pricing runs / SCED (continuous LPs)** solve on the float64 IPM —
  one solver per horizon with (load, renewable caps, commitment, bid
  segments) as params, re-dispatched every market cycle; LMPs come out
  of the equality/inequality duals:
  ``LMP_b = lambda_balance + sum_l mu_l PTDF_{l,b}``.

The dispatch LP keeps the JAX package's layout (one (H,) variable per
thermal segment, renewable unit and participant segment, the same
constraint blocks in the same order, so ``IPMResult.lam`` has the JAX
signs and rows), but its residuals are written over whole blocks
(``_MarketNLP``): the JAX package's per-generator loop compiles into a
few fused XLA ops, while run eagerly it would be thousands of small
launches per residual pass.  The LP is affine, so the dense IPM path
skips its (exactly zero) Lagrangian Hessian.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from dispatches_tpu_torch import resolve_device
from dispatches_tpu_torch.analysis.runtime import CountedProgram
from dispatches_tpu_torch.core.compile import _leaf
from dispatches_tpu_torch.core.config import config, config_field
from dispatches_tpu_torch.obs import trace as obs_trace
from dispatches_tpu_torch.solvers.ipm import IPMOptions, make_ipm_solver

N_SEG = 3  # thermal cost curves: RTS heat-rate tables carry 3 increments


@config
class MarketOptions:
    """Typed simulation options (the Prescient options-dict tier of
    upstream ``run_double_loop.py:309-332`` as one validated config)."""

    sced_horizon: int = config_field(
        4, bounds=(1, None), doc="SCED lookahead hours (reference "
        "sced_horizon=4)")
    ruc_horizon: int = config_field(
        48, bounds=(24, None), doc="RUC commitment horizon with cross-day "
        "state (>= 24: the settlement loop clears 24 hours per simulated "
        "day; reference ruc_horizon=48)")
    reserve_factor: float = config_field(
        0.0, bounds=(0.0, 1.0), doc="spinning-reserve fraction of load")
    use_milp: bool = config_field(
        True, doc="exact HiGHS MILP for the RUC (else LP-relax+repair)")


@dataclass
class ThermalUnit:
    name: str
    bus: str
    pmin: float
    pmax: float
    ramp_hr: float  # MW/hr
    min_up: float
    min_down: float
    startup_cost: float
    noload_cost: float  # $/hr when committed (cost at pmin)
    seg_mw: np.ndarray  # (N_SEG,) widths above pmin
    seg_cost: np.ndarray  # (N_SEG,) marginal $/MWh
    initial_on: bool = True
    initial_p: float = 0.0


@dataclass
class RenewableUnit:
    name: str
    bus: str
    da_cap: np.ndarray  # (n_hours,) MW available, day-ahead forecast
    rt_cap: np.ndarray  # (n_hours,) MW available, real-time
    curtailable: bool = True


@dataclass
class MarketCase:
    buses: List[str]
    thermals: List[ThermalUnit]
    renewables: List[RenewableUnit]
    load_da: np.ndarray  # (n_hours, n_buses)
    load_rt: np.ndarray
    ptdf: np.ndarray  # (n_lines, n_buses)
    line_limits: np.ndarray  # (n_lines,)
    line_names: List[str]
    start_timestamp: pd.Timestamp = None

    @property
    def n_hours(self) -> int:
        return self.load_da.shape[0]


def _hr_to_cost(row) -> Tuple[float, np.ndarray, np.ndarray]:
    """(no-load $/hr at pmin, segment widths MW, marginal $/MWh) from the
    RTS heat-rate columns (HR in BTU/kWh, fuel $/MMBTU)."""
    fuel = float(row.get("Fuel Price $/MMBTU", 0) or 0)
    pmax = float(row["PMax MW"])
    pmin = float(row["PMin MW"])
    pcts = []
    for k in range(4):
        v = row.get(f"Output_pct_{k}", "")
        if v not in ("", None) and not pd.isna(v):
            pcts.append(float(v))
    hr0 = float(row.get("HR_avg_0", 0) or 0)
    noload = hr0 * pmin * fuel * 1e-3  # BTU/kWh * MW * $/MMBTU -> $/hr
    seg_mw = np.zeros(N_SEG)
    seg_cost = np.zeros(N_SEG)
    for k in range(1, min(len(pcts), N_SEG + 1)):
        hri = row.get(f"HR_incr_{k}", "")
        hri = float(hri) if hri not in ("", None) and not pd.isna(hri) else 0.0
        seg_mw[k - 1] = (pcts[k] - pcts[k - 1]) * pmax
        seg_cost[k - 1] = hri * fuel * 1e-3  # $/MWh
    # enforce convexity (nondecreasing marginals) for the LP
    seg_cost = np.maximum.accumulate(seg_cost)
    return noload, seg_mw, seg_cost


def load_rts_gmlc_case(data_path) -> MarketCase:
    """Parse an RTS-GMLC-format directory (the vendored 5-bus miniature
    or a full SourceData tree) into a MarketCase."""
    data_path = Path(data_path)
    gen_df = pd.read_csv(data_path / "gen.csv")
    bus_df = pd.read_csv(data_path / "bus.csv")
    branch_df = pd.read_csv(data_path / "branch.csv")

    bus_ids = bus_df["Bus ID"].tolist()
    buses = [str(b) for b in bus_ids]
    n_bus = len(buses)
    bus_pos = {b: i for i, b in enumerate(bus_ids)}

    # --- DC PTDF (slack = first bus) ------------------------------
    n_line = len(branch_df)
    B_lines = np.zeros(n_line)
    inc = np.zeros((n_line, n_bus))
    for li, row in branch_df.iterrows():
        x = float(row["X"])
        B_lines[li] = 1.0 / x
        inc[li, bus_pos[int(row["From Bus"])]] = 1.0
        inc[li, bus_pos[int(row["To Bus"])]] = -1.0
    Bbus = inc.T @ np.diag(B_lines) @ inc
    # reduced system without slack bus 0
    Br = Bbus[1:, 1:]
    ptdf = np.zeros((n_line, n_bus))
    rhs = np.diag(B_lines) @ inc[:, 1:]
    ptdf[:, 1:] = rhs @ np.linalg.inv(Br)
    line_limits = branch_df["Cont Rating"].to_numpy(float)
    line_names = [str(u).strip('"') for u in branch_df["UID"]]

    # --- timeseries ----------------------------------------------
    def read_ts(name):
        df = pd.read_csv(data_path / name)
        return df

    da_load_df = read_ts("DAY_AHEAD_load.csv")
    rt_load_raw = read_ts("REAL_TIME_load.csv")
    da_ren_df = read_ts("DAY_AHEAD_renewables.csv")
    rt_ren_raw = read_ts("REAL_TIME_renewables.csv")

    def hourly(df):
        """Average sub-hourly RT rows to hourly (Prescient format has
        Period column; 12 periods/hr in RTS RT files, 1 in the 5-bus)."""
        n_per_day = df.groupby(["Year", "Month", "Day"]).size().iloc[0]
        per_hr = max(1, n_per_day // 24)
        vals = df.drop(columns=["Year", "Month", "Day", "Period"]).to_numpy(float)
        if per_hr > 1:
            vals = vals.reshape(-1, per_hr, vals.shape[1]).mean(axis=1)
        return vals, df

    da_load, _ = hourly(da_load_df)
    rt_load, _ = hourly(rt_load_raw)
    da_ren, _ = hourly(da_ren_df)
    rt_ren, _ = hourly(rt_ren_raw)
    da_ren_cols = [
        c for c in da_ren_df.columns if c not in ("Year", "Month", "Day", "Period")
    ]

    # area load -> bus loads by the bus.csv MW Load participation
    area_of_bus = bus_df["Area"].to_numpy()
    bus_mw = bus_df["MW Load"].to_numpy(float)
    load_cols = [
        c for c in da_load_df.columns if c not in ("Year", "Month", "Day", "Period")
    ]
    n_hours = min(len(da_load), len(rt_load))
    load_da = np.zeros((n_hours, n_bus))
    load_rt = np.zeros((n_hours, n_bus))
    for ai, area in enumerate(load_cols):
        sel = area_of_bus == int(area)
        w = np.where(sel, bus_mw, 0.0)
        w = w / max(w.sum(), 1e-12)
        load_da += np.outer(da_load[:n_hours, ai], w)
        load_rt += np.outer(rt_load[:n_hours, ai], w)

    # --- generators ----------------------------------------------
    thermals, renewables = [], []
    init_df = None
    p_init = data_path / "initial_status.csv"
    if p_init.exists():
        init_df = pd.read_csv(p_init)
    for _, row in gen_df.iterrows():
        name = str(row["GEN UID"])
        bus = str(row["Bus ID"])
        if name in da_ren_cols:
            gi = da_ren_cols.index(name)
            renewables.append(
                RenewableUnit(
                    name=name,
                    bus=bus,
                    da_cap=da_ren[:n_hours, gi],
                    rt_cap=rt_ren[:n_hours, gi],
                    curtailable="HYDRO" not in name and "RTPV" not in name,
                )
            )
            continue
        if float(row["PMax MW"]) <= 0:
            continue
        noload, seg_mw, seg_cost = _hr_to_cost(row)
        start_heat = row.get("Start Heat Hot MBTU", 0)
        start_heat = float(start_heat) if not pd.isna(start_heat) else 0.0
        fuel = float(row.get("Fuel Price $/MMBTU", 0) or 0)
        startup = start_heat * fuel + float(
            row.get("Non Fuel Start Cost $", 0) or 0
        )
        on0, p0 = True, float(row["PMin MW"])
        if init_df is not None and name in init_df.columns:
            hours0 = float(init_df[name].iloc[0])
            on0 = hours0 > 0
            p0 = float(init_df[name].iloc[1]) if len(init_df) > 1 else p0
        thermals.append(
            ThermalUnit(
                name=name,
                bus=bus,
                pmin=float(row["PMin MW"]),
                pmax=float(row["PMax MW"]),
                ramp_hr=float(row.get("Ramp Rate MW/Min", 1e3) or 1e3) * 60.0,
                min_up=float(row.get("Min Up Time Hr", 0) or 0),
                min_down=float(row.get("Min Down Time Hr", 0) or 0),
                startup_cost=startup,
                noload_cost=noload,
                seg_mw=seg_mw,
                seg_cost=seg_cost,
                initial_on=on0,
                initial_p=p0,
            )
        )

    ts0 = pd.Timestamp(
        f"{int(da_load_df.Year.iloc[0])}-{int(da_load_df.Month.iloc[0]):02d}-"
        f"{int(da_load_df.Day.iloc[0]):02d}"
    )
    return MarketCase(
        buses=buses,
        thermals=thermals,
        renewables=renewables,
        load_da=load_da,
        load_rt=load_rt,
        ptdf=ptdf,
        line_limits=line_limits,
        line_names=line_names,
        start_timestamp=ts0,
    )


# ---------------------------------------------------------------------
# host-side unit commitment (the CPU MILP fallback hook)
# ---------------------------------------------------------------------


def solve_unit_commitment(
    case: MarketCase,
    hours: np.ndarray,
    reserve_factor: float = 0.0,
    use_milp: bool = True,
    initial_state: "Optional[Dict[str, np.ndarray]]" = None,
) -> np.ndarray:
    """Commitment schedule u (H, n_thermal) for the RUC horizon.

    Exact MILP via scipy/HiGHS branch-and-cut when ``use_milp`` (the
    host-side co-processing path); otherwise LP relaxation + rounding
    with a capacity-feasibility repair (the solver-free fallback).

    ``initial_state`` carries cross-day commitment continuity (the role
    of Prescient's unit ``initial_status``, reference
    ``run_double_loop.py:309-332`` rolling-horizon options): ``{"on":
    (G,) bool, "hours": (G,) int}`` where ``hours`` counts how long each
    unit has been in its current on/off state.  Units still inside
    their min-up (min-down) window are forced on (off) for the
    remainder of it, and hour-0 startup costs are charged against the
    carried state."""
    from scipy.optimize import Bounds, LinearConstraint, linprog, milp
    from scipy.sparse import lil_matrix

    H = len(hours)
    th = case.thermals
    G = len(th)
    load = case.load_da[hours].sum(axis=1)  # (H,) system load
    ren_cap = sum(
        (r.da_cap[hours] for r in case.renewables), np.zeros(H)
    )
    net_load = np.maximum(load - ren_cap, 0.0)
    reserve = reserve_factor * load

    # variables: u[g,h], s[g,h] (startup), p_extra[g,h] (above pmin,
    # aggregated single segment at mean marginal cost for commitment
    # purposes; the pricing/SCED run uses the full segment model)
    nv = 3 * G * H
    iu = lambda g, h: g * H + h  # noqa: E731
    is_ = lambda g, h: G * H + g * H + h  # noqa: E731
    ip = lambda g, h: 2 * G * H + g * H + h  # noqa: E731

    c = np.zeros(nv)
    for g, t in enumerate(th):
        mean_mc = (
            float(np.sum(t.seg_mw * t.seg_cost) / max(np.sum(t.seg_mw), 1e-9))
            if np.sum(t.seg_mw) > 0
            else 0.0
        )
        for h in range(H):
            c[iu(g, h)] = t.noload_cost
            c[is_(g, h)] = t.startup_cost
            c[ip(g, h)] = mean_mc

    A = lil_matrix((0, nv))
    rows_lb, rows_ub = [], []

    def add_row(coefs, lb, ub):
        nonlocal A
        r = A.shape[0]
        A.resize((r + 1, nv))
        for j, v in coefs:
            A[r, j] = v
        rows_lb.append(lb)
        rows_ub.append(ub)

    for h in range(H):
        # demand: sum(u*pmin + p_extra) >= net_load[h]
        coefs = []
        for g, t in enumerate(th):
            coefs.append((iu(g, h), t.pmin))
            coefs.append((ip(g, h), 1.0))
        add_row(coefs, net_load[h], np.inf)
        # capacity + reserve: sum(u*pmax) >= net_load + reserve
        add_row(
            [(iu(g, h), th[g].pmax) for g in range(G)],
            net_load[h] + reserve[h],
            np.inf,
        )
    for g, t in enumerate(th):
        span = max(np.sum(t.seg_mw), t.pmax - t.pmin)
        on0 = t.initial_on
        if initial_state is not None:
            on0 = bool(initial_state["on"][g])
        for h in range(H):
            # p_extra <= (pmax-pmin) * u
            add_row([(ip(g, h), 1.0), (iu(g, h), -span)], -np.inf, 0.0)
            # startup definition: s[h] >= u[h] - u[h-1]
            if h == 0:
                add_row(
                    [(is_(g, h), 1.0), (iu(g, h), -1.0)],
                    -1.0 if on0 else 0.0,
                    np.inf,
                )
            else:
                add_row(
                    [(is_(g, h), 1.0), (iu(g, h), -1.0), (iu(g, h - 1), 1.0)],
                    0.0,
                    np.inf,
                )
        # min up/down (aggregated window form)
        mu_h = int(round(t.min_up))
        md_h = int(round(t.min_down))
        # hour-0 transitions against the carried state: a startup
        # (shutdown) at h=0 pins the following min-up (min-down) window
        for tau in range(1, min(mu_h, H)):
            if not on0:  # startup at 0 => stay on through the window
                add_row([(iu(g, 0), -1.0), (iu(g, tau), 1.0)], 0.0, np.inf)
        for tau in range(1, min(md_h, H)):
            if on0:  # shutdown at 0 => stay off through the window
                add_row([(iu(g, 0), 1.0), (iu(g, tau), -1.0)], 0.0, np.inf)
        for h in range(1, H):
            for tau in range(h + 1, min(h + mu_h, H)):
                # u[h] - u[h-1] <= u[tau]
                add_row(
                    [(iu(g, h), -1.0), (iu(g, h - 1), 1.0), (iu(g, tau), 1.0)],
                    0.0,
                    np.inf,
                )
            for tau in range(h + 1, min(h + md_h, H)):
                # u[h-1] - u[h] <= 1 - u[tau]
                add_row(
                    [(iu(g, h), 1.0), (iu(g, h - 1), -1.0), (iu(g, tau), -1.0)],
                    -1.0,
                    np.inf,
                )

    A = A.tocsr()
    lb = np.zeros(nv)
    ub = np.concatenate(
        [np.ones(2 * G * H), np.full(G * H, np.inf)]
    )
    if initial_state is not None:
        # units still inside their min-up/min-down window at the day
        # boundary are pinned for the remainder of it
        for g, t in enumerate(th):
            k = int(initial_state["hours"][g])
            if bool(initial_state["on"][g]):
                need = min(int(round(t.min_up)) - k, H)
                for h in range(max(need, 0)):
                    lb[iu(g, h)] = 1.0
            else:
                need = min(int(round(t.min_down)) - k, H)
                for h in range(max(need, 0)):
                    ub[iu(g, h)] = 0.0
    con = LinearConstraint(A, np.asarray(rows_lb), np.asarray(rows_ub))

    if use_milp:
        integrality = np.concatenate(
            [np.ones(G * H), np.zeros(2 * G * H)]
        )
        res = milp(
            c,
            constraints=con,
            bounds=Bounds(lb, ub),
            integrality=integrality,
            options={"time_limit": 60.0},
        )
        if res.status == 0:
            u = res.x[: G * H].reshape(G, H).T  # (H, G)
            return np.round(u)

    # LP relaxation + rounding fallback
    res = linprog(
        c,
        A_ub=np.vstack([-A.toarray(), A.toarray()]),
        b_ub=np.concatenate(
            [-np.asarray(rows_lb), np.asarray(rows_ub)]
        ).clip(-1e12, 1e12),
        bounds=list(zip(lb, ub)),
        method="highs",
    )
    if res.x is None:
        raise RuntimeError(
            "unit commitment infeasible: LP relaxation has no solution "
            f"(status {res.status}: {res.message})"
        )
    u = res.x[: G * H].reshape(G, H).T
    u = (u >= 0.5).astype(float)
    # feasibility repair: commit cheapest-capacity units until pmax
    # covers net load + reserve — but never a unit pinned OFF by its
    # carried min-down window (ub[iu(g,h)] == 0 from initial_state)
    for h in range(H):
        need = net_load[h] + reserve[h]
        cap = float(np.sum(u[h] * [t.pmax for t in th]))
        order = np.argsort([t.noload_cost / max(t.pmax, 1) for t in th])
        for g in order:
            if cap >= need:
                break
            if u[h, g] == 0 and ub[iu(g, h)] > 0.5:
                u[h, g] = 1.0
                cap += th[g].pmax
    return u


# ---------------------------------------------------------------------
# dispatch LP (pricing / SCED) on the IPM — LMPs from the duals
# ---------------------------------------------------------------------

N_PSEG = 4  # participant bid curves are padded to this many segments
SHED_COST = 2000.0  # $/MWh load shedding (keeps every LP feasible)
_VAR_SCALE = 10.0  # every dispatch variable's scale (MW / 10)


class _FS:
    """Minimal fs surface for solver-side introspection."""

    def __init__(self, horizon):
        self.horizon = horizon


class _MarketNLP:
    """The economic-dispatch LP over a fixed horizon H, with the
    ``CompiledNLP`` surface the IPM consumes.

    Variables (each (H,), scale 10, lb 0, in this order — the JAX
    package's flowsheet order): ``p_{g}_{k}`` thermal above-min segments,
    ``ren_{r}`` renewable output, ``pp_{k}`` participant segments,
    ``shed``, ``overgen``.  Rows: ``balance`` (eq, H); ineq ``seglim_{g}_
    {k}``, ``renlim_{r}``, ``pplim_{k}`` (H each), ``line_fwd`` and
    ``line_bwd`` (time-last, n_line blocks of H).

    Params (float64, time last): ``load``/``pmin_inj`` (H, nb),
    ``segcap`` (3G, H), ``rencap`` (R, H), ``ppcap``/``ppcost``
    (N_PSEG, H) — one leaf per block where the JAX package keeps one per
    unit."""

    #: objective and constraints are affine in x: the Lagrangian's
    #: Hessian is exactly zero (read by the dense IPM path)
    affine = True
    sense = "min"

    def __init__(self, case, th, rn, horizon, participant, participant_bus):
        H = self.H = int(horizon)
        G, R, nb = len(th), len(rn), len(case.buses)
        self.G, self.R, self.nb = G, R, nb
        self.n_pp = N_PSEG if participant is not None else 0
        self.fs = _FS(H)
        bus_pos = {b: i for i, b in enumerate(case.buses)}

        names = [f"p_{g}_{k}" for g in range(G) for k in range(N_SEG)]
        names += [f"ren_{r}" for r in range(R)]
        names += [f"pp_{k}" for k in range(self.n_pp)]
        names += ["shed", "overgen"]
        self.free_names: List[str] = names
        self.fixed_names: List[str] = []
        self._slices = {nm: (i * H, (i + 1) * H, (H,)) for i, nm in enumerate(names)}
        self.n = len(names) * H
        self.var_scale = np.full(self.n, _VAR_SCALE)
        self.x0 = np.zeros(self.n)
        self.lb = np.zeros(self.n)
        self.ub = np.full(self.n, np.inf)

        self.eq_slices = {"balance": (0, H)}
        self.m_eq = H
        self.ineq_slices = {}
        o = 0
        rows = ([f"seglim_{g}_{k}" for g in range(G) for k in range(N_SEG)]
                + [f"renlim_{r}" for r in range(R)]
                + [f"pplim_{k}" for k in range(self.n_pp)])
        for nm in rows:
            self.ineq_slices[nm] = (o, o + H)
            o += H
        n_line = case.ptdf.shape[0]
        for nm in ("line_fwd", "line_bwd"):
            self.ineq_slices[nm] = (o, o + n_line * H)
            o += n_line * H
        self.m_ineq = o

        gen_bus = np.zeros((G, nb))
        for g, t in enumerate(th):
            gen_bus[g, bus_pos[t.bus]] = 1.0
        ren_bus = np.zeros((R, nb))
        for r_i, r in enumerate(rn):
            ren_bus[r_i, bus_pos[r.bus]] = 1.0
        pp_bus = np.zeros(nb)
        if participant is not None and participant_bus is not None:
            pp_bus[bus_pos[participant_bus]] = 1.0
        seg_cost = np.array([[t.seg_cost[k] for k in range(N_SEG)] for t in th])
        self._host_consts = {
            "ptdf_t": np.array(np.asarray(case.ptdf, float).T, order="C"),
            "lim": np.array(case.line_limits, float),
            "gen_bus": gen_bus, "ren_bus": ren_bus, "pp_bus": pp_bus,
            "seg_cost": seg_cost.reshape(G * N_SEG, 1) if G else np.zeros((0, 1)),
        }
        self._on: Dict = {}

    # -- params / layout ------------------------------------------------

    def default_params(self):
        H, nb = self.H, self.nb
        return {"p": {
            "load": np.zeros((H, nb)), "pmin_inj": np.zeros((H, nb)),
            "segcap": np.zeros((self.G * N_SEG, H)),
            "rencap": np.zeros((self.R, H)),
            "ppcap": np.zeros((self.n_pp, H)), "ppcost": np.zeros((self.n_pp, H)),
        }, "fixed": {}}

    def _consts(self, device):
        c = self._on.get(device)
        if c is None:
            c = {k: torch.as_tensor(v, dtype=torch.float64, device=device)
                 for k, v in self._host_consts.items()}
            self._on[device] = c
        return c

    def _blocks(self, x, params):
        """Physical variable blocks and params on ``x``'s device."""
        H, G, R = self.H, self.G, self.R
        V = (x * _VAR_SCALE).reshape(-1, H)
        ns = G * N_SEG
        p = {k: _leaf(v, x.device) for k, v in params["p"].items()}
        return (V[:ns], V[ns:ns + R], V[ns + R:ns + R + self.n_pp],
                V[-2], V[-1], p, self._consts(x.device))

    # -- the lowered callables ----------------------------------------

    def objective(self, x, params):
        P, _, PP, shed, over, p, c = self._blocks(x, params)
        cost = SHED_COST * torch.sum(shed + over) + torch.sum(c["seg_cost"] * P)
        if self.n_pp:
            cost = cost + torch.sum(p["ppcost"] * PP)
        return cost

    def user_objective(self, x, params):
        return self.objective(x, params)

    def eq(self, x, params):
        P, Rn, PP, shed, over, p, _ = self._blocks(x, params)
        # system balance: generation + committed pmin = system load
        tot = shed - over + P.sum(0) + Rn.sum(0) + PP.sum(0)
        return tot + p["pmin_inj"].sum(1) - p["load"].sum(1)

    def ineq(self, x, params):
        P, Rn, PP, _, _, p, c = self._blocks(x, params)
        H, G = self.H, self.G
        parts = [(P - p["segcap"]).reshape(-1), (Rn - p["rencap"]).reshape(-1)]
        if self.n_pp:
            parts.append((PP - p["ppcap"]).reshape(-1))
        # net bus injections (H, nb), then line flows via the PTDF
        inj = p["pmin_inj"] - p["load"]
        if G:
            inj = inj + P.reshape(G, N_SEG, H).sum(1).T @ c["gen_bus"]
        if self.R:
            inj = inj + Rn.T @ c["ren_bus"]
        if self.n_pp:
            inj = inj + PP.sum(0)[:, None] * c["pp_bus"][None, :]
        flows = inj @ c["ptdf_t"]  # (H, n_line)
        lim = c["lim"][None, :]
        # (H, n_line) residual blocks ravel time-LAST
        parts.append((flows - lim).T.reshape(-1))
        parts.append((-flows - lim).T.reshape(-1))
        return torch.cat(parts)

    def unravel(self, x):
        x = torch.as_tensor(x).detach().cpu().numpy()
        return {nm: (x[a:b] * self.var_scale[a:b]).reshape(shape)
                for nm, (a, b, shape) in self._slices.items()}


class _DispatchLP:
    """One economic-dispatch LP over a fixed horizon, solved on the IPM.

    Params per solve: bus loads, committed pmin injections, per-segment
    thermal capacities (seg width x commitment), renewable caps,
    participant bid segments (caps + marginal costs).  Variables: thermal
    above-min segments, renewable output, participant segments, load
    shedding, overgeneration.  ``device``: where the IPM runs."""

    def __init__(self, case: MarketCase, horizon: int,
                 participant_name: Optional[str] = None,
                 participant_bus: Optional[str] = None, device=None):
        self.case = case
        self.H = horizon
        th = [t for t in case.thermals if t.name != participant_name]
        rn = [r for r in case.renewables if r.name != participant_name]
        self.th, self.rn = th, rn
        self.participant = participant_name
        self.nlp = _MarketNLP(case, th, rn, horizon, participant_name,
                              participant_bus)
        # autoscale off: clean duals (LMPs read directly off lam)
        self._solve = CountedProgram(
            make_ipm_solver(
                self.nlp,
                IPMOptions(max_iter=200, autoscale=False, kkt="dense"),
                device=resolve_device(device),
            ),
            label=f"market.sced[h={self.H}]",
        )

    def solve(self, params):
        res = self._solve(params)
        sol = self.nlp.unravel(res.x)
        H = self.H
        lam = res.lam.detach().cpu().numpy()
        a, b = self.nlp.eq_slices["balance"]
        lmp_sys = -lam[a:b]  # $/MWh (sign verified vs marginal cost)
        # congestion components from the line duals; (H, n_line)
        # residual blocks ravel time-LAST -> stored as (n_line, H)
        af, bf = self.nlp.ineq_slices["line_fwd"]
        ab_, bb_ = self.nlp.ineq_slices["line_bwd"]
        n_line = self.case.ptdf.shape[0]
        mu_fwd = lam[self.nlp.m_eq + af: self.nlp.m_eq + bf].reshape(
            n_line, H
        ).T
        mu_bwd = lam[self.nlp.m_eq + ab_: self.nlp.m_eq + bb_].reshape(
            n_line, H
        ).T
        lmp = lmp_sys[:, None] - (mu_fwd - mu_bwd) @ self.case.ptdf
        return res, sol, lmp

    # -- param assembly -------------------------------------------

    def params_for(self, hours: np.ndarray, u: np.ndarray, rt: bool,
                   participant_bids=None, prev_p=None):
        """u: (H, n_thermal_committed) commitment aligned with self.th."""
        case = self.case
        nb = len(case.buses)
        H = self.H
        bus_pos = {b: i for i, b in enumerate(case.buses)}
        p = self.nlp.default_params()
        load = case.load_rt if rt else case.load_da
        p["p"]["load"] = load[hours]
        pmin_inj = np.zeros((H, nb))
        segcap = p["p"]["segcap"]
        for g, t in enumerate(self.th):
            pmin_inj[:, bus_pos[t.bus]] += t.pmin * u[:, g]
            for k in range(N_SEG):
                segcap[g * N_SEG + k] = t.seg_mw[k] * u[:, g]
        p["p"]["pmin_inj"] = pmin_inj
        for r_i, r in enumerate(self.rn):
            p["p"]["rencap"][r_i] = (r.rt_cap if rt else r.da_cap)[hours]
        if self.participant is not None:
            caps, costs = _bids_to_segments(participant_bids, H)
            p["p"]["ppcap"] = np.ascontiguousarray(caps.T)
            p["p"]["ppcost"] = np.ascontiguousarray(costs.T)
        return p


def _bids_to_segments(bids, H):
    """Convert per-hour bid dicts ({t: {gen: {"p_cost": [(p,c)...]}}} or
    {t: {gen: {"p_max": MW}}}) into (H, N_PSEG) caps + marginal costs."""
    caps = np.zeros((H, N_PSEG))
    costs = np.zeros((H, N_PSEG))
    if bids is None:
        return caps, costs
    for t in range(H):
        info = bids.get(t)
        if info is None:
            continue
        gen_bid = next(iter(info.values()))
        if "p_cost" in gen_bid:
            curve = gen_bid["p_cost"]
            p_prev, c_prev = curve[0]
            for k, (pk, ck) in enumerate(curve[1:]):
                width = pk - p_prev
                mc = (ck - c_prev) / max(width, 1e-9)
                slot = min(k, N_PSEG - 1)
                if k < N_PSEG:
                    caps[t, slot] = width
                    costs[t, slot] = mc
                else:
                    # more breakpoints than market segments: lump the
                    # remaining capacity into the last slot at the
                    # highest (conservative) marginal cost, so the full
                    # offered capacity stays clearable
                    caps[t, slot] += width
                    costs[t, slot] = max(costs[t, slot], mc)
                p_prev, c_prev = pk, ck
        else:
            caps[t, 0] = gen_bid.get("p_max", 0.0)
            costs[t, 0] = 0.0
    return caps, costs


# ---------------------------------------------------------------------
# the co-simulation loop
# ---------------------------------------------------------------------


class MarketSimulator:
    """Daily RUC / hourly SCED cadence with two-settlement accounting
    and Prescient-schema output CSVs.  ``device``: where the dispatch
    LPs solve (``cuda`` unless given)."""

    def __init__(
        self,
        case: MarketCase,
        output_dir,
        sced_horizon: Optional[int] = None,
        ruc_horizon: Optional[int] = None,
        reserve_factor: Optional[float] = None,
        use_milp: Optional[bool] = None,
        coordinator=None,
        options: Optional[MarketOptions] = None,
        device=None,
    ):
        # None = not passed, so an explicit kwarg equal to a config
        # default is still detectable against options=
        passed = {
            k: v for k, v in {
                "sced_horizon": sced_horizon,
                "ruc_horizon": ruc_horizon,
                "reserve_factor": reserve_factor,
                "use_milp": use_milp,
            }.items() if v is not None
        }
        if options is None:
            # kwargs route through the same validated config tier
            options = MarketOptions(**passed)
        else:
            conflicts = [k for k, v in passed.items()
                         if v != getattr(options, k)]
            if conflicts:
                raise ValueError(
                    f"conflicting MarketSimulator arguments: {conflicts} "
                    "passed both as kwargs and via options="
                )
        self.options = options
        self.case = case
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.sced_horizon = options.sced_horizon
        self.ruc_horizon = options.ruc_horizon
        self.reserve_factor = options.reserve_factor
        self.use_milp = options.use_milp
        self.coordinator = coordinator
        pname = pbus = None
        if coordinator is not None:
            pname = coordinator.generator_name
            pbus = coordinator.generator_bus(case)
            self._apply_participant_params(coordinator)
        self.device = resolve_device(device)
        self._da_lp = _DispatchLP(case, self.ruc_horizon, pname, pbus,
                                  device=self.device)
        self._rt_lp = _DispatchLP(case, self.sced_horizon, pname, pbus,
                                  device=self.device)
        self._pname = pname

    def _apply_participant_params(self, coordinator) -> None:
        """Push the participant's static model_data into the market's
        generator record (the reference coordinator's extra RUC/SCED
        plugin callbacks, ``workflow/coordinator.py:29-44`` — there they
        rewrite Prescient instance dicts; here they overlay the
        matching ThermalUnit in the case before the LPs are built)."""
        gen_dict: Dict = {}
        coordinator.update_static_params(gen_dict)
        name = coordinator.generator_name
        for t in self.case.thermals:
            if t.name != name:
                continue
            if "p_min" in gen_dict:
                t.pmin = float(gen_dict["p_min"])
            if "p_max" in gen_dict:
                t.pmax = float(gen_dict["p_max"])
            if "ramp_up_60min" in gen_dict:
                t.ramp_hr = float(gen_dict["ramp_up_60min"])
            if "min_up_time" in gen_dict:
                t.min_up = float(gen_dict["min_up_time"])
            if "min_down_time" in gen_dict:
                t.min_down = float(gen_dict["min_down_time"])
            curve = gen_dict.get("p_cost")
            # renewable participants carry a scalar p_cost; only a
            # thermal piecewise dict contributes bid segments
            if isinstance(curve, dict) and curve.get("values"):
                pts = np.asarray(curve["values"], dtype=float)  # (k, 2)
                if len(pts) >= 2:
                    widths = np.diff(pts[:, 0])
                    marg = np.diff(pts[:, 1]) / np.maximum(widths, 1e-9)
                    k = min(N_SEG, len(widths))
                    t.seg_mw = np.concatenate(
                        [widths[:k], np.zeros(N_SEG - k)]
                    )
                    t.seg_cost = np.concatenate(
                        [marg[:k], np.full(N_SEG - k, marg[k - 1])]
                    )
                    t.noload_cost = float(pts[0, 1])

    def simulate(self, start_date: str, num_days: int,
                 da_bid_window: int = 1, mesh=None):
        """Run the two-settlement co-simulation.

        ``da_bid_window > 1`` turns on day-parallel DA bidding: at each
        window boundary the participant's bid programs for the next
        ``da_bid_window`` days are solved as ONE batched IPM call (the
        day is its lane axis), while tracking/settlement and
        realized-state re-sync stay sequential.  Day-parallel bids match
        the sequential loop's whenever the within-window feedback is
        state-neutral (static forecaster pools and day-boundary-neutral
        realized state).  ``mesh`` splits each window's day axis over a
        device mesh (``compute_day_ahead_bids_batch``).
        """
        case = self.case
        start = pd.Timestamp(start_date)
        hour0 = int((start - case.start_timestamp).total_seconds() // 3600)
        if hour0 < 0 or hour0 + num_days * 24 > case.n_hours:
            raise ValueError(
                f"simulation window [{start_date}, +{num_days}d] outside "
                f"the dataset's {case.n_hours} hours"
            )

        th_names = [t.name for t in self._da_lp.th]
        rn_names = [r.name for r in self._da_lp.rn]
        summary_rows, bus_rows, th_rows, rn_rows = [], [], [], []
        total_cost = 0.0
        uc_case = _case_for_uc(case, self._pname)
        # cross-day commitment state (Prescient's rolling initial_status;
        # the 48-h RUC lookahead re-optimizes day d+1 but the implemented
        # day-d tail still binds min-up/min-down continuity)
        uc_state = {
            "on": np.array([t.initial_on for t in uc_case.thermals]),
            "hours": np.array(
                [max(int(round(t.min_up)), 1) if t.initial_on
                 else max(int(round(t.min_down)), 1)
                 for t in uc_case.thermals]),
        }

        for day in range(num_days):
            d0 = hour0 + day * 24
            # fixed-shape RUC window: near the dataset end the lookahead
            # hours clamp to the final hour (the compiled DA LP has a
            # static horizon of ruc_horizon)
            H = self.ruc_horizon
            hours = np.clip(np.arange(d0, d0 + H), 0, case.n_hours - 1)
            date = (start + pd.Timedelta(days=day)).strftime("%Y-%m-%d")

            da_bids = None
            if self.coordinator is not None:
                if da_bid_window > 1 and day % da_bid_window == 0:
                    window = [
                        (start + pd.Timedelta(days=day + k)).strftime(
                            "%Y-%m-%d")
                        for k in range(min(da_bid_window, num_days - day))
                    ]
                    self.coordinator.prefetch_da_bids(window, mesh=mesh)
                da_bids = self.coordinator.request_da_bids(date)

            # RUC cycle: unit commitment + the day-ahead pricing LP
            # (the LP solve syncs to host for LMP math, so the span's
            # wall-clock covers device completion)
            with obs_trace.span("market.ruc", date=date):
                u = solve_unit_commitment(
                    uc_case,
                    hours,
                    reserve_factor=self.reserve_factor,
                    use_milp=self.use_milp,
                    initial_state=uc_state,
                )
                # advance the carried state over the implemented day
                n_impl = min(24, H)
                new_on = uc_state["on"].copy()
                new_hours = uc_state["hours"].copy()
                for g in range(u.shape[1]):
                    col = u[:n_impl, g] > 0.5
                    run = 1
                    while run < n_impl and col[n_impl - 1 - run] == col[-1]:
                        run += 1
                    if (run == n_impl
                            and bool(col[-1]) == bool(uc_state["on"][g])):
                        run += int(uc_state["hours"][g])  # spans the day
                    new_on[g] = bool(col[-1])
                    new_hours[g] = run
                uc_state = {"on": new_on, "hours": new_hours}
                params = self._da_lp.params_for(
                    hours, u, rt=False, participant_bids=da_bids
                )
                res, sol, da_lmp = self._da_lp.solve(params)
                da_dispatch = self._collect_dispatch(self._da_lp, sol, u)

                if self.coordinator is not None:
                    pp_da = self._participant_power(self._da_lp, sol)
                    self.coordinator.push_da_results(
                        date, da_lmp, pp_da,
                        {b: da_lmp[:24, i] for i, b in enumerate(case.buses)},
                    )

            # ---- hourly SCED over the settlement day (bounded by the
            # RUC horizon when ruc_horizon < 24) -------------------
            for hr in range(min(24, H)):
                h_abs = d0 + hr
                Hs = self.sced_horizon
                sced_hours = np.clip(
                    np.arange(h_abs, h_abs + Hs), 0, case.n_hours - 1
                )
                # SCED cycle: bid refresh + the real-time pricing LP
                with obs_trace.span("market.sced", date=date, hour=hr):
                    rt_bids = None
                    if self.coordinator is not None:
                        rt_bids = self.coordinator.request_rt_bids(
                            date, hr, da_lmp
                        )
                    u_h = u[np.clip(np.arange(hr, hr + Hs), 0, H - 1)]
                    p_rt = self._rt_lp.params_for(
                        sced_hours, u_h, rt=True, participant_bids=rt_bids
                    )
                    res_rt, sol_rt, rt_lmp = self._rt_lp.solve(p_rt)

                    # settlement + logs for the implemented hour (index 0)
                    sys_load = float(case.load_rt[h_abs].sum())
                    shed = float(sol_rt["shed"][0])
                    total_cost += float(res_rt.obj) / Hs
                    pp_rt = 0.0
                    if self.coordinator is not None:
                        pp_rt = float(
                            self._participant_power(self._rt_lp, sol_rt)[0]
                        )
                        self.coordinator.push_rt_dispatch(
                            date, hr, pp_rt,
                            {b: rt_lmp[0, i]
                             for i, b in enumerate(case.buses)},
                        )
                summary_rows.append(
                    {
                        "Date": date,
                        "Hour": hr,
                        "TotalCosts": round(float(res_rt.obj) / Hs, 2),
                        "Demand": round(sys_load, 2),
                        "Shortfall": round(shed, 2),
                        "Overgeneration": 0.0,
                        "RenewablesUsed": round(
                            sum(
                                float(sol_rt[f"ren_{i}"][0])
                                for i in range(len(rn_names))
                            ),
                            2,
                        ),
                        "RenewablesCurtailment": round(
                            sum(
                                max(
                                    float(r.rt_cap[h_abs])
                                    - float(sol_rt[f"ren_{i}"][0]),
                                    0.0,
                                )
                                for i, r in enumerate(self._rt_lp.rn)
                            ),
                            2,
                        ),
                    }
                )
                for i, b in enumerate(case.buses):
                    bus_rows.append(
                        {
                            "Date": date,
                            "Hour": hr,
                            "Minute": 0,
                            "Bus": b,
                            "LMP": round(float(rt_lmp[0, i]), 4),
                            "LMP DA": round(float(da_lmp[hr, i]), 4),
                            "Demand": round(float(case.load_rt[h_abs, i]), 2),
                            "Shortfall": round(shed, 2),
                            "Overgeneration": 0.0,
                        }
                    )
                for g, t in enumerate(self._rt_lp.th):
                    pg = t.pmin * u_h[0, g] + sum(
                        float(sol_rt[f"p_{g}_{k}"][0]) for k in range(N_SEG)
                    )
                    pg_da = t.pmin * u[hr, g] + sum(
                        float(sol[f"p_{g}_{k}"][hr]) for k in range(N_SEG)
                    )
                    th_rows.append(
                        {
                            "Date": date,
                            "Hour": hr,
                            "Minute": 0,
                            "Generator": t.name,
                            "Dispatch": round(pg, 2),
                            "Dispatch DA": round(pg_da, 2),
                            "Unit State": "On" if u_h[0, g] else "Off",
                        }
                    )
                for r_i, r in enumerate(self._rt_lp.rn):
                    out = float(sol_rt[f"ren_{r_i}"][0])
                    rn_rows.append(
                        {
                            "Date": date,
                            "Hour": hr,
                            "Minute": 0,
                            "Generator": r.name,
                            "Output": round(out, 2),
                            "Output DA": round(float(sol[f"ren_{r_i}"][hr]), 2),
                            "Curtailment": round(
                                max(float(r.rt_cap[h_abs]) - out, 0.0), 2
                            ),
                        }
                    )
                if self._pname is not None:
                    th_rows.append(
                        {
                            "Date": date,
                            "Hour": hr,
                            "Minute": 0,
                            "Generator": self._pname,
                            "Dispatch": round(pp_rt, 2),
                            "Dispatch DA": round(float(pp_da[hr]), 2),
                            "Unit State": "On",
                        }
                    )

        pd.DataFrame(summary_rows).to_csv(
            self.output_dir / "hourly_summary.csv", index=False
        )
        pd.DataFrame(bus_rows).to_csv(
            self.output_dir / "bus_detail.csv", index=False
        )
        pd.DataFrame(th_rows).to_csv(
            self.output_dir / "thermal_detail.csv", index=False
        )
        pd.DataFrame(rn_rows).to_csv(
            self.output_dir / "renewables_detail.csv", index=False
        )
        pd.DataFrame(
            [{"TotalCosts": round(total_cost, 2), "Days": num_days}]
        ).to_csv(self.output_dir / "overall_simulation_output.csv", index=False)
        if self.coordinator is not None:
            self.coordinator.write_results(self.output_dir)
        return {
            "total_cost": total_cost,
            "output_dir": self.output_dir,
        }

    # -- helpers ------------------------------------------------------

    @staticmethod
    def _collect_dispatch(lp, sol, u):
        out = {}
        for g, t in enumerate(lp.th):
            out[t.name] = t.pmin * u[: lp.H, g] + sum(
                np.asarray(sol[f"p_{g}_{k}"]) for k in range(N_SEG)
            )
        return out

    @staticmethod
    def _participant_power(lp, sol):
        return sum(np.asarray(sol[f"pp_{k}"]) for k in range(N_PSEG))


def _case_for_uc(case: MarketCase, participant_name):
    """UC sees the market case without the participant's own unit (the
    participant enters through its bids in the pricing/SCED runs)."""
    if participant_name is None:
        return case
    return MarketCase(
        buses=case.buses,
        thermals=[t for t in case.thermals if t.name != participant_name],
        renewables=[r for r in case.renewables if r.name != participant_name],
        load_da=case.load_da,
        load_rt=case.load_rt,
        ptdf=case.ptdf,
        line_limits=case.line_limits,
        line_names=case.line_names,
        start_timestamp=case.start_timestamp,
    )
