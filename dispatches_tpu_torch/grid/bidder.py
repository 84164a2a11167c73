"""Bidder / SelfScheduler: two-stage stochastic bid optimization
(counterpart of ``dispatches_tpu/grid/bidder.py``).

Optimize the operation model against forecast price scenarios and emit
either a self-schedule (per-hour p_max energies) or thermal-style convex
bid curves (per-hour (power, cost) pairs).

This IS the two-stage stochastic program, not a heuristic: the
scenarios are stacked into one NLP (``core/stacked.py``) with
non-anticipativity by construction — the SelfScheduler ties the
delivered profile across scenarios through a shared first-stage
schedule variable, and the Bidder enforces incentive-compatible
bid-curve consistency ((pi_s - pi_s')(P_s - P_s') >= 0) so every
scenario's dispatch lies on one monotone curve, from which the
multi-segment (power, cumulative cost) pairs are read off.  The stacked
program solves on the float64 IPM; the scenario slabs are evaluated
under ``torch.func.vmap``, and a batch of days is the IPM's lane axis.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch

from dispatches_tpu_torch import resolve_device
from dispatches_tpu_torch.analysis.runtime import CountedProgram
from dispatches_tpu_torch.core.stacked import StackedScenarioNLP
from dispatches_tpu_torch.solvers.ipm import IPMOptions, make_ipm_solver


class _BidderBase:
    def __init__(
        self,
        bidding_model_object,
        day_ahead_horizon: int,
        real_time_horizon: int,
        n_scenario: int,
        solver=None,
        forecaster=None,
        max_iter: int = 300,
        solve_service=None,
        device=None,
    ):
        #: where the bid IPMs run (``cuda`` unless given)
        self.device = resolve_device(device)
        self.bidding_model_object = bidding_model_object
        self.day_ahead_horizon = int(day_ahead_horizon)
        self.real_time_horizon = int(real_time_horizon)
        self.n_scenario = int(n_scenario)
        self.forecaster = forecaster
        self.generator = bidding_model_object.model_data.gen_name
        self.bids_result_list = []
        self._max_iter = max_iter
        #: opt-in micro-batching: when a ``dispatches_tpu_torch.serve.
        #: SolveService`` is supplied, per-scenario stacked solves route
        #: through it (bucketed on this bidder's already-built solver),
        #: so many bidders sharing one service dispatch as one batch
        self.solve_service = solve_service

        self.day_ahead_model = self._build(self.day_ahead_horizon)
        self.real_time_model = self._build(self.real_time_horizon)

    #: stacked-program coupling mode; subclasses override
    _coupling = "first_stage"

    def _build(self, horizon: int):
        blk = SimpleNamespace()
        self.bidding_model_object.populate_model(blk, horizon)
        fs = blk.m.fs
        fs.add_param("energy_price", np.zeros(horizon))

        def objective(v, p):
            revenue = torch.sum(
                p["energy_price"] * blk.power_output_expr(v, p)
            )
            cost = torch.sum(blk.total_cost_expr(v, p))
            return revenue - cost

        blk.nlp = fs.compile(objective=objective, sense="max")

        md = self.bidding_model_object.model_data
        blk.stacked = StackedScenarioNLP(
            blk.nlp,
            n_scenarios=self.n_scenario,
            scenario_param_keys=["energy_price"],
            first_stage_expr=blk.power_output_expr,
            coupling=self._coupling,
            price_key="energy_price",
            first_stage_bounds=(md.p_min, md.p_max),
            first_stage_scale=max(md.p_max, 1.0) / 2.0,
        )
        blk.solver_fn = make_ipm_solver(
            blk.stacked, IPMOptions(max_iter=self._max_iter),
            device=self.device)
        if self.solve_service is not None:
            # route through the shared micro-batching service, reusing
            # the solver built above (base_solver buckets by identity,
            # so DA/RT horizons land in separate shape buckets)
            service, stacked, solver_fn = (
                self.solve_service, blk.stacked, blk.solver_fn)

            def _service_solve(batched):
                return service.solve(
                    stacked, params=batched, solver="ipm",
                    base_solver=solver_fn)

            blk.solve = _service_solve
        else:
            blk.solve = CountedProgram(
                blk.solver_fn,
                label=f"bidder.solve[h={horizon}]",
            )
        return blk

    def _scenario_solve(self, blk, prices: np.ndarray):
        """Solve the stacked two-stage program; returns per-scenario
        coupled power profiles (n_scenario, horizon) in MW and the
        result (res.x is in the stacked space)."""
        params = blk.stacked.default_params()
        batched = {
            "p": {**params["p"], "energy_price": np.asarray(prices, float)},
            "fixed": params["fixed"],
        }
        res = blk.solve(batched)
        powers = blk.stacked.scenario_profiles(res.x, batched)
        return powers, res

    def _forecast(self, date, hour, horizon):
        bus = self.bidding_model_object.model_data.bus
        return np.asarray(
            self.forecaster.forecast_day_ahead_prices(
                date, hour, bus, horizon, self.n_scenario
            )
        )

    def compute_day_ahead_bids_batch(self, dates, mesh=None):
        """Day-parallel projection/bidding solves: the per-day two-stage
        bid programs are independent given the forecaster state, so all
        D days solve as ONE IPM call whose lane axis is the day (the
        scenario slab stays a vmap inside each lane).  The caller
        re-syncs realized state sequentially through the usual
        ``update_*_model`` hooks (windowed re-sync).  ``mesh`` splits the
        day axis over a device mesh: through an execution plan on that
        mesh, each entry solves its contiguous block of days, and the
        results are gathered in day order on the bidder's device.

        Returns ``{date: bids}`` with bids formatted exactly like
        ``compute_day_ahead_bids``."""
        blk = self.day_ahead_model
        H = self.day_ahead_horizon
        prices_days = np.stack([
            np.asarray(self._forecast(d, 0, H)) for d in dates
        ])  # (D, n_scenario, H)
        params = blk.stacked.default_params()
        # deterministic per-day param windows (e.g. the rolling CF
        # window update_model would shift to) so batched day-i bids
        # equal the sequential loop's given window-start state
        mo = self.bidding_model_object
        overrides = (mo.batch_day_params(blk, len(dates))
                     if hasattr(mo, "batch_day_params") else {})
        # map each override onto the matching param key: exact name, or
        # a dotted-qualified form of it (never a bare suffix — that
        # would capture sibling units like 'offshore_windpower.…')
        ov_keys = {
            k: ov
            for k in params["p"]
            for name, ov in overrides.items()
            if k == name or k.endswith("." + name)
        }
        # an override that matches NO stacked-param key would otherwise
        # vanish silently and every day would solve with the
        # window-start state (exactly the bug class batch_day_params
        # exists to prevent) — fail loudly instead
        matched = {
            name
            for name in overrides
            for k in params["p"]
            if k == name or k.endswith("." + name)
        }
        unmatched = sorted(set(overrides) - matched)
        if unmatched:
            raise ValueError(
                f"batch_day_params override(s) {unmatched} match no "
                "stacked param key; known keys: "
                f"{sorted(params['p'])} — the batched day solves would "
                "silently reuse the window-start state"
            )
        # one counted program per (D, override keys), as the JAX package
        # caches one compiled batch solver per key on the model block
        cache = getattr(blk, "_batch_solvers", None)
        if cache is None:
            cache = blk._batch_solvers = {}
        ck = (len(dates), tuple(sorted(ov_keys)))
        vsolve = cache.get(ck)
        if vsolve is None:
            vsolve = CountedProgram(
                blk.solver_fn, label=f"bidder.batch_solve[D={len(dates)}]")
            cache[ck] = vsolve
        # the day axis leads every batched leaf: one extra leading dim
        # over default_params() is the IPM's lane axis
        batched = {"p": {**params["p"], "energy_price": prices_days,
                         **{k: np.asarray(ov, float) for k, ov in ov_keys.items()}},
                   "fixed": params["fixed"]}
        if mesh is None:
            res = vsolve(batched)
        else:
            res = self._mesh_solve(vsolve, batched, mesh, len(dates),
                                   {"energy_price", *ov_keys})
        xs = res.x
        # every day's profiles are computed on the solve's device and come
        # to the host with the solutions in one transfer each, not one
        # sync per day
        powers = torch.stack([
            blk.stacked.scenario_profiles(
                xs[i], {"p": {**params["p"],
                              "energy_price": prices_days[i],
                              **{k: np.asarray(ov[i], float)
                                 for k, ov in ov_keys.items()}},
                        "fixed": params["fixed"]}, host=False)
            for i in range(len(dates))]).detach().cpu().numpy()
        xs = xs.detach().cpu().numpy()
        return {d: self._format_bids(blk, prices_days[i], powers[i], xs[i], H)
                for i, d in enumerate(dates)}

    def _mesh_solve(self, vsolve, batched, mesh, n_days, day_keys):
        """``vsolve(batched)`` with the day axis split over ``mesh``: the
        ``day_keys`` params carry it, every other leaf goes whole to each
        mesh entry."""
        from dispatches_tpu_torch.plan import ExecutionPlan, PlanOptions

        plan = ExecutionPlan(PlanOptions(mesh=mesh, donate=False,
                                         device=self.device))
        program = plan.program(vsolve, label=vsolve._graft_counter.label,
                               donate_argnums=())
        mask = {"p": {k: k in day_keys for k in batched["p"]},
                "fixed": {k: False for k in batched["fixed"]}}
        staged = plan.stage(batched, lanes=n_days, donate=False, batched=mask)
        return plan.collect(plan.submit(program, (staged,), n_live=n_days,
                                        lanes=n_days))

    def update_day_ahead_model(self, **profiles):
        self.bidding_model_object.update_model(self.day_ahead_model, **profiles)

    def update_real_time_model(self, **profiles):
        self.bidding_model_object.update_model(self.real_time_model, **profiles)

    def write_results(self, path):
        import pandas as pd

        if self.bids_result_list:
            pd.concat(self.bids_result_list).to_csv(path, index=False)
        else:  # header-only file keeps the log readers working
            pd.DataFrame(
                columns=["Generator", "Date", "Hour", "Market", "HorizonHour"]
            ).to_csv(path, index=False)

    def record_bids(self, bids, date, hour, market="Day-ahead"):
        import pandas as pd

        rows = [
            {"Generator": self.generator, "Date": date, "Hour": hour,
             "Market": market, "HorizonHour": t, **info}
            for t, gen_bids in bids.items()
            for info in [
                {k: v for k, v in gen_bids[self.generator].items()
                 if not isinstance(v, list)}
            ]
        ]
        self.bids_result_list.append(pd.DataFrame(rows))


class SelfScheduler(_BidderBase):
    """Self-scheduling participant: bids are per-hour scheduled energies
    (reference test :152-177: ``bids[t][gen]['p_max']``)."""

    def _format_bids(self, blk, prices, powers, x, horizon) -> Dict:
        # the shared first-stage variable IS the self-schedule: hard
        # non-anticipativity, not a mean of scenario optima
        schedule = blk.stacked.first_stage(x)
        md = self.bidding_model_object.model_data
        return {
            t: {
                self.generator: {
                    "p_min": md.p_min,
                    "p_max": float(schedule[t]),
                }
            }
            for t in range(horizon)
        }

    def compute_day_ahead_bids(self, date, hour: int = 0) -> Dict:
        prices = self._forecast(date, hour, self.day_ahead_horizon)  # $/MWh
        powers, res = self._scenario_solve(self.day_ahead_model, prices)
        return self._format_bids(self.day_ahead_model, prices, powers,
                                 res.x.detach().cpu().numpy(),
                                 self.day_ahead_horizon)

    def compute_real_time_bids(self, date, hour, realized_day_ahead_prices=None,
                               realized_day_ahead_dispatches=None) -> Dict:
        bus = self.bidding_model_object.model_data.bus
        prices = np.asarray(
            self.forecaster.forecast_real_time_prices(
                date, hour, bus, self.real_time_horizon, self.n_scenario
            )
        )
        _, res = self._scenario_solve(self.real_time_model, prices)
        schedule = self.real_time_model.stacked.first_stage(res.x)
        md = self.bidding_model_object.model_data
        return {
            t: {self.generator: {"p_min": md.p_min, "p_max": float(schedule[t])}}
            for t in range(self.real_time_horizon)
        }


class Bidder(_BidderBase):
    """Thermal-style bidder: per-hour convex multi-segment bid curves
    (reference test :218-252: ``bids[t][gen]['p_cost']`` pairs; curve
    semantics per ``coordinator.py:46-81`` /
    ``convert_marginal_costs_to_actual_costs``)."""

    _coupling = "monotone"

    def _curves(self, prices: np.ndarray, powers: np.ndarray, horizon: int):
        """Read the shared monotone bid curve off the scenario
        solutions: the incentive-compatibility coupling guarantees
        (price, power) pairs are co-monotone per hour, so sorting by
        price gives the curve's breakpoints; costs are the integral of
        the marginal prices (convex piecewise (power, total cost))."""
        md = self.bidding_model_object.model_data
        bids = {}
        for t in range(horizon):
            order = np.argsort(prices[:, t], kind="stable")
            pi = prices[order, t]
            P = np.maximum.accumulate(np.maximum(powers[order, t], 0.0))
            if P[-1] <= 1e-6 or pi[-1] <= 0:
                curve = [(md.p_min, 0.0), (md.p_max, 0.0)]
            else:
                curve = [(float(md.p_min), 0.0)]
                cost, p_prev = 0.0, float(md.p_min)
                for k in range(len(pi)):
                    pk = float(P[k])
                    # solver-noise dedup: near-identical scenario
                    # dispatches (within 1e-4 MW) collapse to one
                    # breakpoint, else sliver segments get junk slopes
                    if pk <= p_prev + 1e-4:
                        continue
                    cost += max(float(pi[k]), 0.0) * (pk - p_prev)
                    curve.append((pk, cost))
                    p_prev = pk
                if p_prev < md.p_max - 1e-9:
                    # extend to p_max at the top marginal price (the
                    # S=1 reference curve is [(p_min,0),(p_max, pi*p_max)])
                    cost += max(float(pi[-1]), 0.0) * (md.p_max - p_prev)
                    curve.append((float(md.p_max), cost))
            bids[t] = {
                self.generator: {
                    "p_min": md.p_min,
                    "p_max": md.p_max,
                    "p_cost": curve,
                    "startup_capacity": getattr(md, "startup_capacity", md.p_max),
                    "shutdown_capacity": getattr(md, "shutdown_capacity", md.p_max),
                }
            }
        return bids

    def _format_bids(self, blk, prices, powers, x, horizon) -> Dict:
        return self._curves(np.asarray(prices), np.asarray(powers), horizon)

    def compute_day_ahead_bids(self, date, hour: int = 0) -> Dict:
        prices = self._forecast(date, hour, self.day_ahead_horizon)
        powers, _ = self._scenario_solve(self.day_ahead_model, prices)
        return self._curves(prices, powers, self.day_ahead_horizon)

    def compute_real_time_bids(self, date, hour, realized_day_ahead_prices=None,
                               realized_day_ahead_dispatches=None) -> Dict:
        bus = self.bidding_model_object.model_data.bus
        prices = np.asarray(
            self.forecaster.forecast_real_time_prices(
                date, hour, bus, self.real_time_horizon, self.n_scenario
            )
        )
        powers, _ = self._scenario_solve(self.real_time_model, prices)
        return self._curves(prices, powers, self.real_time_horizon)
