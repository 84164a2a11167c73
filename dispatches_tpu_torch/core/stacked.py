"""Scenario-stacked NLP: the two-stage stochastic program builder
(counterpart of ``dispatches_tpu/core/stacked.py``).

The program is built over a compiled per-scenario NLP:

    X = [x_1, ..., x_S, e]      e = first-stage schedule, shape (T,)

* per-scenario residuals are evaluated with ``torch.func.vmap`` over the
  scenario slab (one pass, S lanes);
* non-anticipativity is BY CONSTRUCTION: one shared ``e`` with hard
  coupling rows ``P_s(x_s) - e = 0`` for every scenario;
* the objective is the probability-weighted sum of scenario objectives
  plus an optional first-stage term.

The result implements the ``CompiledNLP`` surface consumed by
``make_ipm_solver`` (objective/eq/ineq, x0/lb/ub/var_scale,
``default_params``/``unravel``), so the stacked program solves on the
same IPM as everything else.

Two lane axes: the scenario slab is a ``vmap`` inside the residuals, and
a batch of programs (the bidder's days) is the IPM's own lane axis.  So
``default_params()["p"][k]`` of a scenario key keeps its per-scenario
shape ``(S, ...)``: a day batch ``(D, S, ...)`` reads as one lane axis,
a single program as none.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from dispatches_tpu_torch.core.compile import _leaf


class _FS:
    """Minimal fs surface for solver-side introspection."""

    def __init__(self, horizon):
        self.horizon = horizon


class StackedScenarioNLP:
    """Stack ``n_scenarios`` copies of a compiled NLP with a shared
    first-stage profile.

    Args:
        nlp: the per-scenario CompiledNLP (one flowsheet over horizon T)
        n_scenarios: S
        scenario_param_keys: params batched per scenario (e.g.
            ``["energy_price"]``); everything else is shared
        first_stage_expr: ``fn(v, p) -> (T,)`` evaluated per scenario —
            the profile the coupling acts on (delivered power)
        coupling: "first_stage" ties the profile hard across scenarios
            through a shared schedule variable (SelfScheduler
            non-anticipativity); "monotone" instead enforces
            incentive-compatible bid-curve consistency — whenever
            scenario s sees a higher price than s', its dispatch must
            be at least as large: (pi_s - pi_s')(P_s - P_s') >= 0 for
            all pairs, per hour
        price_key: the scenario param holding the per-hour prices
            (required for "monotone")
        first_stage_bounds: (lb, ub) for the shared schedule ``e``
        weights: scenario probabilities (default uniform)
        first_stage_obj: optional ``fn(e, p) -> scalar`` added to the
            weighted scenario objectives (DA settlement terms)
    """

    def __init__(
        self,
        nlp,
        n_scenarios: int,
        scenario_param_keys: Sequence[str],
        first_stage_expr: Callable,
        coupling: str = "first_stage",
        price_key: Optional[str] = None,
        first_stage_bounds=(0.0, np.inf),
        weights: Optional[Sequence[float]] = None,
        first_stage_obj: Optional[Callable] = None,
        first_stage_scale: float = 1.0,
    ):
        if coupling not in ("first_stage", "monotone"):
            raise ValueError("coupling must be 'first_stage' or 'monotone'")
        if coupling == "monotone" and price_key is None:
            raise ValueError("coupling='monotone' requires price_key")
        self.base = nlp
        self.S = int(n_scenarios)
        self.T = int(nlp.fs.horizon)
        self.fs = _FS(self.T)
        self.sense = nlp.sense
        self.coupling = coupling
        self._price_key = price_key
        self._sp_keys = list(scenario_param_keys)
        self._fs_obj = first_stage_obj
        self._fs_expr = first_stage_expr
        w = (
            np.full(self.S, 1.0 / self.S)
            if weights is None
            else np.asarray(weights, float)
        )
        if len(w) != self.S or abs(w.sum() - 1.0) > 1e-9:
            raise ValueError("weights must have length S and sum to 1")
        # scenario weights in float64, as the JAX package holds them
        # under x64; one tensor per device, made on first use
        self._w = np.asarray(w, dtype=np.float64)
        self._on: Dict = {}

        n1 = nlp.n
        self._n1 = n1
        self._has_e = coupling == "first_stage"
        n_e = self.T if self._has_e else 0
        self.n = self.S * n1 + n_e

        # bounds/inits/scales: scenario slabs then the first stage
        self._e_scale = first_stage_scale
        lb_e = np.broadcast_to(np.asarray(first_stage_bounds[0], float), (n_e,))
        ub_e = np.broadcast_to(np.asarray(first_stage_bounds[1], float), (n_e,))
        self.var_scale = np.concatenate(
            [np.tile(np.asarray(nlp.var_scale), self.S),
             np.full(n_e, first_stage_scale)]
        )
        self.lb = np.concatenate(
            [np.tile(np.asarray(nlp.lb), self.S), lb_e / first_stage_scale]
        )
        self.ub = np.concatenate(
            [np.tile(np.asarray(nlp.ub), self.S), ub_e / first_stage_scale]
        )

        # x0: per-scenario inits + first stage from the base expression
        p0 = nlp.default_params()
        x0_1 = torch.as_tensor(np.asarray(nlp.x0, dtype=np.float64))
        e0 = first_stage_expr(nlp._vals(x0_1, p0), nlp._pvals(x0_1, p0))
        e0 = torch.as_tensor(e0).detach().numpy()[:n_e]
        self.x0 = np.concatenate(
            [np.tile(np.asarray(nlp.x0), self.S), e0 / first_stage_scale]
        )

        n_pairs = self.S * (self.S - 1) // 2
        self.m_eq = self.S * nlp.m_eq + (self.S * self.T if self._has_e else 0)
        self.m_ineq = self.S * nlp.m_ineq + (
            0 if self._has_e else n_pairs * self.T
        )
        self._pairs = np.array(
            [(i, j) for i in range(self.S) for j in range(i + 1, self.S)],
            dtype=np.int64,
        ).reshape(n_pairs, 2)

        # named slices for unravel: "s{k}.var" + "first_stage"
        self.free_names: List[str] = []
        self._slices: Dict = {}
        for s in range(self.S):
            off = s * n1
            for name in nlp.free_names:
                a, b, shape = nlp._slices[name]
                key = f"s{s}.{name}"
                self.free_names.append(key)
                self._slices[key] = (off + a, off + b, shape)
        if self._has_e:
            self.free_names.append("first_stage")
            self._slices["first_stage"] = (
                self.S * n1, self.S * n1 + self.T, (self.T,)
            )
        self.fixed_names = list(nlp.fixed_names)

        # eq/ineq slice maps (per-scenario blocks + coupling)
        self.eq_slices = {}
        o = 0
        for s in range(self.S):
            for cname, (a, b) in nlp.eq_slices.items():
                self.eq_slices[f"s{s}.{cname}"] = (o + a, o + b)
            o += nlp.m_eq
        if self._has_e:
            for s in range(self.S):
                self.eq_slices[f"s{s}.non_anticipativity"] = (o, o + self.T)
                o += self.T
        self.ineq_slices = {}
        o = 0
        for s in range(self.S):
            for cname, (a, b) in nlp.ineq_slices.items():
                self.ineq_slices[f"s{s}.{cname}"] = (o + a, o + b)
            o += nlp.m_ineq
        if not self._has_e and n_pairs:
            self.ineq_slices["bid_monotonicity"] = (o, o + n_pairs * self.T)

    # -- device constants ----------------------------------------------

    def _consts(self, device):
        """(weights, pair rows i, pair rows j) as tensors on ``device``."""
        c = self._on.get(device)
        if c is None:
            c = (torch.as_tensor(self._w, device=device),
                 torch.as_tensor(self._pairs[:, 0], device=device),
                 torch.as_tensor(self._pairs[:, 1], device=device))
            self._on[device] = c
        return c

    # -- params -------------------------------------------------------

    def default_params(self):
        base = self.base.default_params()
        p = dict(base["p"])
        for k in self._sp_keys:
            p[k] = np.tile(np.asarray(p[k])[None, ...], (self.S,) + (1,) * np.ndim(p[k]))
        return {"p": p, "fixed": base["fixed"]}

    def _slab(self, fn, xs, params):
        """``fn(x_s, params_s)`` mapped over the scenario slab: the
        scenario keys are split along their leading axis, everything else
        is shared."""
        dev = xs.device
        p = {k: _leaf(v, dev) for k, v in params["p"].items()}
        fixed = {k: _leaf(v, dev) for k, v in params["fixed"].items()}
        dims = ({"p": {k: (0 if k in self._sp_keys else None) for k in p},
                 "fixed": {k: None for k in fixed}},)
        return torch.func.vmap(fn, in_dims=(0,) + dims)(
            xs, {"p": p, "fixed": fixed})

    def _split(self, x):
        xs = x[: self.S * self._n1].reshape(self.S, self._n1)
        e = x[self.S * self._n1:]  # empty in "monotone" mode
        return xs, e

    def _profiles(self, xs, params):
        """(S, T) coupled profile per scenario."""
        base = self.base

        def one(x_s, p_s):
            return self._fs_expr(base._vals(x_s, p_s), base._pvals(x_s, p_s))

        return self._slab(one, xs, params)

    def _per_scenario(self, fn, x, params):
        xs, _ = self._split(x)
        return self._slab(fn, xs, params)

    # -- CompiledNLP surface ------------------------------------------

    def objective(self, x, params):
        _, e = self._split(x)
        w, _, _ = self._consts(x.device)
        objs = self._per_scenario(self.base.objective, x, params)
        total = torch.sum(w * objs)
        if self._fs_obj is not None:
            fs_term = self._fs_obj(e * self._e_scale, self.base._pvals(x, params))
            # base.objective is in minimization form; user fs_obj is in
            # the USER's sense
            total = total + (-fs_term if self.sense == "max" else fs_term)
        return total

    def user_objective(self, x, params):
        val = self.objective(x, params)
        return -val if self.sense == "max" else val

    def eq(self, x, params):
        xs, e = self._split(x)
        blocks = self._per_scenario(self.base.eq, x, params)  # (S, m_eq)
        if not self._has_e:
            return blocks.reshape(-1)
        prof = self._profiles(xs, params)  # (S, T)
        na = (prof - (e * self._e_scale)[None, :]) * (1.0 / self._e_scale)
        return torch.cat([blocks.reshape(-1), na.reshape(-1)])

    def ineq(self, x, params):
        xs, _ = self._split(x)
        blocks = self._per_scenario(self.base.ineq, x, params).reshape(-1)
        if self._has_e or not len(self._pairs):
            return blocks
        # incentive compatibility: (pi_i - pi_j)(P_i - P_j) >= 0
        _, i, j = self._consts(x.device)
        prof = self._profiles(xs, params)  # (S, T)
        prices = _leaf(params["p"][self._price_key], x.device)  # (S, T)
        dpi = (prices[i] - prices[j]) * (1.0 / torch.clamp(
            torch.max(torch.abs(prices)), min=1.0))
        dP = (prof[i] - prof[j]) * (1.0 / self._e_scale)
        mono = -(dpi * dP)  # <= 0
        return torch.cat([blocks, mono.reshape(-1)])

    # -- helpers ------------------------------------------------------

    @staticmethod
    def _host(x):
        if isinstance(x, np.ndarray):  # already on the host: no transfer
            return x
        return torch.as_tensor(x).detach().cpu().numpy()

    def unravel(self, x):
        x = self._host(x)
        out = {}
        for name, (a, b, shape) in self._slices.items():
            out[name] = (x[a:b] * self.var_scale[a:b]).reshape(shape)
        return out

    def scenario_solution(self, x, s: int):
        """Per-scenario solution dict in the base NLP's naming."""
        xs, _ = self._split(self._host(x))
        return self.base.unravel(xs[s])

    def first_stage(self, x):
        if not self._has_e:
            raise ValueError(
                "no shared schedule variable in coupling='monotone' mode"
            )
        _, e = self._split(self._host(x))
        return np.asarray(e) * self._e_scale

    def scenario_profiles(self, x, params=None, host: bool = True):
        """(S, T) coupled profiles at a solution, computed on ``x``'s
        device and returned as host numpy (``host=False``: the tensor on
        that device, so that a caller can move many at once)."""
        params = self.default_params() if params is None else params
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x, dtype=np.float64))
        xs, _ = self._split(x)
        out = self._profiles(xs, params)
        return self._host(out) if host else out
