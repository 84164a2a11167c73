"""Lowering: Flowsheet -> flat NLP over torch callables (counterpart of
``dispatches_tpu/core/compile.py``).

Lowering happens once and produces three callables over a flat decision
vector ``x`` (fixed variables come in through ``params``):

    objective(x, params) -> scalar
    eq(x, params)        -> (m_eq,)   residuals, feasible iff == 0
    ineq(x, params)      -> (m_ineq,) residuals, feasible iff <= 0

They are plain tensor code, so ``torch.func.grad``/``jacfwd``/``vmap``
transform them.  ``params`` follows ``default_params()``: numpy leaves
are turned into float64 tensors on ``x``'s device at call time, and
tensor leaves are used as given.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from dispatches_tpu_torch.analysis.runtime import nan_guard
from dispatches_tpu_torch.core.graph import Flowsheet, Vals


def _leaf(value, device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    return torch.as_tensor(np.asarray(value, dtype=np.float64), device=device)


class CompiledNLP:
    def __init__(self, fs: Flowsheet, objective: Optional[Callable] = None, sense: str = "min"):
        self.fs = fs
        self.sense = sense
        if sense not in ("min", "max"):
            raise ValueError("sense must be 'min' or 'max'")
        self._objective_fn = objective

        # --- variable layout -----------------------------------------
        self.free_names: List[str] = [n for n, s in fs.var_specs.items() if not s.fixed]
        self.fixed_names: List[str] = [n for n, s in fs.var_specs.items() if s.fixed]

        slices: Dict[str, Tuple[int, int, Tuple[int, ...]]] = {}
        off = 0
        for n in self.free_names:
            sz = int(np.prod(fs.var_specs[n].shape, dtype=int)) if fs.var_specs[n].shape else 1
            slices[n] = (off, off + sz, fs.var_specs[n].shape)
            off += sz
        self._slices = slices
        self.n = off

        # The decision vector holds SCALED values (x_phys = x * var_scale);
        # residuals see physical values via _vals.
        def _cat(fn):
            if not self.free_names:
                return np.zeros(0)
            return np.concatenate(
                [fn(fs.var_specs[n]).ravel() for n in self.free_names]
            )

        self.var_scale = _cat(
            lambda s: np.full(s.shape if s.shape else (1,), s.scale)
        )
        self.x0 = _cat(lambda s: s.init_array()) / self.var_scale
        self.lb = _cat(lambda s: s.lb_array()) / self.var_scale
        self.ub = _cat(lambda s: s.ub_array()) / self.var_scale
        self._scale_on: Dict[torch.device, torch.Tensor] = {}

        # --- constraint layout (shapes probed once, eagerly, on the host)
        self._eq = [c for c in fs.constraints if c.kind == "eq"]
        self._ineq = [c for c in fs.constraints if c.kind == "ineq"]

        p0 = self.default_params()
        cpu = torch.device("cpu")
        v0 = self._vals(torch.as_tensor(self.x0, device=cpu), p0)
        pv0 = Vals({k: _leaf(v, cpu) for k, v in fs.params.items()})

        def _probe(cons):
            sl, o = {}, 0
            for c in cons:
                sz = int(torch.as_tensor(c.fn(v0, pv0)).numel())
                sl[c.name] = (o, o + sz)
                o += sz
            return sl, o

        self._horizon = int(getattr(fs, "horizon", 0))
        self.eq_slices, self.m_eq = _probe(self._eq)
        self.ineq_slices, self.m_ineq = _probe(self._ineq)

    def _ravel_tlast(self, out) -> torch.Tensor:
        """Ravel a residual time-LAST: a (T, k) block becomes k contiguous
        length-T segments — the JAX package's row order, so K and G
        match it row for row."""
        out = torch.as_tensor(out)
        if out.ndim >= 2 and out.shape[0] == self._horizon:
            out = torch.movedim(out, 0, -1)
        return out.reshape(-1)

    # ------------------------------------------------------------------

    def default_params(self) -> Dict[str, Dict[str, np.ndarray]]:
        fs = self.fs
        return {
            "p": {k: np.asarray(v) for k, v in fs.params.items()},
            "fixed": {n: np.asarray(fs.var_specs[n].fixed_value) for n in self.fixed_names},
        }

    def _scale(self, device) -> torch.Tensor:
        s = self._scale_on.get(device)
        if s is None:
            s = torch.as_tensor(self.var_scale, dtype=torch.float64, device=device)
            self._scale_on[device] = s
        return s

    def _vals(self, x: torch.Tensor, params) -> Vals:
        scale = self._scale(x.device)
        d: Dict[str, torch.Tensor] = {}
        for n, (a, b, shape) in self._slices.items():
            d[n] = (x[a:b] * scale[a:b]).reshape(shape)
        for n in self.fixed_names:
            d[n] = _leaf(params["fixed"][n], x.device)
        return Vals(d)

    def _pvals(self, x: torch.Tensor, params) -> Vals:
        return Vals({k: _leaf(v, x.device) for k, v in params["p"].items()})

    # --- the three lowered callables ---------------------------------

    def objective(self, x: torch.Tensor, params) -> torch.Tensor:
        if self._objective_fn is None:
            return torch.zeros((), dtype=x.dtype, device=x.device)
        val = self._objective_fn(self._vals(x, params), self._pvals(x, params))
        nan_guard("nlp.objective", val)
        return -val if self.sense == "max" else val

    def user_objective(self, x: torch.Tensor, params) -> torch.Tensor:
        """Objective in the user's declared sense (max problems are
        negated internally for the minimizing solver)."""
        val = self.objective(x, params)
        return -val if self.sense == "max" else val

    def _residuals(self, cons, label, x, params) -> torch.Tensor:
        if not cons:
            return torch.zeros((0,), dtype=x.dtype, device=x.device)
        v = self._vals(x, params)
        p = self._pvals(x, params)
        out = torch.cat([c.scale * self._ravel_tlast(c.fn(v, p)) for c in cons])
        nan_guard(label, out)
        return out

    def eq(self, x: torch.Tensor, params) -> torch.Tensor:
        return self._residuals(self._eq, "nlp.eq", x, params)

    def ineq(self, x: torch.Tensor, params) -> torch.Tensor:
        return self._residuals(self._ineq, "nlp.ineq", x, params)

    # --- solution helpers --------------------------------------------

    def unravel(self, x) -> Dict[str, np.ndarray]:
        x = torch.as_tensor(x).detach().cpu().numpy()
        out = {}
        for n, (a, b, shape) in self._slices.items():
            out[n] = (x[a:b] * self.var_scale[a:b]).reshape(shape)
        for n in self.fixed_names:
            out[n] = np.asarray(self.fs.var_specs[n].fixed_value)
        return out

    def constraint_report(self, x, params, tol: float = 1e-6) -> Dict[str, float]:
        """Max PHYSICAL violation per constraint block (residual scales
        divided back out)."""
        x = torch.as_tensor(x)
        r_eq = self.eq(x, params).detach().cpu().numpy()
        r_in = self.ineq(x, params).detach().cpu().numpy()
        out = {}
        for c in self._eq:
            a, b = self.eq_slices[c.name]
            viol = float(np.max(np.abs(r_eq[a:b]))) / c.scale if b > a else 0.0
            if viol > tol:
                out[c.name] = viol
        for c in self._ineq:
            a, b = self.ineq_slices[c.name]
            viol = float(np.max(r_in[a:b])) / c.scale if b > a else 0.0
            if viol > tol:
                out[c.name] = viol
        return out
