"""Reduced-space NLP solver: square flowsheet physics plus a few design
or operating decisions (counterpart of ``dispatches_tpu/solvers/
reduced.py``).

The reference's storage studies are NLPs whose variable count is
dominated by flowsheet physics (hundreds of steam states) while the true
decision space is tiny: the integrated USC + TES ``model_analysis``
frees 6 operating decisions on top of a ~800-variable square plant.
This module splits the problem the way power-plant optimization
classically does:

* **inner**: the flowsheet states ``x`` solve the square system
  ``F(x; u) = 0`` by the damped Newton of ``solvers/newton.py``; the
  decisions ``u`` enter through the params dict, the mechanism
  ``Flowsheet.fix`` already uses, so any fixed variable can be promoted
  to a decision;
* **outer**: SciPy's ``trust-constr`` on the host over the decisions,
  with objective and inequality values and exact gradients from the
  implicit-function theorem: one adjoint solve ``J_x' L = C`` with the
  square Jacobian covers the objective and every inequality row.

One evaluation (Newton solve, Jacobians, adjoint, VJPs) runs on the
device and comes back to the host in one transfer.
:class:`BatchedReducedSpaceNLP` evaluates T copies of one plant along a
lane axis (the multiperiod model: T hour-plants coupled only through
``u``), with the lane-batched Newton of
:func:`~dispatches_tpu_torch.solvers.newton.make_batched_newton_solver`
and one batched adjoint solve.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy import optimize as sopt

from dispatches_tpu_torch import resolve_device
from dispatches_tpu_torch.core.graph import Vals
from dispatches_tpu_torch.solvers.newton import (
    NewtonOptions,
    lane_solve,
    make_batched_newton_solver,
    make_newton_solver,
)

F64 = torch.float64


class ReducedResult(NamedTuple):
    u: np.ndarray          # decisions, scaled
    x: np.ndarray          # inner states, scaled decision space of the NLP
    obj: float             # objective in the user's sense
    g: np.ndarray          # inequality values (<= 0 feasible)
    converged: bool        # outer success and final inner Newton converged
    outer_iterations: int
    inner_failures: int    # inner Newton non-convergences along the path
    message: str


def _to_host(parts):
    """One device-to-host transfer for a list of tensors: float64 numpy
    arrays of the same shapes (booleans come back as 0.0/1.0)."""
    flat = torch.cat([t.detach().reshape(-1).to(F64) for t in parts]).cpu().numpy()
    out, o = [], 0
    for t in parts:
        k = t.numel()
        out.append(flat[o:o + k].reshape(tuple(t.shape)))
        o += k
    return out


class ReducedSpaceNLP:
    """Reduced-space view of a :class:`CompiledNLP` whose equality system
    is square in the non-decision variables, on ``device`` (``cuda``
    unless given).

    ``nlp`` must be compiled from a flowsheet where every decision in
    ``decisions`` is fixed (``fs.fix``), so the rest is square:
    ``n_free == m_eq``.  The flowsheet's inequalities (``fs.add_ineq``)
    become the outer constraints; the objective and sense passed to
    ``fs.compile`` become the outer objective.
    """

    def __init__(self, nlp, decisions: Sequence[str],
                 newton_options: Optional[NewtonOptions] = None,
                 u_scales: Optional[Dict[str, float]] = None,
                 device=None):
        self.nlp = nlp
        self.device = dev = resolve_device(device)
        specs = nlp.fs.var_specs
        missing = [d for d in decisions if d not in nlp.fixed_names]
        if missing:
            raise ValueError(
                f"decisions must be fixed variables of the compiled NLP; "
                f"not fixed: {missing}")
        params0 = nlp.default_params()
        self._params0 = {
            grp: {k: torch.as_tensor(np.asarray(v, dtype=np.float64), device=dev)
                  for k, v in params0[grp].items()}
            for grp in ("p", "fixed")
        }
        probe = nlp.eq(torch.as_tensor(nlp.x0, dtype=F64, device=dev), self._params0)
        if probe.shape[-1] != nlp.n:
            raise ValueError(
                f"inner system must be square: n={nlp.n}, "
                f"m_eq={probe.shape[-1]}")
        self.decisions = list(decisions)

        # decision scaling: the outer trust region is spherical in the
        # scaled u-space, so scales should reflect the expected move per
        # decision; u_scales overrides VarSpec.scale
        u_scales = u_scales or {}
        self._u_layout: Dict[str, Tuple[int, int, Tuple[int, ...], float]] = {}
        off = 0
        for d in self.decisions:
            s = specs[d]
            sz = int(np.prod(s.shape, dtype=int)) if s.shape else 1
            self._u_layout[d] = (off, off + sz, s.shape,
                                 float(u_scales.get(d, s.scale)))
            off += sz
        self.m_u = off

        def _cat(fn) -> np.ndarray:
            return np.concatenate([
                np.broadcast_to(
                    np.asarray(fn(specs[d]), dtype=np.float64),
                    specs[d].shape if specs[d].shape else (1,),
                ).ravel() / self._u_layout[d][3]
                for d in self.decisions
            ]) if self.decisions else np.zeros(0)

        self.u0 = _cat(lambda s: s.fixed_value)
        self.u_lb = _cat(lambda s: s.lb)
        self.u_ub = _cat(lambda s: s.ub)

        layout = self._u_layout

        def patch(params, u):
            fixed = dict(params["fixed"])
            for d, (a, b, shape, scale) in layout.items():
                fixed[d] = (u[a:b] * scale).reshape(shape)
            return {"p": params["p"], "fixed": fixed}

        self._patch = patch
        newton = make_newton_solver(nlp, newton_options, device=dev)
        P0 = self._params0
        m_u = self.m_u

        def evaluate(u, x_warm):
            params = patch(P0, u)
            res = newton(params, x_warm)
            x = res.x
            f = nlp.objective(x, params)
            g = nlp.ineq(x, params)
            m_g = g.shape[0]

            # implicit-function-theorem adjoints: J_x' L = [grad_x f; grad_x g]'
            Jx = torch.func.jacfwd(lambda xx: nlp.eq(xx, params))(x)
            gf = torch.func.grad(lambda xx: nlp.objective(xx, params))(x)
            if m_g:
                Gx = torch.func.jacfwd(lambda xx: nlp.ineq(xx, params))(x)
                C = torch.cat([gf[None, :], Gx], dim=0)
            else:
                C = gf[None, :]
            Lam = torch.linalg.solve(Jx.T, C.T).T  # (1 + m_g, n)

            # direct u-derivatives at frozen x
            fu = torch.func.grad(lambda uu: nlp.objective(x, patch(P0, uu)))(u)
            _, vjpF = torch.func.vjp(lambda uu: nlp.eq(x, patch(P0, uu)), u)
            Fu = torch.func.vmap(lambda lam: vjpF(lam)[0])(Lam)  # (1 + m_g, m_u)
            df = fu - Fu[0]
            if m_g:
                Gu = torch.func.jacrev(lambda uu: nlp.ineq(x, patch(P0, uu)))(u)
                dG = Gu - Fu[1:]
            else:
                dG = torch.zeros((0, m_u), dtype=F64, device=x.device)
            return [x, f, g, df, dG, res.converged, res.max_residual]

        self._evaluate_dev = evaluate

    def _evaluate(self, u, x_warm):
        """One evaluation at ``(u, x_warm)`` (numpy or tensors): ``[x, f,
        g, df, dG, converged, max_residual]`` as host numpy arrays."""
        dev = self.device
        out = self._evaluate_dev(torch.as_tensor(np.asarray(u, dtype=np.float64), device=dev),
                                 torch.as_tensor(np.asarray(x_warm, dtype=np.float64),
                                                 device=dev))
        out = _to_host(out)
        out[5] = out[5].astype(bool)
        return out

    # ------------------------------------------------------------------

    def u_physical(self, u: np.ndarray) -> Dict[str, np.ndarray]:
        out = {}
        for d, (a, b, shape, scale) in self._u_layout.items():
            out[d] = (np.asarray(u[a:b]) * scale).reshape(shape)
        return out

    def unravel(self, result: "ReducedResult") -> Dict[str, np.ndarray]:
        """Physical per-variable solution dict (states and decisions)."""
        sol = self.nlp.unravel(result.x)
        sol.update(self.u_physical(result.u))
        return sol

    def solve(self, u0: Optional[np.ndarray] = None,
              x0: Optional[np.ndarray] = None,
              u_bounds: Optional[Dict[str, Tuple[float, float]]] = None,
              maxiter: int = 300, xtol: float = 1e-12, gtol: float = 1e-10,
              solver_options: Optional[Dict] = None,
              verbose: int = 0) -> ReducedResult:
        nlp = self.nlp
        u0 = np.asarray(self.u0 if u0 is None else u0, dtype=np.float64)
        lb, ub = self.u_lb.copy(), self.u_ub.copy()
        if u_bounds:
            for d, (lo, hi) in u_bounds.items():
                a, b, _, scale = self._u_layout[d]
                lb[a:b], ub[a:b] = lo / scale, hi / scale
        u0 = np.clip(u0, lb, ub)

        state = {
            "x": np.asarray(nlp.x0 if x0 is None else x0, dtype=np.float64),
            "key": None, "out": None, "inner_failures": 0, "evaluations": 0,
        }
        x_cold = np.asarray(nlp.x0 if x0 is None else x0, dtype=np.float64)

        def _ev(u):
            u = np.asarray(u, dtype=np.float64)
            key = u.tobytes()
            if state["key"] != key:
                out = self._evaluate(u, state["x"])
                state["evaluations"] += 1
                if not bool(out[5]):
                    # cold restart before giving up: a big outer step can
                    # leave the previous states in the wrong basin
                    out2 = self._evaluate(u, x_cold)
                    state["evaluations"] += 1
                    if bool(out2[5]):
                        out = out2
                if not bool(out[5]):
                    state["inner_failures"] += 1
                else:
                    state["x"] = out[0]
                _sanitize(out)
                state["key"], state["out"] = key, out
            return state["out"]

        m_g = int(_ev(u0)[2].shape[0])
        cons = []
        if m_g:
            cons.append(sopt.NonlinearConstraint(
                lambda u: _ev(u)[2], -np.inf, 0.0,
                jac=lambda u: _ev(u)[4]))

        options = dict(maxiter=maxiter, xtol=xtol, gtol=gtol,
                       verbose=verbose)
        options.update(solver_options or {})
        res = sopt.minimize(
            lambda u: float(_ev(u)[1]), u0, jac=lambda u: _ev(u)[3],
            method="trust-constr", bounds=sopt.Bounds(lb, ub),
            constraints=cons, options=options,
        )
        out = _ev(res.x)
        self.last_evaluations = state["evaluations"]
        f_user = -float(out[1]) if nlp.sense == "max" else float(out[1])
        return ReducedResult(
            u=np.asarray(res.x), x=out[0], obj=f_user, g=out[2],
            converged=bool(out[5]) and res.status in (1, 2),
            outer_iterations=int(res.niter),
            inner_failures=state["inner_failures"],
            message=str(res.message),
        )


class BatchedReducedResult(NamedTuple):
    U: np.ndarray           # (T, m_u) decisions, scaled
    X: np.ndarray           # (T, n) inner states, scaled
    obj: float              # objective in the user's sense
    g_local: np.ndarray     # (T, m1) per-period inequalities
    g_coupling: np.ndarray  # (m2,) cross-period inequalities
    eq_coupling: np.ndarray  # (m3,) cross-period equalities
    converged: bool
    outer_iterations: int
    inner_failures: int
    message: str


class BatchedReducedSpaceNLP:
    """T independent copies of one square flowsheet, coupled only through
    the decision variables, on ``device`` (``cuda`` unless given): the
    reduced-space form of the reference's ``MultiPeriodModel`` (cloned
    per-hour blocks with linking constraints).

    The per-period physics solves along a lane axis (T Newton solves at
    once), per-period inequalities come from the flowsheet's ``add_ineq``
    rows, and the coupling layer (ramps, storage inventories, periodic
    conditions) is a small set of callables ``fn(vb, p)`` over the
    time-stacked variable dict.  Gradients are exact: one batched adjoint
    solve with the per-period Jacobians covers the objective and every
    constraint row.

    ``runtime_params``: named arrays visible to the objective and the
    coupling callables through ``p``, re-bindable at each
    ``solve(runtime_params=...)`` (the rolling-horizon market loop
    rebinds the LMP and dispatch signals every hour); a key not declared
    here raises ``KeyError``.
    """

    def __init__(self, nlp, decisions: Sequence[str], T: int,
                 objective, sense: str = "max",
                 coupling_ineqs: Sequence[Tuple[str, object]] = (),
                 coupling_eqs: Sequence[Tuple[str, object]] = (),
                 newton_options: Optional[NewtonOptions] = None,
                 u_scales: Optional[Dict[str, float]] = None,
                 runtime_params: Optional[Dict[str, object]] = None,
                 device=None):
        base = ReducedSpaceNLP(nlp, decisions, newton_options, u_scales, device=device)
        self.base = base
        self.nlp = nlp
        self.device = dev = base.device
        self.T = int(T)
        self.sense = sense
        self.coupling_ineqs = list(coupling_ineqs)
        self.coupling_eqs = list(coupling_eqs)
        if sense not in ("min", "max"):
            raise ValueError("sense must be 'min' or 'max'")

        params0 = base._params0
        patch = base._patch
        dec = set(decisions)
        T_ = self.T
        m_u = base.m_u
        var_scale = torch.as_tensor(np.asarray(nlp.var_scale, dtype=np.float64), device=dev)
        sgn = -1.0 if sense == "max" else 1.0

        def batched_params(U):
            """Params with a leading T axis on the decision entries."""
            fixed = {}
            for k, v in params0["fixed"].items():
                if k in dec:
                    a, b, shape, scale = base._u_layout[k]
                    fixed[k] = (U[:, a:b] * scale).reshape((T_,) + tuple(shape))
                else:
                    fixed[k] = v
            return {"p": params0["p"], "fixed": fixed}

        axes = {
            "p": {k: None for k in params0["p"]},
            "fixed": {k: (0 if k in dec else None) for k in params0["fixed"]},
        }
        self._params_axes = axes
        self._newton_b = make_batched_newton_solver(nlp, newton_options, lane_axes=axes,
                                                    device=dev)
        self._batched_params = batched_params

        slices = nlp._slices
        fixed0 = params0["fixed"]
        p_vals = params0["p"]

        def stack_vals(X, U) -> Dict[str, torch.Tensor]:
            d = {}
            for name, (a, b, shape) in slices.items():
                d[name] = (X[:, a:b] * var_scale[a:b]).reshape((T_,) + tuple(shape))
            for name, v in fixed0.items():
                if name in dec:
                    a, b, shape, scale = base._u_layout[name]
                    d[name] = (U[:, a:b] * scale).reshape((T_,) + tuple(shape))
                else:
                    d[name] = torch.broadcast_to(v, (T_,) + tuple(v.shape))
            return d

        self._rp0 = {k: np.asarray(v, dtype=np.float64)
                     for k, v in (runtime_params or {}).items()}

        def f_fn(X, U, rp):
            return sgn * objective(Vals(stack_vals(X, U)), Vals({**p_vals, **rp}))

        def rows_fn(fns):
            def rows(X, U, rp):
                if not fns:
                    return X.new_zeros((0,))
                vb, pv = Vals(stack_vals(X, U)), Vals({**p_vals, **rp})
                return torch.cat([torch.ravel(fn(vb, pv)) for _, fn in fns])
            return rows

        g2_fn = rows_fn(self.coupling_ineqs)
        e3_fn = rows_fn(self.coupling_eqs)

        def per_hour_ineq(x, u):
            return nlp.ineq(x, patch(params0, u))

        def per_hour_eq(x, u):
            return nlp.eq(x, patch(params0, u))

        vmap, jacfwd, jacrev = torch.func.vmap, torch.func.jacfwd, torch.func.jacrev

        def contract(x, u, lam_rows):
            _, vjp = torch.func.vjp(lambda uu: per_hour_eq(x, uu), u)
            return vmap(lambda lam: vjp(lam)[0])(lam_rows)

        def evaluate(U, Xw, rp):
            res = self._newton_b(batched_params(U), Xw)
            X = res.x

            f = f_fn(X, U, rp)
            g1 = vmap(per_hour_ineq)(X, U)                 # (T, m1)
            g2 = g2_fn(X, U, rp)                           # (m2,)
            e3 = e3_fn(X, U, rp)                           # (m3,)
            m1, m2, m3 = g1.shape[1], g2.shape[0], e3.shape[0]

            # ---- gradients ------------------------------------------
            fX, fU = torch.func.grad(f_fn, argnums=(0, 1))(X, U, rp)  # (T, n), (T, m_u)
            G1x = vmap(jacfwd(per_hour_ineq, argnums=0))(X, U)
            G1u = vmap(jacfwd(per_hour_ineq, argnums=1))(X, U)
            zx, zu = X.new_zeros((0, T_, nlp.n)), X.new_zeros((0, T_, m_u))
            G2x, G2u = jacrev(g2_fn, argnums=(0, 1))(X, U, rp) if m2 else (zx, zu)
            E3x, E3u = jacrev(e3_fn, argnums=(0, 1))(X, U, rp) if m3 else (zx, zu)

            J = vmap(jacfwd(per_hour_eq, argnums=0))(X, U)

            # cotangent stack per hour: objective, per-hour rows,
            # coupling rows (ineq, then eq)
            C = torch.cat([
                fX[:, None, :],                    # (T, 1, n)
                G1x,                               # (T, m1, n)
                torch.movedim(G2x, 0, 1),          # (T, m2, n)
                torch.movedim(E3x, 0, 1),          # (T, m3, n)
            ], dim=1)
            Lam = lane_solve(J.transpose(-1, -2), C.transpose(-1, -2)).transpose(-1, -2)
            FuT = vmap(contract)(X, U, Lam)        # (T, R, m_u)

            dfU = fU - FuT[:, 0]                                   # (T, m_u)
            dG1 = G1u - FuT[:, 1:1 + m1]                           # (T, m1, m_u)
            dG2 = G2u - torch.movedim(FuT[:, 1 + m1:1 + m1 + m2], 0, 1)
            dE3 = E3u - torch.movedim(FuT[:, 1 + m1 + m2:], 0, 1)
            return [X, f, g1, g2, e3, dfU, dG1, dG2, dE3,
                    res.converged, res.max_residual, res.iterations]

        self._evaluate_dev = evaluate

    def runtime_on_device(self, runtime_params=None):
        """The runtime params (declared defaults overridden by
        ``runtime_params``) as float64 tensors on the device; an
        undeclared key raises ``KeyError``."""
        rp = {**self._rp0, **{k: np.asarray(v, dtype=np.float64)
                              for k, v in (runtime_params or {}).items()}}
        unknown = set(rp) - set(self._rp0)
        if unknown:
            raise KeyError(f"unknown runtime params {sorted(unknown)}")
        return {k: torch.as_tensor(v, device=self.device) for k, v in rp.items()}

    def _evaluate_b(self, U, Xw, rp):
        """One batched evaluation at ``(U, Xw)`` with device runtime params
        ``rp``: ``[X, f, g1, g2, e3, dfU, dG1, dG2, dE3, converged,
        max_residual, iterations]`` as host numpy arrays, in one
        transfer."""
        dev = self.device
        out = _to_host(self._evaluate_dev(
            torch.as_tensor(np.asarray(U, dtype=np.float64), device=dev),
            torch.as_tensor(np.asarray(Xw, dtype=np.float64), device=dev), rp))
        out[9] = out[9].astype(bool)
        out[11] = out[11].astype(np.int64)
        return out

    # ------------------------------------------------------------------

    def stack_solution(self, X: np.ndarray, U: np.ndarray) -> Dict[str, np.ndarray]:
        """Physical per-variable dict with a leading T axis."""
        nlp, base = self.nlp, self.base
        out = {}
        for name, (a, b, shape) in nlp._slices.items():
            out[name] = (np.asarray(X[:, a:b])
                         * np.asarray(nlp.var_scale[a:b])).reshape(
                             (self.T,) + shape)
        for name in nlp.fixed_names:
            if name in base._u_layout:
                a, b, shape, scale = base._u_layout[name]
                out[name] = (np.asarray(U[:, a:b]) * scale).reshape(
                    (self.T,) + shape)
            else:
                v = np.asarray(self.nlp.fs.var_specs[name].fixed_value)
                out[name] = np.broadcast_to(v, (self.T,) + v.shape)
        return out

    def solve(self, U0: Optional[np.ndarray] = None,
              X0: Optional[np.ndarray] = None,
              u_bounds: Optional[Dict[str, Tuple[float, float]]] = None,
              maxiter: int = 300, xtol: float = 1e-10, gtol: float = 1e-8,
              solver_options: Optional[Dict] = None,
              runtime_params: Optional[Dict[str, object]] = None,
              verbose: int = 0) -> BatchedReducedResult:
        T_, m_u, nlp = self.T, self.base.m_u, self.nlp
        rp = self.runtime_on_device(runtime_params)  # once per solve
        if U0 is None:
            U0 = np.tile(self.base.u0, (T_, 1))
        U0 = np.asarray(U0, dtype=np.float64).reshape(T_, m_u)
        lb1, ub1 = self.base.u_lb.copy(), self.base.u_ub.copy()
        if u_bounds:
            for d, (lo, hi) in u_bounds.items():
                a, b, _, scale = self.base._u_layout[d]
                lb1[a:b], ub1[a:b] = lo / scale, hi / scale
        lb = np.tile(lb1, T_)
        ub = np.tile(ub1, T_)
        U0 = np.clip(U0, lb1, ub1)

        X_cold = (np.tile(np.asarray(nlp.x0), (T_, 1))
                  if X0 is None else np.asarray(X0, dtype=np.float64))
        state = {"x": X_cold.copy(), "key": None, "out": None,
                 "inner_failures": 0, "evaluations": 0}

        def _ev(uflat):
            u = np.asarray(uflat, dtype=np.float64)
            key = u.tobytes()
            if state["key"] != key:
                U = u.reshape(T_, m_u)
                out = self._evaluate_b(U, state["x"], rp)
                state["evaluations"] += 1
                conv = out[9]
                if not conv.all():
                    # cold-restart the failed periods once
                    Xr = np.where(conv[:, None], out[0], X_cold)
                    out2 = self._evaluate_b(U, Xr, rp)
                    state["evaluations"] += 1
                    if out2[9].sum() > conv.sum():
                        out, conv = out2, out2[9]
                if conv.all():
                    state["x"] = out[0]
                else:
                    state["inner_failures"] += 1
                for i in (1, 2, 3, 4):
                    out[i] = np.where(np.isfinite(out[i]), out[i], 1e6)
                for i in (5, 6, 7, 8):
                    out[i] = np.where(np.isfinite(out[i]), out[i], 0.0)
                state["key"], state["out"] = key, out
            return state["out"]

        out0 = _ev(U0.ravel())
        m1, m2, m3 = out0[2].shape[1], out0[3].shape[0], out0[4].shape[0]

        def g1_jac(uflat):
            dG1 = _ev(uflat)[6]  # (T, m1, m_u)
            Jg = np.zeros((T_ * m1, T_ * m_u))
            for t in range(T_):
                Jg[t * m1:(t + 1) * m1, t * m_u:(t + 1) * m_u] = dG1[t]
            return Jg

        cons = []
        if m1:
            cons.append(sopt.NonlinearConstraint(
                lambda u: _ev(u)[2].ravel(), -np.inf, 0.0, jac=g1_jac))
        if m2:
            cons.append(sopt.NonlinearConstraint(
                lambda u: _ev(u)[3], -np.inf, 0.0,
                jac=lambda u: _ev(u)[7].reshape(m2, T_ * m_u)))
        if m3:
            cons.append(sopt.NonlinearConstraint(
                lambda u: _ev(u)[4], 0.0, 0.0,
                jac=lambda u: _ev(u)[8].reshape(m3, T_ * m_u)))

        options = dict(maxiter=maxiter, xtol=xtol, gtol=gtol,
                       verbose=verbose)
        options.update(solver_options or {})
        res = sopt.minimize(
            lambda u: float(_ev(u)[1]), U0.ravel(),
            jac=lambda u: _ev(u)[5].ravel(),
            method="trust-constr", bounds=sopt.Bounds(lb, ub),
            constraints=cons, options=options,
        )
        out = _ev(res.x)
        self.last_evaluations = state["evaluations"]
        f_user = -float(out[1]) if self.sense == "max" else float(out[1])
        return BatchedReducedResult(
            U=np.asarray(res.x).reshape(T_, m_u), X=out[0], obj=f_user,
            g_local=out[2], g_coupling=out[3], eq_coupling=out[4],
            converged=bool(out[9].all()) and res.status in (1, 2),
            outer_iterations=int(res.niter),
            inner_failures=state["inner_failures"],
            message=str(res.message),
        )


def _sanitize(out) -> None:
    """Replace non-finite evaluation results in place so the outer
    trust-region solver treats a diverged inner solve as a very bad but
    finite trial point (the step is rejected, the radius shrinks)."""
    _, f, g, df, dG = out[0], out[1], out[2], out[3], out[4]
    if not np.isfinite(f):
        out[1] = np.asarray(1e6)
    out[2] = np.where(np.isfinite(g), g, 1e6)
    out[3] = np.where(np.isfinite(df), df, 0.0)
    out[4] = np.where(np.isfinite(dG), dG, 0.0)
