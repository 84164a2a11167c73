"""Damped-Newton solver for square (DOF = 0) flowsheet systems
(counterpart of ``dispatches_tpu/solvers/newton.py``).

A flowsheet "simulation" is F(x) = 0 with variable bounds that keep
EoS auxiliaries on their declared branches: no objective, no
inequalities.  This module solves it with a projected damped Newton
iteration in float64:

* the Jacobian by ``torch.func.jacfwd`` of the scaled residual (one
  batched forward-mode pass over the identity);
* Armijo backtracking on 0.5 |F|^2 with each trial point clipped into
  the bound box.  The candidate steps 1, 1/2, ..., 1/2**max_backtracks
  are evaluated as one batched fan and the first that passes is taken —
  the step the reference's sequential backtracking takes — so the loop
  reads the device once per Newton step: the max residual that decides
  whether to go on;
* linear solves by LU (``torch.linalg.solve``), or ``"refined_f32"``: a
  float32 LU with three float64 refinement steps.  ``"auto"`` is LU,
  on the card and on the CPU.

:func:`make_batched_newton_solver` solves T copies of one system at once
along an explicit lane axis, with the semantics of ``jax.vmap`` of the
reference's ``while_loop``: every lane runs until it converges or hits
``max_iter``, and a finished lane is frozen while the others go on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from dispatches_tpu_torch import resolve_device
from dispatches_tpu_torch.analysis.runtime import nan_guard
from dispatches_tpu_torch.solvers.pdlp import _params_on

F64 = torch.float64


@dataclass
class NewtonOptions:
    tol: float = 1e-8          # max|F| (scaled residuals) at convergence
    max_iter: int = 50
    armijo_c: float = 1e-4
    backtrack: float = 0.5
    max_backtracks: int = 25
    # regularization added to J
    reg: float = 0.0
    linear_solver: str = "auto"  # auto | lu | refined_f32


class NewtonResult(NamedTuple):
    x: torch.Tensor              # scaled decision vector
    converged: torch.Tensor
    iterations: torch.Tensor
    max_residual: torch.Tensor

    @property
    def status(self):
        return torch.where(self.converged, 0, 2)


def _linear_solve_refined(J, r):
    """float32 LU + float64 iterative refinement."""
    lu, piv = torch.linalg.lu_factor(J.to(torch.float32))

    def solve32(b):
        return torch.linalg.lu_solve(lu, piv, b.to(torch.float32)[:, None])[:, 0].to(F64)

    x = solve32(r)
    for _ in range(3):
        x = x + solve32(r - J @ x)
    return x


def _linear_solve_lu(J, r):
    return torch.linalg.solve(J, r)


def _lanes(fn, *args):
    """``fn`` over a leading lane axis.  On the card one batched call; on
    the CPU one call per lane: oneMKL's batched LU (torch 2.13 CPU builds)
    fails on a few lanes of ~800 x 800 ("Parameter 6 was incorrect on
    entry to DLASWP") and does not return."""
    if args[0].device.type != "cpu":
        return fn(*args)
    outs = [fn(*(a[t] for a in args)) for t in range(args[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def lane_solve(A, B):
    """``torch.linalg.solve`` over a leading lane axis (see :func:`_lanes`)."""
    return _lanes(torch.linalg.solve, A, B)


def _linear_solve_refined_b(J, r):
    """Lane-batched ``_linear_solve_refined``: J (T, n, n), r (T, n)."""
    lu, piv = _lanes(lambda a: torch.linalg.lu_factor_ex(a)[:2], J.to(torch.float32))

    def solve32(b):
        return _lanes(lambda f, p, c: torch.linalg.lu_solve(f, p, c[..., None])[..., 0],
                      lu, piv, b.to(torch.float32)).to(F64)

    x = solve32(r)
    for _ in range(3):
        x = x + solve32(r - (J @ x[..., None])[..., 0])
    return x


def _linear_solve_lu_b(J, r):
    # solve_ex: a singular lane gives non-finite entries (caught by the
    # gradient fallback) instead of an error, and no host read
    return _lanes(lambda a, b: torch.linalg.solve_ex(a, b)[0], J, r)


def _linear_kind(opt: "NewtonOptions") -> str:
    kind = "lu" if opt.linear_solver == "auto" else opt.linear_solver
    if kind not in ("lu", "refined_f32"):
        raise ValueError(f"unknown linear_solver {opt.linear_solver!r}; "
                         "expected 'auto', 'lu' or 'refined_f32'")
    return kind


def make_newton_solver(nlp, options: Optional[NewtonOptions] = None,
                       trace: bool = False, device=None):
    """Build a square-system Newton solver for a CompiledNLP with no
    inequalities, on ``device`` (``cuda`` unless given).  Returns
    ``solver(params, x0=None) -> NewtonResult`` (``x0`` scaled, as
    ``nlp.x0``).

    ``trace=True`` returns ``(NewtonResult, trace_dict)`` where
    ``trace_dict["max_residual"]`` has length ``max_iter``: the max
    residual after each damped step, the last value repeated past the
    final step."""
    opt = options or NewtonOptions()
    dev = resolve_device(device)
    p0 = _params_on(nlp.default_params(), dev)
    n_eq = int(nlp.eq(torch.as_tensor(nlp.x0, dtype=F64, device=dev), p0).shape[-1])
    if n_eq != nlp.n:
        raise ValueError(
            f"square solver needs n_eq == n_var, got {n_eq} != {nlp.n} "
            "(use the IPM for non-square systems)"
        )
    lb = torch.as_tensor(np.asarray(nlp.lb, dtype=np.float64), device=dev)
    ub = torch.as_tensor(np.asarray(nlp.ub, dtype=np.float64), device=dev)

    kind = _linear_kind(opt)
    lin = _linear_solve_refined if kind == "refined_f32" else _linear_solve_lu
    # the Armijo fan: alpha_k = backtrack**k, k = 0..max_backtracks
    alphas = torch.tensor([opt.backtrack ** k for k in range(opt.max_backtracks + 1)],
                          dtype=F64, device=dev)
    eye = torch.eye(nlp.n, dtype=F64, device=dev) if opt.reg else None

    def clip(x):
        return torch.minimum(torch.maximum(x, lb), ub)

    def solver(params, x0=None):
        p = _params_on(params, dev)
        if not isinstance(x0, torch.Tensor):
            x0 = np.asarray(nlp.x0 if x0 is None else x0, dtype=np.float64)
        x = clip(torch.as_tensor(x0, dtype=F64, device=dev))

        def F(xx):
            return nlp.eq(xx, p)

        jac = torch.func.jacfwd(F)

        def merit(xx):
            r = F(xx)
            return 0.5 * torch.dot(r, r)

        merit_fan = torch.func.vmap(merit)
        it, err = 0, float("inf")
        errs = []
        err_t = torch.tensor(float("inf"), dtype=F64, device=dev)
        while err > opt.tol and it < opt.max_iter:
            r = F(x)
            J = jac(x)
            if eye is not None:
                J = J + opt.reg * eye
            dx = lin(J, -r)
            # guard non-finite steps (singular J): fall back to the gradient
            g = J.T @ r
            dx = torch.where(torch.isfinite(dx).all(), dx, -g)
            m0 = 0.5 * torch.dot(r, r)
            g_dx = torch.dot(g, dx)
            m_try = merit_fan(clip(x[None, :] + alphas[:, None] * dx[None, :]))
            # the reference's backtracking stops on `not (m > bound)`, so
            # a NaN merit stops it too
            ok = ~(m_try > m0 + opt.armijo_c * alphas * g_dx)
            # the first passing step; the smallest when none passes
            k = torch.where(ok.any(), torch.argmax(ok.to(torch.int8)),
                            torch.tensor(opt.max_backtracks, device=dev))
            x = clip(x + alphas[k] * dx)
            nan_guard("newton.iterate", x)
            it += 1
            err_t = torch.max(torch.abs(F(x)))
            err = float(err_t)  # the step's one host read
            errs.append(err)
        result = NewtonResult(
            x=x,
            converged=err_t <= opt.tol,
            iterations=torch.tensor(it, device=dev),
            max_residual=err_t,
        )
        if not trace:
            return result
        rec = np.full(opt.max_iter, errs[-1] if errs else np.inf)
        rec[:len(errs)] = errs
        return result, {"max_residual": torch.as_tensor(rec, device=dev)}

    return solver


def make_batched_newton_solver(nlp, options: Optional[NewtonOptions], lane_axes,
                               device=None):
    """The lane-batched counterpart of ``jax.vmap(make_newton_solver(nlp,
    options), in_axes=(lane_axes, 0))``, on ``device`` (``cuda`` unless
    given).  Returns ``solver(params, X0) -> NewtonResult`` where ``X0``
    is (T, n) (scaled, as ``nlp.x0``) and every params leaf whose
    ``lane_axes`` entry is 0 carries a leading T (``lane_axes`` has the
    params' tree, 0 or None at each leaf).  The result's ``x`` is (T, n) and
    ``converged``, ``iterations`` and ``max_residual`` are per lane.

    Each lane runs while its max residual is above ``tol`` and its
    iteration count below ``max_iter``; a finished lane keeps its x,
    count and residual.  Each active lane takes the first passing step of
    its own Armijo fan (the smallest when none passes) and falls back to
    -J'r when its Newton step is not finite.  The loop reads the device
    once per step: whether any lane is still active."""
    opt = options or NewtonOptions()
    dev = resolve_device(device)
    p0 = _params_on(nlp.default_params(), dev)
    n_eq = int(nlp.eq(torch.as_tensor(nlp.x0, dtype=F64, device=dev), p0).shape[-1])
    if n_eq != nlp.n:
        raise ValueError(
            f"square solver needs n_eq == n_var, got {n_eq} != {nlp.n} "
            "(use the IPM for non-square systems)"
        )
    lb = torch.as_tensor(np.asarray(nlp.lb, dtype=np.float64), device=dev)
    ub = torch.as_tensor(np.asarray(nlp.ub, dtype=np.float64), device=dev)
    lin = (_linear_solve_refined_b if _linear_kind(opt) == "refined_f32"
           else _linear_solve_lu_b)
    alphas = torch.tensor([opt.backtrack ** k for k in range(opt.max_backtracks + 1)],
                          dtype=F64, device=dev)
    eye = torch.eye(nlp.n, dtype=F64, device=dev) if opt.reg else None

    def clip(x):
        return torch.minimum(torch.maximum(x, lb), ub)

    def merit(x, p):
        r = nlp.eq(x, p)
        return 0.5 * torch.dot(r, r)

    def solver(params, X0):
        P = _params_on(params, dev)
        if not isinstance(X0, torch.Tensor):
            X0 = np.asarray(X0, dtype=np.float64)
        X = clip(torch.as_tensor(X0, dtype=F64, device=dev))
        T = X.shape[0]
        F = torch.func.vmap(nlp.eq, in_dims=(0, lane_axes))
        jac = torch.func.vmap(torch.func.jacfwd(nlp.eq), in_dims=(0, lane_axes))
        merit_fan = torch.func.vmap(torch.func.vmap(merit, in_dims=(0, None)),
                                    in_dims=(0, lane_axes))
        it = torch.zeros(T, dtype=torch.int64, device=dev)
        err = torch.full((T,), float("inf"), dtype=F64, device=dev)
        active = torch.full((T,), opt.max_iter > 0, device=dev)
        while bool(active.any()):  # the step's one host read
            r = F(X, P)
            J = jac(X, P)
            if eye is not None:
                J = J + opt.reg * eye
            dx = lin(J, -r)
            g = (J.transpose(-1, -2) @ r[..., None])[..., 0]
            dx = torch.where(torch.isfinite(dx).all(-1, keepdim=True), dx, -g)
            m0 = 0.5 * (r * r).sum(-1)
            g_dx = (g * dx).sum(-1)
            m_try = merit_fan(clip(X[:, None, :] + alphas[None, :, None] * dx[:, None, :]), P)
            ok = ~(m_try > m0[:, None] + opt.armijo_c * alphas[None, :] * g_dx[:, None])
            k = torch.where(ok.any(-1), torch.argmax(ok.to(torch.int8), -1),
                            torch.full_like(it, opt.max_backtracks))
            Xn = clip(X + alphas[k][:, None] * dx)
            nan_guard("newton.iterate", Xn)
            errn = F(Xn, P).abs().amax(-1)
            X = torch.where(active[:, None], Xn, X)
            err = torch.where(active, errn, err)
            it = it + active.to(it.dtype)
            active = (err > opt.tol) & (it < opt.max_iter)
        return NewtonResult(x=X, converged=err <= opt.tol, iterations=it, max_residual=err)

    return solver


def solve_square(nlp, params=None, x0=None,
                 options: Optional[NewtonOptions] = None, jit: bool = True,
                 device=None):
    """One-shot convenience wrapper on ``device`` (``cuda`` unless given).
    ``jit`` is accepted for parity with the JAX package and ignored."""
    params = nlp.default_params() if params is None else params
    solver = make_newton_solver(nlp, options, device=device)
    return solver(params) if x0 is None else solver(params, x0)
