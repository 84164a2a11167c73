"""Batched primal-dual interior-point NLP solver (counterpart of
``dispatches_tpu/solvers/ipm.py``).

Canonical form solved (inequalities get slacks):

    min f(x)  s.t.  c_eq(x) = 0,  c_ineq(x) + s = 0,  s >= 0,  lb <= x <= ub

Barrier + primal-dual Newton with the fraction-to-boundary rule, an
l1-merit backtracking fan, monotone (Fiacco-McCormick) barrier reduction,
IPOPT-style scaled KKT error for termination, best-iterate certification
and a multiplier polish — the JAX package's algorithm step for step, in
float64.

Derivatives come from ``torch.func`` in reverse mode (``grad``,
``jacrev``, ``vjp``; Jacobian-vector products by ``structured.jvp_fn``),
where the JAX package takes ``jacfwd``/``hessian``/``jvp``: same values,
and forward mode is the slow path in torch.  The KKT system is solved
either by dense Cholesky condensation with an inertia-correction ladder
or, for time-structured models, by the bordered block-tridiagonal
elimination of ``solvers/structured.py``.  An NLP that declares
``affine = True`` (the market's dispatch LP) has a zero Hessian: the dense
path then divides by the diagonal H and forms the Schur complement from
J's sparse form when J is large and sparse.

Batching: the JAX package maps one scenario's solve over a batch with
``jax.vmap``.  Here ``solve`` takes the batch itself — a params leaf with
one leading axis more than its ``default_params()`` counterpart is a lane
axis — and carries per-lane state.  The Newton loop is a host loop that
reads ``any(active)`` once per iteration; lanes that finished are frozen
with ``torch.where``, exactly as a vmapped ``while_loop`` freezes them, so
per-lane iterations match the JAX package's.  The inertia ladders and the
multiplier refresh (a ``lax.cond`` that vmap turns into a select) run only
when some active lane needs them, one host read each.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from dispatches_tpu_torch import resolve_device
from dispatches_tpu_torch.analysis.runtime import nan_guard
from dispatches_tpu_torch.solvers.pdlp import _lane_axes, _params_on, resolve_pdlp_precision
from dispatches_tpu_torch.solvers.structured import (
    detect_time_structure,
    jvp_fn,
    make_structured_kkt,
)

F64 = torch.float64
# conjugate-gradient products take J explicitly (one batched reverse pass,
# then two batched matmuls per step) while B*m*n doubles stay within this
# budget (1 GiB); beyond it (annual horizons) they replay the VJP/JVP
# graphs each step, as the JAX package always does
_J_BUDGET = 1 << 27


class IPMOptions(NamedTuple):
    tol: float = 1e-8
    max_iter: int = 100
    mu_init: float = 1e-1
    mu_min_factor: float = 0.1  # mu floor = tol * factor
    kappa_mu: float = 0.2
    theta_mu: float = 1.5
    kappa_eps: float = 10.0
    tau_min: float = 0.99
    bound_push: float = 1e-2
    delta_w: float = 1e-8  # primal (Hessian) regularization
    delta_c: float = 1e-8  # dual (constraint) regularization
    n_linesearch: int = 14  # candidate fan size, alpha * 0.6**k
    obj_scale: float = 1.0
    ls_armijo: float = 1e-6
    kappa_sigma: float = 1e10  # dual safeguard clamp
    # IPOPT-style acceptable termination: stop after `acceptable_iter`
    # consecutive iterations at `acceptable_tol`
    acceptable_tol: float = 1e-5
    acceptable_iter: int = 10
    autoscale: bool = True  # gradient-based constraint/objective scaling
    # KKT factorization: "dense" (Cholesky condensation), "structured"
    # (bordered block-tridiagonal over the time axis), or "auto"
    # (structured when time structure is detected and n + m_ineq >= 256)
    kkt: str = "auto"
    # exit after this many iterations without improving the best mu=0
    # KKT error (0 disables); the best iterate is what gets reported
    noimp_exit: int = 60
    # precision policy of the condensation products (PDLPOptions'
    # vocabulary, resolved through resolve_pdlp_precision so
    # DISPATCHES_TPU_PDLP_PRECISION applies).  The IPM runs in float64,
    # where torch's products have one precision, so every tier computes
    # the same condensation here, as the JAX package does off the TPU.
    precision: Optional[str] = None


class IPMResult(NamedTuple):
    # primal solution in the SCALED decision space (nlp.unravel(res.x)
    # gives the physical per-variable dict).  solve()'s x0 is PHYSICAL:
    # feed res.x_phys (never res.x) back as a warm start.
    x: torch.Tensor
    x_phys: torch.Tensor  # x * var_scale: safe to feed back as x0
    slacks: torch.Tensor
    lam: torch.Tensor  # equality+inequality multipliers
    z_l: torch.Tensor
    z_u: torch.Tensor
    obj: torch.Tensor  # objective in the user's declared sense
    kkt_error: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor
    # 0 = optimal (strict tol), 1 = acceptable (acceptable_tol), 2 = not
    # converged — IPOPT's status triple
    status: torch.Tensor


def _make_funcs(nlp, r_eq=None, r_in=None):
    """Wrap a CompiledNLP into (f, C) over the slack-augmented vector y.
    ``r_eq``/``r_in`` are constant row-scaling vectors applied to the
    constraint residuals (slacks live in the scaled inequality units)."""
    n_x, m_eq, m_in = nlp.n, nlp.m_eq, nlp.m_ineq

    def fobj(y, p):
        return nlp.objective(y[:n_x], p)

    def cons(y, p):
        x = y[:n_x]
        parts = []
        if m_eq:
            e = nlp.eq(x, p)
            parts.append(e if r_eq is None else e * r_eq)
        if m_in:
            i = nlp.ineq(x, p)
            parts.append((i if r_in is None else i * r_in) + y[n_x:])
        if not parts:
            return y.new_zeros((0,))
        return torch.cat(parts)

    return fobj, cons


def _cg(Aop, b, x0, maxiter, tol, active):
    """Conjugate gradients on a batch of SPD systems, lane by lane: the
    JAX package's ``jax.scipy.sparse.linalg.cg`` (stop when
    r'r <= tol^2 b'b or after ``maxiter`` steps) under vmap, where a
    finished lane is frozen while the others go on.  Lanes outside
    ``active`` are frozen from the start."""
    atol2 = tol * tol * (b * b).sum(-1)
    x = x0
    r = b - Aop(x0)
    p = r
    gamma = (r * r).sum(-1)
    run = active & (gamma > atol2)
    k = 0
    while k < maxiter:
        # one host read per 8 steps: a step on frozen lanes changes nothing
        if k % 8 == 0 and not bool(run.any()):
            break
        Ap = Aop(p)
        alpha = gamma / (p * Ap).sum(-1)
        x_ = x + alpha[:, None] * p
        r_ = r - alpha[:, None] * Ap
        gamma_ = (r_ * r_).sum(-1)
        p_ = r_ + (gamma_ / gamma)[:, None] * p
        rc = run[:, None]
        x, r, p = torch.where(rc, x_, x), torch.where(rc, r_, r), torch.where(rc, p_, p)
        gamma = torch.where(run, gamma_, gamma)
        k += 1
        run = run & (gamma > atol2)
    return x


def _cholesky(A):
    """Lower Cholesky factor with NaN where the factorization failed, as
    ``jnp.linalg.cholesky`` returns it (torch's raises instead)."""
    L, info = torch.linalg.cholesky_ex(A)
    ok = (info == 0) & torch.isfinite(L).flatten(-2).all(-1)
    return torch.where(ok[..., None, None], L, torch.nan), ok


def _kkt_solve(W, Sigma, J, r1, c, delta_w, delta_c, active=None):
    """Solve [[W + diag(Sigma), J^T], [J, -delta_c*I]] [dy, dlam] = [-r1, -c]
    lane by lane (leading lane axis on every argument) by Cholesky
    condensation: dy from H = W + diag(Sigma) + dw*I, dlam from the Schur
    complement S = J H^-1 J^T + delta_c.  H is made positive definite by
    an escalating inertia-correction ladder (dw = delta_w, then 100x per
    try, at most 12 tries, ~1e16 at the end) for the lanes in ``active``
    (default all); a lane whose ladder never yields a factor gets NaN
    directions, which the step rejects."""
    B, m = W.shape[0], J.shape[1]
    active = torch.ones(B, dtype=torch.bool, device=W.device) if active is None else active

    def chol_H(dw):
        return _cholesky(W + torch.diag_embed(Sigma + dw[:, None]))

    dw = torch.full((B,), delta_w, dtype=W.dtype, device=W.device)
    L_H, ok = chol_H(dw)
    need = ~ok & active
    tries = 0
    while tries < 12 and bool(need.any()):
        dw = torch.where(need, dw * 100.0, dw)
        L2, ok2 = chol_H(dw)
        L_H = torch.where(need[:, None, None], L2, L_H)
        ok = torch.where(need, ok2, ok)
        need = ~ok & active
        tries += 1

    if m:
        X = torch.cholesky_solve(J.transpose(1, 2), L_H)
        S = J @ X + delta_c * torch.eye(m, dtype=W.dtype, device=W.device)
        L_S, _ = _cholesky(S)
        t = torch.cholesky_solve(r1[..., None], L_H)
        dlam = torch.cholesky_solve(c[..., None] - J @ t, L_S)
        dy = -torch.cholesky_solve(r1[..., None] + J.transpose(1, 2) @ dlam, L_H)
        return dy[..., 0], dlam[..., 0]
    dy = -torch.cholesky_solve(r1[..., None], L_H)[..., 0]
    return dy, W.new_zeros((B, 0))


# a J with at least this many entries, under 5% of them nonzero, forms
# J H^-1 J^T as a sparse-sparse product; smaller or denser ones use the
# dense matmul
_SPARSE_SCHUR_MIN = 1 << 24


def _schur_diag(J, h=None):
    """``J diag(1/h) J^T`` per lane (``J J^T`` when ``h`` is None).  A
    large, sparse J goes through its sparse form: the dispatch LP's J
    (26,112 x 40,704 at the market's day-ahead size) holds ~0.3% nonzeros,
    where the dense product is 5.5e13 FLOP per Newton step (on an H100,
    ``chip_smoke.py``'s DA LP took 1.10 s per Newton step with it, 0.32 s
    this way).  Only the order in which the nonzero products are summed
    differs."""
    B, m, n = J.shape
    if m * n >= _SPARSE_SCHUR_MIN and int(torch.count_nonzero(J)) < 0.05 * J.numel():
        out = []
        with warnings.catch_warnings():  # torch calls its sparse support beta
            warnings.simplefilter("ignore", UserWarning)
            for i in range(B):
                coo = J[i].to_sparse_coo()
                r, c = coo.indices()
                v = coo.values()
                A = torch.sparse_coo_tensor(torch.stack([r, c]), v, (m, n),
                                            is_coalesced=True).to_sparse_csr()
                vt = v if h is None else v / h[i][c]
                At = torch.sparse_coo_tensor(torch.stack([c, r]), vt,
                                             (n, m)).coalesce().to_sparse_csr()
                out.append(torch.sparse.mm(A, At).to_dense())
        return torch.stack(out)
    if h is None:
        return J @ J.transpose(1, 2)
    return J @ (J.transpose(1, 2) / h[..., None])


def _kkt_solve_diag(Sigma, J, r1, c, delta_w, delta_c):
    """:func:`_kkt_solve` for an affine NLP, where W = 0 exactly: then H =
    diag(Sigma) + delta_w*I is diagonal and positive (Sigma >= 0), its
    Cholesky factor never fails, and every solve with it is a division.
    The Schur complement S = J H^-1 J^T + delta_c is formed and factored
    as there.  Skips the n x n Hessian and its factorization, which at
    the market's day-ahead size (n ~ 40,000 with slacks) is most of the
    memory and time of a Newton step."""
    h = Sigma + delta_w  # (B, n)
    if J.shape[1]:
        S = _schur_diag(J, h)
        S.diagonal(dim1=-2, dim2=-1).add_(delta_c)
        L_S, _ = _cholesky(S)
        del S
        t = r1 / h
        dlam = torch.cholesky_solve((c - (J @ t[..., None])[..., 0])[..., None], L_S)
        dy = -(r1 + (J.transpose(1, 2) @ dlam)[..., 0]) / h
        return dy, dlam[..., 0]
    return -r1 / h, r1.new_zeros((r1.shape[0], 0))


def _rows_chunked(make, rows):
    """``make(chunk_size)`` builds a row-by-row Jacobian callable
    (``torch.func.jacrev``'s ``chunk_size``).  The call first runs with
    every row at once (``None``), as before; when the card runs out of
    memory it retries with half the rows per chunk, down to one, and
    keeps the chunk that fitted.  Chunking changes which rows share a
    pass, not any value."""
    state = {"chunk": None}

    def call(*args):
        while True:
            try:
                return make(state["chunk"])(*args)
            except torch.cuda.OutOfMemoryError:
                cur = state["chunk"] or rows
                if cur <= 1:
                    raise
                state["chunk"] = (cur + 1) // 2
                torch.cuda.empty_cache()

    return call


def make_ipm_solver(nlp, options: Optional[IPMOptions] = None, scale_params=None,
                    trace: bool = False, device=None):
    """Build ``solve(params, x0=None, lam0=None) -> IPMResult`` for one
    CompiledNLP on ``device`` (``cuda`` unless given), in float64.

    ``params`` follows ``nlp.default_params()``; leaves with one extra
    leading axis are scenario lanes, and the result's fields then carry
    that axis.  ``x0`` (physical, like ``IPMResult.x_phys``) and ``lam0``
    may be one vector for every lane or one row per lane.

    ``scale_params``: representative params for the build-time autoscaling
    probe (defaults to ``nlp.default_params()``).

    ``trace=True`` returns ``(IPMResult, trace_dict)`` where ``trace_dict``
    holds per-iteration ``mu``/``kkt_error``/``alpha``/``stall`` arrays of
    length ``max_iter`` (entries past ``iterations`` repeat the final
    state)."""
    opts = options or IPMOptions()
    dev = resolve_device(device)
    resolve_pdlp_precision(opts.precision)  # same validation and env rule
    n_x, m_eq, m_in = nlp.n, nlp.m_eq, nlp.m_ineq
    n = n_x + m_in
    m = m_eq + m_in

    def t64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)

    # Gradient-based automatic row scaling (IPOPT's default
    # nlp_scaling_method): each constraint's largest Jacobian entry at x0
    # becomes <= 1, the objective gradient <= 100.  Computed once here.
    r_eq = np.ones(m_eq)
    r_in = np.ones(m_in)
    obj_auto = 1.0
    if opts.autoscale and n_x:
        p0 = _params_on(scale_params if scale_params is not None
                        else nlp.default_params(), dev)
        x0_ = t64(nlp.x0)

        def _row_maxes(fn, m_rows):
            """max_j |J_ij| per row, J computed in column chunks (a one-
            shot dense Jacobian at annual horizons does not fit)."""
            rows = np.zeros(m_rows)
            chunk = max(1, min(n_x, int(2_000_000 // max(m_rows, 1)) or 1,
                               int(2_000_000 // max(n_x, 1)) or 1))
            jac_cols = torch.func.vmap(jvp_fn(fn, x0_))
            for s in range(0, n_x, chunk):
                k = min(chunk, n_x - s)
                basis = torch.zeros((k, n_x), dtype=F64, device=dev)
                basis[torch.arange(k), s + torch.arange(k)] = 1.0
                cols = jac_cols(basis).cpu().numpy()
                rows = np.maximum(rows, np.max(np.abs(cols), axis=0))
            return rows

        if m_eq:
            rows = _row_maxes(lambda x: nlp.eq(x, p0), m_eq)
            r_eq = 1.0 / np.maximum(1.0, np.where(np.isfinite(rows), rows, 1.0))
        if m_in:
            rows = _row_maxes(lambda x: nlp.ineq(x, p0), m_in)
            r_in = 1.0 / np.maximum(1.0, np.where(np.isfinite(rows), rows, 1.0))
        g0 = torch.func.grad(lambda x: nlp.objective(x, p0))(x0_).cpu().numpy()
        gmax = float(np.max(np.abs(g0))) if g0.size else 0.0
        if np.isfinite(gmax) and gmax > 100.0:
            obj_auto = 100.0 / gmax

    L = np.concatenate([nlp.lb, np.zeros(m_in)])
    U = np.concatenate([nlp.ub, np.full(m_in, math.inf)])
    has_lb_np = np.isfinite(L)
    has_ub_np = np.isfinite(U)
    # fixed-via-equal-bounds would make the barrier singular; the
    # Flowsheet moves fixed vars into params instead
    if np.any((U - L) <= 0):
        raise ValueError("empty or degenerate variable bounds (use Flowsheet.fix)")
    has_lb = torch.as_tensor(has_lb_np, device=dev)
    has_ub = torch.as_tensor(has_ub_np, device=dev)
    L_s = t64(np.where(has_lb_np, L, 0.0))  # safe values for arithmetic
    U_s = t64(np.where(has_ub_np, U, 0.0))
    r_in_t = t64(r_in)
    var_scale = t64(nlp.var_scale)

    fobj_raw, cons = _make_funcs(nlp, t64(r_eq), r_in_t)
    scale_f = opts.obj_scale * obj_auto

    def fobj(y, p):
        return fobj_raw(y, p) * scale_f

    def lagrangian(y, p, lam):
        return fobj(y, p) + (cons(y, p) @ lam if m else 0.0)

    eps = 1e-12

    def barrier1(y, mu):
        dL = torch.where(has_lb, y - L_s, 1.0)
        dU = torch.where(has_ub, U_s - y, 1.0)
        terms = torch.where(has_lb, -torch.log(torch.clamp(dL, min=eps)), 0.0) \
            + torch.where(has_ub, -torch.log(torch.clamp(dU, min=eps)), 0.0)
        return mu * terms.sum()

    def merit1(y, p, mu, nu):
        cv = cons(y, p)
        return fobj(y, p) + barrier1(y, mu) + nu * (cv.abs().sum() if m else 0.0)

    # --- KKT strategy selection --------------------------------------
    # size-gate before probing: detection runs several JVP/HVPs, wasted
    # on small models where the dense path wins anyway
    ts = None
    if opts.kkt == "structured" or (opts.kkt == "auto" and n >= 256):
        ts = detect_time_structure(nlp, device=dev)
    structured_solve = make_structured_kkt(ts, n, m, device=dev) if ts is not None else None
    # an NLP that declares itself affine (objective and constraints affine
    # in x, e.g. the market's dispatch LP) has a Lagrangian Hessian of
    # exactly zero: the dense path then skips forming and factoring it
    affine = bool(getattr(nlp, "affine", False))
    mu_floor = opts.tol * opts.mu_min_factor
    ls_pows = torch.tensor(0.6, dtype=F64, device=dev) ** torch.arange(
        opts.n_linesearch, dtype=F64, device=dev)

    def lanes(axes):
        """The per-scenario callables mapped over lanes for one params
        layout (``axes`` from ``_lane_axes``)."""
        def vm(fn, extra=0):
            return torch.func.vmap(fn, in_dims=(0, axes) + (0,) * extra)

        lag_grad1 = torch.func.grad(lagrangian)
        return {
            "grad_f": vm(torch.func.grad(fobj)),
            "cons": vm(cons),
            "ineq": vm(nlp.ineq),
            "jac_c": _rows_chunked(
                lambda k: vm(torch.func.jacrev(cons, chunk_size=k)), m),
            "hess_l": _rows_chunked(
                lambda k: vm(torch.func.jacrev(lag_grad1, chunk_size=k), 1), n),
            "lag_grad": vm(lag_grad1, 1),
            "merit": vm(merit1, 2),
            "merit_fan": torch.func.vmap(
                torch.func.vmap(merit1, in_dims=(0, None, None, None)),
                in_dims=(0, axes, 0, 0)),
            "user_obj": vm(nlp.user_objective),
        }

    def _cons_vjp(F, y, P):
        """``(c, jt, vjp_c)``: the constraints at ``y``, ``v -> J(y)' v`` by
        one VJP graph replayed per ``v`` (never materializes J), and that
        VJP itself."""
        if not m:
            return y.new_zeros((y.shape[0], 0)), torch.zeros_like, None
        c, vjp_c = torch.func.vjp(lambda Y: F["cons"](Y, P), y)
        return c, lambda v: vjp_c(v)[0], vjp_c

    def _cg_products(F, y, P):
        """``(jt, jv)``: v -> J'v and v -> J v at ``y`` for the CG
        solves, explicit or matrix-free per ``_J_BUDGET``."""
        if y.shape[0] * m * n <= _J_BUDGET:
            J = F["jac_c"](y, P)
            return ((lambda w: (J.transpose(1, 2) @ w[..., None])[..., 0]),
                    (lambda v: (J @ v[..., None])[..., 0]))
        _, jt, _ = _cons_vjp(F, y, P)
        return jt, jvp_fn(lambda Y: F["cons"](Y, P), y)

    def _dists(y):
        return (torch.where(has_lb, y - L_s, 1.0), torch.where(has_ub, U_s - y, 1.0))

    def _kkt_error(F, y, P, lam, z_l, z_u, mu, pre=None):
        """Scaled KKT error per lane; pass precomputed ``(g, J^T lam, c)``
        at ``y`` to reuse evaluations.  ``mu`` is (B,) or 0.0."""
        if pre is None:
            c, jt, _ = _cons_vjp(F, y, P)
            pre = (F["grad_f"](y, P), jt(lam) if m else torch.zeros_like(y), c)
        g, jtlam, c = pre
        dL, dU = _dists(y)
        mu_ = mu[:, None] if isinstance(mu, torch.Tensor) else mu
        r_d = g + jtlam - z_l + z_u
        comp_l = torch.where(has_lb, dL * z_l - mu_, 0.0)
        comp_u = torch.where(has_ub, dU * z_u - mu_, 0.0)
        s_max = 100.0
        z_sum = z_l.abs().sum(-1) + z_u.abs().sum(-1)
        s_d = torch.clamp((lam.abs().sum(-1) + z_sum) / max(m + 2 * n, 1), min=s_max) / s_max
        s_c = torch.clamp(z_sum / max(2 * n, 1), min=s_max) / s_max
        zero = y.new_zeros(y.shape[0])
        e_d = r_d.abs().amax(-1) / s_d if n else zero
        e_p = c.abs().amax(-1) if m else zero
        e_c = torch.maximum(comp_l.abs().amax(-1), comp_u.abs().amax(-1)) / s_c if n else zero
        return torch.maximum(torch.maximum(e_d, e_p), e_c)

    def _lsq_multipliers(F, y, P, g, need):
        """Least-squares multiplier estimate (J J^T + d I) lam = -J g with
        a zero fallback on non-finite results: dense Cholesky, or (on the
        structured path, where J J^T does not fit at annual horizons)
        matrix-free CG with jvp/vjp products.  Lanes outside ``need``
        come back unspecified."""
        if structured_solve is not None:
            jt, jv = _cg_products(F, y, P)

            def Aop(w):
                return jv(jt(w)) + 1e-8 * w

            Jg = jv(g)
            lam_ls = _cg(Aop, -Jg, torch.zeros_like(Jg), 100, 1e-12, need)
            ok = torch.isfinite(lam_ls).all(-1)
        else:
            J = F["jac_c"](y, P)
            A = _schur_diag(J) + 1e-8 * torch.eye(m, dtype=F64, device=dev)
            L_A, _ = _cholesky(A)
            lam_ls = torch.cholesky_solve(-(J @ g[..., None]), L_A)[..., 0]
            ok = torch.isfinite(lam_ls).all(-1)
        return torch.where(ok[:, None], lam_ls, 0.0)

    def _structured_step(F, y, P, lam, Sigma, r1, c, c_vjp, active):
        """Direction from the structured KKT with its own ladder: the LU
        has no inertia information, so a direction is accepted only with
        positive curvature dy' (W + Sigma + dw) dy > 0 (W dy by one HVP);
        else 100x more regularization, at most 10 tries; a lane that
        never passes takes a zero (rejected) step.  ``c_vjp`` is the
        constraints' VJP at ``y``; it and the W products are built once
        and shared by every try."""
        def cons_y(Y):
            return F["cons"](Y, P)

        def lag_grad_fn(Y):
            return F["lag_grad"](Y, P, lam)

        hvp = jvp_fn(lag_grad_fn, y)  # W v

        def attempt(dw):
            dy_, dlam_, ok_ = structured_solve(
                cons_y, lag_grad_fn, y, Sigma, r1, c, dw, opts.delta_c,
                cons_vjp=(c, c_vjp), lag_jvp=hvp)
            w_dy = hvp(dy_)
            curv = (dy_ * w_dy).sum(-1) + ((Sigma + dw[:, None]) * dy_ * dy_).sum(-1)
            return dy_, dlam_, ok_ & (curv >= 1e-10 * (dy_ * dy_).sum(-1))

        dw = torch.full((y.shape[0],), opts.delta_w, dtype=F64, device=dev)
        dy, dlam, ok = attempt(dw)
        need = ~ok & active
        tries = 0
        while tries < 10 and bool(need.any()):
            dw = torch.where(need, dw * 100.0, dw)
            dy2, dlam2, ok2 = attempt(dw)
            dy = torch.where(need[:, None], dy2, dy)
            dlam = torch.where(need[:, None], dlam2, dlam)
            ok = torch.where(need, ok2, ok)
            need = ~ok & active
            tries += 1
        return torch.where(ok[:, None], dy, 0.0), torch.where(ok[:, None], dlam, 0.0)

    def step(F, s, P, active, at_y=None):
        """One Newton iteration on every lane.  Returns the new state and
        ``(g, c, jt, vjp)`` at the new iterate: the next step's ``at_y``,
        valid on the lanes that stay active (there y is the new iterate)."""
        y, lam, z_l, z_u, mu = s["y"], s["lam"], s["z_l"], s["z_u"], s["mu"]
        mu_ = mu[:, None]
        dL, dU = _dists(y)
        dLc, dUc = torch.clamp(dL, min=eps), torch.clamp(dU, min=eps)

        g, c, jt, c_vjp = at_y or (F["grad_f"](y, P), *_cons_vjp(F, y, P))
        jtlam = jt(lam)

        sig_l = torch.where(has_lb, z_l / dLc, 0.0)
        sig_u = torch.where(has_ub, z_u / dUc, 0.0)
        Sigma = sig_l + sig_u

        r1 = g + jtlam
        r1 = r1 - torch.where(has_lb, mu_ / dLc, 0.0)
        r1 = r1 + torch.where(has_ub, mu_ / dUc, 0.0)

        if structured_solve is not None:
            dy, dlam = _structured_step(F, y, P, lam, Sigma, r1, c, c_vjp, active)
        elif affine:
            dy, dlam = _kkt_solve_diag(Sigma, F["jac_c"](y, P), r1, c,
                                       opts.delta_w, opts.delta_c)
        else:
            J = F["jac_c"](y, P)
            W = F["hess_l"](y, P, lam)
            dy, dlam = _kkt_solve(W, Sigma, J, r1, c, opts.delta_w, opts.delta_c, active)

        dz_l = torch.where(has_lb, mu_ / dLc - z_l - sig_l * dy, 0.0)
        dz_u = torch.where(has_ub, mu_ / dUc - z_u + sig_u * dy, 0.0)

        # fraction-to-boundary step bounds
        tau = torch.clamp(1.0 - mu, min=opts.tau_min)[:, None]

        def _max_alpha(d, dist, active_b):
            # max alpha s.t. dist + alpha*d >= (1-tau)*dist, active bounds
            shrink = torch.where(active_b & (d < 0),
                                 -tau * dist / torch.clamp(d, max=-eps), math.inf)
            return torch.clamp(shrink.amin(-1) if n else shrink.new_full(
                (shrink.shape[0],), math.inf), max=1.0)

        alpha_p_max = torch.minimum(_max_alpha(dy, dL, has_lb), _max_alpha(-dy, dU, has_ub))

        # per-element dual steps: each bound multiplier only has to stay
        # positive, so each takes its own fraction-to-boundary length
        def _alpha_vec(z, dz, active_b):
            neg = active_b & (dz < 0)
            return torch.clamp(torch.where(neg, -tau * z / torch.clamp(dz, max=-eps), 1.0),
                               max=1.0)

        alpha_zl = _alpha_vec(z_l, dz_l, has_lb)
        alpha_zu = _alpha_vec(z_u, dz_u, has_ub)

        # l1 merit with barrier; parallel backtracking fan
        nu = 10.0 * (1.0 + (lam.abs().amax(-1).clamp(min=0.0) if m
                            else y.new_zeros(y.shape[0])))
        phi0 = F["merit"](y, P, mu, nu)
        dphi = (g * dy).sum(-1) - torch.where(has_lb, mu_ / dLc * dy, 0.0).sum(-1) \
            + torch.where(has_ub, mu_ / dUc * dy, 0.0).sum(-1) \
            - nu * (c.abs().sum(-1) if m else 0.0)
        alphas = alpha_p_max[:, None] * ls_pows  # (B, n_ls)
        phis = F["merit_fan"](y[:, None, :] + alphas[..., None] * dy[:, None, :], P, mu, nu)
        # machine-precision slack: near a solution phi(y+a dy) equals phi0
        # up to rounding, and without it every candidate is rejected
        slack = 1e-13 * (1.0 + phi0.abs())
        ok = (phis <= phi0[:, None]
              + opts.ls_armijo * alphas * torch.clamp(dphi, max=0.0)[:, None]
              + slack[:, None]) & torch.isfinite(phis)
        # the largest admissible alpha (first True along the decreasing
        # fan); else the smallest trial
        idx = torch.argmax(ok.to(torch.uint8), dim=-1)
        alpha = torch.where(ok.any(-1), alphas.gather(1, idx[:, None])[:, 0], alphas[:, -1])

        z_l_new = z_l + alpha_zl * dz_l
        z_u_new = z_u + alpha_zu * dz_u

        # KKT-error-reduction acceptance: if the full step strictly
        # reduces the scaled KKT error, take it over the merit choice
        err_cur = _kkt_error(F, y, P, lam, z_l, z_u, mu, pre=(g, jtlam, c))
        y_full = y + alpha_p_max[:, None] * dy
        lam_full = lam + alpha_p_max[:, None] * dlam
        err_full = _kkt_error(F, y_full, P, lam_full, z_l_new, z_u_new, mu)
        take_full = torch.isfinite(err_full) & (err_full <= 0.9 * err_cur)
        alpha = torch.where(take_full, alpha_p_max, alpha)

        y_new = y + alpha[:, None] * dy
        lam_new = lam + alpha[:, None] * dlam

        # IPOPT kappa_sigma safeguard: keep z compatible with mu/dist
        dLn, dUn = _dists(y_new)
        dLn, dUn = torch.clamp(dLn, min=eps), torch.clamp(dUn, min=eps)
        ks = opts.kappa_sigma
        z_l_new = torch.where(has_lb, torch.clamp(
            z_l_new, min=mu_ / (ks * dLn), max=ks * mu_ / dLn), 0.0)
        z_u_new = torch.where(has_ub, torch.clamp(
            z_u_new, min=mu_ / (ks * dUn), max=ks * mu_ / dUn), 0.0)

        # reject steps that went non-finite (keep the previous iterate)
        good = (torch.isfinite(y_new).all(-1) & torch.isfinite(lam_new).all(-1)
                & torch.isfinite(z_l_new).all(-1) & torch.isfinite(z_u_new).all(-1))[:, None]
        y_new = torch.where(good, y_new, y)
        lam_new = torch.where(good, lam_new, lam)
        z_l_new = torch.where(good, z_l_new, z_l)
        z_u_new = torch.where(good, z_u_new, z_u)

        # one gradient/VJP/constraint evaluation at y_new serves the
        # barrier test and the stall check
        g_new = F["grad_f"](y_new, P)
        c_new, jt_new, c_vjp_new = _cons_vjp(F, y_new, P)
        pre_new = (g_new, jt_new(lam_new), c_new)

        # barrier update (monotone), at most 100x per step
        err_mu = _kkt_error(F, y_new, P, lam_new, z_l_new, z_u_new, mu, pre=pre_new)
        shrink = err_mu <= opts.kappa_eps * mu
        mu_tgt = torch.minimum(opts.kappa_mu * mu, mu ** opts.theta_mu)
        mu_new = torch.where(
            shrink, torch.clamp(torch.maximum(mu_tgt, 0.01 * mu), min=mu_floor), mu)

        # stall detection + multiplier refresh: on 8 stagnant iterations
        # re-estimate lam by least squares and reset z to mu/dist (the
        # counter resets whenever mu moved: err_prev was taken at the old
        # mu)
        err_chk = _kkt_error(F, y_new, P, lam_new, z_l_new, z_u_new, mu_new, pre=pre_new)
        improved = err_chk < 0.9999 * s["err_prev"]
        stall = torch.where(improved | (mu_new != mu), 0, s["stall"] + 1)
        do_reset = stall >= 8
        refreshed = m and bool((do_reset & active).any())
        if refreshed:
            lam_ref = _lsq_multipliers(F, y_new, P, g_new, do_reset & active)
            lam_new = torch.where(do_reset[:, None], lam_ref, lam_new)
        dLr, dUr = _dists(y_new)
        mu_n = mu_new[:, None]
        z_l_new = torch.where(do_reset[:, None] & has_lb,
                              mu_n / torch.clamp(dLr, min=eps), z_l_new)
        z_u_new = torch.where(do_reset[:, None] & has_ub,
                              mu_n / torch.clamp(dUr, min=eps), z_u_new)
        stall = torch.where(do_reset, 0, stall)

        # lam_new may have just been refreshed: then re-derive J^T lam
        err0 = _kkt_error(F, y_new, P, lam_new, z_l_new, z_u_new, 0.0,
                          pre=(g_new, jt_new(lam_new), c_new) if refreshed else pre_new)
        acc = torch.where(err0 <= opts.acceptable_tol, s["acc"] + 1, 0)

        better = err0 < s["err_best"]
        bc = better[:, None]
        # the mu=0 error legitimately worsens during the barrier phase, so
        # the no-improvement exit arms only in the endgame (mu at floor)
        endgame = mu_new <= max(mu_floor * 100.0, opts.tol)
        noimp = torch.where(better | ~endgame, 0, s["noimp"] + 1)

        done = (err0 <= opts.tol) | (acc >= opts.acceptable_iter)
        if opts.noimp_exit:
            done = done | (noimp >= opts.noimp_exit)

        nan_guard("ipm.iterate", y_new, lam_new)
        return {
            "y": y_new, "lam": lam_new, "z_l": z_l_new, "z_u": z_u_new, "mu": mu_new,
            "it": s["it"] + 1, "done": done, "acc": acc, "err_prev": err_chk,
            "stall": stall, "alpha_last": alpha,
            "y_best": torch.where(bc, y_new, s["y_best"]),
            "lam_best": torch.where(bc, lam_new, s["lam_best"]),
            "z_l_best": torch.where(bc, z_l_new, s["z_l_best"]),
            "z_u_best": torch.where(bc, z_u_new, s["z_u_best"]),
            "err_best": torch.where(better, err0, s["err_best"]),
            "noimp": noimp,
        }, (g_new, c_new, jt_new, c_vjp_new)

    def _push(v, lo, hi, has_lo, has_hi):
        """Push the primal point strictly inside its bounds (IPOPT
        bound_push); an empty pushed corridor takes the midpoint."""
        kappa = opts.bound_push
        p_lo = torch.where(has_lo, lo + kappa * torch.clamp(lo.abs(), min=1.0), -math.inf)
        p_hi = torch.where(has_hi, hi - kappa * torch.clamp(hi.abs(), min=1.0), math.inf)
        mid = 0.5 * (torch.where(has_lo, lo, 0.0) + torch.where(has_hi, hi, 0.0))
        v2 = torch.minimum(torch.maximum(v, p_lo), p_hi)
        return torch.where(has_lo & has_hi & (p_lo > p_hi), mid, v2)

    def _lanes_of(t, B):
        t = torch.as_tensor(t, device=dev).to(F64)
        return t.expand(B, t.shape[-1]) if t.ndim == 1 else t

    def solve(params, x0=None, lam0=None):
        P = _params_on(params, dev)
        axes, B = _lane_axes(nlp, P)
        if B is None:  # no batched leaf: the starts may still carry lanes
            rows = [torch.as_tensor(v).shape[0] for v in (x0, lam0)
                    if v is not None and torch.as_tensor(v).ndim == 2]
            B = rows[0] if rows else None
        batched = B is not None
        B = B or 1
        F = lanes(axes)

        # user-facing x0 is PHYSICAL; the decision vector is scaled by
        # nlp.var_scale, and IPMResult.x is in that scaled space
        x_init = _lanes_of(t64(nlp.x0) if x0 is None
                           else torch.as_tensor(x0, device=dev).to(F64) / var_scale, B)
        x_in = _push(x_init, L_s[:n_x], U_s[:n_x], has_lb[:n_x], has_ub[:n_x])
        if m_in:
            s0 = torch.clamp(-F["ineq"](x_in, P) * r_in_t, min=opts.bound_push)
        else:
            s0 = x_in.new_zeros((B, 0))
        y0 = torch.cat([x_in, s0], dim=1)

        mu0 = torch.full((B,), opts.mu_init, dtype=F64, device=dev)
        dL0, dU0 = _dists(y0)
        z_l0 = torch.where(has_lb, mu0[:, None] / torch.clamp(dL0, min=eps), 0.0)
        z_u0 = torch.where(has_ub, mu0[:, None] / torch.clamp(dU0, min=eps), 0.0)
        all_lanes = torch.ones(B, dtype=torch.bool, device=dev)

        if lam0 is None and m:
            lam_init = _lsq_multipliers(F, y0, P, F["grad_f"](y0, P), all_lanes)
        elif lam0 is None:
            lam_init = y0.new_zeros((B, 0))
        else:
            lam_init = _lanes_of(lam0, B)

        zeros_i = torch.zeros(B, dtype=torch.int64, device=dev)
        inf = torch.full((B,), math.inf, dtype=F64, device=dev)
        s = {
            "y": y0, "lam": lam_init, "z_l": z_l0, "z_u": z_u0, "mu": mu0,
            "it": zeros_i, "done": ~all_lanes, "acc": zeros_i, "err_prev": inf,
            "stall": zeros_i, "alpha_last": torch.zeros_like(mu0),
            "y_best": y0, "lam_best": lam_init, "z_l_best": z_l0, "z_u_best": z_u0,
            "err_best": inf, "noimp": zeros_i,
        }
        recs, at_y = [], None
        active = all_lanes if opts.max_iter > 0 else ~all_lanes
        while bool(active.any()):
            new, at_y = step(F, s, P, active, at_y)
            s = {k: torch.where(active.view(-1, *([1] * (v.ndim - 1))), v, s[k])
                 for k, v in new.items()}
            active = ~s["done"] & (s["it"] < opts.max_iter)
            if trace:
                recs.append((s["mu"], s["err_prev"], s["alpha_last"], s["stall"]))

        # --- termination certification ------------------------------
        # report the best mu=0 iterate seen, not necessarily the last
        err_raw_last = _kkt_error(F, s["y"], P, s["lam"], s["z_l"], s["z_u"], 0.0)
        use_best = s["err_best"] < err_raw_last
        ub_ = use_best[:, None]
        y_fin = torch.where(ub_, s["y_best"], s["y"])
        lam_fin = torch.where(ub_, s["lam_best"], s["lam"])
        z_l_fin = torch.where(ub_, s["z_l_best"], s["z_l"])
        z_u_fin = torch.where(ub_, s["z_u_best"], s["z_u"])
        err_raw = torch.minimum(s["err_best"], err_raw_last)

        # multiplier polish: re-derive z from the reduced costs
        # r = g + J'lam (r>0 to the lower bound, r<0 to the upper) and
        # keep whichever multiplier set scores the smaller mu=0 error
        g_f = F["grad_f"](y_fin, P)
        c_f, jt_f, _ = _cons_vjp(F, y_fin, P)
        dLf, dUf = _dists(y_fin)
        to_lb = has_lb & (~has_ub | (dLf <= dUf))
        to_ub = has_ub & ~to_lb

        def _z_from_r(r):
            return (torch.where(to_lb, torch.clamp(r, min=0.0), 0.0),
                    torch.where(to_ub, torch.clamp(-r, min=0.0), 0.0))

        # (a) z-only polish with the iteration's lam
        jtlam_f = jt_f(lam_fin)
        z_l_a, z_u_a = _z_from_r(g_f + jtlam_f)
        err_a = _kkt_error(F, y_fin, P, lam_fin, z_l_a, z_u_a, 0.0, pre=(g_f, jtlam_f, c_f))

        # (b) dual crossover: re-estimate lam by least squares on the
        # interior components only, J Wf J^T lam = -J Wf g, matrix-free CG
        if m:
            wf = ((dLf > 1e-6) & (dUf > 1e-6)).to(F64)
            jt_cg, jv_f = _cg_products(F, y_fin, P)

            def Aop(w):
                return jv_f(wf * jt_cg(w)) + 1e-12 * w

            Jg_f = jv_f(wf * g_f)
            lam_b = _cg(Aop, -Jg_f, lam_fin, 200, 1e-14, all_lanes)
            lam_b = torch.where(torch.isfinite(lam_b).all(-1)[:, None], lam_b, lam_fin)
            jtlam_b = jt_f(lam_b)
            z_l_b, z_u_b = _z_from_r(g_f + jtlam_b)
            err_b = _kkt_error(F, y_fin, P, lam_b, z_l_b, z_u_b, 0.0,
                               pre=(g_f, jtlam_b, c_f))
        else:
            lam_b, z_l_b, z_u_b = lam_fin, z_l_a, z_u_a
            err_b = err_a

        # keep the best-certifying multiplier set
        err = torch.minimum(err_raw, torch.minimum(err_a, err_b))
        use_b = err_b <= torch.minimum(err_raw, err_a)
        use_a = (~use_b) & (err_a <= err_raw)
        b_, a_ = use_b[:, None], use_a[:, None]
        lam_out = torch.where(b_, lam_b, lam_fin)
        z_l_out = torch.where(b_, z_l_b, torch.where(a_, z_l_a, z_l_fin))
        z_u_out = torch.where(b_, z_u_b, torch.where(a_, z_u_a, z_u_fin))

        status = torch.where(err <= opts.tol, 0,
                             torch.where(err <= opts.acceptable_tol, 1, 2)).to(torch.int32)
        x_fin = y_fin[:, :n_x]
        out = IPMResult(
            x=x_fin, x_phys=x_fin * var_scale, slacks=y_fin[:, n_x:], lam=lam_out,
            z_l=z_l_out, z_u=z_u_out, obj=F["user_obj"](x_fin, P), kkt_error=err,
            iterations=s["it"], converged=status < 2, status=status)
        if not batched:
            out = IPMResult(*(f[0] for f in out))
        if not trace:
            return out
        # fixed length max_iter: finished lanes hold their state
        last = recs[-1] if recs else (s["mu"], s["err_prev"], s["alpha_last"], s["stall"])
        recs += [last] * (opts.max_iter - len(recs))
        rec = {k: torch.stack([r[i] for r in recs], dim=-1)
               for i, k in enumerate(("mu", "kkt_error", "alpha", "stall"))}
        if not batched:
            rec = {k: v[0] for k, v in rec.items()}
        return out, rec

    return solve


def format_iteration_trace(trace, result=None, every: int = 1) -> str:
    """IPOPT-style iteration log from ``make_ipm_solver(..., trace=True)``.
    Pass the matching ``IPMResult`` to trim the table at the iteration
    count actually used (finished lanes hold state); a batched trace
    reports lane 0."""
    def host(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    mu = host(trace["mu"])
    err = host(trace["kkt_error"])
    alpha = host(trace["alpha"])
    stall = host(trace["stall"])
    if mu.ndim > 1:  # batched solve: lane axis leads — report lane 0
        mu, err, alpha, stall = mu[0], err[0], alpha[0], stall[0]
    if result is not None:
        n_it = int(host(result.iterations).reshape(-1)[0])  # lane 0
    else:
        n_it = len(mu)
    lines = ["iter         mu    kkt_error      alpha  stall"]
    for i in range(0, min(n_it, len(mu)), max(every, 1)):
        lines.append(f"{i:4d}  {mu[i]:9.3e}  {err[i]:11.5e}  "
                     f"{alpha[i]:9.3e}  {int(stall[i]):5d}")
    return "\n".join(lines) + "\n"


def solve_nlp(nlp, params=None, x0=None, options: Optional[IPMOptions] = None,
              device=None):
    """One-shot convenience wrapper: build the IPM for ``nlp`` on
    ``device`` (``cuda`` unless given) and solve it once."""
    params = nlp.default_params() if params is None else params
    solver = make_ipm_solver(nlp, options, device=device)
    return solver(params) if x0 is None else solver(params, x0)
