"""PDLP options, results, preconditioning and LP data extraction
(counterpart of ``dispatches_tpu/solvers/pdlp.py``).

The LP is extracted from a :class:`CompiledNLP` whose residuals are
affine in ``x``:

    min  c(p)'x           s.t.  K x = q(p),   G x <= h(p),   l <= x <= u

``K``/``G`` must not depend on the scenario params (probe-checked in
:func:`make_lp_data`); ``c``/``q``/``h`` are re-derived per scenario by
the solver.  The preconditioning (Ruiz equilibration, Pock–Chambolle
pass, power-iteration norm) is host numpy, copied from the JAX package
so both packages precondition bit for bit alike.

:func:`make_pdlp_solver` solves one scenario, or a lane axis of them
(the counterpart of ``jax.vmap(make_pdlp_solver(...))``, which the serve
buckets run): restarted averaged or reflected-Halpern PDHG with plain
``torch.matmul`` sweeps (the JAX package runs them as XLA scans, not
Pallas kernels), the optional high-tier refinement tail and the float64
active-set polish.  Its loops are host loops that read "any lane still
running" once per ``check_every`` steps; per-lane branches are masks.
The batch-native solver with the CUDA sweep kernels is
``solvers.pdlp_batch.make_pdlp_batch_solver``, whose restart trajectories
differ from this one's.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from dispatches_tpu_torch import resolve_device
from dispatches_tpu_torch.analysis.flags import flag_name
from dispatches_tpu_torch.analysis.runtime import nan_guard
from dispatches_tpu_torch.utils.tree import tree_map

PDLP_ALGORITHMS = ("avg", "halpern")

PDLP_PRECISIONS = ("f32", "bf16x-f32", "f32-f64")

# Inner-phase KKT floors of the two-tier precision schemes: bf16 matmul
# inputs floor the PDHG fixed point at ~1e-3 relative KKT error, full
# f32 products around 1e-6.  The low-tier main loop only has to reach
# these; the high-tier refinement tail takes the iterate to ``tol``.
_BF16_INNER_TOL = 4e-3
_F32_INNER_TOL = 5e-6

# The reflected operator 2T(w) - w is nonexpansive only while
# tau * sigma * |A|^2 < 1 holds strictly, and the power-iteration
# estimate of |A| converges from below — so the halpern path shrinks
# both steps by a safety margin (value carried over from the JAX
# package, which measured it on the wind+battery LP batch).
_HALPERN_STEP_SCALE = 0.98

# Provenance of a caller-supplied primal–dual start, echoed per lane in
# ``LPResult.start_kind``.
START_COLD = 0       # no reuse: the x=0/z=0 init
START_EXACT = 1      # exact-key cache hit (same request fingerprint)
START_NEIGHBOR = 2   # parameter-space k-NN retrieval
START_PREDICTED = 3  # learned-regression start
START_KIND_NAMES = ("cold", "exact", "neighbor", "predicted")


class LPResult(NamedTuple):
    x: torch.Tensor          # solution in the SCALED decision space
    obj: torch.Tensor        # objective in the user's declared sense
    converged: torch.Tensor  # bool: relative KKT error below tol
    iters: torch.Tensor
    pr_err: torch.Tensor     # relative primal infeasibility (inf-norm)
    du_err: torch.Tensor     # relative dual infeasibility (inf-norm)
    gap: torch.Tensor        # relative primal-dual objective gap
    z: torch.Tensor = None   # row duals in the ORIGINAL constraint space
    refined: torch.Tensor = None  # high-tier refinement rounds applied
    start_kind: torch.Tensor = None  # START_* of the lane's start; None
    #                                  when the caller passed no start


@dataclass(frozen=True)
class PDLPOptions:
    """Options shared by the LP solvers; see the JAX package's
    ``PDLPOptions`` docstring for the meaning of each knob.

    ``algorithm``: "halpern" (reflected Halpern PDHG, default) or "avg"
    (restarted averaged PDHG), overridden by
    ``DISPATCHES_TPU_PDLP_ALGO``.  ``precision``: "f32" (single tier),
    "bf16x-f32" (bf16 matmul operands in the sweep + a full-precision
    refinement tail) or "f32-f64" (f64 refinement tail), overridden by
    ``DISPATCHES_TPU_PDLP_PRECISION``.
    """

    tol: float = 1e-6            # relative KKT tolerance (all three errs)
    max_iter: int = 20000
    check_every: int = 40        # iterations between restart/term checks
    restart_beta: float = 0.36   # sufficient-decay factor (PDLP's beta)
    ruiz_iters: int = 10
    dtype: str = "float32"       # sweep/iterate dtype
    omega0: float = 1.0          # initial primal weight
    polish: bool = False         # active-set crossover
    polish_act_tol: float = 1e-3  # relative activity threshold
    stall_min_iters: int = 2400  # earliest stall-exit iteration
    algorithm: str = "halpern"   # "halpern" | "avg"
    pock_chambolle: bool = None  # PC pass after Ruiz; None = on for halpern
    precision: str = "f32"       # "f32" | "bf16x-f32" | "f32-f64"
    refine_rounds: int = 3       # max high-tier refinement epochs
    refine_iters: int = 400      # high-tier PDHG steps per epoch
    inner_tol: float = None      # low-tier main-loop tolerance; None = auto


def _ruiz_equilibrate(A, iters):
    """Symmetric Ruiz scaling: returns (D_r, D_c) with
    Ahat = D_r[:,None] * A * D_c[None,:] having rows/cols of ~unit
    inf-norm.  Computed once on the host in f64."""
    m, n = A.shape
    dr = np.ones(m)
    dc = np.ones(n)
    Ah = A.copy()
    for _ in range(iters):
        rn = np.sqrt(np.maximum(np.abs(Ah).max(axis=1), 1e-12))
        cn = np.sqrt(np.maximum(np.abs(Ah).max(axis=0), 1e-12))
        dr /= rn
        dc /= cn
        Ah = dr[:, None] * A * dc[None, :]
    return dr, dc


def _pock_chambolle(A, alpha=1.0):
    """Pock–Chambolle diagonal preconditioning as a scaling pass: returns
    (D_r, D_c) with D_r = diag(1/sqrt(row alpha-norms^alpha)) and
    D_c = diag(1/sqrt(col (2-alpha)-norms^(2-alpha))).  Host, f64."""
    absA = np.abs(A)
    r = np.power(absA, alpha).sum(axis=1)
    c = np.power(absA, 2.0 - alpha).sum(axis=0)
    dr = 1.0 / np.sqrt(np.maximum(r, 1e-12))
    dc = 1.0 / np.sqrt(np.maximum(c, 1e-12))
    return dr, dc


def resolve_pdlp_algorithm(algorithm: Optional[str] = None) -> str:
    """Effective PDLP algorithm: ``DISPATCHES_TPU_PDLP_ALGO`` when set,
    else ``algorithm``, else the :class:`PDLPOptions` default."""
    algo = (os.environ.get(flag_name("PDLP_ALGO"), "")
            or algorithm or PDLPOptions.algorithm).lower()
    if algo not in PDLP_ALGORITHMS:
        raise ValueError(
            f"unknown PDLP algorithm {algo!r}; expected one of "
            f"{PDLP_ALGORITHMS} (check DISPATCHES_TPU_PDLP_ALGO)"
        )
    return algo


def resolve_pdlp_precision(precision: Optional[str] = None) -> str:
    """Effective PDLP precision policy: ``DISPATCHES_TPU_PDLP_PRECISION``
    when set, else ``precision``, else the :class:`PDLPOptions`
    default."""
    prec = (os.environ.get(flag_name("PDLP_PRECISION"), "")
            or precision or PDLPOptions.precision).lower()
    if prec not in PDLP_PRECISIONS:
        raise ValueError(
            f"unknown PDLP precision {prec!r}; expected one of "
            f"{PDLP_PRECISIONS} (check DISPATCHES_TPU_PDLP_PRECISION)"
        )
    return prec


def resolve_pdlp_refine_rounds(rounds: Optional[int] = None) -> int:
    """Effective max refinement-round count:
    ``DISPATCHES_TPU_PDLP_REFINE_ROUNDS`` when set, else ``rounds``,
    else the :class:`PDLPOptions` default."""
    env = os.environ.get(flag_name("PDLP_REFINE_ROUNDS"), "")
    if env:
        try:
            rounds = int(env)
        except ValueError:
            raise ValueError(
                f"DISPATCHES_TPU_PDLP_REFINE_ROUNDS={env!r} is not an int"
            ) from None
    if rounds is None:
        rounds = PDLPOptions.refine_rounds
    rounds = int(rounds)
    if rounds < 0:
        raise ValueError(f"refine_rounds must be >= 0, got {rounds}")
    return rounds


class _PrecisionPlan(NamedTuple):
    policy: str      # resolved PDLP_PRECISIONS member
    rounds: int      # refinement epochs (0 <=> single tier, no tail)
    inner_tol: float  # low-tier main-loop termination tolerance
    hi: str          # refinement-tier dtype name


def _precision_plan(opt) -> _PrecisionPlan:
    """Resolve ``opt.precision`` into the two-tier execution plan: the
    tolerance the low-tier main loop stops at, how many high-tier
    refinement epochs may follow, and their dtype.  (torch always has
    float64, so "f32-f64" needs no x64 check.)"""
    policy = resolve_pdlp_precision(opt.precision)
    if policy == "f32":
        return _PrecisionPlan(policy, 0, float(opt.tol), opt.dtype)
    rounds = resolve_pdlp_refine_rounds(opt.refine_rounds)
    if policy == "bf16x-f32":
        floor = _BF16_INNER_TOL
        hi = opt.dtype
    else:  # "f32-f64"
        floor = _F32_INNER_TOL
        hi = "float64"
    inner = (float(opt.inner_tol) if opt.inner_tol is not None
             else max(float(opt.tol), floor))
    if rounds == 0:
        # no refinement tail behind it: the main loop must go all the
        # way to tol itself (the low-tier floor then gates via stall)
        inner = float(opt.tol)
    return _PrecisionPlan(policy, rounds, inner, hi)


def _scalings(A, opt):
    """The preconditioning pipeline for one LP: Ruiz equilibration, then
    (for the Halpern path, or when forced via ``opt.pock_chambolle``) one
    Pock–Chambolle pass on the equilibrated matrix.  Returns
    (dr, dc, Ah, algo)."""
    algo = resolve_pdlp_algorithm(opt.algorithm)
    dr, dc = _ruiz_equilibrate(A, opt.ruiz_iters)
    use_pc = (opt.pock_chambolle if opt.pock_chambolle is not None
              else algo == "halpern")
    if use_pc:
        Ah = dr[:, None] * A * dc[None, :]
        dr2, dc2 = _pock_chambolle(Ah)
        dr, dc = dr * dr2, dc * dc2
    Ah = dr[:, None] * A * dc[None, :]
    return dr, dc, Ah, algo


def _power_norm(A, iters=60):
    """||A||_2 estimate by power iteration on A'A (host, f64)."""
    rng = np.random.default_rng(0)
    v = rng.standard_normal(A.shape[1])
    v /= np.linalg.norm(v) + 1e-30
    s = 1.0
    for _ in range(iters):
        w = A.T @ (A @ v)
        s = np.linalg.norm(w)
        v = w / (s + 1e-30)
    return float(np.sqrt(s))


def _params_on(params, device):
    """``params`` with every numpy leaf as a float64 tensor on ``device``."""
    def leaf(v):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        return torch.as_tensor(np.asarray(v, dtype=np.float64), device=device)
    return {grp: {k: leaf(v) for k, v in d.items()} for grp, d in params.items()}


def _lane_axes(nlp, params):
    """``(axes, B)`` for a params tree of tensors: a leaf with one leading
    axis more than its ``default_params()`` counterpart is a lane axis
    (``axes`` 0), any other leaf is broadcast (None); ``B`` is the lane
    count, or None when no leaf is batched."""
    sizes = set()

    def axis_of(leaf, default_leaf):
        extra = leaf.ndim - np.ndim(default_leaf)
        if extra not in (0, 1):
            raise ValueError(
                f"parameter leaf has {extra} extra leading dims vs the "
                "default; expected 0 (broadcast) or 1 (batch axis)"
            )
        if extra == 1:
            sizes.add(leaf.shape[0])
            return 0
        return None

    axes = tree_map(axis_of, params, nlp.default_params())
    if len(sizes) > 1:
        raise ValueError(f"inconsistent batch sizes: {sorted(sizes)}")
    return axes, (sizes.pop() if sizes else None)


def _lp_rhs(nlp, params, dc, dr, dtype):
    """One scenario's (c, b) in the equilibrated space: the objective
    gradient and minus the [eq; ineq] residuals at x = 0, in float64,
    times the column and row scalings ``dc``/``dr``, cast to ``dtype``."""
    x0 = torch.zeros(nlp.n, dtype=torch.float64, device=dc.device)
    c = torch.func.grad(lambda x: nlp.objective(x, params))(x0)
    b = torch.cat([-nlp.eq(x0, params), -nlp.ineq(x0, params)])
    return (c * dc).to(dtype), (b * dr).to(dtype)


def make_lp_data(nlp, probe_params=None, device=None):
    """Materialize the constant LP structure (Jacobians, bounds) of an
    affine :class:`CompiledNLP` as host numpy arrays.  The Jacobians are
    taken with ``torch.func`` in float64 on ``device`` (``cuda`` unless
    given).  Probe-checks affinity and that the Jacobians are
    parameter-independent; raises ValueError otherwise."""
    dev = resolve_device(device)
    params = _params_on(
        probe_params if probe_params is not None else nlp.default_params(), dev)
    n = nlp.n
    x0 = torch.zeros(n, dtype=torch.float64, device=dev)

    def host(t):
        return t.detach().cpu().numpy()

    def obj(x):
        return nlp.objective(x, params)

    K = host(torch.func.jacfwd(lambda x: nlp.eq(x, params))(x0))
    G = host(torch.func.jacfwd(lambda x: nlp.ineq(x, params))(x0))
    c0 = host(torch.func.grad(obj)(x0))

    # affinity probe: residual(x) - residual(0) must equal J @ x
    rng = np.random.default_rng(1)
    xt_np = rng.standard_normal(n)
    xt = torch.as_tensor(xt_np, dtype=torch.float64, device=dev)
    r_eq = host(nlp.eq(xt, params) - nlp.eq(x0, params))
    r_in = host(nlp.ineq(xt, params) - nlp.ineq(x0, params))
    ct = host(torch.func.grad(obj)(xt))
    scale_eq = 1.0 + np.abs(r_eq).max() if r_eq.size else 1.0
    scale_in = 1.0 + np.abs(r_in).max() if r_in.size else 1.0
    if (
        (r_eq.size and np.abs(r_eq - K @ xt_np).max() / scale_eq > 1e-8)
        or (r_in.size and np.abs(r_in - G @ xt_np).max() / scale_in > 1e-8)
        or np.abs(ct - c0).max() / (1.0 + np.abs(c0).max()) > 1e-8
    ):
        raise ValueError(
            "model is not affine in x: use the IPM (make_ipm_solver) instead"
        )

    return {"K": K, "G": G, "lb": np.asarray(nlp.lb), "ub": np.asarray(nlp.ub)}


def make_pdlp_solver(nlp, options: PDLPOptions = PDLPOptions(), lp_data=None,
                     trace: bool = False, device=None):
    """Build ``solver(params, start=None) -> LPResult`` for an affine
    CompiledNLP, on ``device`` (``cuda`` unless given).

    ``params`` holds one scenario, or a batch of them: a leaf with one
    leading axis more than its ``default_params()`` counterpart is a lane
    axis (the counterpart of ``jax.vmap(make_pdlp_solver(...))``), and every
    field of the result then carries it.  Each lane runs the scenario's own
    solve: its restarts, primal weight and exits are its own, and a lane
    that finished is frozen (state and ``iters``) while the others go on,
    as a vmapped ``while_loop`` freezes it.

    ``c``/``q``/``h`` are re-derived from ``params`` on every call (one
    residual evaluation at x=0 plus one objective gradient, float64).

    ``start`` (optional) is a primal–dual warm start ``(x0, z0)`` or
    ``(x0, z0, kind)``: ``x0`` in the CompiledNLP scaled space (the space
    ``LPResult.x`` reports), ``z0`` in the original constraint space
    (``LPResult.z``), ``kind`` one of the ``START_*`` codes (default
    exact), echoed in ``LPResult.start_kind``; with lanes, each may carry
    the lane axis.  The start seeds the iterate and (halpern) the anchor.
    ``start=None`` is the cold path, and a zero-vector start reproduces it
    bit for bit, lane by lane.

    ``trace=True`` (one scenario only) returns ``(LPResult, trace_dict)``
    where ``trace_dict`` holds one row per termination check (fixed length
    ``ceil(max_iter / check_every)``; rows past the end repeat the final
    state): ``it``, candidate KKT ``err``, ``err_best``, and the
    best-iterate ``pr`` / ``du`` / ``gap``.  The iterate arithmetic is the
    same, so traced and untraced solves are bitwise equal."""
    opt = options
    dev = resolve_device(device)
    dtype = getattr(torch, opt.dtype)
    f64 = torch.float64
    plan = _precision_plan(opt)
    data = lp_data if lp_data is not None else make_lp_data(nlp, device=dev)
    K, G = data["K"], data["G"]
    m_eq, m_in = K.shape[0], G.shape[0]
    n = nlp.n

    A = np.vstack([K, G]) if m_in else K
    dr, dc, Ah, algo = _scalings(A, opt)
    norm_A = max(_power_norm(Ah), 1e-12)

    def dev_t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dt)

    # lane state is (B, n) / (B, m): products are v @ Ah^T and z @ Ah
    Ah_raw = dev_t(Ah)
    AhT_raw = dev_t(Ah.T)

    def Amv(v):
        return v @ AhT_raw

    def ATmv(v):
        return v @ Ah_raw

    if plan.policy == "bf16x-f32":
        # low tier for the inner sweeps only: bf16 operands with
        # full-dtype products and sums (bf16 x bf16 is exact in f32), as
        # the JAX package's explicit casts; the KKT checks, restarts and
        # the refinement tail keep the high-tier Amv/ATmv
        Ah_lo = Ah_raw.to(torch.bfloat16).to(dtype)
        AhT_lo = AhT_raw.to(torch.bfloat16).to(dtype)

        def Amv_sw(v):
            return v.to(torch.bfloat16).to(dtype) @ AhT_lo

        def ATmv_sw(v):
            return v.to(torch.bfloat16).to(dtype) @ Ah_lo
    else:
        Amv_sw, ATmv_sw = Amv, ATmv
    dr_j = dev_t(dr)
    dc_j = dev_t(dc)
    dr64, dc64 = dev_t(dr, f64), dev_t(dc, f64)  # c and b are scaled in f64
    # scaled-space bounds: x = xhat * dc  =>  xhat in [lb/dc, ub/dc]
    lb_h = dev_t(data["lb"] / dc)
    ub_h = dev_t(data["ub"] / dc)
    is_eq = torch.cat([torch.ones(m_eq, dtype=torch.bool, device=dev),
                       torch.zeros(m_in, dtype=torch.bool, device=dev)])
    inv_step = torch.tensor(1.0 / norm_A, dtype=dtype, device=dev)

    def _inf(v):
        """Per-lane inf-norm over the last axis."""
        return v.abs().amax(dim=-1) if v.shape[-1] else v.new_zeros(v.shape[:-1])

    def _make_kkt(Amv_, ATmv_, lb_, ub_):
        """KKT-error evaluator for one precision tier (the matvecs and
        bound arrays decide the tier's dtype)."""
        lb_ok, ub_ok = torch.isfinite(lb_), torch.isfinite(ub_)
        lb_fin = torch.where(lb_ok, lb_, 0.0)
        ub_fin = torch.where(ub_ok, ub_, 0.0)

        def kkt(x, z, c, b):
            """Relative primal/dual/gap errors in the equilibrated space,
            one per lane."""
            ax = Amv_(x)
            viol = torch.where(is_eq, (ax - b).abs(), torch.clamp(ax - b, min=0.0))
            pr = _inf(viol) / (1.0 + _inf(b))
            # reduced costs r = c + A'z; dual residual = the part of r not
            # attributable to a finite bound's multiplier
            r = c + ATmv_(z)
            rd = r - torch.where(r > 0, torch.where(lb_ok, r, 0.0),
                                 torch.where(ub_ok, r, 0.0))
            du = _inf(rd) / (1.0 + _inf(c))
            pobj = (c * x).sum(-1)
            dobj = -(b * z).sum(-1) + (torch.clamp(r, min=0.0) * lb_fin
                                       + torch.clamp(r, max=0.0) * ub_fin).sum(-1)
            gap = (pobj - dobj).abs() / (1.0 + pobj.abs() + dobj.abs())
            return pr, du, gap
        return kkt

    _kkt_errors = _make_kkt(Amv, ATmv, lb_h, ub_h)
    ridge = torch.tensor(1e-7, dtype=f64, device=dev)

    def _polish(x, z, c, b):
        """Active-set crossover (see ``PDLPOptions.polish``), per lane: fix
        the variables at their identified active bounds, restrict to the
        identified active rows, and project x onto that face by a
        min-norm correction (row-space normal equations, float64 Cholesky
        factor and one iterative-refinement step).  Masks, not gathers,
        as in the JAX package."""
        act = opt.polish_act_tol
        r = c + ATmv(z)
        near_lb = torch.isfinite(lb_h) & (x - lb_h <= act * (1 + lb_h.abs()))
        near_ub = torch.isfinite(ub_h) & (ub_h - x <= act * (1 + ub_h.abs()))
        fix_lb = near_lb & (r > 0)
        fix_ub = near_ub & (r < 0) & ~fix_lb
        fixed = fix_lb | fix_ub
        v_fix = torch.where(fix_lb, lb_h, torch.where(fix_ub, ub_h, 0.0))

        ax = Amv(x)
        row_act = is_eq | ((ax - b).abs() <= act * (1 + b.abs()))
        rowm = row_act.to(dtype)
        freem = (~fixed).to(dtype)

        def mv(Mat, v):
            return (Mat @ v[..., None])[..., 0]

        M = Ah_raw * rowm[:, :, None]
        Mf = M * freem[:, None, :]
        x_free = x * freem
        rhs = b * rowm - mv(M, v_fix)
        d = rhs - mv(Mf, x_free)
        H = Mf @ Mf.transpose(-1, -2)
        H64 = H.to(f64) + ridge * torch.eye(H.shape[-1], dtype=f64, device=dev)
        # a failed factor is NaN, as jnp.linalg.cholesky returns it
        L, info = torch.linalg.cholesky_ex(H64)
        L = torch.where((info == 0)[:, None, None], L, torch.nan)
        Mf64 = Mf.to(f64)
        MfT64 = Mf64.transpose(-1, -2)
        d64 = d.to(f64)
        lam = torch.cholesky_solve(d64[..., None], L)[..., 0]
        resid = d64 - mv(Mf64, mv(MfT64, lam)) - ridge * lam
        lam = lam + torch.cholesky_solve(resid[..., None], L)[..., 0]
        xf = x_free.to(f64) + mv(MfT64, lam)
        xp64 = torch.where(fixed, v_fix.to(f64), xf)
        xp64 = torch.minimum(torch.maximum(xp64, lb_h.to(f64)), ub_h.to(f64))
        # guard against a singular/garbage factor (degenerate bases)
        return torch.where(torch.isfinite(xp64).all(-1, keepdim=True), xp64, x.to(f64))

    def _pdhg_sweep(x, z, xs, zs, c, b, omega, k):
        """k fixed PDHG steps, extending the running average sums."""
        tau = (omega * inv_step)[:, None]
        sig = (inv_step / omega)[:, None]
        for _ in range(k):
            xn = torch.clamp(x - tau * (c + ATmv_sw(z)), lb_h, ub_h)
            z_t = z + sig * (Amv_sw(2.0 * xn - x) - b)
            zn = torch.where(is_eq, z_t, torch.clamp(z_t, min=0.0))
            x, z, xs, zs = xn, zn, xs + xn, zs + zn
        return x, z, xs, zs

    def _halpern_sweep(x, z, xa, za, xs, zs, c, b, omega, k0, k):
        """k reflected-Halpern PDHG steps anchored at (xa, za):
        w_{j+1} = (j+1)/(j+2) * (2 T(w_j) - w_j) + 1/(j+2) * anchor, with
        j = k0 + step counting from each lane's last restart.  Returns the
        final reflected iterate (x, z), the last operator output (xt, zt) —
        a feasible candidate — and the operator-output sums (xs, zs)."""
        tau = (omega * inv_step * _HALPERN_STEP_SCALE)[:, None]
        sig = (inv_step / omega * _HALPERN_STEP_SCALE)[:, None]
        # every step's weight per lane, in float64 then cast, as the JAX
        # package computes (j + 1.0) / (j + 2.0) from its int32 counter
        j = k0.to(f64)[:, None] + torch.arange(k, dtype=f64, device=dev)
        ws = ((j + 1.0) / (j + 2.0)).to(dtype)
        xt, zt = x, z
        for i in range(k):
            xt = torch.clamp(x - tau * (c + ATmv_sw(z)), lb_h, ub_h)
            z_t = z + sig * (Amv_sw(2.0 * xt - x) - b)
            zt = torch.where(is_eq, z_t, torch.clamp(z_t, min=0.0))
            w = ws[:, i:i + 1]
            x = w * (2.0 * xt - x) + (1.0 - w) * xa
            z = w * (2.0 * zt - z) + (1.0 - w) * za
            xs, zs = xs + xt, zs + zt
        return x, z, xt, zt, xs, zs

    # the low-tier main loop stops at the tier's KKT floor and hands off
    # to the refinement tail; without a tail, both are just tol
    tol_main = plan.inner_tol
    ce = opt.check_every
    stall_min = (opt.stall_min_iters if plan.rounds == 0
                 else min(opt.stall_min_iters, 12 * ce))

    def _freeze(active, new, old):
        """``new`` on the active lanes, ``old`` (frozen) on the rest."""
        return {k: torch.where(active.view(-1, *([1] * (v.ndim - 1))), v, old[k])
                for k, v in new.items()}

    if plan.rounds:
        hdt = getattr(torch, plan.hi)
        Ah_hi = dev_t(Ah, hdt)
        AhT_hi = dev_t(Ah.T, hdt)
        lb_hi = dev_t(data["lb"] / dc, hdt)
        ub_hi = dev_t(data["ub"] / dc, hdt)
        dc_hi = dev_t(dc, hdt)
        kkt_hi = _make_kkt(lambda v: v @ AhT_hi, lambda v: v @ Ah_hi, lb_hi, ub_hi)
        ws_hi = [torch.tensor((j + 1.0) / (j + 2.0), dtype=hdt, device=dev)
                 for j in range(opt.refine_iters)]

        def _refine(x0_, z0_, c, b, omega):
            """Iterative-refinement tail, per lane: up to ``plan.rounds``
            epochs of ``opt.refine_iters`` reflected-Halpern steps in the
            HIGH tier, each re-anchored at its own start, keeping the best
            candidate seen; a lane stops as soon as its error reaches
            ``tol`` (and is frozen while the others go on)."""
            ch = c.to(hdt)
            bh = b.to(hdt)
            tau = (omega * inv_step * _HALPERN_STEP_SCALE).to(hdt)[:, None]
            sig = (inv_step / omega * _HALPERN_STEP_SCALE).to(hdt)[:, None]

            def err_of(x_, z_):
                pr, du, gap = kkt_hi(x_, z_, ch, bh)
                return torch.maximum(torch.maximum(pr, du), gap), (pr, du, gap)

            x_it = x0_.to(hdt)
            z_it = z0_.to(hdt)
            e_b, (pr, du, gap) = err_of(x_it, z_it)
            r = {"x_it": x_it, "z_it": z_it, "xb": x_it, "zb": z_it, "e_b": e_b,
                 "pr": pr, "du": du, "gap": gap,
                 "rounds": torch.zeros(e_b.shape, dtype=torch.int32, device=dev)}
            active = (r["rounds"] < plan.rounds) & (r["e_b"] > opt.tol)
            while bool(active.any()):
                x_, z_ = r["x_it"], r["z_it"]
                xs = torch.zeros_like(x_)
                zs = torch.zeros_like(z_)
                for w in ws_hi:
                    xt = torch.clamp(x_ - tau * (ch + z_ @ Ah_hi), lb_hi, ub_hi)
                    z_t = z_ + sig * ((2.0 * xt - x_) @ AhT_hi - bh)
                    zt = torch.where(is_eq, z_t, torch.clamp(z_t, min=0.0))
                    x_ = w * (2.0 * xt - x_) + (1.0 - w) * r["x_it"]
                    z_ = w * (2.0 * zt - z_) + (1.0 - w) * r["z_it"]
                    xs, zs = xs + xt, zs + zt
                e_cur, k_cur = err_of(xt, zt)
                xa = xs / opt.refine_iters
                za = zs / opt.refine_iters
                e_avg, k_avg = err_of(xa, za)
                use_avg = e_avg < e_cur
                ua = use_avg[:, None]
                e_c = torch.minimum(e_avg, e_cur)
                nb = e_c < r["e_b"]
                nb_ = nb[:, None]
                new = {
                    # continue from the reflected iterate, not the candidate
                    "x_it": x_, "z_it": z_,
                    "xb": torch.where(nb_, torch.where(ua, xa, xt), r["xb"]),
                    "zb": torch.where(nb_, torch.where(ua, za, zt), r["zb"]),
                    "e_b": torch.where(nb, e_c, r["e_b"]),
                    "rounds": r["rounds"] + 1,
                }
                for key, ka, kc in zip(("pr", "du", "gap"), k_avg, k_cur):
                    new[key] = torch.where(nb, torch.where(use_avg, ka, kc), r[key])
                r = _freeze(active, new, r)
                active = (r["rounds"] < plan.rounds) & (r["e_b"] > opt.tol)
            return r["xb"], r["zb"], r["pr"], r["du"], r["gap"], r["rounds"]

    def solver(params, start=None) -> LPResult:
        P = _params_on(params, dev)
        axes, B_p = _lane_axes(nlp, P)
        B = B_p
        if B is None and start is not None and torch.as_tensor(start[0]).ndim == 2:
            B = torch.as_tensor(start[0]).shape[0]  # lanes from the start alone
        batched = B is not None
        if trace and batched:
            raise ValueError("make_pdlp_solver(trace=True) takes one scenario, "
                             "not a lane axis")
        B = B or 1
        if B_p is not None:
            c, b = torch.func.vmap(lambda p: _lp_rhs(nlp, p, dc64, dr64, dtype),
                                   in_dims=(axes,))(P)
        else:
            c, b = _lp_rhs(nlp, P, dc64, dr64, dtype)
            c, b = c.expand(B, n), b.expand(B, m_eq + m_in)
        if start is None:
            # cold path: the x=0/z=0 init
            x = torch.clamp(torch.zeros(n, dtype=dtype, device=dev), lb_h, ub_h).expand(B, n)
            z = torch.zeros((B, m_eq + m_in), dtype=dtype, device=dev)
            start_kind = None
        else:
            # x0 in the CompiledNLP scaled space, z0 in the original
            # constraint space: map both into the equilibrated space and
            # project; a zero start reproduces the cold arithmetic
            kind = start[2] if len(start) > 2 else START_EXACT
            x = torch.clamp(torch.as_tensor(start[0], device=dev).to(dtype) / dc_j,
                            lb_h, ub_h).expand(B, n)
            zw = torch.as_tensor(start[1], device=dev).to(dtype) / dr_j
            z = torch.where(is_eq, zw, torch.clamp(zw, min=0.0)).expand(B, m_eq + m_in)
            start_kind = torch.as_tensor(kind, device=dev).to(torch.int32).expand(B)

        # initial primal weight omega ~ |b|/|c| balances primal and dual
        # travel in this parameterization (tau = omega/|A|)
        nb, nc = torch.linalg.vector_norm(b, dim=-1), torch.linalg.vector_norm(c, dim=-1)
        omega0 = torch.where((nb > 0.0) & (nc > 0.0), torch.clamp(nb / nc, 1e-4, 1e6),
                             torch.tensor(opt.omega0, dtype=dtype, device=dev)).to(dtype)

        def err_of(x_, z_):
            pr, du, gap = _kkt_errors(x_, z_, c, b)
            return torch.maximum(torch.maximum(pr, du), gap), (pr, du, gap)

        e0, k0 = err_of(x, z)

        def restart_and_track(s, e_c, xc, zc, k, artificial_floor):
            """The between-check bookkeeping both algorithms share, per
            lane: PDLP sufficient-decay + artificial restarts,
            primal-weight rebalancing, best iterate and the stall/floor
            exit."""
            sufficient = e_c <= opt.restart_beta * s["e_r"]
            rs = sufficient | (k >= torch.clamp(0.36 * s["it"].to(f64),
                                                min=float(artificial_floor)))
            rs_ = rs[:, None]
            dx = _inf(xc - s["xr"])
            dz = _inf(zc - s["zr"])
            omega_new = torch.clamp(torch.exp(
                0.5 * torch.log(s["omega"])
                + 0.5 * torch.log(torch.clamp(dx, min=1e-10) / torch.clamp(dz, min=1e-10))),
                1e-6, 1e8)
            improved = e_c < 0.95 * s["e_b"]
            new_best = e_c < s["e_b"]
            nb_ = new_best[:, None]
            e_b = torch.where(new_best, e_c, s["e_b"])
            stall = torch.where(improved, 0, s["stall"] + 1)
            # the floored exit may not fire before stall_min_iters: an
            # early plateau is a pre-restart lull, not the f32 floor
            floored = (e_b < 20.0 * tol_main) & (stall >= 12) & (s["it"] >= stall_min)
            out = {
                "omega": torch.where(rs, omega_new, s["omega"]),
                "xr": torch.where(rs_, xc, s["xr"]), "zr": torch.where(rs_, zc, s["zr"]),
                "e_r": torch.where(rs, e_c, s["e_r"]),
                "e_b": e_b,
                "xb": torch.where(nb_, xc, s["xb"]), "zb": torch.where(nb_, zc, s["zb"]),
                "stall": stall,
                "done": s["done"] | (e_b < tol_main) | floored,
                "k": torch.where(rs, 0, k),
                "it": s["it"] + ce,
            }
            if trace:
                out["e_c"] = e_c
            return rs_, new_best, out

        def candidates(x1, z1, xa, za):
            e_cur, k_cur = err_of(x1, z1)
            e_avg, k_avg = err_of(xa, za)
            use_avg = e_avg < e_cur
            ua = use_avg[:, None]
            comps = [torch.where(use_avg, a, b_) for a, b_ in zip(k_avg, k_cur)]
            return (torch.minimum(e_avg, e_cur), torch.where(ua, xa, x1),
                    torch.where(ua, za, z1), comps)

        def track_comps(s, out, new_best, comps):
            if trace:
                for key, v in zip(("pr_b", "du_b", "gap_b"), comps):
                    out[key] = torch.where(new_best, v, s[key])

        def step_avg(s):
            x1, z1, xs, zs = _pdhg_sweep(s["x"], s["z"], s["xs"], s["zs"], c, b,
                                         s["omega"], ce)
            nan_guard("pdlp.iterate", x1, z1)
            k = s["k"] + ce
            kf = k.to(dtype)[:, None]
            e_c, xc, zc, comps = candidates(x1, z1, xs / kf, zs / kf)
            rs_, new_best, out = restart_and_track(s, e_c, xc, zc, k, 8 * ce)
            out["x"] = torch.where(rs_, xc, x1)
            out["z"] = torch.where(rs_, zc, z1)
            out["xs"] = torch.where(rs_, 0.0, xs)
            out["zs"] = torch.where(rs_, 0.0, zs)
            track_comps(s, out, new_best, comps)
            return out

        def step_halpern(s):
            x1, z1, xt, zt, xts, zts = _halpern_sweep(
                s["x"], s["z"], s["xs"], s["zs"], s["xts"], s["zts"], c, b,
                s["omega"], s["k"], ce)
            nan_guard("pdlp.iterate", x1, z1)
            k = s["k"] + ce
            # two candidates: the last operator output (feasible) and the
            # in-epoch mean of operator outputs (smooths f32 rounding at
            # the KKT floor)
            kf = k.to(dtype)[:, None]
            e_c, xc, zc, comps = candidates(xt, zt, xts / kf, zts / kf)
            # restart-to-current-iterate; the artificial floor is one
            # check interval (re-anchoring is free)
            rs_, new_best, out = restart_and_track(s, e_c, xc, zc, k, ce)
            out["x"] = torch.where(rs_, xc, x1)
            out["z"] = torch.where(rs_, zc, z1)
            # xs/zs carry the Halpern ANCHOR (a restart re-anchors at the
            # candidate), xts/zts the in-epoch operator-output sums
            out["xs"] = torch.where(rs_, xc, s["xs"])
            out["zs"] = torch.where(rs_, zc, s["zs"])
            out["xts"] = torch.where(rs_, 0.0, xts)
            out["zts"] = torch.where(rs_, 0.0, zts)
            track_comps(s, out, new_best, comps)
            return out

        step = step_halpern if algo == "halpern" else step_avg
        zeros_i = torch.zeros(B, dtype=torch.int64, device=dev)
        s = {
            "x": x, "z": z,
            # avg: running sums (start at 0); halpern: anchor (start at
            # the initial point)
            "xs": x if algo == "halpern" else torch.zeros_like(x),
            "zs": z if algo == "halpern" else torch.zeros_like(z),
            "k": zeros_i, "xr": x, "zr": z, "e_r": e0, "omega": omega0, "it": zeros_i,
            "done": e0 < tol_main, "e_b": e0, "stall": zeros_i, "xb": x, "zb": z,
        }
        if algo == "halpern":
            s["xts"] = torch.zeros_like(x)
            s["zts"] = torch.zeros_like(z)
        rows = []

        def row(s_):
            return tuple(s_[key][0] for key in ("it", "e_c", "e_b", "pr_b", "du_b", "gap_b"))

        if trace:
            s.update(e_c=e0, pr_b=k0[0], du_b=k0[1], gap_b=k0[2])
        # one host read per check: does any lane still run?
        active = (s["it"] < opt.max_iter) & ~s["done"]
        while bool(active.any()):
            s = _freeze(active, step(s), s)
            if trace:
                rows.append(row(s))
            active = (s["it"] < opt.max_iter) & ~s["done"]

        xb, zb = s["xb"], s["zb"]
        if plan.rounds:
            xh, zh, pr, du, gap, refined = _refine(xb, zb, c, b, s["omega"])
            xb = xh.to(dtype)
            zb = zh.to(dtype)
        else:
            xh = None
            pr, du, gap = _kkt_errors(xb, zb, c, b)
            refined = torch.zeros(B, dtype=torch.int32, device=dev)
        x_scaled = xb * dc_j  # back to the CompiledNLP's scaled space
        if opt.polish:
            xp64 = _polish(xb, zb, c, b)
            xp = xp64.to(dtype)
            prp, dup, gapp = _kkt_errors(xp, zb, c, b)
            better = torch.maximum(torch.maximum(prp, dup), gapp) <= \
                torch.maximum(torch.maximum(pr, du), gap)
            pr = torch.where(better, prp, pr)
            du = torch.where(better, dup, du)
            gap = torch.where(better, gapp, gap)
            x_scaled = torch.where(better[:, None], xp, xb) * dc_j
            # the f64 vertex is what gets certified
            x_obj = torch.where(better[:, None], xp64, xb.to(f64)) * dc_j
        elif plan.rounds and getattr(torch, plan.hi) != dtype:
            # the f64 refined iterate goes into the objective evaluation
            x_obj = xh * dc_hi
        else:
            x_obj = x_scaled.to(f64)
        # the model objective itself (keeps any constant term c'x misses,
        # and the user's declared sense)
        if batched:
            obj = torch.func.vmap(nlp.user_objective, in_dims=(0, axes))(x_obj, P)
        else:
            obj = nlp.user_objective(x_obj[0], P)[None]
        result = LPResult(
            x=x_scaled, obj=obj,
            converged=torch.maximum(torch.maximum(pr, du), gap) < opt.tol,
            iters=s["it"].to(torch.int32),
            pr_err=pr, du_err=du, gap=gap,
            z=zb * dr_j,
            refined=refined.to(torch.int32),
            start_kind=start_kind,
        )
        if not batched:
            result = LPResult(*(None if f is None else f[0] for f in result))
        if not trace:
            return result
        n_checks = -(-opt.max_iter // ce)
        rows += [row(s)] * (n_checks - len(rows))
        keys = ("it", "err", "err_best", "pr", "du", "gap")
        rec = {key: torch.stack([r[i] for r in rows]) for i, key in enumerate(keys)}
        return result, rec

    return solver
