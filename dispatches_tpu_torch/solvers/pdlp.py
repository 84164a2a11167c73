"""PDLP options, results, preconditioning and LP data extraction
(counterpart of ``dispatches_tpu/solvers/pdlp.py``).

The LP is extracted from a :class:`CompiledNLP` whose residuals are
affine in ``x``:

    min  c(p)'x           s.t.  K x = q(p),   G x <= h(p),   l <= x <= u

``K``/``G`` must not depend on the scenario params (probe-checked in
:func:`make_lp_data`); ``c``/``q``/``h`` are re-derived per scenario by
the solver.  The preconditioning (Ruiz equilibration, Pock–Chambolle
pass, power-iteration norm) is host numpy, copied from the JAX package
so both packages precondition bit for bit alike.  The per-scenario
``make_pdlp_solver`` is not ported yet; batched solves go through
``solvers.pdlp_batch.make_pdlp_batch_solver``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from dispatches_tpu_torch import resolve_device
from dispatches_tpu_torch.analysis.flags import flag_name

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
    polish: bool = False         # active-set crossover (per-scenario only)
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
            "model is not affine in x: the IPM is not ported yet"
        )

    return {"K": K, "G": G, "lb": np.asarray(nlp.lb), "ub": np.asarray(nlp.ub)}
