"""Batch-native PDLP: one call solves a whole LMP-scenario batch
(counterpart of ``dispatches_tpu/solvers/pdlp_batch.py``).

The scenario axis is an explicit leading dimension: (B, n) primal and
(B, m) dual iterates.  Every ``check_every`` PDHG steps run as ONE fused
sweep — the CUDA kernels of ``kernels/pdhg_sweep.py`` on the card, their
plain PyTorch versions on the CPU — and between sweeps the restart and
termination logic runs vectorized over lanes exactly as in the JAX
package: averaging or Halpern anchoring per ``options.algorithm``, PDLP
sufficient-decay + artificial restarts, primal-weight rebalancing, the
best-iterate stall exit, and the optional high-tier refinement tail.

JAX's ``while_loop`` becomes a Python loop that reads ``done.all()``
once per sweep (the same cadence as the JAX ``cond``).  KKT checks and
the refinement tail are plain ``torch.matmul``; on the card that needs
``torch.backends.cuda.matmul.allow_tf32`` off, since TF32 would bring
back the accuracy floor that ``Precision.HIGHEST`` avoids in the JAX
package, and the solver builder raises if it is on.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from dispatches_tpu_torch import resolve_device
from dispatches_tpu_torch.analysis.runtime import nan_guard
from dispatches_tpu_torch.kernels import pdhg_sweep as _kern
from dispatches_tpu_torch.solvers.pdlp import (
    _HALPERN_STEP_SCALE,
    LPResult,
    PDLPOptions,
    START_EXACT,
    _lane_axes,
    _lp_rhs,
    _params_on,
    _power_norm,
    _precision_plan,
    _scalings,
    make_lp_data,
)

SWEEPS = ("auto", "cuda", "torch")


@dataclass(frozen=True)
class BatchPDLPOptions(PDLPOptions):
    sweep: str = "auto"       # "auto" (kernel on cuda, plain on cpu) |
    #                           "cuda" (kernel; needs a cuda device) |
    #                           "torch" (the plain sweep on any device)
    lanes_per_block: int | None = None  # CUDA kernel: scenario lanes per
    #                           thread block; None: chosen from the batch
    #                           (kernels/pdhg_sweep.py:default_lanes)


def make_pdlp_batch_solver(nlp, options: BatchPDLPOptions = BatchPDLPOptions(),
                           lp_data=None, device=None):
    """Build ``solver(batched_params, start=None) -> LPResult`` on
    ``device`` (``cuda`` unless given).  Every leaf of ``batched_params``
    that varies per scenario carries a leading batch axis (broadcast
    leaves may stay unbatched); the result's fields all carry the batch
    axis.  Leaves may be numpy arrays or tensors.

    ``start`` (optional) is a per-lane primal–dual start ``(x0, z0)`` or
    ``(x0, z0, kind)``: ``x0`` (B, n) in the CompiledNLP scaled space,
    ``z0`` (B, m) in the original constraint space, ``kind`` (B,) int32
    ``START_*`` codes echoed in ``LPResult.start_kind``.  Zero rows
    reproduce the cold arithmetic bit for bit."""
    opt = options
    if opt.polish:
        raise NotImplementedError(
            "active-set polish is implemented on the per-scenario solver "
            "only; the batch path certifies parity at its converged ~1e-5 "
            "KKT error without it"
        )
    if opt.sweep not in SWEEPS:
        raise ValueError(f"unknown sweep {opt.sweep!r}; expected one of {SWEEPS}")
    dev = resolve_device(device)
    if opt.sweep == "cuda" and dev.type != "cuda":
        raise ValueError("sweep='cuda' needs a cuda device")
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: TF32 KKT checks "
            "would floor PDLP's accuracy; set it to False"
        )
    dtype = getattr(torch, opt.dtype)
    f64 = torch.float64
    plan = _precision_plan(opt)
    low_prec = plan.policy == "bf16x-f32"
    data = lp_data if lp_data is not None else make_lp_data(nlp, device=dev)
    K, G = data["K"], data["G"]
    m_eq, m_in = K.shape[0], G.shape[0]
    n = nlp.n
    m = m_eq + m_in

    A = np.vstack([K, G]) if m_in else K
    dr, dc, Ah, algo = _scalings(A, opt)
    norm_A = max(_power_norm(Ah), 1e-12)

    def dev_t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dt)

    Ah_j = dev_t(Ah)
    AhT_j = dev_t(Ah.T)
    dr_j = dev_t(dr)
    dc_j = dev_t(dc)
    lb_h = dev_t(data["lb"] / dc)
    ub_h = dev_t(data["ub"] / dc)
    is_eq = torch.cat([torch.ones(m_eq, dtype=torch.bool, device=dev),
                       torch.zeros(m_in, dtype=torch.bool, device=dev)])
    is_eq_f = is_eq.to(dtype)
    inv_step = torch.tensor(1.0 / norm_A, dtype=dtype, device=dev)
    ce = opt.check_every

    use_kernel = opt.sweep == "cuda" or (opt.sweep == "auto" and dev.type == "cuda")
    if algo == "halpern":
        fn = _kern.halpern_sweep if use_kernel else _kern.halpern_sweep_reference
    else:
        fn = _kern.avg_sweep if use_kernel else _kern.avg_sweep_reference
    # the kernels' packed operator, made once here from the host copy of
    # Ah, so no sweep copies the operator back from the card
    extra = ({"lanes_per_block": opt.lanes_per_block,
              "packed": _kern.pack_operator(torch.as_tensor(Ah).to(dtype), device=dev)}
             if use_kernel else {})
    sweep = functools.partial(fn, Ah_j, AhT_j, lb_h, ub_h, is_eq_f, k=ce,
                              low_precision=low_prec, **extra)

    def _inf_rows(v):
        if v.shape[-1]:
            return v.abs().amax(dim=-1)
        return torch.zeros(v.shape[0], dtype=v.dtype, device=v.device)

    def _make_kkt(Ah_, AhT_, lb_, ub_):
        """Per-lane KKT-error evaluator for one precision tier."""
        lb_fin = torch.where(torch.isfinite(lb_), lb_, 0.0)
        ub_fin = torch.where(torch.isfinite(ub_), ub_, 0.0)
        lb_ok = torch.isfinite(lb_)[None, :]
        ub_ok = torch.isfinite(ub_)[None, :]

        def kkt(x, z, c, b):
            ax = x @ AhT_
            viol = torch.where(is_eq[None, :], (ax - b).abs(),
                               torch.clamp(ax - b, min=0.0))
            pr = _inf_rows(viol) / (1.0 + _inf_rows(b))
            r = c + z @ Ah_
            rd = r - torch.where(r > 0, torch.where(lb_ok, r, 0.0),
                                 torch.where(ub_ok, r, 0.0))
            du = _inf_rows(rd) / (1.0 + _inf_rows(c))
            pobj = (c * x).sum(dim=-1)
            dobj = -(b * z).sum(dim=-1) + (
                torch.clamp(r, min=0.0) * lb_fin[None, :]
                + torch.clamp(r, max=0.0) * ub_fin[None, :]).sum(dim=-1)
            gap = (pobj - dobj).abs() / (1.0 + pobj.abs() + dobj.abs())
            return pr, du, gap
        return kkt

    _kkt_errors = _make_kkt(Ah_j, AhT_j, lb_h, ub_h)

    def _err(x, z, c, b):
        pr, du, gap = _kkt_errors(x, z, c, b)
        return torch.maximum(torch.maximum(pr, du), gap)

    # the low-tier main loop stops at the tier's KKT floor and hands off
    # to the refinement tail; without a tail, both are just tol
    tol_main = plan.inner_tol
    stall_min = (opt.stall_min_iters if plan.rounds == 0
                 else min(opt.stall_min_iters, 12 * ce))

    if plan.rounds:
        hdt = getattr(torch, plan.hi)
        Ah_hi = dev_t(Ah, hdt)
        AhT_hi = dev_t(Ah.T, hdt)
        lb_hi = dev_t(data["lb"] / dc, hdt)
        ub_hi = dev_t(data["ub"] / dc, hdt)
        kkt_hi = _make_kkt(Ah_hi, AhT_hi, lb_hi, ub_hi)

        def _refine(x0_, z0_, c, b, omega):
            """Per-lane iterative-refinement tail: up to ``plan.rounds``
            epochs of ``opt.refine_iters`` reflected-Halpern steps in the
            HIGH tier (plain torch, as the JAX package leaves the tail to
            XLA), each epoch re-anchored at its own start; a lane at
            ``tol`` freezes while stragglers finish."""
            x_it = x0_.to(hdt)
            z_it = z0_.to(hdt)
            ch = c.to(hdt)
            bh = b.to(hdt)
            tau = (omega * inv_step * _HALPERN_STEP_SCALE).to(hdt)[:, None]
            sig = (inv_step / omega * _HALPERN_STEP_SCALE).to(hdt)[:, None]
            ws = [torch.tensor((j + 1.0) / (j + 2.0), dtype=hdt, device=dev)
                  for j in range(opt.refine_iters)]

            def err_of(x_, z_):
                pr, du, gap = kkt_hi(x_, z_, ch, bh)
                return torch.maximum(torch.maximum(pr, du), gap), (pr, du, gap)

            e_b, (pr, du, gap) = err_of(x_it, z_it)
            xb, zb = x_it, z_it
            rounds = torch.zeros(x_it.shape[0], dtype=torch.int32, device=dev)
            while bool(((e_b > opt.tol) & (rounds < plan.rounds)).any()):
                need = (e_b > opt.tol) & (rounds < plan.rounds)
                x_, z_ = xt, zt = x_it, z_it
                xs = torch.zeros_like(x_it)
                zs = torch.zeros_like(z_it)
                for w in ws:
                    grad = ch + z_ @ Ah_hi
                    xt = torch.clamp(x_ - tau * grad, lb_hi, ub_hi)
                    ax = (2.0 * xt - x_) @ AhT_hi
                    z_t = z_ + sig * (ax - bh)
                    zt = torch.where(is_eq[None, :], z_t,
                                     torch.clamp(z_t, min=0.0))
                    # all lanes re-anchor at the epoch start, so the
                    # Halpern weight is a scalar per step here
                    x_, z_ = (w * (2.0 * xt - x_) + (1.0 - w) * x_it,
                              w * (2.0 * zt - z_) + (1.0 - w) * z_it)
                    xs, zs = xs + xt, zs + zt
                e_cur, k_cur = err_of(xt, zt)
                xa = xs / opt.refine_iters
                za = zs / opt.refine_iters
                e_avg, k_avg = err_of(xa, za)
                use_avg = e_avg < e_cur
                xc = torch.where(use_avg[:, None], xa, xt)
                zc = torch.where(use_avg[:, None], za, zt)
                e_c = torch.minimum(e_avg, e_cur)
                new_best = need & (e_c < e_b)
                xb = torch.where(new_best[:, None], xc, xb)
                zb = torch.where(new_best[:, None], zc, zb)
                pr = torch.where(new_best, torch.where(use_avg, k_avg[0], k_cur[0]), pr)
                du = torch.where(new_best, torch.where(use_avg, k_avg[1], k_cur[1]), du)
                gap = torch.where(new_best, torch.where(use_avg, k_avg[2], k_cur[2]), gap)
                e_b = torch.where(new_best, e_c, e_b)
                x_it = torch.where(need[:, None], x_, x_it)
                z_it = torch.where(need[:, None], z_, z_it)
                rounds = rounds + need.to(torch.int32)
            return xb, zb, pr, du, gap, rounds

    def _restart_and_track(s, it, e_c, xc, zc, k, artificial_floor):
        """The between-sweep bookkeeping both algorithms share: PDLP
        sufficient-decay + artificial restarts, primal-weight update,
        best iterate and the stall/floor exit."""
        sufficient = e_c <= opt.restart_beta * s["e_r"]
        artificial = k >= max(0.36 * it, artificial_floor)
        do_restart = sufficient | artificial
        rs = do_restart[:, None]

        dx = _inf_rows(xc - s["xr"])
        dz = _inf_rows(zc - s["zr"])
        omega_new = torch.clamp(
            torch.exp(0.5 * torch.log(s["omega"])
                      + 0.5 * torch.log(torch.clamp(dx, min=1e-10)
                                        / torch.clamp(dz, min=1e-10))),
            1e-6, 1e8)
        improved = e_c < 0.95 * s["e_b"]
        new_best = e_c < s["e_b"]
        stall = torch.where(improved, 0, s["stall"] + 1)
        e_b = torch.where(new_best, e_c, s["e_b"])
        # same gate as the JAX package: the floored exit may not fire
        # before stall_min_iters
        floored = (e_b < 20.0 * tol_main) & (stall >= 12) & (it >= stall_min)
        done = s["done"] | (e_b < tol_main) | floored
        it_next = it + ce
        return do_restart, rs, {
            "omega": torch.where(do_restart, omega_new, s["omega"]),
            "xr": torch.where(rs, xc, s["xr"]),
            "zr": torch.where(rs, zc, s["zr"]),
            "e_r": torch.where(do_restart, e_c, s["e_r"]),
            # per-lane iteration count, frozen when the lane finishes
            "it_done": torch.where(done & ~s["done"], it_next, s["it_done"]),
            "done": done, "e_b": e_b, "stall": stall,
            "xb": torch.where(new_best[:, None], xc, s["xb"]),
            "zb": torch.where(new_best[:, None], zc, s["zb"]),
            "k": torch.where(do_restart, 0, k),
        }

    def _candidates(x1, z1, xa, za, c, b):
        e_cur = _err(x1, z1, c, b)
        e_avg = _err(xa, za, c, b)
        use_avg = (e_avg < e_cur)[:, None]
        return (torch.minimum(e_avg, e_cur), torch.where(use_avg, xa, x1),
                torch.where(use_avg, za, z1))

    def step_avg(s, it, c, b):
        tau = (s["omega"] * inv_step)[:, None]
        sig = (inv_step / s["omega"])[:, None]
        x1, z1, xs, zs = sweep(s["x"], s["z"], s["xs"], s["zs"], c, b, tau, sig)
        nan_guard("pdlp_batch.iterate", x1, z1)
        k = s["k"] + ce
        kf = k[:, None]
        e_c, xc, zc = _candidates(x1, z1, xs / kf, zs / kf, c, b)
        do_restart, rs, out = _restart_and_track(s, it, e_c, xc, zc, k, 8 * ce)
        out.update({
            "x": torch.where(rs, xc, x1), "z": torch.where(rs, zc, z1),
            "xs": torch.where(rs, 0.0, xs), "zs": torch.where(rs, 0.0, zs),
        })
        return out

    def step_halpern(s, it, c, b):
        # per-lane anchors, step counts and restarts ([:, None] broadcasts)
        tau = (s["omega"] * inv_step * _HALPERN_STEP_SCALE)[:, None]
        sig = (inv_step / s["omega"] * _HALPERN_STEP_SCALE)[:, None]
        k0 = s["k"].to(dtype)[:, None]
        x1, z1, xt, zt, xts, zts = sweep(
            s["x"], s["z"], s["xs"], s["zs"], s["xts"], s["zts"],
            c, b, tau, sig, k0)
        nan_guard("pdlp_batch.iterate", x1, z1)
        k = s["k"] + ce
        # two candidates: the last operator output (feasible) and the
        # in-epoch mean of operator outputs, which smooths f32 rounding
        # noise at the KKT floor
        kf = k.to(dtype)[:, None]
        e_c, xc, zc = _candidates(xt, zt, xts / kf, zts / kf, c, b)
        # restart-to-current-iterate; the artificial floor is one check
        # interval
        do_restart, rs, out = _restart_and_track(s, it, e_c, xc, zc, k, ce)
        out.update({
            "x": torch.where(rs, xc, x1), "z": torch.where(rs, zc, z1),
            # xs/zs carry the per-lane Halpern ANCHOR (a restart
            # re-anchors the lane at its candidate); xts/zts the in-epoch
            # operator-output sums (a restart zeroes them)
            "xs": torch.where(rs, xc, s["xs"]), "zs": torch.where(rs, zc, s["zs"]),
            "xts": torch.where(rs, 0.0, xts), "zts": torch.where(rs, 0.0, zts),
        })
        return out

    step = step_halpern if algo == "halpern" else step_avg

    def solver(batched_params, start=None) -> LPResult:
        # batch axis = any leaf with one extra leading dim vs defaults;
        # broadcast leaves map with in_dims None
        params = _params_on(batched_params, dev)
        axes, B = _lane_axes(nlp, params)
        if B is None:
            raise ValueError("no leaf carries a leading batch axis")
        c, b = torch.func.vmap(lambda p: _lp_rhs(nlp, p, dc_j, dr_j, dtype),
                               in_dims=(axes,))(params)
        c, b = c.contiguous(), b.contiguous()

        if start is None:
            # cold path: the historical init
            x = torch.clamp(torch.zeros(n, dtype=dtype, device=dev), lb_h,
                            ub_h).expand(B, n).contiguous()
            z = torch.zeros((B, m), dtype=dtype, device=dev)
            start_kind = None
        else:
            # per-lane primal–dual starts mapped into the equilibrated
            # space and projected; zero rows reproduce the cold
            # arithmetic exactly
            x = torch.clamp(torch.as_tensor(start[0], device=dev).to(dtype)
                            / dc_j[None, :], lb_h, ub_h)
            zw = torch.as_tensor(start[1], device=dev).to(dtype) / dr_j[None, :]
            z = torch.where(is_eq[None, :], zw, torch.clamp(zw, min=0.0))
            kind = (start[2] if len(start) > 2
                    else torch.full((B,), START_EXACT, dtype=torch.int32))
            start_kind = torch.as_tensor(kind, device=dev).to(torch.int32)

        nb = torch.linalg.vector_norm(b, dim=-1)
        nc = torch.linalg.vector_norm(c, dim=-1)
        omega0 = torch.where(
            (nb > 0.0) & (nc > 0.0),
            torch.clamp(nb / nc, 1e-4, 1e6),
            torch.tensor(opt.omega0, dtype=dtype, device=dev),
        ).to(dtype)

        e0 = _err(x, z, c, b)
        zeros_i = torch.zeros(B, dtype=torch.int32, device=dev)
        s = {
            "x": x, "z": z,
            # avg: running sums (start at 0); halpern: per-lane anchor
            # (start at the initial point)
            "xs": x if algo == "halpern" else torch.zeros_like(x),
            "zs": z if algo == "halpern" else torch.zeros_like(z),
            "k": zeros_i,
            "xr": x, "zr": z, "e_r": e0, "omega": omega0,
            "it_done": zeros_i,
            "done": e0 < tol_main, "e_b": e0,
            "stall": zeros_i,
            "xb": x, "zb": z,
        }
        if algo == "halpern":
            # in-epoch operator-output sums (the second candidate)
            s["xts"] = torch.zeros_like(x)
            s["zts"] = torch.zeros_like(z)
        it = 0
        while it < opt.max_iter and not bool(s["done"].all()):
            s = step(s, it, c, b)
            it += ce

        xb, zb = s["xb"], s["zb"]
        if plan.rounds:
            xh, zh, pr, du, gap, refined = _refine(xb, zb, c, b, s["omega"])
            xb = xh.to(dtype)
            zb = zh.to(dtype)
        else:
            pr, du, gap = _kkt_errors(xb, zb, c, b)
            refined = torch.zeros(B, dtype=torch.int32, device=dev)
        x_scaled = xb * dc_j[None, :]
        obj = torch.func.vmap(
            lambda xv, pv: nlp.user_objective(xv.to(f64), pv),
            in_dims=(0, axes),
        )(x_scaled, params)
        err = torch.maximum(torch.maximum(pr, du), gap)
        return LPResult(
            x=x_scaled, obj=obj, converged=err < opt.tol,
            # per-lane count: frozen at convergence, global for lanes
            # that ran out the clock
            iters=torch.where(s["done"], s["it_done"], it),
            pr_err=pr, du_err=du, gap=gap,
            # row duals back in the ORIGINAL constraint space, per lane
            z=zb * dr_j[None, :],
            refined=refined,
            start_kind=start_kind,
        )

    return solver
