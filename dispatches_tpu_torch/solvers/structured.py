"""Structured (bordered block-tridiagonal) KKT factorization for
time-indexed NLPs (counterpart of ``dispatches_tpu/solvers/structured.py``).

The NLPs the flowsheet builds are time-structured by construction:
``tshift`` linking gives every constraint row support on periods
{t-1, t, t+1}, and scalar design variables plus periodic rows couple
globally.  Ordering the unknowns period-major turns the KKT matrix into

    [ block-tridiagonal    border ]      u_t = (y_t, lam_t)
    [ border^T             dense  ]      border = design vars,
                                                  periodic rows, ...

which factorizes in O(T*nb^3) by block forward elimination with a small
dense Schur complement for the border.

Structure is detected, not declared: variables with a leading time axis
are period unknowns, everything else is border; constraint blocks of
length T are probed with Jacobian-vector products and classified banded
if their response stays within {t-1, t, t+1}.  Per-iteration block
extraction uses 3-colouring: seeding every third period at once recovers
the sub-/diagonal/super-diagonal blocks of J and of the Lagrangian
Hessian from 3*nps + n_by JVPs/HVPs instead of n of them.

The solve is batched over scenario lanes: ``y`` and the vectors carry a
leading lane axis, and the callables map a (B, n_y) batch to (B, rows)
lane by lane.  The elimination over periods is a Python loop over T,
each step one batched ``torch.linalg`` call over lanes.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from dispatches_tpu_torch import resolve_device
from dispatches_tpu_torch.solvers.pdlp import _params_on


class TimeStructure(NamedTuple):
    T: int
    # per-period y slots: (T, nps) index matrix into y (x part and
    # banded-inequality slacks); border y slots: (n_by,)
    period_y_idx: np.ndarray
    border_y_idx: np.ndarray
    # per-period constraint rows: (T, npc) into the stacked [eq; ineq]
    # row space; border rows: (n_bc,)
    period_c_idx: np.ndarray
    border_c_idx: np.ndarray
    nps: int  # y slots per period
    npc: int  # constraint rows per period
    n_by: int
    n_bc: int


def jvp_fn(fn, y):
    """``v -> J v`` for the Jacobian J of ``fn`` at ``y``, by reverse mode
    twice: J v is the VJP of the linear map u -> J'u.  The JAX package
    takes forward-mode JVPs here; in torch, forward mode through the
    models' mixed dual/constant arithmetic costs several times a reverse
    pass (its zero tangents take a slow path), while this costs about
    two reverse passes, and the returned function replays the graph for
    any number of ``v`` (``torch.func.vmap`` it over a seed batch)."""
    out, vjp_y = torch.func.vjp(fn, y)
    return _jvp_of(vjp_y, out)


def _jvp_of(vjp_y, out):
    """``v -> J v`` from the VJP ``vjp_y`` of a map at a point (``out`` is
    its value there)."""
    _, vjp_u = torch.func.vjp(lambda u: vjp_y(u)[0], torch.zeros_like(out))
    return lambda v: vjp_u(v)[0]


def _probe_responses(res_fn, y0, n_y, T, idx_of, probes, rng, device):
    """One JVP per probe period, shared by every constraint block:
    returns {t0: |response|} over all rows of ``res_fn``, or None when
    any response is non-finite (the probe point left the model's domain,
    so the caller falls back to the dense path)."""
    out = {}
    for t0 in probes:
        tang = np.zeros(n_y)
        tang[idx_of[t0]] = rng.uniform(0.5, 1.5, idx_of.shape[1])
        _, dr = torch.func.jvp(
            res_fn, (y0,), (torch.as_tensor(tang, device=device),))
        dr = dr.detach().cpu().numpy()
        if not np.all(np.isfinite(dr)):
            return None
        out[t0] = np.abs(dr)
    return out


def _segment_banded(resp, rows, probes) -> bool:
    """True iff the length-T row segment responds only within
    {t0-1, t0, t0+1} for every probe period t0."""
    for t0, dr in resp.items():
        seg = dr[rows]
        hit = np.nonzero(seg > 1e-12)[0]
        if hit.size and (hit.min() < t0 - 1 or hit.max() > t0 + 1):
            return False
    return True


def detect_time_structure(nlp, min_T: int = 8, device=None) -> Optional[TimeStructure]:
    """Classify an NLP's variables/constraints into period-banded and
    border sets, or return None when the problem has no usable time
    structure (the dense path stays in charge).  The probes run in
    float64 on ``device`` (``cuda`` unless given); the classification and
    the index maps are host numpy."""
    dev = resolve_device(device)
    T = int(getattr(nlp.fs, "horizon", 0))
    if T < min_T:
        return None
    n_x, m_eq, m_in = nlp.n, nlp.m_eq, nlp.m_ineq

    # --- variables ---------------------------------------------------
    per_x: List[np.ndarray] = []  # each (T,) of x indices for one slot
    border_x: List[int] = []
    for name in nlp.free_names:
        a, b, shape = nlp._slices[name]
        if len(shape) >= 1 and shape[0] == T:
            k = int(np.prod(shape[1:], dtype=int)) if len(shape) > 1 else 1
            for j in range(k):
                per_x.append(a + np.arange(T) * k + j)
        else:
            border_x.extend(range(a, b))
    if not per_x:
        return None

    # --- constraints -------------------------------------------------
    rng = np.random.default_rng(7)
    params = _params_on(nlp.default_params(), dev)
    # probe point: x0 jittered away from coincidental zeros
    x_probe = torch.as_tensor(
        np.asarray(nlp.x0) + rng.uniform(0.05, 0.15, n_x), device=dev)
    idx_x = np.stack(per_x, axis=1)  # (T, nvx)

    def eq_fn(x):
        return nlp.eq(x, params)

    def ineq_fn(x):
        return nlp.ineq(x, params)

    # Two shared probe periods; one JVP each over all rows at once.
    # Constraint blocks whose size is a multiple of T (port connections
    # concatenate k member streams into one k*T block) are split into
    # length-T segments classified independently.
    probes = (T // 2, max(1, T // 3))
    resp_eq = (_probe_responses(eq_fn, x_probe, n_x, T, idx_x, probes, rng, dev)
               if m_eq else {})
    resp_in = (_probe_responses(ineq_fn, x_probe, n_x, T, idx_x, probes, rng, dev)
               if m_in else {})
    if resp_eq is None or resp_in is None:
        return None

    def classify(slices, resp):
        banded_segs: List[np.ndarray] = []  # each (T,) row indices
        border_rows: List[int] = []
        for a, b in slices.values():
            size = b - a
            if size and size % T == 0:
                for j in range(size // T):
                    rows = a + j * T + np.arange(T)
                    if _segment_banded(resp, rows, probes):
                        banded_segs.append(rows)
                    else:
                        border_rows.extend(rows.tolist())
            else:
                border_rows.extend(range(a, b))
        return banded_segs, border_rows

    banded_eq, border_eq_rows = classify(nlp.eq_slices, resp_eq)
    banded_in, border_in_rows = classify(nlp.ineq_slices, resp_in)

    # --- period-major index maps ------------------------------------
    # y = [x (n_x), slacks (m_in)]; stacked rows = [eq (m_eq), ineq (m_in)]
    y_cols = [idx_x]  # (T, nvx)
    for rows in banded_in:
        y_cols.append((n_x + rows)[:, None])
    period_y_idx = np.concatenate(y_cols, axis=1)

    c_cols = []
    for rows in banded_eq:
        c_cols.append(rows[:, None])
    for rows in banded_in:
        c_cols.append((m_eq + rows)[:, None])
    if not c_cols:
        return None
    period_c_idx = np.concatenate(c_cols, axis=1)

    border_y_idx = np.asarray(
        border_x + [n_x + r for r in border_in_rows], dtype=np.int64)
    border_c_idx = np.asarray(
        border_eq_rows + [m_eq + r for r in border_in_rows], dtype=np.int64)

    # --- Lagrangian-Hessian bandedness probe -------------------------
    # The block-tridiagonal form also requires W = d2L/dx2 to couple only
    # adjacent periods: probe rather than assume.
    lam_r = torch.as_tensor(rng.standard_normal(m_eq + m_in), device=dev)

    def lag(xx):
        val = nlp.objective(xx, params)
        if m_eq:
            val = val + nlp.eq(xx, params) @ lam_r[:m_eq]
        if m_in:
            val = val + nlp.ineq(xx, params) @ lam_r[m_eq:]
        return val

    lag_grad = torch.func.grad(lag)
    for t0 in (T // 2, max(1, T // 3)):
        tang = np.zeros(n_x)
        tang[idx_x[t0]] = rng.uniform(0.5, 1.5, idx_x.shape[1])
        _, dg = torch.func.jvp(lag_grad, (x_probe,), (torch.as_tensor(tang, device=dev),))
        dg = dg.detach().cpu().numpy()
        if not np.all(np.isfinite(dg)):
            return None  # probe left the model's domain: stay dense
        resp = np.abs(dg)[idx_x]  # (T, nvx)
        resp[max(0, t0 - 1): t0 + 2] = 0.0
        if resp.max() > 1e-10:
            return None

    return TimeStructure(
        T=T,
        period_y_idx=period_y_idx,
        border_y_idx=border_y_idx,
        period_c_idx=period_c_idx,
        border_c_idx=border_c_idx,
        nps=period_y_idx.shape[1],
        npc=period_c_idx.shape[1],
        n_by=len(border_y_idx),
        n_bc=len(border_c_idx),
    )


def make_structured_kkt(ts: TimeStructure, n_y: int, m: int, device=None):
    """Build ``solve(cons_fn, lag_grad_fn, y, Sigma, r1, c, delta_w,
    delta_c) -> (dy, dlam, ok)`` solving, lane by lane,

        [[W + diag(Sigma) + delta_w*I, J^T], [J, -delta_c*I]]
            [dy; dlam] = [-r1; -c]

    by bordered block-tridiagonal elimination.  ``y``, ``Sigma``, ``r1``
    and ``c`` carry a leading lane axis (B, ...) and ``cons_fn`` /
    ``lag_grad_fn`` map a (B, n_y) batch to (B, m) / (B, n_y) lane by
    lane; W = d(lag_grad)/dy is extracted by HVP colouring, J by JVP
    colouring.  Unbatched inputs (``y`` of shape (n_y,), per-scenario
    callables) are solved as one lane.  ``delta_w`` is a float or a (B,)
    tensor.  The seed basis lives on ``device`` (``cuda`` unless
    given).  A batched caller that already holds the constraints' VJP at
    ``y`` (``cons_vjp = (c(y), vjp)``) or the W-vector product there
    (``lag_jvp``, from ``jvp_fn``) passes them to skip rebuilding them."""
    dev = resolve_device(device)
    T, nps, npc = ts.T, ts.nps, ts.npc
    n_by, n_bc = ts.n_by, ts.n_bc
    nb = nps + npc  # per-period KKT block size
    nB = n_by + n_bc  # border block size

    py = torch.as_tensor(ts.period_y_idx, device=dev)  # (T, nps)
    pc = torch.as_tensor(ts.period_c_idx, device=dev)  # (T, npc)
    by = torch.as_tensor(ts.border_y_idx, device=dev)
    bc = torch.as_tensor(ts.border_c_idx, device=dev)

    # seed basis: (3*nps, n_y) period seeds (colour k, slot i = sum over
    # t = k mod 3 of e_{py[t, i]}) then (n_by, n_y) border seeds
    colors = np.arange(T) % 3
    S_np = np.zeros((3 * nps + n_by, n_y))
    for k in range(3):
        tsel = np.nonzero(colors == k)[0]
        for i in range(nps):
            S_np[k * nps + i, ts.period_y_idx[tsel, i]] = 1.0
    for jb in range(n_by):
        S_np[3 * nps + jb, ts.border_y_idx[jb]] = 1.0
    S = torch.as_tensor(S_np, dtype=torch.float64, device=dev)
    # border-row selectors for the VJPs: (n_bc, m) one-hot rows
    E_bc = torch.zeros((n_bc, m), dtype=torch.float64, device=dev)
    E_bc[torch.arange(n_bc, device=dev), bc] = 1.0

    # gather maps for block extraction: the response R has shape
    # (B, n_seeds, n_rows); blocks
    #   A_t[r, i] = R[color(t)*nps + i,   row(r, t)]   (diagonal)
    #   B_t[r, i] = R[color(t-1)*nps + i, row(r, t)]   (sub)
    #   C_t[r, i] = R[color(t+1)*nps + i, row(r, t)]   (super)
    def seed_rows(col_sel):
        return torch.as_tensor(col_sel[:, None] * nps + np.arange(nps)[None, :],
                               device=dev)  # (T, nps)

    sel_a = seed_rows(colors)
    sel_b = seed_rows(np.roll(colors, 1))   # color(t-1) at slot t
    sel_c = seed_rows(np.roll(colors, -1))  # color(t+1)

    def _extract_blocks(R, row_idx):
        """R: (B, n_seeds, n_rows); row_idx: (T, width).  Returns
        (A, B, C) each (B, T, width, nps) and the border-column part
        (B, T, width, n_by)."""
        rows = R.transpose(1, 2)[:, row_idx]  # (B, T, width, n_seeds)
        Tw = (T, row_idx.shape[1], nps)

        def pick(sel):
            idx = sel[:, None, :].expand(Tw)
            return torch.gather(rows, 3, idx.expand(rows.shape[0], *Tw))

        return pick(sel_a), pick(sel_b), pick(sel_c), rows[..., 3 * nps:]

    def _solve(cons_fn, lag_grad_fn, y, Sigma, r1, c, delta_w, delta_c, cons_vjp, lag_jvp):
        dtype = y.dtype
        Bl = y.shape[0]
        dw = torch.as_tensor(delta_w, dtype=dtype, device=y.device)
        dw = dw.expand(Bl) if dw.ndim == 0 else dw
        Sd = S.to(dtype)[:, None, :].expand(S.shape[0], Bl, n_y)

        # ---- compressed J and W: (B, n_seeds, rows) ----------------
        # one VJP graph of the constraints serves the J seeds and the
        # border rows below
        c_at_y, vjp_c = cons_vjp if cons_vjp is not None else torch.func.vjp(cons_fn, y)
        JR = torch.func.vmap(_jvp_of(vjp_c, c_at_y))(Sd).transpose(0, 1)
        w_jvp = lag_jvp if lag_jvp is not None else jvp_fn(lag_grad_fn, y)
        WR = torch.func.vmap(w_jvp)(Sd).transpose(0, 1)

        Ja, Jb, Jc_, Je = _extract_blocks(JR, pc)   # (B, T, npc, *)
        # W is symmetric: the superdiagonal block is Wb^T, so only the
        # diagonal/subdiagonal extractions are consumed
        Wa, Wb, _, We = _extract_blocks(WR, py)     # (B, T, nps, *)

        # border rows of J (dense over y): one VJP per border row
        if n_bc:
            Eb = E_bc.to(dtype)[:, None, :].expand(n_bc, Bl, m)
            Jborder = torch.func.vmap(vjp_c)(Eb)[0].transpose(0, 1)  # (B, n_bc, n_y)
        else:
            Jborder = y.new_zeros((Bl, 0, n_y))
        # border rows/cols of W from the border seeds' responses
        Wby = WR[:, 3 * nps:, :]  # (B, n_by, n_y)

        # ---- per-period KKT blocks ---------------------------------
        Sig_p = Sigma[:, py]  # (B, T, nps)
        r1_p = r1[:, py]
        c_p = c[:, pc]
        eye_nps = torch.eye(nps, dtype=dtype, device=y.device)
        eye_npc = torch.eye(npc, dtype=dtype, device=y.device)

        H_t = Wa + (Sig_p[..., None] + dw[:, None, None, None]) * eye_nps
        M = torch.cat([
            torch.cat([H_t, Ja.transpose(2, 3)], dim=3),
            torch.cat([Ja, (-delta_c * eye_npc).expand(Bl, T, npc, npc)], dim=3),
        ], dim=2)  # (B, T, nb, nb)

        # subdiagonal S_t (block (t, t-1)) = [[Wb_t, Jc_{t-1}^T], [Jb_t, 0]]
        Jc_prev = torch.roll(Jc_, 1, dims=1)
        Sub = torch.cat([
            torch.cat([Wb, Jc_prev.transpose(2, 3)], dim=3),
            torch.cat([Jb, y.new_zeros((Bl, T, npc, npc))], dim=3),
        ], dim=2)
        Sub[:, 0] = 0.0  # no t = -1

        # border coupling E_t (nb x nB): y-part from We/Je, plus the
        # border J rows' dependence on period unknowns
        JB_period = Jborder[:, :, py].permute(0, 2, 1, 3)  # (B, T, n_bc, nps)
        E_y = torch.cat([We, JB_period.transpose(2, 3)], dim=3)  # (B, T, nps, nB)
        E_c = torch.cat([Je, y.new_zeros((Bl, T, npc, n_bc))], dim=3)
        E = torch.cat([E_y, E_c], dim=2)  # (B, T, nb, nB)

        # border diagonal D (nB x nB)
        D_yy = Wby[:, :, by] + torch.diag_embed(Sigma[:, by]) \
            + dw[:, None, None] * torch.eye(n_by, dtype=dtype, device=y.device)
        D_cy = Jborder[:, :, by]  # (B, n_bc, n_by)
        D = torch.cat([
            torch.cat([D_yy, D_cy.transpose(1, 2)], dim=2),
            torch.cat([D_cy, (-delta_c * torch.eye(n_bc, dtype=dtype, device=y.device))
                       .expand(Bl, n_bc, n_bc)], dim=2),
        ], dim=1)
        rB = torch.cat([-r1[:, by], -c[:, bc]], dim=1)  # (B, nB)

        r_t = torch.cat([-r1_p, -c_p], dim=2)  # (B, T, nb)

        # ---- forward block elimination over periods -----------------
        # each period carries [M_t | E_t | r_t] and the border [D | rB], so a
        # step is one LU solve and two products; singular blocks are not
        # checked here: they surface as non-finite dy and ok=False, as in
        # the JAX package
        MEr = torch.cat([M, E, r_t[..., None]], dim=3)  # (B, T, nb, nb+nB+1)
        DrB = torch.cat([D, rB[..., None]], dim=2)      # (B, nB, nB+1)
        Er = MEr[:, 0, :, nb:]                           # [E_hat_0 | r_hat_0]
        lus, Ers = [torch.linalg.lu_factor_ex(M[:, 0])[:2]], [Er]
        for t in range(1, T):
            S_t = Sub[:, t]
            X = torch.linalg.lu_solve(*lus[-1], torch.cat([S_t.transpose(1, 2), Er], dim=2))
            DrB = DrB - torch.bmm(Er[..., :nB].transpose(1, 2), X[..., nb:])
            new = MEr[:, t] - torch.bmm(S_t, X)
            lus.append(torch.linalg.lu_factor_ex(new[..., :nb])[:2])
            Er = new[..., nb:]
            Ers.append(Er)
        # the border Schur complement also subtracts the last block's term
        DrB = DrB - torch.bmm(Er[..., :nB].transpose(1, 2), torch.linalg.lu_solve(*lus[-1], Er))

        # ---- border solve + backward substitution -------------------
        if nB:
            d = torch.linalg.solve_ex(DrB[..., :nB], DrB[..., nB])[0]
        else:
            d = y.new_zeros((Bl, 0))
        ErS = torch.stack(Ers, dim=1)  # (B, T, nb, nB+1)
        rr = ErS[..., nB] - (ErS[..., :nB] @ d[:, None, :, None])[..., 0]  # r_hat - E_hat d
        # columns, not vectors: (B, nb, 1) throughout the substitution
        rr = rr[..., None]
        SubT = Sub.transpose(2, 3).contiguous()
        us = [None] * T
        u = torch.linalg.lu_solve(*lus[-1], rr[:, -1])
        us[T - 1] = u
        for t in range(T - 2, -1, -1):
            u = torch.linalg.lu_solve(*lus[t], rr[:, t] - torch.bmm(SubT[:, t + 1], u))
            us[t] = u
        U = torch.cat(us, dim=2).transpose(1, 2)  # (B, T, nb)

        # ---- scatter back to flat dy, dlam --------------------------
        dy = y.new_zeros((Bl, n_y))
        dlam = y.new_zeros((Bl, m))
        dy[:, py.reshape(-1)] = U[..., :nps].reshape(Bl, -1)
        dlam[:, pc.reshape(-1)] = U[..., nps:].reshape(Bl, -1)
        dy[:, by] = d[:, :n_by]
        dlam[:, bc] = d[:, n_by:]

        ok = torch.isfinite(dy).all(dim=1) & torch.isfinite(dlam).all(dim=1)
        return dy, dlam, ok

    def solve(cons_fn, lag_grad_fn, y, Sigma, r1, c, delta_w, delta_c, *,
              cons_vjp=None, lag_jvp=None):
        if y.ndim == 2:
            return _solve(cons_fn, lag_grad_fn, y, Sigma, r1, c, delta_w, delta_c,
                          cons_vjp, lag_jvp)
        dy, dlam, ok = _solve(
            lambda Y: cons_fn(Y[0])[None], lambda Y: lag_grad_fn(Y[0])[None],
            y[None], Sigma[None], r1[None], c[None], delta_w, delta_c, None, None)
        return dy[0], dlam[0], ok[0]

    return solve
