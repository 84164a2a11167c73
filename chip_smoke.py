#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``dispatches_tpu_torch``) on one
NVIDIA GPU.  Run from the repository root: ``python3 chip_smoke.py``.

Phases (any failure exits nonzero; nothing is caught and passed over):

1. device: print the card's name and power limit (nvidia-smi), build the
   PDHG sweep kernels from ``dispatches_tpu_torch/csrc`` with nvcc;
2. main path: build the 24-h wind+battery price-taker LP on ``cuda``,
   solve 366, 1024 and 4096 LMP scenarios through
   ``make_pdlp_batch_solver`` (halpern, f32, tol 1e-5), then 366 with
   ``algorithm="avg"`` and 366 with ``precision="bf16x-f32"``; check
   that the kernels were launched and that 16 scenarios agree with
   scipy's HiGHS on the port's own LP data to 1e-4 relative; then trace
   one B = 4096 solve with torch.profiler;
3. kernels: hold each kernel (avg and halpern; f32, f64 and bf16-operand
   tiers) to its plain PyTorch version on the card: at the main-path
   shapes (m 218, n 193, k 40; B = 4096 and a ragged B = 366), and on a
   dense, an empty-row-and-column, a dense too large for shared memory
   and a wide operator, so that every kernel family runs; then time the
   kernels against their plain versions in turns with CUDA events (f32 at
   B = 366, 1024, 4096; f64 and bf16 at 4096) and sweep lanes per block;
4. the interior-point path (float64; it runs no hand-written kernel, and
   the sweep kernels' counts are read around it to show so):
   ``[entry]`` ``entry()`` over its 8 LMP lanes, status-0 objectives
   within 1e-6 of HiGHS; ``[ipm]`` the phase-2 model at B = 366,
   max_iter 300, on the structured (``kkt="auto"``) and the dense KKT
   path, 16 lanes within 1e-6 of HiGHS; ``[ipm-trace]`` one warmed
   structured B = 366 solve under torch.profiler; ``[pdlp1]`` the
   per-scenario PDLP solver on 4 scenarios (halpern f32 tol 1e-5; f64
   tol 1e-8 with the polish); ``[factory]`` ``SolverFactory("ipopt")``
   and ``("cbc")`` on a storage LP, and ``cbc``'s IPM fallback on a
   non-affine model; ``[optimize]`` ``wind_battery_optimize`` at T = 24
   and T = 168 with the battery size free, against HiGHS.

The line before the last is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
T = 24
WIND_MW, BATT_MW = 200.0, 25.0
N_SCENARIOS = 366
PEAK_BATCHES = (1024, 4096)
N_HIGHS = 16
K_STEPS = 40
OBJ_RTOL = 1e-4                 # the system's objective target vs HiGHS
IPM_RTOL = 1e-6                 # IPM (tol 1e-8) and f64 PDLP objectives vs HiGHS
F32_TOL, F64_TOL = 1e-5, 1e-10  # kernel vs plain, relative to max(1, |want|)
H100_F32_FLOPS = 67e12          # CUDA-core f32 peak, H100 SXM data sheet
H100_F64_FLOPS = 34e12          # CUDA-core f64 peak, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def scenarios(n, rng):
    """LMP ($/MWh) and wind capacity-factor batches for n scenarios (the
    same recipe as the JAX bench)."""
    lmps = 35.0 + 25.0 * np.sin(
        2 * np.pi * (np.arange(T)[None, :] + rng.uniform(0, 24, (n, 1))) / 24
    ) + 5.0 * rng.standard_normal((n, T))
    lmps = np.clip(lmps, 0.0, 200.0)
    cfs = np.clip(0.35 + 0.3 * rng.random((n, T)), 0.0, 1.0)
    return lmps, cfs


# ---------------------------------------------------------------------
# phase 1: device and build
# ---------------------------------------------------------------------

def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    # full-precision products everywhere (the KKT checks, the plain
    # sweeps): TF32 would floor PDLP's accuracy
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from dispatches_tpu_torch.kernels import pdhg_sweep

    t0 = time.perf_counter()
    pdhg_sweep.build()
    lib = pdhg_sweep.library_path()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s")
    log = lib.with_suffix(".log")
    if log.exists():
        _ptxas_summary(log.read_text())
    return card


def _ptxas_summary(text):
    """Registers and spill bytes per kernel family (type, items per
    thread; 0 = state in shared memory), from the ptxas -v build log."""
    import re

    fam, worst = None, {}
    for line in text.splitlines():
        hit = re.search(r"pdhg_sweep_kernelI([fd])Lb(\d)ELb(\d)ELi(\d+)ELb(\d)E", line)
        if "Compiling entry function" in line:
            fam = ("f32" if hit.group(1) == "f" else "f64", int(hit.group(4))) if hit else None
        regs = re.search(r"Used (\d+) registers", line)
        spill = re.search(r"(\d+) bytes spill stores", line)
        if fam and (regs or spill):
            r, sp = worst.get(fam, (0, 0))
            worst[fam] = (max(r, int(regs.group(1))) if regs else r,
                          max(sp, int(spill.group(1))) if spill else sp)
    for (dt, items), (r, sp) in sorted(worst.items()):
        print(f"[build] ptxas {dt} items/thread={items}: max {r} registers/thread, "
              f"max {sp} bytes spill stores")


# ---------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------

def _sweep_inputs(torch, Ah, lb, ub, m_eq, B, dtype, device, seed):
    rng = np.random.default_rng(seed)
    m, n = Ah.shape
    lb32, ub32 = lb.astype(np.float64), ub.astype(np.float64)
    from dispatches_tpu_torch.solvers.pdlp import _power_norm

    step = 0.4 / _power_norm(Ah)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)

    const = dict(Ah=t(Ah), AhT=t(Ah.T), lb=t(lb32), ub=t(ub32),
                 eq=t(np.r_[np.ones(m_eq), np.zeros(m - m_eq)]))
    lane = dict(
        x=t(np.clip(rng.standard_normal((B, n)), lb32, ub32)),
        z=t(rng.standard_normal((B, m))),
        xa=t(np.clip(rng.standard_normal((B, n)), lb32, ub32)),
        za=t(rng.standard_normal((B, m))),
        xs=t(rng.standard_normal((B, n))),
        zs=t(rng.standard_normal((B, m))),
        c=t(0.1 * rng.standard_normal((B, n))),
        b=t(0.1 * rng.standard_normal((B, m))),
        tau=t(np.full((B, 1), step)),
        sig=t(np.full((B, 1), step)),
        k0=t(rng.integers(0, 200, (B, 1))),
    )
    return const, lane


def _args(algo, const, lane):
    c = [const[k] for k in ("Ah", "AhT", "lb", "ub", "eq")]
    if algo == "halpern":
        return c + [lane[k] for k in ("x", "z", "xa", "za", "xs", "zs", "c",
                                      "b", "tau", "sig", "k0")]
    return c + [lane[k] for k in ("x", "z", "xs", "zs", "c", "b", "tau", "sig")]


def _time_ms(torch, fn, reps):
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph, the graph replayed between CUDA events.  A sweep of the new
    kernels takes less device time than the wrapper's Python takes to
    launch it, so events around eager calls would time the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _call_ms(torch, fn, reps):
    """Time of one eager call of ``fn``, host launch included."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _other_operators(Ah_main, lb_main, ub_main, m_eq_main):
    """(name, Ah, lb, ub, m_eq, lanes) beside the main path's operator:
    a fully dense one, the main one with an empty row and column, a dense
    one too large for shared memory (read through the read-only cache)
    and a wide sparse one whose lane state does not fit the registers
    (held in shared memory)."""
    rng = np.random.default_rng(7)

    def box(n):
        lb = np.where(rng.random(n) < 0.2, -np.inf, -1.0 - rng.random(n))
        return lb, np.where(rng.random(n) < 0.2, np.inf, 1.0 + rng.random(n))

    empty = Ah_main.copy()
    empty[5, :] = 0.0
    empty[:, 7] = 0.0
    wide = np.zeros((2100, 200))
    for i in range(2100):
        wide[i, rng.choice(200, 2, replace=False)] = rng.standard_normal(2)
    return [("dense 64x48", rng.standard_normal((64, 48)), *box(48), 32, 8),
            ("empty row+col", empty, lb_main, ub_main, m_eq_main, 8),
            ("dense 218x193", rng.standard_normal((218, 193)), *box(193), 122, 8),
            ("wide 2100x200", wide, *box(200), 1000, 2)]


def _bound(algo, m, n, nnz, B, dtype_name):
    """Least time for one sweep: each lane input and the packed operator
    read once, each output written once, at the HBM rate; or the FLOPs the
    nonzeros need at the CUDA-core peak of the compute type.  Returns
    (ms, "bytes" | "operations")."""
    esz = 8 if dtype_name == "f64" else 4
    per_lane = (7 * (n + m) + 3) if algo == "halpern" else (5 * (n + m) + 2)
    nbytes = esz * (B * per_lane + 2 * nnz + 2 * n + m) + 4 * (m + n + 2 + 2 * nnz)
    flops = 4 * nnz * K_STEPS * B
    peak = H100_F64_FLOPS if dtype_name == "f64" else H100_F32_FLOPS
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, lp, dev):
    from dispatches_tpu_torch.kernels import pdhg_sweep as ks
    from dispatches_tpu_torch.solvers.pdlp import PDLPOptions, _scalings

    K, G = lp["K"], lp["G"]
    A = np.vstack([K, G])
    m_eq = K.shape[0]
    tiers = (("f32", torch.float32, False, F32_TOL), ("f64", torch.float64, False, F64_TOL),
             ("bf16", torch.float32, True, F32_TOL))
    report = {}

    def compare(algo, wrapper, plain, const, lane, tier, low, tol, lanes, label,
                stepwise=False):
        """The kernel against its plain version over one K_STEPS sweep, or
        (``stepwise``) over K_STEPS one-step sweeps, each started from the
        kernel's own state; ``lanes`` None is the wrapper's own choice from
        B, as on the main path."""
        args = _args(algo, const, lane)
        m, n = const["Ah"].shape
        lanes = lanes or ks.default_lanes(lane["x"].shape[0], dev)
        cfg = ks.launch_config(algo == "halpern", m, n, int(torch.count_nonzero(const["Ah"])),
                               lanes, const["Ah"].dtype)
        err, scale, finite = 0.0, 1.0, True
        for _ in range(K_STEPS if stepwise else 1):
            k = 1 if stepwise else K_STEPS
            got = wrapper(*args, k=k, low_precision=low, lanes_per_block=lanes)
            want = plain(*args, k=k, low_precision=low)
            torch.cuda.synchronize()
            err = max(err, *(float((g - w).abs().max()) for g, w in zip(got, want)))
            scale = max(scale, *(float(w.abs().max()) for w in want))
            finite = finite and all(bool(torch.isfinite(g).all()) for g in got)
            # the next step from the kernel's state: halpern's k0 counts on
            if algo == "halpern":
                args[5:7], args[9:11], args[15] = got[:2], got[4:], args[15] + 1.0
            else:
                args[5:9] = got
        ok = finite and err <= tol * scale
        where = (f"items/thread={cfg.items}" if cfg.items else "state in smem") + \
            f" threads={cfg.threads} op in {'smem' if cfg.op_in_smem else 'L1/L2'}"
        print(f"[kernel] {algo:7s} {tier:4s} {label:14s} B={lane['x'].shape[0]:5d} "
              f"lanes/block={lanes:2d} ({where}){' stepwise' if stepwise else ''} "
              f"max|got-want|={err:.3e} scale={scale:.3e} tol={tol:.0e} {'ok' if ok else 'FAIL'}")
        check(ok, f"{algo} kernel disagrees with its plain version ({tier}, {label}, "
                  f"B={lane['x'].shape[0]}, lanes {lanes}): {err:.3e} > {tol:.0e} * {scale:.3e}")
        return err, (cfg.items > 0, cfg.op_in_smem)

    for algo, wrapper, plain in (("halpern", ks.halpern_sweep, ks.halpern_sweep_reference),
                                 ("avg", ks.avg_sweep, ks.avg_sweep_reference)):
        _, dc, Ah, _ = _scalings(A, PDLPOptions(algorithm=algo))
        lb, ub = lp["lb"] / dc, lp["ub"] / dc
        m, n = Ah.shape
        nnz = int(np.count_nonzero(Ah))
        errs, families = {}, set()
        # agreement: the main path's operator, then the others.  Where the
        # f32 tier is not bitwise, the plain version's matmul sums in
        # another order than the kernel's ascending one (cuBLAS picks it by
        # shape); a last-bit difference then flips bf16 operand roundings
        # that the later steps amplify, so there the bf16 tier is held to
        # its plain version step by step along the kernel's trajectory
        for tier, dtype, low, tol in tiers:
            for B in (PEAK_BATCHES[-1], N_SCENARIOS):
                const, lane = _sweep_inputs(torch, Ah, lb, ub, m_eq, B, dtype, dev, seed=B)
                errs[(tier, B)], fam = compare(algo, wrapper, plain, const, lane, tier,
                                               low, tol, None, "main")
                families.add(fam)
            for label, Ao, lbo, ubo, m_eqo, lanes in _other_operators(Ah, lb, ub, m_eq):
                const, lane = _sweep_inputs(torch, Ao, lbo, ubo, m_eqo, N_SCENARIOS, dtype,
                                            dev, seed=11)
                errs[(tier, label)], fam = compare(
                    algo, wrapper, plain, const, lane, tier, low, tol, lanes, label,
                    stepwise=low and errs[("f32", label)] > 0)
                families.add(fam)
        # registers or shared memory for the state, shared memory or the
        # read-only cache for the operator: all four kernel families ran
        check(len(families) == 4, f"{algo}: kernel families driven: {sorted(families)}")

        # times: the kernel and its plain version in turns (plain, kernel,
        # kernel, plain) after warm-up, at the lanes per block the main path
        # takes, with the operator packed once as the solver packs it
        times = {}
        for tier, dtype, low, _ in tiers:
            for B in ((N_SCENARIOS, *PEAK_BATCHES) if tier == "f32" else PEAK_BATCHES[-1:]):
                const, lane = _sweep_inputs(torch, Ah, lb, ub, m_eq, B, dtype, dev, seed=B)
                args = _args(algo, const, lane)
                packed = ks.pack_operator(const["Ah"])

                def run_kernel():
                    wrapper(*args, k=K_STEPS, low_precision=low, packed=packed)

                def run_plain():
                    plain(*args, k=K_STEPS, low_precision=low)

                for fn in (run_kernel, run_plain):
                    fn()
                torch.cuda.synchronize()
                plain_ms = [_time_ms(torch, run_plain, 3)]
                kern_ms = [_time_ms(torch, run_kernel, 200), _time_ms(torch, run_kernel, 200)]
                plain_ms.append(_time_ms(torch, run_plain, 3))
                call_ms = _call_ms(torch, run_kernel, 200)
                bound_ms, bound_by = _bound(algo, m, n, nnz, B, tier if tier == "f64" else "f32")
                times[(tier, B)] = (min(kern_ms), min(plain_ms), bound_ms, bound_by)
                print(f"[time] {algo:7s} {tier:4s} B={B:5d} lanes/block={ks.default_lanes(B, dev)}: kernel "
                      f"{kern_ms[0]:.4f}/{kern_ms[1]:.4f} ms, plain {plain_ms[0]:.4f}/"
                      f"{plain_ms[1]:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; nnz {nnz}), "
                      f"{bound_ms / min(kern_ms):.1%} of bound; one eager call {call_ms:.4f} ms")
        if algo == "halpern":
            # where a sweep's time goes: the fixed cost (k = 0) and the cost
            # of one step, with Ah as it is and with its longest column cut
            # to four nonzeros (every step waits for its slowest thread)
            cut = Ah.copy()
            longest = int(np.argmax((Ah != 0).sum(axis=0)))
            cut[np.nonzero(Ah[:, longest])[0][4:], longest] = 0.0
            for label, Ao in (("as is", Ah), ("longest column cut to 4", cut)):
                for B in (N_SCENARIOS, PEAK_BATCHES[-1]):
                    const, lane = _sweep_inputs(torch, Ao, lb, ub, m_eq, B, torch.float32,
                                                dev, seed=B)
                    args = _args(algo, const, lane)
                    packed = ks.pack_operator(const["Ah"])
                    t = {k: _time_ms(torch, lambda: wrapper(*args, k=k, packed=packed), 50)
                         for k in (0, 10, K_STEPS)}
                    print(f"[steps] halpern f32 B={B:5d} Ah {label}: k=0 {t[0]:.4f} ms, "
                          f"one step {(t[K_STEPS] - t[10]) / (K_STEPS - 10) * 1e3:.3f} us")
        ms, plain_ms, bound_ms, bound_by = times[("f32", PEAK_BATCHES[-1])]
        report[algo] = {"max_abs_err": errs[("f32", PEAK_BATCHES[-1])], "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by}

        # lanes per block: each value checked against the plain version,
        # then timed, at the annual and the peak batch (f32)
        for B in (N_SCENARIOS, PEAK_BATCHES[-1]):
            const, lane = _sweep_inputs(torch, Ah, lb, ub, m_eq, B, torch.float32, dev, seed=B)
            args = _args(algo, const, lane)
            packed = ks.pack_operator(const["Ah"])
            sweep_ms = {}
            for lanes in ks.LANES_PER_BLOCK:
                try:
                    ks.launch_config(algo == "halpern", m, n, nnz, lanes, torch.float32)
                except ValueError:
                    continue
                compare(algo, wrapper, plain, const, lane, "f32", False, F32_TOL, lanes,
                        "main")
                sweep_ms[lanes] = _time_ms(torch, lambda: wrapper(
                    *args, k=K_STEPS, lanes_per_block=lanes, packed=packed), 200)
            print(f"[lanes] {algo} f32 B={B} lanes/block -> ms: "
                  + ", ".join(f"{k}: {v:.4f}" for k, v in sorted(sweep_ms.items())))
    return report


# ---------------------------------------------------------------------
# phase 2: the main path and its trace
# ---------------------------------------------------------------------

def highs_objective(torch, nlp, lp, p, label):
    """The objective of one scenario (params ``p``, numpy leaves) solved by
    scipy's HiGHS on the port's own LP data (K, G, bounds; c, q, h derived
    on the host)."""
    from scipy.optimize import linprog

    x0 = torch.zeros(nlp.n, dtype=torch.float64, device=torch.device("cpu"))
    bounds = [(None if not np.isfinite(lo) else lo, None if not np.isfinite(hi) else hi)
              for lo, hi in zip(lp["lb"], lp["ub"])]
    c = torch.func.grad(lambda x: nlp.objective(x, p))(x0).numpy()
    q = -nlp.eq(x0, p).numpy()
    h = -nlp.ineq(x0, p).numpy()
    res = linprog(c, A_ub=lp["G"] if lp["G"].size else None, b_ub=h if h.size else None,
                  A_eq=lp["K"], b_eq=q, bounds=bounds, method="highs")
    check(res.status == 0, f"HiGHS failed on {label}: {res.message}")
    return float(nlp.user_objective(torch.as_tensor(res.x), p))


def highs_objectives(torch, nlp, lp, lmps, cfs):
    """HiGHS objectives of the first scenarios (LMPs in $/MWh)."""
    defaults = nlp.default_params()
    return np.asarray([highs_objective(
        torch, nlp, lp, {"p": {**defaults["p"], "lmp": lmps[s] * 1e-3,
                               "windpower.capacity_factor": cfs[s]},
                         "fixed": defaults["fixed"]}, f"scenario {s}")
        for s in range(len(lmps))])


def phase_main_path(torch, dev):
    from dispatches_tpu_torch.case_studies.renewables.wind_battery_lmp import (
        wind_battery_pricetaker_nlp,
    )
    from dispatches_tpu_torch.kernels import pdhg_sweep as ks
    from dispatches_tpu_torch.solvers import BatchPDLPOptions, make_lp_data, make_pdlp_batch_solver

    rng = np.random.default_rng(0)
    lmps, cfs = scenarios(N_SCENARIOS, rng)
    _, nlp = wind_battery_pricetaker_nlp(T, {
        "wind_mw": WIND_MW, "batt_mw": BATT_MW, "design_opt": False,
        "extant_wind": True, "capacity_factors": cfs[0], "DA_LMPs": lmps[0]})
    lp = make_lp_data(nlp, device=dev)
    nnz = int(np.count_nonzero(np.vstack([lp["K"], lp["G"]])))
    print(f"[lp] n={nlp.n} m_eq={nlp.m_eq} m_ineq={nlp.m_ineq} nnz={nnz}")
    check((nlp.n, nlp.m_eq, nlp.m_ineq) == (193, 122, 96), "unexpected LP shape")

    ref = highs_objectives(torch, nlp, lp, lmps[:N_HIGHS], cfs[:N_HIGHS])
    defaults = nlp.default_params()
    main = {"nlp": nlp, "lp": lp, "ref": ref, "lmps": lmps, "cfs": cfs}

    def batch(lmp_b, cf_b):
        return {"p": {**defaults["p"],
                      "lmp": torch.as_tensor(lmp_b * 1e-3, device=dev),
                      "windpower.capacity_factor": torch.as_tensor(cf_b, device=dev)},
                "fixed": defaults["fixed"]}

    runs = [("halpern", {}, N_SCENARIOS, lmps, cfs)]
    for B in PEAK_BATCHES:
        runs.append(("halpern", {}, B, *scenarios(B, np.random.default_rng(B))))
    runs.append(("avg", {"algorithm": "avg"}, N_SCENARIOS, lmps, cfs))
    runs.append(("halpern", {"precision": "bf16x-f32"}, N_SCENARIOS, lmps, cfs))

    # warm-up (CUDA context, cuBLAS, the kernel library) before timing
    make_pdlp_batch_solver(nlp, BatchPDLPOptions(tol=1e-5, dtype="float32"),
                           lp_data=lp, device=dev)(batch(lmps, cfs))
    torch.cuda.synchronize()

    ks.avg_sweep.launches = 0
    ks.halpern_sweep.launches = 0
    for kernel, extra, B, lmp_b, cf_b in runs:
        opts = BatchPDLPOptions(tol=1e-5, dtype="float32", **extra)
        solver = make_pdlp_batch_solver(nlp, opts, lp_data=lp, device=dev)
        wrapper = ks.halpern_sweep if kernel == "halpern" else ks.avg_sweep
        params = batch(lmp_b, cf_b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = wrapper.launches
        t0 = time.perf_counter()
        res = solver(params)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = wrapper.launches - before
        obj = res.obj.cpu().numpy()
        iters = res.iters.cpu().numpy()
        conv = float(res.converged.float().mean())
        refined = float(res.refined.float().mean())
        label = f"{kernel}{'/' + extra.get('precision', '') if 'precision' in extra else ''}"
        check(obj.shape == (B,) and np.all(np.isfinite(obj)),
              f"{label} B={B}: objectives not finite of shape ({B},)")
        check(tuple(res.x.shape) == (B, nlp.n) and bool(torch.isfinite(res.x).all()),
              f"{label} B={B}: x not finite of shape ({B}, {nlp.n})")
        check(launches > 0, f"{label} B={B}: the {kernel} kernel was never launched")
        check(launches == math.ceil(iters.max() / K_STEPS),
              f"{label} B={B}: {launches} launches for max {iters.max()} iterations")
        line = (f"[main] {label:18s} B={B:5d} converged={conv:.4f} "
                f"iters_mean={iters.mean():.1f} iters_max={iters.max()} "
                f"refine_mean={refined:.2f} solves/s={B / dt:.1f} ({dt * 1e3:.1f} ms) "
                f"peak_mem={torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
                f"launches={launches}")
        if lmp_b is lmps and not extra:
            main["pdlp_obj"] = obj
        if lmp_b is lmps:
            rel = np.abs(obj[:N_HIGHS] - ref) / np.maximum(np.abs(ref), 1.0)
            line += f" obj_rel_err_vs_highs={rel.max():.3e}"
            check(rel.max() <= OBJ_RTOL,
                  f"{label} B={B}: objective error {rel.max():.3e} > {OBJ_RTOL}")
        print(line)
        if kernel == "halpern" and not extra and B == PEAK_BATCHES[-1]:
            traced = (solver, params)
    launches = {"halpern": ks.halpern_sweep.launches, "avg": ks.avg_sweep.launches}
    check(all(v > 0 for v in launches.values()), f"kernel launch counts {launches}")
    phase_trace(torch, *traced)
    return main, launches


def profile_run(torch, run, tag):
    """One call of ``run`` (already warmed) under torch.profiler: prints the
    host wall, the profiled window, the device's busy time and idle share
    and the top ten device operations by total time, with ``tag`` at the
    head of each line.  Reads the profiler's raw events (the per-operation
    tables would take minutes to build for a solve of 10^5-10^6 launches).
    Returns (result, profiler, {name: (launches, device us)}, total device
    us, window us); the dict is empty when the profiler saw no device
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print(f"{tag} solve: {wall_ms:.1f} ms host wall under the profiler")
    by_name, spans, lo, hi = {}, [], math.inf, -math.inf
    for e in prof.profiler.kineto_results.events():
        a, d = e.start_ns() / 1e3, e.duration_ns() / 1e3
        lo, hi = min(lo, a), max(hi, a + d)
        if e.device_type() == DeviceType.CUDA and d > 0:
            spans.append((a, a + d))
            n, t = by_name.get(e.name(), (0, 0.0))
            by_name[e.name()] = (n + 1, t + d)
    if not spans:
        print(f"{tag} device time not measured: the profiler recorded no device activity")
        return res, prof, {}, 0.0, 0.0
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    window = hi - lo
    total = sum(t for _, t in by_name.values())
    print(f"{tag} window {window / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, "
          f"device idle share {1 - busy / window:.4f}")
    print(f"{tag} device operations: {len(by_name)} kinds, {len(spans)} launches, "
          f"{total / 1e3:.3f} ms; top ten by total time:")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"{tag}   {t / 1e3:9.3f} ms {n:6d}x  {name[:100]}")
    return res, prof, by_name, total, window


def phase_trace(torch, solver, params):
    """One warmed halpern f32 B = 4096 solve under torch.profiler, and the
    sweep kernel's share of the device time and of the window.  The
    profiler's table (60 rows) goes to standard error."""
    solver(params)
    torch.cuda.synchronize()
    res, prof, by_name, total, window = profile_run(
        torch, lambda: solver(params), f"[trace] halpern f32 B={params['p']['lmp'].shape[0]}")
    check(bool(torch.isfinite(res.obj).all()), "traced solve: objectives not finite")
    if by_name:
        sweep = [v for k, v in by_name.items() if "pdhg_sweep_kernel" in k]
        sweep_us = sum(t for _, t in sweep)
        print(f"[trace] sweep kernel: {sum(n for n, _ in sweep)} launches, "
              f"{sweep_us / 1e3:.3f} ms = {sweep_us / total:.4f} of device time, "
              f"{sweep_us / window:.4f} of the window")
    print(prof.key_averages().table(row_limit=60), file=sys.stderr)


# ---------------------------------------------------------------------
# phase 4: the interior-point path, the per-scenario PDLP and the factory
# ---------------------------------------------------------------------

def _lanes_line(res):
    st = res.status.cpu().numpy()
    it = res.iterations.cpu().numpy()
    counts = np.bincount(st, minlength=3)
    return st, it, (f"status 0/1/2 = {counts[0]}/{counts[1]}/{counts[2]} "
                    f"iters_mean={it.mean():.1f} iters_max={it.max()}")


def phase_entry(torch, dev):
    """``entry()`` over its 8 LMP lanes (max_iter 60, kkt="auto")."""
    from dispatches_tpu_torch.entry import _build_nlp, entry
    from dispatches_tpu_torch.solvers import IPMOptions, make_ipm_solver, make_lp_data

    fn, (batched,) = entry(device=dev)
    t0 = time.perf_counter()
    obj = fn(batched)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    nlp = _build_nlp()
    res = make_ipm_solver(nlp, IPMOptions(max_iter=60), device=dev)(batched)
    check(torch.equal(res.obj, obj), "[entry] entry() and its solver disagree")
    st, it, line = _lanes_line(res)
    print(f"[entry] B=8 {line} solve {dt * 1e3:.1f} ms")
    print(f"[entry] status {st.tolist()} iterations {it.tolist()}")
    print(f"[entry] objectives {np.array2string(obj.cpu().numpy(), precision=6)}")
    check(obj.shape == (8,) and bool(torch.isfinite(obj).all()), "[entry] objectives not finite")
    lp = make_lp_data(nlp, device=dev)
    d = nlp.default_params()
    lmps = batched["p"]["lmp"]
    ok = np.nonzero(st == 0)[0]
    check(ok.size > 0, "[entry] no lane reached status 0")
    ref = np.asarray([highs_objective(torch, nlp, lp, {"p": {**d["p"], "lmp": lmps[s]},
                                                       "fixed": d["fixed"]}, f"entry lane {s}")
                      for s in ok])
    err = np.abs(obj.cpu().numpy()[ok] - ref) / np.maximum(np.abs(ref), 1.0)
    print(f"[entry] status-0 lanes {ok.tolist()}: obj_rel_err_vs_highs max {err.max():.3e}")
    check(err.max() <= IPM_RTOL, f"[entry] objective error {err.max():.3e} > {IPM_RTOL}")


def phase_ipm(torch, dev, main_run):
    """The phase-2 model at B = 366, max_iter 300, both KKT paths; returns
    the structured solver and its params for the trace."""
    from dispatches_tpu_torch.solvers import IPMOptions, make_ipm_solver

    nlp, lmps, cfs = main_run["nlp"], main_run["lmps"], main_run["cfs"]
    d = nlp.default_params()
    B = lmps.shape[0]
    params = {"p": {**d["p"], "lmp": torch.as_tensor(lmps * 1e-3, device=dev),
                    "windpower.capacity_factor": torch.as_tensor(cfs, device=dev)},
              "fixed": d["fixed"]}
    out = None
    for kkt in ("auto", "dense"):
        solver = make_ipm_solver(nlp, IPMOptions(max_iter=300, kkt=kkt), device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = solver(params)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        obj = res.obj.cpu().numpy()
        check(obj.shape == (B,) and np.all(np.isfinite(obj)), f"[ipm] {kkt}: objectives not finite")
        st, it, line = _lanes_line(res)
        err = np.abs(obj[:N_HIGHS] - main_run["ref"]) / np.maximum(np.abs(main_run["ref"]), 1.0)
        gap = np.abs(obj - main_run["pdlp_obj"]) / np.maximum(np.abs(obj), 1.0)
        print(f"[ipm] kkt={kkt:6s} B={B} {line} solve {dt * 1e3:.1f} ms "
              f"solves/s={B / dt:.1f} peak_mem={torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
              f"obj_rel_err_vs_highs({N_HIGHS}) max {err.max():.3e} "
              f"max_gap_to_batch_pdlp {gap.max():.3e}")
        check(err.max() <= IPM_RTOL, f"[ipm] {kkt}: objective error {err.max():.3e} > {IPM_RTOL} "
                                     f"(statuses {st[:N_HIGHS].tolist()})")
        if kkt == "auto":
            out = solver, params, int(it.max())
    return out


def phase_ipm_trace(torch, solver, params, max_iters):
    """One warmed structured B = 366 solve under torch.profiler: idle share,
    device launches per Newton iteration (all launches of the solve over
    the slowest lane's iterations, which the batch runs), top ten."""
    res, _, by_name, total, window = profile_run(
        torch, lambda: solver(params), f"[ipm-trace] structured B={params['p']['lmp'].shape[0]}")
    check(bool(torch.isfinite(res.obj).all()), "[ipm-trace] objectives not finite")
    if by_name:
        launches = sum(n for n, _ in by_name.values())
        print(f"[ipm-trace] {launches} device launches over {max_iters} Newton iterations: "
              f"{launches / max_iters:.1f} per iteration, {total / 1e3 / max_iters:.3f} ms "
              "device time per iteration")


def phase_pdlp1(torch, dev, main_run):
    """The per-scenario PDLP solver on the first 4 scenarios."""
    from dispatches_tpu_torch.solvers import PDLPOptions, make_pdlp_solver

    nlp, lp, lmps, cfs = main_run["nlp"], main_run["lp"], main_run["lmps"], main_run["cfs"]
    d = nlp.default_params()
    for label, opts, rtol in (
            ("halpern f32 tol 1e-5", PDLPOptions(tol=1e-5, dtype="float32"), OBJ_RTOL),
            ("f64 tol 1e-8 polish", PDLPOptions(tol=1e-8, dtype="float64", polish=True), IPM_RTOL)):
        solver = make_pdlp_solver(nlp, opts, lp_data=lp, device=dev)
        objs, iters, ms = [], [], []
        for s in range(4):
            p = {"p": {**d["p"], "lmp": lmps[s] * 1e-3, "windpower.capacity_factor": cfs[s]},
                 "fixed": d["fixed"]}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solver(p)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            objs.append(float(res.obj))
            iters.append(int(res.iters))
        err = np.abs(np.asarray(objs) - main_run["ref"][:4]) / np.abs(main_run["ref"][:4])
        print(f"[pdlp1] {label}: iters {iters} solve ms {[round(t, 1) for t in ms]} "
              f"obj_rel_err_vs_highs max {err.max():.3e}")
        check(err.max() <= rtol, f"[pdlp1] {label}: objective error {err.max():.3e} > {rtol}")


def _storage_lp(torch, T=24):
    """The storage LP of the repository's verify recipe."""
    from dispatches_tpu_torch.core.graph import Flowsheet, tshift

    price = np.abs(np.sin(np.arange(T))) * 50 + 10
    fs = Flowsheet(horizon=T)
    fs.add_var("charge", lb=0, ub=2)
    fs.add_var("discharge", lb=0, ub=2)
    fs.add_var("soc", lb=0, ub=8)
    fs.add_var("soc0", shape=(), lb=0, ub=8)
    fs.fix("soc0", 0.0)
    fs.add_param("price", price)
    fs.add_eq("soc", lambda v, p: v["soc"] - tshift(v["soc"], v["soc0"])
              - 0.95 * v["charge"] + v["discharge"] / 0.95)
    return fs.compile(objective=lambda v, p: torch.sum(p["price"] * (v["discharge"] - v["charge"])),
                      sense="max")


def phase_factory(torch, dev):
    from dispatches_tpu_torch.core.graph import Flowsheet
    from dispatches_tpu_torch.solvers import IPMResult, SolverFactory

    nlp = _storage_lp(torch)
    objs = {}
    for name in ("ipopt", "cbc"):
        t0 = time.perf_counter()
        res = SolverFactory(name, device=dev).solve(nlp, tee=True)
        torch.cuda.synchronize()
        objs[name] = float(res.obj)
        print(f"[factory] {name}: obj {objs[name]:.10g} in {(time.perf_counter() - t0) * 1e3:.1f} ms "
              "(build included)")
    rel = abs(objs["cbc"] - objs["ipopt"]) / max(abs(objs["ipopt"]), 1.0)
    print(f"[factory] ipopt vs cbc relative difference {rel:.3e}")
    check(rel <= IPM_RTOL, f"[factory] ipopt and cbc disagree: {rel:.3e}")
    fs = Flowsheet()
    fs.add_var("x", shape=(), lb=0.0, init=2.0)
    fs.add_var("y", shape=(), init=2.0)
    fs.add_eq("hyper", lambda v, p: v["x"] * v["y"] - 1.0)
    res = SolverFactory("cbc", device=dev).solve(
        fs.compile(objective=lambda v, p: v["x"] ** 2 + v["y"] ** 2), tee=True)
    print(f"[factory] cbc on x*y = 1: {type(res).__name__} obj {float(res.obj):.10g}")
    check(isinstance(res, IPMResult) and abs(float(res.obj) - 2.0) <= 1e-6,
          "[factory] cbc did not fall back to the IPM on a non-affine model")


def phase_optimize(torch, dev):
    from dispatches_tpu_torch.case_studies.renewables import wind_battery_optimize
    from dispatches_tpu_torch.solvers import make_lp_data

    for T_opt in (24, 168):
        params = {"wind_mw": 100, "batt_mw": 10, "capacity_factors": np.full(T_opt, 0.5),
                  "DA_LMPs": np.where(np.arange(T_opt) % 24 < 12, 5.0, 100.0),
                  "design_opt": True, "extant_wind": True}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = wind_battery_optimize(T_opt, params, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        nlp = out.nlp
        ref = highs_objective(torch, nlp, make_lp_data(nlp, device=dev), nlp.default_params(),
                              f"optimize T={T_opt}")
        err = abs(float(out.res.obj) - ref) / max(abs(ref), 1.0)
        print(f"[optimize] T={T_opt} n={nlp.n} NPV={out.npv:.2f} battery_kw={out.battery_power_kw:.3f} "
              f"converged={out.converged} iterations={int(out.res.iterations)} "
              f"wall {dt * 1e3:.1f} ms (build included) obj_rel_err_vs_highs {err:.3e}")
        check(out.converged and err <= IPM_RTOL,
              f"[optimize] T={T_opt}: converged={out.converged}, objective error {err:.3e}")


def phase_ipm_path(torch, dev, main_run):
    """Phase 4, with the sweep kernels' counts set to 0 before and read
    after: the interior-point path launches neither."""
    from dispatches_tpu_torch.kernels import pdhg_sweep as ks

    ks.avg_sweep.launches = 0
    ks.halpern_sweep.launches = 0
    t0 = time.perf_counter()
    phase_entry(torch, dev)
    solver, params, max_iters = phase_ipm(torch, dev, main_run)
    phase_ipm_trace(torch, solver, params, max_iters)
    phase_pdlp1(torch, dev, main_run)
    phase_factory(torch, dev)
    phase_optimize(torch, dev)
    print(f"[phase4] {time.perf_counter() - t0:.1f} s; sweep kernel launches during it: "
          f"halpern {ks.halpern_sweep.launches}, avg {ks.avg_sweep.launches}")


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    if not (ROOT / "dispatches_tpu_torch").is_dir():
        fail("dispatches_tpu_torch/ is not beside chip_smoke.py")
    sys.path.insert(0, str(ROOT))

    card = phase_device(torch)
    # the main path runs first, so its launch counts start from zero
    # before any comparison launch
    dev = torch.device("cuda")
    main_run, launches = phase_main_path(torch, dev)
    report = phase_kernels(torch, main_run["lp"], dev)
    phase_ipm_path(torch, dev, main_run)

    replaces = {"halpern": "dispatches_tpu/solvers/pdlp_batch.py:196",
                "avg": "dispatches_tpu/solvers/pdlp_batch.py:80"}
    kernels = [{
        "name": f"pdhg_{algo}_sweep", "route": "cuda",
        "source": "dispatches_tpu_torch/csrc/pdhg_sweep.cu",
        "replaces": replaces[algo], "launches": launches[algo],
        "max_abs_err": report[algo]["max_abs_err"], "ms": report[algo]["ms"],
        "plain_ms": report[algo]["plain_ms"], "bound_ms": report[algo]["bound_ms"],
        "bound_by": report[algo]["bound_by"], "library_ms": None,
    } for algo in ("halpern", "avg")]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
