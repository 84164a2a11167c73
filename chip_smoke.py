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
   dense, an empty-row-and-column, a dense too large for shared memory,
   a wide operator and the PEM price-taker's, so that every kernel family
   runs; then time the
   kernels against their plain versions in turns with CUDA events (every
   tier at B = 366, 1024 and 4096) and sweep lanes per block;
4. the interior-point path (float64; it runs no hand-written kernel, and
   the sweep kernels' counts are read around it to show so):
   ``[entry]`` ``entry()`` over its 8 LMP lanes, status-0 objectives
   within 1e-6 of HiGHS; ``[ipm]`` the phase-2 model at B = 366,
   max_iter 300, on the structured KKT path (``kkt="auto"``; the dense
   B = 366 run is cut for phase 7's time), 16 lanes within 1e-6 of HiGHS; ``[ipm-trace]`` one warmed
   structured B = 366 solve under torch.profiler; ``[pdlp1]`` the
   per-scenario PDLP solver on 4 scenarios (halpern f32 tol 1e-5; f64
   tol 1e-8 with the polish); ``[factory]`` ``SolverFactory("ipopt")``
   and ``("cbc")`` on a storage LP, and ``cbc``'s IPM fallback on a
   non-affine model; ``[optimize]`` ``wind_battery_optimize`` at T = 24
   (T = 168 is cut for phase 7's time) with the battery size free,
   against HiGHS;
5. the serve path (``SolveService`` over ``ExecutionPlan``, float64 PDLP
   with a lane axis; no hand-written kernel, the sweep kernels' counts are
   read around it): ``[serve-demo]`` ``python -m dispatches_tpu_torch.serve
   --stats``; ``[serve-golden]`` the fake-clock ``--stats`` golden of
   tests/test_obs.py on the card (reported, not required); ``[serve]`` the
   366 scenarios one request at a time, twice, max_batch 64, tol 1e-8,
   warm starts and the predictor on, 16 within 1e-6 of HiGHS;
   ``[serve-default]`` a default ``SolveService()`` on the real clock;
   ``[serve-ipm]`` ``entry()``'s 8 lanes through an IPM bucket, statuses
   and objectives as ``[entry]``; ``[plan]`` a poisoned lane isolated with
   bitwise batchmates, FIFO against ready fencing bitwise;
   ``[serve-trace]`` one warmed 64-lane batch under torch.profiler;
6. the hydrogen hybrid (float64 IPM; the sweep kernels' counts are read
   around it): ``[h2-units]`` the PEM, simple and detailed tank and
   hydrogen turbine recipes of tests/test_models.py at its anchors;
   ``[pem]`` ``wind_battery_pem_optimize`` at T = 24 and 168 against
   HiGHS; ``[pem-batch]`` bench.py's 32-lane PEM recipe through the IPM,
   status-0 lanes against HiGHS; ``[pem-pdlp]`` its LMPs widened to 366
   lanes through the batch PDLP on the CUDA sweeps (phase 3 also holds
   both kernels on this operator); ``[hybrid]`` the full hybrid (wind +
   battery + PEM + tank + turbine) at T = 12 (T = 24 is cut for phase 7's
   time) on the structured KKT path,
   converged, with the tank balance, the air/H2 ratio and the work signs;
   ``[hybrid-trace]`` its first 15 Newton iterations under torch.profiler;
   ``[hybrid-dense]`` the first Newton iteration on the dense KKT path,
   its primal iterate within 1e-6 of the structured path's;
7. the double loop and the nuclear case (float64 IPM; the sweep kernels'
   counts are read around it): ``[ne]`` the nuclear price-taker of
   tests/test_ne_multiperiod.py (T = 4, h2 price 3, max_iter 600) at LMP
   500 (LMP 5's 600-iteration cold start is cut for time), converged, tank
   balanced, dear power to the grid; ``[double-loop]`` the port's ``run_double_loop`` for
   one day on a synthetic RTS-GMLC-size case written from a seed (73
   buses, 120 branches, 73 thermal and 81 renewable units,
   ``write_synthetic_rts``) at ``DoubleLoopOptions``' defaults: every
   bidder, tracker and dispatch solve converged, every bid curve
   non-decreasing, the output files complete; ``[market]`` its DA LP and
   4 SCED hours within 1e-6 of HiGHS on the same LPs, no load shed;
   ``[bid-batch]`` 7 bid days as one lane axis equal to 7 sequential
   solves within 1e-6; ``[dl-trace]`` one warmed market hour under
   torch.profiler.
8. the design-space sweep and the sweep->surrogate workflow (float64
   per-scenario PDLP and plain torch; the sweep kernels' counts are read
   around it): ``[sweep]`` ``run_sweep`` over 366 price profiles x 2 LHS
   battery sizes (732 points) on phase 2's model, direct backend, chunks
   of 128, tol 1e-8: the store complete, every point OK or retried, 16
   points within 1e-6 of HiGHS; ``[sweep-resume]`` the same spec cut
   after 3 chunks and resumed, every store file but progress.json
   byte-equal to ``[sweep]``'s; ``[sweep-serve]`` the first 64 points
   through the serve backend, within 1e-8 of ``[sweep]``;
   ``[sweep-report]`` ``python -m dispatches_tpu_torch.sweep --report``
   (and ``--json``) in a subprocess; ``[surrogate]`` a revenue MLP trained
   on the store on the card, held within 1e-9 relative of the same recipe
   trained on the CPU, and the five predictable shipped surrogates
   against tests/data/surrogate_goldens; ``[cluster]`` k-means of the 366
   LMP days (k 20) against a numpy Lloyd from the same seeding, and the
   soft-DTW k-means recipe; ``[cashflow]`` NPV, IRR and PI at
   tests/test_utils.py's anchors; ``[sweep-trace]`` one warmed 128-point
   chunk under torch.profiler.

Phase 3 times every kernel tier at B = 366, 1024 and 4096.
``--only-phase 7`` and ``--only-phase 8`` run one of those phases alone,
for development (no kernel build, no result line).  The line
before the last is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import gc
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

def phase_device_info(torch):
    """Print the card's name and power limit (nvidia-smi) and the versions;
    return the nvidia-smi line."""
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
    return card


def phase_device(torch):
    card = phase_device_info(torch)
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
    (held in shared memory).  ``lanes`` None is the wrapper's own choice."""
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


def phase_kernels(torch, lp, dev, pem_lp):
    """Both kernels against their plain versions on the main path's
    operator, the others of ``_other_operators`` and the PEM
    price-taker's (``pem_lp``, phase 6's [pem-pdlp] operator); then their
    times.  Returns the JSON line's numbers per kernel."""
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
        _, dc_p, Ah_p, _ = _scalings(np.vstack([pem_lp["K"], pem_lp["G"]]),
                                     PDLPOptions(algorithm=algo))
        others = _other_operators(Ah, lb, ub, m_eq) + [
            ("pem LP", Ah_p, pem_lp["lb"] / dc_p, pem_lp["ub"] / dc_p, pem_lp["K"].shape[0], None)]
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
            for label, Ao, lbo, ubo, m_eqo, lanes in others:
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
            for B in (N_SCENARIOS, *PEAK_BATCHES):
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


def flagship(torch, dev):
    """Phase 2's model and scenarios without its solves: the 24-h
    price-taker LP (capacity factors of scenario 0), its LP data and the
    366 LMP and capacity-factor rows."""
    from dispatches_tpu_torch.case_studies.renewables.wind_battery_lmp import (
        wind_battery_pricetaker_nlp,
    )
    from dispatches_tpu_torch.solvers import make_lp_data

    lmps, cfs = scenarios(N_SCENARIOS, np.random.default_rng(0))
    _, nlp = wind_battery_pricetaker_nlp(T, {
        "wind_mw": WIND_MW, "batt_mw": BATT_MW, "design_opt": False,
        "extant_wind": True, "capacity_factors": cfs[0], "DA_LMPs": lmps[0]})
    return {"nlp": nlp, "lp": make_lp_data(nlp, device=dev), "lmps": lmps, "cfs": cfs}


def phase_main_path(torch, dev):
    from dispatches_tpu_torch.kernels import pdhg_sweep as ks
    from dispatches_tpu_torch.solvers import BatchPDLPOptions, make_pdlp_batch_solver

    main = flagship(torch, dev)
    nlp, lp, lmps, cfs = main["nlp"], main["lp"], main["lmps"], main["cfs"]
    nnz = int(np.count_nonzero(np.vstack([lp["K"], lp["G"]])))
    print(f"[lp] n={nlp.n} m_eq={nlp.m_eq} m_ineq={nlp.m_ineq} nnz={nnz}")
    check((nlp.n, nlp.m_eq, nlp.m_ineq) == (193, 122, 96), "unexpected LP shape")

    main["ref"] = highs_objectives(torch, nlp, lp, lmps[:N_HIGHS], cfs[:N_HIGHS])
    ref = main["ref"]
    defaults = nlp.default_params()

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
    return {"nlp": nlp, "params": batched, "status": st, "obj": obj.cpu().numpy()}


def phase_ipm(torch, dev, main_run):
    """The phase-2 model at B = 366, max_iter 300, on the structured KKT
    path; returns the solver and its params for the trace."""
    from dispatches_tpu_torch.solvers import IPMOptions, make_ipm_solver

    nlp, lmps, cfs = main_run["nlp"], main_run["lmps"], main_run["cfs"]
    d = nlp.default_params()
    B = lmps.shape[0]
    params = {"p": {**d["p"], "lmp": torch.as_tensor(lmps * 1e-3, device=dev),
                    "windpower.capacity_factor": torch.as_tensor(cfs, device=dev)},
              "fixed": d["fixed"]}
    out = None
    # the dense-KKT B = 366 run (14.4 s in PR 5) is cut to make room for
    # phase 7; the dense path still runs in [entry], [hybrid-dense] and
    # every dispatch LP of phase 7
    for kkt in ("auto",):
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


def design_vs_highs(torch, dev, tag, optimize, T_opt, params):
    """One design study (``optimize(T, params, device=)``, an LP solved by
    the IPM) against HiGHS on the port's own LP data; returns its result."""
    from dispatches_tpu_torch.solvers import make_lp_data

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = optimize(T_opt, params, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    nlp = out.nlp
    ref = highs_objective(torch, nlp, make_lp_data(nlp, device=dev), nlp.default_params(),
                          f"{tag} T={T_opt}")
    err = abs(float(out.res.obj) - ref) / max(abs(ref), 1.0)
    print(f"[{tag}] T={T_opt} n={nlp.n} m_eq={nlp.m_eq} m_ineq={nlp.m_ineq} NPV={out.npv:.2f} "
          f"battery_kw={out.battery_power_kw:.3f} converged={out.converged} "
          f"iterations={int(out.res.iterations)} wall {dt * 1e3:.1f} ms (build included) "
          f"obj_rel_err_vs_highs {err:.3e}")
    check(out.converged and err <= IPM_RTOL,
          f"[{tag}] T={T_opt}: converged={out.converged}, objective error {err:.3e}")
    return out


def phase_optimize(torch, dev):
    from dispatches_tpu_torch.case_studies.renewables import wind_battery_optimize

    # T = 168 (28.1 s in PR 5) is cut to make room for phase 7
    for T_opt in (24,):
        design_vs_highs(torch, dev, "optimize", wind_battery_optimize, T_opt, {
            "wind_mw": 100, "batt_mw": 10, "capacity_factors": np.full(T_opt, 0.5),
            "DA_LMPs": np.where(np.arange(T_opt) % 24 < 12, 5.0, 100.0),
            "design_opt": True, "extant_wind": True})


def phase_ipm_path(torch, dev, main_run):
    """Phase 4, with the sweep kernels' counts set to 0 before and read
    after: the interior-point path launches neither."""
    from dispatches_tpu_torch.kernels import pdhg_sweep as ks

    ks.avg_sweep.launches = 0
    ks.halpern_sweep.launches = 0
    t0 = time.perf_counter()
    entry_run = phase_entry(torch, dev)
    solver, params, max_iters = phase_ipm(torch, dev, main_run)
    phase_ipm_trace(torch, solver, params, max_iters)
    phase_pdlp1(torch, dev, main_run)
    phase_factory(torch, dev)
    phase_optimize(torch, dev)
    print(f"[phase4] {time.perf_counter() - t0:.1f} s; sweep kernel launches during it: "
          f"halpern {ks.halpern_sweep.launches}, avg {ks.avg_sweep.launches}")
    return entry_run


# ---------------------------------------------------------------------
# phase 5: the serve path (SolveService over ExecutionPlan)
# ---------------------------------------------------------------------

#: [serve]'s max_wait_ms: long enough that batches close at max_batch (64)
#: or at flush_all.  With the default 10 ms every one-lane solve outlasts
#: the wait, and the service dispatches one lane per batch ([serve-default])
SERVE_WAIT_MS = 60_000.0
N_DEFAULT = 16           # [serve-default]: requests through SolveService()


def _flagship_params(nlp, lmps, cfs, s):
    d = nlp.default_params()
    return {"p": {**d["p"], "lmp": lmps[s] * 1e-3, "windpower.capacity_factor": cfs[s]},
            "fixed": d["fixed"]}


def _pct(a):
    p50, p95, p99 = np.percentile(a, (50, 95, 99))
    return f"p50 {p50:.1f} / p95 {p95:.1f} / p99 {p99:.1f} ms"


def serve_demo(torch):
    """``python -m dispatches_tpu_torch.serve --stats`` with its defaults,
    on the card."""
    from dispatches_tpu_torch.serve.__main__ import main as serve_main

    t0 = time.perf_counter()
    rc = serve_main(["--stats"])
    torch.cuda.synchronize()
    print(f"[serve-demo] --stats (24 requests a bucket, max-batch 8, horizons 8 and 12): "
          f"rc {rc}, {time.perf_counter() - t0:.1f} s")
    check(rc == 0, "[serve-demo] not every request finished DONE")


def serve_golden(torch):
    """tests/test_obs.py's fake-clock recipe on the card, against the
    golden stats text (reported, not required: cuBLAS may sum in another
    order than the CPU and move an iteration count)."""
    from dispatches_tpu_torch.serve import ServeOptions, SolveService
    from dispatches_tpu_torch.serve.__main__ import _arbitrage_nlp

    ticks = {"t": 0.0}

    def clock():
        ticks["t"] += 0.25e-3
        return ticks["t"]

    svc = SolveService(ServeOptions(max_batch=4, max_wait_ms=1e9), clock=clock)
    nlp = _arbitrage_nlp(6)
    d = nlp.default_params()
    rng = np.random.default_rng(0)
    hs = [svc.submit(nlp, {"p": {**d["p"], "price": 30.0 + 10.0 * rng.standard_normal(6)},
                           "fixed": d["fixed"]}, solver="pdlp") for _ in range(6)]
    svc.flush_all()
    check(all(h.result().status == "DONE" for h in hs), "[serve-golden] a request failed")
    got = svc.format_stats() + "\n"
    want = (ROOT / "tests" / "data" / "serve_stats_golden.txt").read_text()
    if got == want:
        print("[serve-golden] format_stats() equals tests/data/serve_stats_golden.txt byte for byte")
        return
    print("[serve-golden] format_stats() differs from tests/data/serve_stats_golden.txt "
          "(reported, not required):")
    for a, b in zip(want.splitlines(), got.splitlines()):
        if a != b:
            print(f"[serve-golden]   golden: {a}")
            print(f"[serve-golden]   card:   {b}")
    print(f"[serve-golden] per-lane iterations {[int(h.result().result.iters) for h in hs]}, "
          f"start kinds {[int(h.result().result.start_kind) for h in hs]}")


def serve_default(torch, main_run):
    """A default SolveService() on the real clock, requests one at a time."""
    from dispatches_tpu_torch.serve import SolveService

    nlp, lmps, cfs = main_run["nlp"], main_run["lmps"], main_run["cfs"]
    svc = SolveService()
    t0 = time.perf_counter()
    hs = [svc.submit(nlp, _flagship_params(nlp, lmps, cfs, s)) for s in range(N_DEFAULT)]
    svc.flush_all()
    dt = time.perf_counter() - t0
    res = [h.result() for h in hs]
    check(all(r.status == "DONE" for r in res), "[serve-default] a request failed")
    m = svc.metrics()
    b = next(iter(m["buckets"].values()))
    print(f"[serve-default] SolveService() (max_wait_ms 10), {N_DEFAULT} requests one at a time: "
          f"{dt:.2f} s = {N_DEFAULT / dt:.1f} requests/s, {m['batches']} batches @ lanes "
          f"{b['lane_counts']}, latency {_pct([r.latency_ms for r in res])}, "
          f"iterations mean {np.mean([int(r.result.iters) for r in res]):.1f}")


def serve_full(torch, main_run):
    """The 366 scenarios one request at a time, twice, through a service
    with the default options but ``max_wait_ms`` (float64 PDLP at tol 1e-8,
    max_batch 64, warm starts and the predictor on)."""
    from dispatches_tpu_torch.obs import registry, trace
    from dispatches_tpu_torch.serve import ServeOptions, SolveService

    nlp, lmps, cfs, ref = main_run["nlp"], main_run["lmps"], main_run["cfs"], main_run["ref"]
    svc = SolveService(ServeOptions.from_env(max_wait_ms=SERVE_WAIT_MS))
    refits = registry.counter("predict.refits")
    trace.enable(True)  # serve.batch spans: each batch's dispatch -> fence
    for rnd in (1, 2):
        m0 = svc.metrics()
        r0 = refits.total()
        trace.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        hs, sub_ms = [], []
        for s in range(N_SCENARIOS):
            t_s = time.perf_counter()
            hs.append(svc.submit(nlp, _flagship_params(nlp, lmps, cfs, s)))
            sub_ms.append((time.perf_counter() - t_s) * 1e3)
        svc.flush_all()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        res = [h.result() for h in hs]
        evts = trace.events()
        spans = [e for e in evts if e["name"] == "serve.batch"]
        # dispatch-ahead: what is left to wait for when submit returns
        plan_ms = {k: [e["dur"] / 1e3 for e in evts if e["name"] == k]
                   for k in ("plan.stage", "plan.submit", "plan.fence")}
        # submits that did not flush a batch: the host's per-request cost
        flushing = np.arange(63, N_SCENARIOS, 64)
        quiet = np.delete(np.asarray(sub_ms), flushing)
        slowest = int(np.delete(np.arange(N_SCENARIOS), flushing)[np.argmax(quiet)])
        check(all(r.status == "DONE" for r in res), f"[serve] round {rnd}: a request failed")
        objs = np.asarray([r.obj for r in res])
        check(objs.shape == (N_SCENARIOS,) and np.all(np.isfinite(objs)),
              f"[serve] round {rnd}: objectives not finite")
        err = np.abs(objs[:N_HIGHS] - ref) / np.maximum(np.abs(ref), 1.0)
        iters = np.asarray([int(r.result.iters) for r in res])
        kinds = np.bincount([int(r.result.start_kind) for r in res], minlength=4)
        m = svc.metrics()
        b = next(iter(m["buckets"].values()))
        ws, ws0 = m["warm_start"], m0["warm_start"]
        print(f"[serve] round {rnd}: {N_SCENARIOS} requests in {dt:.2f} s = "
              f"{N_SCENARIOS / dt:.1f} requests/s, latency {_pct([r.latency_ms for r in res])}; "
              f"{m['batches'] - m0['batches']} batches ({m['batches']} in all @ lanes "
              f"{b['lane_counts']}, occupancy {b['occupancy']}), compile count "
              f"{m['compile_count']}; starts cold/exact/neighbor/predicted = "
              f"{kinds[0]}/{kinds[1]}/{kinds[2]}/{kinds[3]}, mispredicts "
              f"{ws['mispredicts'] - ws0['mispredicts']}, predictor refits {refits.total() - r0:.0f}; "
              f"PDHG iterations mean {iters.mean():.1f} max {iters.max()}, "
              f"{sum(not bool(r.result.converged) for r in res)} lanes unconverged; "
              f"peak_mem {(torch.cuda.max_memory_allocated() - mem0) / 2**20:.1f} MiB above "
              f"the round's start; obj_rel_err_vs_highs({N_HIGHS}) max {err.max():.3e}")
        # requests go out in order and each batch takes the oldest 64
        per = [(e["dur"] / 1e3, e["args"]["live"],
                int(iters[64 * k:64 * k + e["args"]["live"]].max()))
               for k, e in enumerate(spans)]
        bucket = next(iter(svc._buckets.values()))
        print(f"[serve] round {rnd} batches (dispatch->fence ms, live lanes, max iterations): "
              + ", ".join(f"({ms:.0f}, {n}, {it})" for ms, n, it in per)
              + f"; ladder degraded: predictor->k-NN {bucket.predict_fallback}, "
              f"warm->cold {bucket.warm_fallback}; submits that flushed nothing: mean "
              f"{quiet.mean():.2f} ms, max {quiet.max():.1f} ms (request {slowest}); "
              + ", ".join(f"{k} mean {np.mean(v):.2f} ms" for k, v in plan_ms.items()))
        check(err.max() <= IPM_RTOL, f"[serve] round {rnd}: objective error {err.max():.3e} "
                                     f"> {IPM_RTOL}")
    trace.enable(False)


def serve_ipm(torch, entry_run):
    """entry()'s 8 LMP lanes through the service's IPM bucket, against
    phase 4's direct solve."""
    from dispatches_tpu_torch.serve import ServeOptions, SolveService

    nlp, batched = entry_run["nlp"], entry_run["params"]
    svc = SolveService(ServeOptions(max_batch=8, max_wait_ms=1e9))
    lmp = np.asarray(batched["p"]["lmp"])
    plist = [{"p": {**batched["p"], "lmp": lmp[i]}, "fixed": batched["fixed"]} for i in range(8)]
    t0 = time.perf_counter()
    res = svc.solve_many(nlp, plist, solver="ipm", options={"max_iter": 60})
    dt = time.perf_counter() - t0
    st = np.asarray([int(r.result.status) for r in res])
    obj = np.asarray([r.obj for r in res])
    ok = entry_run["status"] == 0
    err = np.abs(obj[ok] - entry_run["obj"][ok]) / np.maximum(np.abs(entry_run["obj"][ok]), 1.0)
    print(f"[serve-ipm] 8 lanes, max_iter 60, {dt * 1e3:.1f} ms: status {st.tolist()} "
          f"(phase 4: {entry_run['status'].tolist()}), status-0 objectives vs phase 4 max "
          f"{err.max():.3e}")
    check(np.array_equal(st, entry_run["status"]), "[serve-ipm] statuses differ from [entry]")
    check(err.max() <= 1e-9, f"[serve-ipm] objectives differ from [entry]: {err.max():.3e}")


def plan_checks(torch, main_run):
    """A poisoned lane at the ``solver`` fault site, and FIFO against
    ready fencing over uneven widths."""
    from dispatches_tpu_torch.faults import inject as faults
    from dispatches_tpu_torch.obs import registry
    from dispatches_tpu_torch.plan import ExecutionPlan, PlanOptions
    from dispatches_tpu_torch.serve import ServeOptions, SolveService
    from dispatches_tpu_torch.solvers import PDLPOptions, make_pdlp_solver

    nlp, lp, lmps, cfs = main_run["nlp"], main_run["lp"], main_run["lmps"], main_run["cfs"]
    plist = [_flagship_params(nlp, lmps, cfs, s) for s in range(8)]

    def run(scenario):
        svc = SolveService(ServeOptions(max_batch=8, max_wait_ms=1e9, warm_start=False))
        faults.arm(scenario)
        try:
            hs = [svc.submit(nlp, p) for p in plist]
            svc.flush_all()
            return [h.result() for h in hs]
        finally:
            faults.reset()

    clean = run(None)
    retries = registry.counter("plan.retries")
    r0 = retries.total()
    t0 = time.perf_counter()
    faulted = run("solver,poison_ids=6")  # request ids count from 1: lane 5
    dt = time.perf_counter() - t0
    sts = [r.status for r in faulted]
    same = all(f.obj == c.obj for f, c in zip(faulted, clean) if f.status == "DONE")
    print(f"[plan] fault 'solver,poison_ids=6' on 8 lanes: statuses {sts}, plan.retries "
          f"{retries.total() - r0:.0f}, {dt:.2f} s; DONE lanes bitwise equal to the unfaulted "
          f"run: {same}")
    check(sts == ["DONE"] * 5 + ["ERROR"] + ["DONE"] * 2, "[plan] poisoned lane not isolated")
    check(same, "[plan] innocent lanes differ from the unfaulted run")

    solver = make_pdlp_solver(nlp, PDLPOptions(tol=1e-8, dtype="float64"), lp_data=lp,
                              device="cuda")
    params = [_flagship_params(nlp, lmps, cfs, s) for s in range(17)]

    def arm(schedule):
        plan = ExecutionPlan(PlanOptions(inflight=2, schedule=schedule))
        prog = plan.program(solver, label="plan.parity", vmap_axes=0)
        tickets, s = [], 0
        for width in (5, 3, 8, 1):
            staged = plan.stage(plan.stack(params[s:s + width]), lanes=width, donate=False)
            tickets.append(plan.submit(prog, (staged,), n_live=width, lanes=width))
            s += width
        return [plan.collect(t) for t in tickets]

    fifo, ready = arm("fifo"), arm("ready")
    bitwise = all(torch.equal(getattr(a, f), getattr(b, f)) for a, b in zip(fifo, ready)
                  for f in ("x", "z", "obj", "iters"))
    print(f"[plan] fifo vs ready over widths 5, 3, 8, 1: ticket results bitwise equal: {bitwise}")
    check(bitwise, "[plan] fifo and ready ticket results differ")


def serve_trace(torch, main_run):
    """One warmed 64-lane batch of the flagship (cold starts) under
    torch.profiler."""
    from dispatches_tpu_torch.serve import ServeOptions, SolveService

    nlp, lmps, cfs = main_run["nlp"], main_run["lmps"], main_run["cfs"]
    svc = SolveService(ServeOptions(max_wait_ms=SERVE_WAIT_MS, warm_start=False))
    plist = [_flagship_params(nlp, lmps, cfs, s) for s in range(64)]

    def run():
        hs = [svc.submit(nlp, p) for p in plist]
        svc.flush_all()
        return [h.result() for h in hs]

    run()
    res, _, by_name, total, window = profile_run(torch, run, "[serve-trace] 64-lane batch")
    check(all(r.status == "DONE" for r in res), "[serve-trace] a request failed")
    iters = max(int(r.result.iters) for r in res)
    if by_name:
        launches = sum(n for n, _ in by_name.values())
        checks = math.ceil(iters / K_STEPS)
        print(f"[serve-trace] {launches} device launches over {checks} PDHG check intervals "
              f"(slowest lane {iters} iterations): {launches / checks:.1f} per interval, "
              f"{total / 1e3 / checks:.3f} ms device time per interval")


def phase_serve_path(torch, dev, main_run, entry_run):
    """Phase 5, with the sweep kernels' counts set to 0 before and read
    after: the serve path runs the per-scenario solver and launches
    neither."""
    from dispatches_tpu_torch.kernels import pdhg_sweep as ks

    ks.avg_sweep.launches = 0
    ks.halpern_sweep.launches = 0
    # the earlier phases' garbage is collected here, not inside a timed
    # serve round
    t0 = time.perf_counter()
    freed = gc.collect()
    print(f"[phase5] gc.collect() freed {freed} objects in {time.perf_counter() - t0:.2f} s; "
          f"{len(gc.get_objects())} objects tracked")
    t0 = time.perf_counter()
    serve_demo(torch)
    serve_golden(torch)
    serve_full(torch, main_run)
    serve_default(torch, main_run)
    serve_ipm(torch, entry_run)
    plan_checks(torch, main_run)
    serve_trace(torch, main_run)
    print(f"[phase5] {time.perf_counter() - t0:.1f} s; sweep kernel launches during it: "
          f"halpern {ks.halpern_sweep.launches}, avg {ks.avg_sweep.launches}")


# ---------------------------------------------------------------------
# phase 6: the hydrogen hybrid (PEM, tanks, turbine) on the float64 IPM
# ---------------------------------------------------------------------

H2_T = 24            # tests/test_re_pem_hybrid.py's horizon
# [hybrid]'s horizon: T = 24 (188.6 s in PR 5) is cut to 12 to make room for
# phase 7 (it converges there: 162 iterations on the CPU with
# `python3 tools/cpu_rehearsal.py phase6 hybrid`)
HYB_T = 12
H2_T_LONG = 168      # [pem]'s second horizon: the same formulas over a week
PEM_BATCH = 32       # [pem-batch]: bench.py's nlp_pem24h lanes
HYB_TRACE_ITERS = 15   # [hybrid-trace]: Newton iterations under the profiler
HYB_STEP_RTOL = 1e-6   # [hybrid-dense]: the KKT paths' first primal steps


def _h2_params(horizon, **over):
    """tests/test_re_pem_hybrid.py's params, its capacity-factor and LMP
    formulas evaluated over ``horizon`` hours."""
    t = np.arange(horizon)
    params = {"wind_mw": 100.0, "wind_mw_ub": 1000.0, "batt_mw": 10.0, "pem_mw": 20.0,
              "turb_mw": 1.0, "tank_size": 0.3, "tank_type": "simple",
              "capacity_factors": 0.3 + 0.3 * np.sin(2 * np.pi * t / 24) ** 2,
              "DA_LMPs": np.where(t % 24 < 12, 15.0, 60.0), "h2_price_per_kg": 2.0,
              "design_opt": True, "extant_wind": True}
    params.update(over)
    return params


def pem_batch_model(torch, dev):
    """bench.py's nlp_pem24h recipe (wind 200 MW, battery and PEM 25 MW,
    sizes fixed, capacity factors 0.35 + 0.3 U from default_rng(1)): the
    PEM price-taker LP, its LP data, and an LMP batch maker continuing
    the same generator (35 + 25 sin(2πt/24) + 10 N(0, 1) $/MWh); the
    first 32 rows of any batch are [pem-batch]'s."""
    from dispatches_tpu_torch.case_studies.renewables import wind_battery_pem_optimize
    from dispatches_tpu_torch.solvers import make_lp_data

    rng = np.random.default_rng(1)
    base = 35.0 + 25.0 * np.sin(2 * np.pi * np.arange(H2_T) / 24)
    out = wind_battery_pem_optimize(H2_T, {
        "wind_mw": 200.0, "batt_mw": 25.0, "pem_mw": 25.0, "design_opt": False,
        "extant_wind": True, "capacity_factors": 0.35 + 0.3 * rng.random(H2_T),
        "DA_LMPs": base}, device=dev)
    check(out.converged, "[pem-batch] the design solve of bench.py's recipe did not converge")
    nlp = out.nlp
    lp = make_lp_data(nlp, device=dev)
    noise = rng.standard_normal((N_SCENARIOS, H2_T))
    print(f"[pem-lp] n={nlp.n} m_eq={nlp.m_eq} m_ineq={nlp.m_ineq} "
          f"nnz={int(np.count_nonzero(np.vstack([lp['K'], lp['G']])))}")
    return {"nlp": nlp, "lp": lp, "lmps": (base[None, :] + 10.0 * noise)}


def _pem_params(torch, nlp, lmps, dev=None):
    """Params with an LMP batch ($/MWh rows) as the lane axis, or one row
    as numpy leaves (dev None)."""
    d = nlp.default_params()
    lmp = lmps * 1e-3 if dev is None else torch.as_tensor(lmps * 1e-3, device=dev)
    return {"p": {**d["p"], "lmp": lmp}, "fixed": d["fixed"]}


def h2_units(torch, dev):
    """The unit recipes of tests/test_models.py (PEM, simple tank, detailed
    tank filling and emptying, hydrogen turbine) solved on the card, held
    to that file's anchors and tolerances."""
    from dispatches_tpu_torch.core.graph import Flowsheet
    from dispatches_tpu_torch.models import (
        HydrogenTank,
        HydrogenTurbine,
        PEMElectrolyzer,
        SimpleHydrogenTank,
    )
    from dispatches_tpu_torch.solvers import IPMOptions, solve_nlp

    def solve(label, fs, max_iter=None):
        nlp = fs.compile()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve_nlp(nlp, options=IPMOptions(max_iter=max_iter) if max_iter else None,
                        device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(bool(res.converged), f"[h2-units] {label}: not converged")
        print(f"[h2-units] {label}: n={nlp.n} m_eq={nlp.m_eq} status {int(res.status)} "
              f"iterations {int(res.iterations)} in {dt * 1e3:.1f} ms")
        return nlp.unravel(res.x)

    def near(label, got, want, rel):
        got = float(got)
        print(f"[h2-units]   {label} {got:.8g} (anchor {want:.8g}, rel {rel:.0e})")
        check(abs(got - want) <= rel * abs(want), f"[h2-units] {label} {got} vs {want}")

    fs = Flowsheet(horizon=1)
    pem = PEMElectrolyzer(fs)
    fs.fix(pem.v("electricity"), 5000.0)
    fs.fix(pem.outlet_state.temperature, 300.0)
    fs.fix(pem.outlet_state.pressure, 101325.0)
    sol = solve("PEM 5 MW", fs)
    near("outlet flow mol/s", sol["pem.outlet.flow_mol"][0], 5000 * 0.002527406, 1e-8)

    fs = Flowsheet(horizon=1)
    tank = SimpleHydrogenTank(fs)
    tank.inlet_state.fix_state(flow_mol=25, temperature=300, pressure=101325)
    fs.fix(tank.v("tank_holdup_previous"), 0)
    fs.fix(tank.pipeline_state.flow_mol, 10)
    fs.fix(tank.turbine_state.flow_mol, 10)
    sol = solve("simple tank", fs)
    near("holdup mol", sol["h2_tank.tank_holdup"][0], 3600 * 5, 1e-6)
    near("pipeline outlet K", sol["h2_tank.outlet_to_pipeline.temperature"][0], 300.0, 1e-6)
    near("turbine outlet Pa", sol["h2_tank.outlet_to_turbine.pressure"][0], 101325.0, 1e-6)

    for label, out_flow, anchors in (
            ("detailed tank filling", 0.0, (3600.0945, 300.749, 3820683416.393)),
            ("detailed tank emptying", 0.9, (360.0945, 300.055, 381276651.957))):
        fs = Flowsheet(horizon=1)
        tank = HydrogenTank(fs, name="unit")
        fs.fix(tank.v("tank_diameter"), 0.1)
        fs.fix(tank.v("tank_length"), 0.3)
        fs.fix(tank.v("previous_temperature"), 300)
        fs.fix(tank.v("previous_pressure"), 1e5)
        tank.inlet_state.fix_state(flow_mol=1, temperature=300, pressure=3e6)
        fs.fix(tank.outlet_state.flow_mol, out_flow)
        fs.set_init(tank.v("material_holdup"), 3600 * (1 - out_flow))
        fs.set_init(tank.v("pressure"), 3e9 * max(1 - out_flow, 0.1))
        sol = solve(label, fs)
        near("holdup mol", sol["unit.material_holdup"][0], anchors[0], 1e-3)
        near("temperature K", sol["unit.temperature"][0], anchors[1], 1e-3)
        near("pressure Pa", sol["unit.pressure"][0], anchors[2], 1e-2)

    fs = Flowsheet(horizon=1)
    turb = HydrogenTurbine(fs)
    y_in = {"oxygen": 0.188, "argon": 0.003, "nitrogen": 0.702, "water": 0.022,
            "hydrogen": 0.085}
    comps = turb.props.components
    fs.fix(turb.inlet_state.flow_mol_comp, np.array([[y_in[c] * 4135.2 for c in comps]]))
    fs.fix(turb.inlet_state.temperature, 288.15)
    fs.fix(turb.inlet_state.pressure, 101325)
    fs.fix(turb.v("compressor.deltaP"), 2.401e6)
    fs.fix(turb.v("compressor.efficiency_isentropic"), 0.86)
    fs.fix(turb.v("reactor.conversion"), 0.99)
    fs.fix(turb.v("turbine.deltaP"), -2.401e6)
    fs.fix(turb.v("turbine.efficiency_isentropic"), 0.89)
    t0 = time.perf_counter()
    turb.initialize()
    print(f"[h2-units] turbine initialize() (host bisections): "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    sol = solve("hydrogen turbine", fs, max_iter=300)
    near("compressor outlet K", sol["h2_turbine.compressor.outlet.temperature"][0], 763.25, 2e-2)
    fc_out = sol["h2_turbine.reactor.outlet.flow_mol_comp"][0]
    y_out = dict(zip(comps, fc_out / fc_out.sum()))
    for c, want, rel in (("hydrogen", 0.00085, 5e-2), ("nitrogen", 0.73285, 1e-2),
                         ("oxygen", 0.15232, 1e-2), ("water", 0.11085, 1e-2),
                         ("argon", 0.0031318, 1e-2)):
        near(f"reactor outlet y_{c}", y_out[c], want, rel)
    near("reactor outlet K", sol["h2_turbine.reactor.outlet.temperature"][0], 1426.3, 2e-2)
    near("turbine outlet K", sol["h2_turbine.outlet.temperature"][0], 726.44, 2e-2)
    w_t = float(sol["h2_turbine.turbine.work_mechanical"][0])
    w_c = float(sol["h2_turbine.compressor.work_mechanical"][0])
    print(f"[h2-units]   work W: compressor {w_c:.6g}, turbine {w_t:.6g}, net {w_c + w_t:.6g}")
    check(w_t < 0 and w_c + w_t < 0, "[h2-units] turbine work signs")


def pem_optimize(torch, dev):
    """``wind_battery_pem_optimize`` at T = 24 and 168, each against HiGHS
    on the port's own LP data."""
    from dispatches_tpu_torch.case_studies.renewables import wind_battery_pem_optimize

    for T_p in (H2_T, H2_T_LONG):
        out = design_vs_highs(torch, dev, "pem", wind_battery_pem_optimize, T_p, _h2_params(T_p))
        print(f"[pem]   pem_kw={float(out.solution['pem_system_capacity']):.3f}")


def pem_batch(torch, dev, pem):
    """bench.py's nlp_pem24h: 32 LMP lanes through the IPM (max_iter 200;
    the process is warm from ``pem_batch_model``'s solve of the same
    model); status-0 lanes against HiGHS."""
    from dispatches_tpu_torch.solvers import IPMOptions, make_ipm_solver

    nlp, lp, lmps = pem["nlp"], pem["lp"], pem["lmps"][:PEM_BATCH]
    solver = make_ipm_solver(nlp, IPMOptions(max_iter=200), device=dev)
    params = _pem_params(torch, nlp, lmps, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = solver(params)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    obj = res.obj.cpu().numpy()
    check(obj.shape == (PEM_BATCH,) and np.all(np.isfinite(obj)), "[pem-batch] objectives not finite")
    st, it, line = _lanes_line(res)
    ok = np.nonzero(st == 0)[0]
    check(ok.size > 0, "[pem-batch] no lane reached status 0")
    ref = np.asarray([highs_objective(torch, nlp, lp, _pem_params(torch, nlp, lmps[s]),
                                      f"pem-batch lane {s}") for s in ok])
    err = np.abs(obj[ok] - ref) / np.maximum(np.abs(ref), 1.0)
    print(f"[pem-batch] B={PEM_BATCH} {line} converged share {float(res.converged.float().mean()):.4f} "
          f"solve {dt * 1e3:.1f} ms solves/s={PEM_BATCH / dt:.1f} "
          f"peak_mem={torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; status-0 lanes "
          f"{ok.size}: obj_rel_err_vs_highs max {err.max():.3e}")
    check(err.max() <= IPM_RTOL, f"[pem-batch] objective error {err.max():.3e} > {IPM_RTOL}")


def pem_pdlp(torch, dev, pem):
    """[pem-batch]'s LMPs widened to 366 lanes through the batch PDLP
    (halpern, f32, tol 1e-5) on the CUDA sweeps; 16 objectives against
    HiGHS (reported, not required)."""
    from dispatches_tpu_torch.kernels import pdhg_sweep as ks
    from dispatches_tpu_torch.solvers import BatchPDLPOptions, make_pdlp_batch_solver

    nlp, lp, lmps = pem["nlp"], pem["lp"], pem["lmps"]
    solver = make_pdlp_batch_solver(nlp, BatchPDLPOptions(tol=1e-5, dtype="float32"),
                                    lp_data=lp, device=dev)
    params = _pem_params(torch, nlp, lmps, dev)
    before = ks.halpern_sweep.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver(params)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ks.halpern_sweep.launches - before
    obj = res.obj.cpu().numpy()
    iters = res.iters.cpu().numpy()
    check(obj.shape == (N_SCENARIOS,) and np.all(np.isfinite(obj)),
          "[pem-pdlp] objectives not finite")
    check(launches > 0, "[pem-pdlp] the halpern kernel was never launched")
    ref = np.asarray([highs_objective(torch, nlp, lp, _pem_params(torch, nlp, lmps[s]),
                                      f"pem-pdlp lane {s}") for s in range(N_HIGHS)])
    err = np.abs(obj[:N_HIGHS] - ref) / np.maximum(np.abs(ref), 1.0)
    print(f"[pem-pdlp] halpern f32 B={N_SCENARIOS} converged={float(res.converged.float().mean()):.4f} "
          f"iters_mean={iters.mean():.1f} iters_max={iters.max()} solves/s={N_SCENARIOS / dt:.1f} "
          f"({dt * 1e3:.1f} ms) launches={launches} obj_rel_err_vs_highs({N_HIGHS}) max "
          f"{err.max():.3e} (reported, not required)")


def hybrid(torch, dev):
    """``wind_battery_pem_tank_turb_optimize`` at T = HYB_T on the structured
    KKT path (the path ``kkt="auto"`` takes), converged and held to
    tests/test_re_pem_hybrid.py's structural checks (tank balance, air/H2
    ratio, work signs).  Returns the model for ``hybrid_paths``."""
    from dispatches_tpu_torch.case_studies.renewables import load_parameters as re_lp
    from dispatches_tpu_torch.case_studies.renewables import wind_battery_pem_tank_turb_optimize

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = wind_battery_pem_tank_turb_optimize(HYB_T, _h2_params(HYB_T, kkt="structured"),
                                              device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    nlp, res, sol = out.nlp, out.res, out.solution
    check(bool(torch.isfinite(res.x).all()), "[hybrid] iterate not finite")
    net_in = (sol["h2_tank.inlet.flow_mol"] - sol["h2_tank.outlet_to_pipeline.flow_mol"]
              - sol["h2_tank.outlet_to_turbine.flow_mol"]) * 3600.0
    holdup = sol["h2_tank.tank_holdup"]
    prev = np.concatenate([[float(sol["h2_tank.tank_holdup_previous"])], holdup[:-1]])
    balance = float(np.max(np.abs(holdup - prev - net_in)))
    h2 = re_lp.air_h2_ratio * (sol["mixer.purchased_hydrogen_feed.flow_mol"]
                               + sol["mixer.hydrogen_feed.flow_mol"])
    ratio = float(np.max(np.abs(sol["mixer.air_feed.flow_mol"] - h2) / np.abs(h2)))
    w_c = sol["h2_turbine.compressor.work_mechanical"]
    w_t = sol["h2_turbine.turbine.work_mechanical"]
    print(f"[hybrid] kkt=structured T={HYB_T} n={nlp.n} m_eq={nlp.m_eq} m_ineq={nlp.m_ineq} "
          f"NPV={out.npv:.2f} battery_kw={out.battery_power_kw:.3f} "
          f"pem_kw={float(sol['pem_system_capacity']):.3f} "
          f"tank_mol={float(sol['h2_tank_size']):.3f} "
          f"turbine_kw={float(sol['turb_system_capacity']):.3f} status {int(res.status)} "
          f"iterations {int(res.iterations)} kkt_error {float(res.kkt_error):.3e} "
          f"wall {dt * 1e3:.1f} ms (build included); tank balance max {balance:.3e} mol, "
          f"air/H2 ratio max rel {ratio:.3e}, compressor work min {w_c.min():.6g}, "
          f"turbine work max {w_t.max():.6g}")
    check(out.converged, f"[hybrid] not converged (status {int(res.status)})")
    check(balance <= 1e-3, f"[hybrid] tank mass balance off by {balance:.3e}")
    check(ratio <= 1e-5, f"[hybrid] air/H2 ratio off by {ratio:.3e}")
    check(np.all(w_c >= -1e-6) and np.all(w_t <= 1e-6), "[hybrid] work signs")
    return nlp


def hybrid_paths(torch, dev, nlp):
    """[hybrid-trace]: the structured path's first HYB_TRACE_ITERS Newton
    iterations under torch.profiler (idle share, launches per iteration,
    top ten; a whole solve would record millions of launches, and its
    iterations are alike).  [hybrid-dense]: the first Newton iteration
    on both KKT paths, whose primal iterates agree within HYB_STEP_RTOL.
    Their multipliers need not: J is rank-deficient, and each path's
    regularization sets the null-space part of lam, which enters W from
    the second iteration on.  The paths part there, and from the default
    start the dense one does not converge on this model (status 2 after
    500 iterations, in the JAX package too: tests/test_torch_re_hybrid.py,
    slow)."""
    from dispatches_tpu_torch.solvers import IPMOptions, make_ipm_solver

    params = nlp.default_params()
    solver = make_ipm_solver(nlp, IPMOptions(max_iter=HYB_TRACE_ITERS, kkt="structured"),
                             device=dev)
    res, _, by_name, total, window = profile_run(
        torch, lambda: solver(params), f"[hybrid-trace] structured T={HYB_T}")
    check(bool(torch.isfinite(res.x).all()), "[hybrid-trace] iterate not finite")
    iters = int(res.iterations)
    if by_name:
        launches = sum(n for n, _ in by_name.values())
        print(f"[hybrid-trace] {launches} device launches over {iters} Newton iterations: "
              f"{launches / iters:.1f} per iteration, {total / 1e3 / iters:.3f} ms device time "
              f"per iteration, {window / 1e3 / iters:.3f} ms of window per iteration")
    step = {}
    for kkt in ("structured", "dense"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step[kkt] = make_ipm_solver(nlp, IPMOptions(max_iter=1, kkt=kkt), device=dev)(params)
        torch.cuda.synchronize()
        print(f"[hybrid-dense] kkt={kkt}: one Newton iteration in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms (solver set-up included)")
        check(bool(torch.isfinite(step[kkt].x).all()), f"[hybrid-dense] {kkt}: iterate not finite")
    s, d = step["structured"], step["dense"]
    x_rel = float((d.x - s.x).abs().max() / s.x.abs().max())
    lam_rel = float((d.lam - s.lam).abs().max() / s.lam.abs().max())
    print(f"[hybrid-dense] dense vs structured after one iteration: iterate max rel {x_rel:.3e}, "
          f"multipliers max rel {lam_rel:.3e} (not required)")
    check(x_rel <= HYB_STEP_RTOL,
          f"[hybrid-dense] the KKT paths' first steps differ by {x_rel:.3e} > {HYB_STEP_RTOL}")


def phase_hydrogen(torch, dev, pem):
    """Phase 6, with the sweep kernels' counts set to 0 before and read
    after: the hybrid's IPM path launches neither; [pem-pdlp] runs the
    batch PDLP on the PEM operator."""
    from dispatches_tpu_torch.kernels import pdhg_sweep as ks

    ks.avg_sweep.launches = 0
    ks.halpern_sweep.launches = 0
    t0 = time.perf_counter()
    h2_units(torch, dev)
    pem_optimize(torch, dev)
    pem_batch(torch, dev, pem)
    pem_pdlp(torch, dev, pem)
    hybrid_paths(torch, dev, hybrid(torch, dev))
    print(f"[phase6] {time.perf_counter() - t0:.1f} s; sweep kernel launches during it: "
          f"halpern {ks.halpern_sweep.launches}, avg {ks.avg_sweep.launches} "
          "(all from [pem-pdlp])")


# ---------------------------------------------------------------------
# phase 7: the double loop (bid, clear, track) and the nuclear case
# ---------------------------------------------------------------------

# RTS-GMLC-like thermal fleet (family, PMax MW, PMin share, avg heat rate
# BTU/kWh, fuel $/MMBTU, min up h, min down h, ramp MW/min, start heat
# MBTU): 73 units in RTS-GMLC's families and sizes
_FLEET = ([("NUCLEAR", 400.0, 0.99, 10500.0, 0.8, 24, 24, 20.0, 0.0)]
          + [("STEAM", 350.0, 0.40, 9700.0, 2.0, 8, 8, 4.0, 3500.0)] * 3
          + [("STEAM", 155.0, 0.35, 9900.0, 2.0, 8, 8, 3.0, 1500.0)] * 4
          + [("STEAM", 76.0, 0.40, 11200.0, 2.0, 8, 4, 2.0, 800.0)] * 4
          + [("STEAM", 197.0, 0.35, 10300.0, 9.0, 4, 4, 3.0, 1900.0)] * 3
          + [("STEAM", 100.0, 0.25, 10700.0, 9.0, 4, 4, 7.0, 1000.0)] * 3
          + [("STEAM", 12.0, 0.20, 12500.0, 9.0, 2, 2, 1.0, 30.0)] * 5
          + [("CC", 355.0, 0.48, 7500.0, 4.0, 6, 6, 4.0, 1500.0)]
          + [("CT", 55.0, 0.40, 11000.0, 4.0, 1, 1, 3.7, 100.0)] * 22
          + [("CT", 20.0, 0.40, 13000.0, 9.0, 1, 1, 3.0, 50.0)] * 27)
# renewable families and their count shares in RTS-GMLC (81 units)
_REN = (("WIND", 4, 150.0), ("PV", 25, 60.0), ("RTPV", 31, 12.0), ("HYDRO", 21, 25.0))


def write_synthetic_rts(path, n_bus=73, n_branch=120, n_thermal=73, n_renewable=81,
                        n_days=3, seed=0, start="2020-07-10", participant="4_WIND"):
    """Write an RTS-GMLC-format directory from ``seed``: ``bus.csv``,
    ``branch.csv``, ``gen.csv``, ``initial_status.csv`` and hourly
    ``DAY_AHEAD_``/``REAL_TIME_`` load and renewables CSVs for ``n_days``
    days from ``start`` (what ``grid/market.py:load_rts_gmlc_case``
    reads).  Buses 1..n_bus lie in 3 areas (one when n_bus < 6), each bus
    with an ``MW Load`` share; branches form a connected network with
    ~10% of them rated tight so that some bind; the thermal
    fleet takes RTS-GMLC's families (``_FLEET``, spread over it when
    n_thermal < 73); the renewables are wind, PV, RTPV and hydro by
    RTS-GMLC's shares, the first wind unit named ``participant`` on bus
    ``participant``'s prefix.  Returns ``path``."""
    import pandas as pd

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    n_area = 3 if n_bus >= 6 else 1
    area = np.minimum(np.arange(n_bus) * n_area // n_bus, n_area - 1) + 1
    bus_ids = np.arange(1, n_bus + 1)
    share = rng.uniform(0.3, 1.7, n_bus)
    share[rng.random(n_bus) < 0.2] = 0.0  # some buses carry no load
    share[0] = max(share[0], 0.5)
    pd.DataFrame({"Bus ID": bus_ids, "Bus Name": [f"Bus{b}" for b in bus_ids],
                  "Area": area, "MW Load": np.round(100.0 * share, 2)}).to_csv(
        path / "bus.csv", index=False)

    # thermal fleet, spread over the RTS-like list
    pick = [_FLEET[int((i + 0.5) * len(_FLEET) / n_thermal)] for i in range(n_thermal)]
    th_bus = rng.integers(1, n_bus + 1, n_thermal)
    th_rows, names = [], []
    for g, (fam, pmax, pmin_s, hr, fuel, mu, md, ramp, heat) in enumerate(pick):
        name = f"{th_bus[g]}_{fam}_{g + 1}"
        names.append(name)
        hr_incr = hr * np.array([0.85, 0.95, 1.10]) * rng.uniform(0.97, 1.03)
        th_rows.append({
            "GEN UID": name, "Bus ID": th_bus[g], "PMax MW": pmax,
            "PMin MW": round(pmax * pmin_s, 2), "Fuel Price $/MMBTU": fuel,
            "Output_pct_0": pmin_s, "Output_pct_1": pmin_s + (1 - pmin_s) / 3,
            "Output_pct_2": pmin_s + 2 * (1 - pmin_s) / 3, "Output_pct_3": 1.0,
            "HR_avg_0": round(hr * 1.05, 1), "HR_incr_1": round(hr_incr[0], 1),
            "HR_incr_2": round(hr_incr[1], 1), "HR_incr_3": round(hr_incr[2], 1),
            "Start Heat Hot MBTU": heat, "Non Fuel Start Cost $": 0.0,
            "Ramp Rate MW/Min": ramp, "Min Up Time Hr": mu, "Min Down Time Hr": md})
    cap_th = sum(r["PMax MW"] for r in th_rows)

    # renewables by RTS shares; the participant is the first wind unit
    counts = [max(1, round(c * n_renewable / 81)) for _, c, _ in _REN]
    while sum(counts) > n_renewable:  # trim the largest family, never wind
        counts[1 + int(np.argmax(counts[1:]))] -= 1
    while sum(counts) < n_renewable:
        counts[1] += 1
    p_bus = int(participant.split("_")[0])
    ren_rows, ren_kind = [], []
    for (fam, _, size), cnt in zip(_REN, counts):
        for k in range(cnt):
            if fam == "WIND" and k == 0:
                name, b = participant, p_bus
            else:
                b = int(rng.integers(1, n_bus + 1))
                name = f"{b}_{fam}_{k + 1}"
            scale = cap_th / 5430.0 * size * rng.uniform(0.6, 1.4)
            ren_rows.append({"GEN UID": name, "Bus ID": b,
                             "PMax MW": round(scale, 2), "PMin MW": 0.0})
            ren_kind.append(fam)
    pd.DataFrame(th_rows + ren_rows).to_csv(path / "gen.csv", index=False)

    # hourly series: a daily load shape per area, renewables by family
    H = 24 * n_days
    hours = np.arange(H)
    start_ts = pd.Timestamp(start)
    stamp = [start_ts + pd.Timedelta(hours=int(h)) for h in hours]
    cols = {"Year": [t.year for t in stamp], "Month": [t.month for t in stamp],
            "Day": [t.day for t in stamp], "Period": [t.hour + 1 for t in stamp]}
    shape = 0.75 + 0.25 * np.sin(2 * np.pi * (hours - 9) / 24)
    peak = 0.72 * cap_th
    a_share = np.array([share[area == a].sum() for a in range(1, n_area + 1)])
    a_share = a_share / a_share.sum()
    load_da = np.stack([peak * a_share[a] * shape * rng.uniform(0.97, 1.03, H)
                        for a in range(n_area)], axis=1)
    load_rt = load_da * rng.uniform(0.97, 1.03, load_da.shape)
    for name, arr in (("DAY_AHEAD_load.csv", load_da), ("REAL_TIME_load.csv", load_rt)):
        pd.DataFrame({**cols, **{str(a + 1): np.round(arr[:, a], 2)
                                 for a in range(n_area)}}).to_csv(path / name, index=False)
    sun = np.clip(np.sin(2 * np.pi * (hours % 24 - 6) / 24), 0.0, None)
    ren_da = {}
    for row, fam in zip(ren_rows, ren_kind):
        if fam == "WIND":
            cf = np.clip(0.45 + 0.3 * np.sin(2 * np.pi * hours / rng.uniform(20, 60)
                                             + rng.uniform(0, 6)) + 0.1 * rng.standard_normal(H),
                         0.02, 1.0)
        elif fam in ("PV", "RTPV"):
            cf = sun * rng.uniform(0.6, 0.95)
        else:
            cf = np.full(H, rng.uniform(0.4, 0.8))
        ren_da[row["GEN UID"]] = row["PMax MW"] * cf
    ren_rt = {k: np.clip(v * rng.uniform(0.9, 1.1, H), 0.0, None) for k, v in ren_da.items()}
    for name, d in (("DAY_AHEAD_renewables.csv", ren_da), ("REAL_TIME_renewables.csv", ren_rt)):
        pd.DataFrame({**cols, **{k: np.round(v, 3) for k, v in d.items()}}).to_csv(
            path / name, index=False)

    # initial status: hours in state (negative = off) and output
    on = np.array([r["Min Up Time Hr"] >= 4 or rng.random() < 0.3 for r in th_rows])
    init = {n: [float(max(th_rows[g]["Min Up Time Hr"], 1)) if on[g]
                else -float(max(th_rows[g]["Min Down Time Hr"], 1)),
                th_rows[g]["PMin MW"] if on[g] else 0.0] for g, n in enumerate(names)}
    pd.DataFrame(init).to_csv(path / "initial_status.csv", index=False)

    # network: a ring per area, chords, and ties between the areas
    edges = set()
    for a in range(1, n_area + 1):
        b = bus_ids[area == a]
        for i in range(len(b)):
            if len(b) > 1:
                edges.add(tuple(sorted((int(b[i]), int(b[(i + 1) % len(b)])))))
    for a in range(1, n_area):
        edges.add((int(bus_ids[area == a][0]), int(bus_ids[area == a + 1][-1])))
        edges.add((int(bus_ids[area == a][len(bus_ids[area == a]) // 2]),
                   int(bus_ids[area == a + 1][len(bus_ids[area == a + 1]) // 2])))
    while len(edges) < n_branch:
        i, j = sorted(int(v) for v in rng.choice(bus_ids, 2, replace=False))
        if area[i - 1] == area[j - 1] or rng.random() < 0.1:
            edges.add((i, j))
    edges = sorted(edges)[:n_branch] if len(edges) > n_branch else sorted(edges)
    x = rng.uniform(0.02, 0.2, len(edges))
    # ratings: every line carries at least the flow bound of a zero
    # dispatch above pmin (sum_b |PTDF_lb| max(pmin_b, peak load_b)), so
    # every dispatch LP is feasible (shedding is system-wide), and 1.6x
    # (~10% of lines: 1.15x) the peak flow of a capacity-proportional
    # dispatch with every unit on
    pos = {b: i for i, b in enumerate(bus_ids)}
    inc = np.zeros((len(edges), n_bus))
    for li, (i, j) in enumerate(edges):
        inc[li, pos[i]], inc[li, pos[j]] = 1.0, -1.0
    bl = 1.0 / x
    bbus = inc.T @ np.diag(bl) @ inc
    ptdf = np.zeros((len(edges), n_bus))
    ptdf[:, 1:] = (np.diag(bl) @ inc[:, 1:]) @ np.linalg.inv(bbus[1:, 1:])
    bus_load = np.zeros((H, n_bus))
    for a in range(n_area):
        wa = np.where(area == a + 1, share, 0.0)
        bus_load += np.outer(np.maximum(load_da[:, a], load_rt[:, a]),
                             wa / max(wa.sum(), 1e-12))
    gen_cap, pmin_b = np.zeros(n_bus), np.zeros(n_bus)
    for r in th_rows:
        gen_cap[pos[r["Bus ID"]]] += r["PMax MW"]
        pmin_b[pos[r["Bus ID"]]] += r["PMin MW"]
    ren_inj = np.zeros((H, n_bus))
    for row in ren_rows:
        ren_inj[:, pos[row["Bus ID"]]] += ren_da[row["GEN UID"]]
    need = bus_load.sum(1) - ren_inj.sum(1)
    inj = ren_inj + np.outer(np.maximum(need, 0.0), gen_cap / gen_cap.sum()) - bus_load
    zero_bound = np.abs(ptdf) @ np.maximum(pmin_b, bus_load.max(0))
    peak_flow = np.abs(inj @ ptdf.T).max(axis=0)
    tight = rng.random(len(edges)) < 0.1
    rating = np.maximum(np.where(tight, 1.15 * peak_flow, 1.6 * peak_flow + 50.0),
                        1.02 * zero_bound)
    pd.DataFrame({"UID": [f"L{i + 1}" for i in range(len(edges))],
                  "From Bus": [e[0] for e in edges], "To Bus": [e[1] for e in edges],
                  "X": np.round(x, 4), "Cont Rating": np.round(rating, 1)}).to_csv(
        path / "branch.csv", index=False)
    return path


def sparse_rows(torch, fn, x, rows, chunk=2048):
    """The Jacobian of ``fn`` at ``x`` (``rows`` outputs) as a scipy CSR
    matrix, ``chunk`` rows at a time by vmapped VJPs on ``x``'s device."""
    from scipy.sparse import csr_matrix, vstack

    _, vjp = torch.func.vjp(fn, x)
    rows_vjp = torch.func.vmap(lambda v: vjp(v)[0])
    blocks = []
    for a in range(0, rows, chunk):
        k = min(chunk, rows - a)
        basis = torch.zeros((k, rows), dtype=x.dtype, device=x.device)
        basis[torch.arange(k), a + torch.arange(k)] = 1.0
        blocks.append(csr_matrix(rows_vjp(basis).cpu().numpy()))
    return vstack(blocks).tocsr() if blocks else csr_matrix((0, x.shape[0]))


def highs_lp(torch, nlp, p, label, device):
    """HiGHS (scipy ``linprog``) on the affine NLP ``nlp`` at params ``p``:
    the LP read off the port's own residuals at x = 0 (sparse Jacobians
    by ``sparse_rows``).  Returns (objective in the user's sense, the
    result's equality and inequality marginals)."""
    from scipy.optimize import linprog

    x0 = torch.zeros(nlp.n, dtype=torch.float64, device=device)
    c = torch.func.grad(lambda x: nlp.objective(x, p))(x0).cpu().numpy()
    K = sparse_rows(torch, lambda x: nlp.eq(x, p), x0, nlp.m_eq)
    G = sparse_rows(torch, lambda x: nlp.ineq(x, p), x0, nlp.m_ineq)
    q = -nlp.eq(x0, p).cpu().numpy()
    h = -nlp.ineq(x0, p).cpu().numpy()
    bounds = [(None if not np.isfinite(lo) else lo, None if not np.isfinite(hi) else hi)
              for lo, hi in zip(nlp.lb, nlp.ub)]
    res = linprog(c, A_ub=G if G.shape[0] else None, b_ub=h if h.size else None,
                  A_eq=K if K.shape[0] else None, b_eq=q if q.size else None,
                  bounds=bounds, method="highs")
    check(res.status == 0, f"HiGHS failed on {label}: {res.message}")
    obj = float(nlp.user_objective(torch.as_tensor(res.x, device=device), p))
    return obj, res.eqlin.marginals, res.ineqlin.marginals


# the synthetic RTS-GMLC-size market of phase 7 and its seed
DL_BUSES, DL_BRANCHES, DL_THERMAL, DL_RENEWABLE, DL_SEED = 73, 120, 73, 81, 7
DL_OBJ_RTOL = 1e-6      # [market] LP objectives vs HiGHS
BID_RTOL = 1e-6         # [bid-batch] day batch vs sequential bids
N_BID_DAYS = 7


# [ne] runs at LMP 500 only: LMP 5's stiff cold start (600 iterations,
# 52.6 s on the card in PR 6 run B) is cut for the script's time; tier 1
# holds it against JAX (tests/test_torch_nuclear.py)
NE_LMPS = (500.0,)


def ne_price_taker(torch, dev):
    """[ne]: tests/test_ne_multiperiod.py's recipe (T = 4, h2 price 3,
    max_iter 600) on the card at ``NE_LMPS``: converged, the tank holdup
    balanced, and dear power sent to the grid rather than to hydrogen."""
    from dispatches_tpu_torch.case_studies.nuclear import ne_price_taker_optimize

    for lmp in NE_LMPS:
        t0 = time.perf_counter()
        m, nlp, res, sol = ne_price_taker_optimize(4, np.full(4, lmp), h2_price=3.0,
                                                   max_iter=600, device=dev)
        torch.cuda.synchronize()
        print(f"[ne] LMP {lmp:g}: status {int(res.status)}, {int(res.iterations)} iterations, "
              f"{time.perf_counter() - t0:.2f} s, objective {float(res.obj):.6f}")
        check(bool(res.converged), f"[ne] the price-taker at LMP {lmp:g} did not converge")
        holdup = sol["h2_tank.tank_holdup"]
        prev = np.concatenate([[float(sol["h2_tank.tank_holdup_previous"])], holdup[:-1]])
        net_in = (sol["h2_tank.inlet.flow_mol"] - sol["h2_tank.outlet_to_pipeline.flow_mol"]
                  - sol["h2_tank.outlet_to_turbine.flow_mol"]) * 3600.0
        bal = float(np.abs(holdup - prev - net_in).max())
        pipe = float(np.mean(sol["h2_tank.outlet_to_pipeline.flow_mol"]))
        grid = float(np.mean(sol["np_power_split.np_to_grid_elec"]))
        print(f"[ne] LMP {lmp:g}: tank balance max error {bal:.3e} mol; pipeline flow "
              f"{pipe:.3f} mol/s, grid {grid:.1f} kW of 500,000")
        check(bal <= 1e-4, f"[ne] the tank holdup does not balance at LMP {lmp:g}: {bal:.3e}")
        if lmp >= 100.0:
            check(grid >= 0.999 * 500e3 and pipe <= 1e-3,
                  f"[ne] dear power (LMP {lmp:g}) does not go to the grid")
        else:
            check(pipe > 1.0 and grid < 500e3, f"[ne] cheap power (LMP {lmp:g}) does not go "
                  "to hydrogen")


class _Recorder:
    """Wraps the double loop's hooks for phase 7: every IPM solve's status
    and iterations, the seconds of each market cycle's parts, the bid
    curves, the RUC's host time and commitment, the dispatch LPs' params
    (the DA LP and the first 4 SCED hours), and the simulator itself."""

    def __init__(self, torch):
        from dispatches_tpu_torch.grid import bidder, coordinator, market, tracker

        self.torch = torch
        self.solves = []          # (kind, status, iterations, seconds)
        self.parts = {}           # part -> [seconds]
        self.curves = []          # bid dicts
        self.lps = []             # (kind, params, result, seconds, peak bytes)
        self.ruc_s, self.u, self.sim = [], None, None
        self._undo = []
        rec = self

        def wrap(obj, name, fn):
            orig = getattr(obj, name)
            self._undo.append((obj, name, orig))
            setattr(obj, name, fn(orig))

        def timed(part):
            def deco(orig):
                def run(*a, **k):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = orig(*a, **k)
                    torch.cuda.synchronize()
                    rec.parts.setdefault(part, []).append(time.perf_counter() - t0)
                    if part in ("bid.rt", "bid.da"):
                        rec.curves.append(out)
                    return out
                return run
            return deco

        def scen(orig):
            def run(self_, blk, prices):
                t0 = time.perf_counter()
                powers, res = orig(self_, blk, prices)
                rec.solves.append((f"bid[h={blk.horizon}]", int(res.status),
                                   int(res.iterations), time.perf_counter() - t0))
                return powers, res
            return run

        def track(orig):
            def run(self_, *a, **k):
                t0 = time.perf_counter()
                out = orig(self_, *a, **k)
                rec.solves.append((f"track[h={self_.tracking_horizon}]", int(self_.res.status),
                                   int(self_.res.iterations), time.perf_counter() - t0))
                return out
            return run

        def lp_solve(orig):
            def run(self_, params):
                kind = "da" if self_.H == rec.sim.ruc_horizon else "sced"
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                out = orig(self_, params)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                res = out[0]
                rec.solves.append((kind, int(res.status), int(res.iterations), dt))
                n_sced = sum(1 for lp in rec.lps if lp[0] == "sced")
                if kind == "da" or n_sced < 4:
                    rec.lps.append((kind, params, out, dt, torch.cuda.max_memory_allocated()))
                return out
            return run

        def ruc(orig):
            def run(*a, **k):
                t0 = time.perf_counter()
                u = orig(*a, **k)
                rec.ruc_s.append(time.perf_counter() - t0)
                rec.u = u
                return u
            return run

        def sim_init(orig):
            def run(self_, *a, **k):
                orig(self_, *a, **k)
                rec.sim = self_
            return run

        C = coordinator.DoubleLoopCoordinator
        wrap(C, "request_rt_bids", timed("bid.rt"))
        wrap(C, "request_da_bids", timed("bid.da"))
        wrap(C, "push_rt_dispatch", timed("track.rt"))
        wrap(C, "push_da_results", timed("projection"))
        wrap(bidder._BidderBase, "_scenario_solve", scen)
        wrap(tracker.Tracker, "track_market_dispatch", track)
        wrap(market._DispatchLP, "solve", lp_solve)
        wrap(market, "solve_unit_commitment", ruc)
        wrap(market.MarketSimulator, "__init__", sim_init)

    def restore(self):
        for obj, name, orig in reversed(self._undo):
            setattr(obj, name, orig)


def _monotone(bids):
    """Every curve of a bid dict non-decreasing: power and cost up, the
    marginal price (cost slope) not falling."""
    for t, gens in bids.items():
        for g in gens.values():
            if "p_cost" not in g:
                continue
            pw = np.array([p for p, _ in g["p_cost"]])
            c = np.array([c for _, c in g["p_cost"]])
            if np.any(np.diff(pw) <= 0) or np.any(np.diff(c) < -1e-9):
                return False
            marg = np.diff(c) / np.diff(pw)
            if np.any(np.diff(marg) < -1e-6):
                return False
    return True


def double_loop(torch, dev, work):
    """[double-loop]: the port's ``run_double_loop`` on the synthetic
    73-bus case, one day, ``DoubleLoopOptions``' defaults otherwise (the
    device passed as ``--device``: cuda, its default, on the card)."""
    import pandas as pd

    from dispatches_tpu_torch.case_studies.renewables.run_double_loop import main as dl_main
    from dispatches_tpu_torch.grid.market import load_rts_gmlc_case

    t0 = time.perf_counter()
    data = write_synthetic_rts(work / "rts73", DL_BUSES, DL_BRANCHES, DL_THERMAL, DL_RENEWABLE,
                               seed=DL_SEED)
    case = load_rts_gmlc_case(data)
    print(f"[market] synthetic RTS-GMLC case (seed {DL_SEED}): {len(case.buses)} buses, "
          f"{case.ptdf.shape[0]} branches, {len(case.thermals)} thermal, "
          f"{len(case.renewables)} renewable units, {case.n_hours} hours; written and "
          f"parsed in {time.perf_counter() - t0:.2f} s")
    check((len(case.buses), case.ptdf.shape[0], len(case.thermals), len(case.renewables))
          == (DL_BUSES, DL_BRANCHES, DL_THERMAL, DL_RENEWABLE),
          "[market] load_rts_gmlc_case did not parse the synthetic case's counts")
    out = work / "dl_out"
    rec = _Recorder(torch)
    try:
        t0 = time.perf_counter()
        res = dl_main(["--data_path", str(data), "--num_days", "1", "--output_dir", str(out),
                       "--device", dev.type])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        rec.restore()
    print(f"[double-loop] one market day in {wall:.1f} s; total cost {res['total_cost']:.2f}")
    bad = [s for s in rec.solves if s[1] >= 2]
    check(not bad, f"[double-loop] {len(bad)} solves did not converge: {bad[:5]}")
    kinds = sorted({s[0] for s in rec.solves})
    for k in kinds:
        its = [s[2] for s in rec.solves if s[0] == k]
        secs = [s[3] for s in rec.solves if s[0] == k]
        print(f"[double-loop] {k}: {len(its)} solves, IPM iterations mean {np.mean(its):.1f} "
              f"(min {min(its)}, max {max(its)}), seconds mean {np.mean(secs):.3f}, "
              f"statuses {sorted(set(s[1] for s in rec.solves if s[0] == k))}")
    for part, secs in rec.parts.items():
        print(f"[double-loop] {part}: {len(secs)} calls, {np.mean(secs):.3f} s mean, "
              f"{np.sum(secs):.1f} s total")
    sced = [s for s in rec.solves if s[0] == "sced"]
    hourly = sum(1 for s in rec.solves if s[0] in ("sced", "bid[h=4]", "track[h=4]"))
    print(f"[double-loop] per market hour: RT bidding {np.mean(rec.parts['bid.rt']):.3f} s, "
          f"SCED {np.mean([s[3] for s in sced]):.3f} s, tracking "
          f"{np.mean(rec.parts['track.rt']):.3f} s; projection {np.sum(rec.parts['projection']):.3f} s "
          f"per day; {hourly / 24:.2f} solves per hour (+ the DA bid, the DA LP and the "
          "projection once a day)")
    check(all(_monotone(b) for b in rec.curves) and rec.curves,
          "[double-loop] a bid curve is not non-decreasing in price")
    print(f"[double-loop] {len(rec.curves)} bid sets, every curve non-decreasing in price")
    files = {p.name: len(pd.read_csv(p)) for p in sorted(out.glob("*.csv"))}
    print(f"[double-loop] output files (rows): {files}")
    nb, nth, nren = len(case.buses), len(case.thermals), len(case.renewables)
    want = {"hourly_summary.csv": 1, "bus_detail.csv": nb, "thermal_detail.csv": nth + 1,
            "renewables_detail.csv": nren - 1}
    for name, per_hour in want.items():
        df = pd.read_csv(out / name)
        counts = df.groupby("Hour").size()
        check(sorted(counts.index) == list(range(24)) and set(counts) == {per_hour},
              f"[market] {name} does not hold {per_hour} rows in each of 24 hours")
    check(files.get("tracker_detail.csv") == 24 * 4 and files.get("tracking_model_detail.csv") == 4
          and files.get("bidder_detail.csv") == 48 + 24 * 4
          and files.get("overall_simulation_output.csv") == 1,
          f"[double-loop] the participant's output files are incomplete: {files}")
    shed = float(pd.read_csv(out / "hourly_summary.csv")["Shortfall"].max())
    check(shed == 0.0, f"[market] load was shed: {shed} MW")
    return rec, case


def market_checks(torch, dev, rec, case):
    """[market]: the DA LP and 4 SCED hours of the [double-loop] run
    against HiGHS on the same LPs."""
    print(f"[market] RUC (host MILP): {rec.ruc_s[0]:.2f} s")
    worst = 0.0
    for kind, params, (res, sol, lmp), dt, peak in rec.lps:
        nlp = (rec.sim._da_lp if kind == "da" else rec.sim._rt_lp).nlp
        t0 = time.perf_counter()
        obj, eqm, inm = highs_lp(torch, nlp, params, f"[market] {kind} LP", dev)
        hs = time.perf_counter() - t0
        rel = abs(float(res.obj) - obj) / max(1.0, abs(obj))
        worst = max(worst, rel)
        H = nlp.H
        n_line = case.ptdf.shape[0]
        a, b = nlp.ineq_slices["line_fwd"]
        mf = inm[a:b].reshape(n_line, H).T
        mb = inm[b:b + n_line * H].reshape(n_line, H).T
        lmp_h = eqm[:H, None] + (mf - mb) @ case.ptdf
        binding = int((np.abs(mf) + np.abs(mb) > 1e-6).sum())
        print(f"[market] {kind} LP (H={H}, n={nlp.n}, m_eq={nlp.m_eq}, m_ineq={nlp.m_ineq}): "
              f"{int(res.iterations)} IPM iterations, {dt:.3f} s, peak device memory "
              f"{peak / 2**30:.2f} GiB; objective {float(res.obj):.6f} vs HiGHS {obj:.6f} "
              f"(rel {rel:.3e}, HiGHS {hs:.1f} s); LMP range [{lmp.min():.4f}, {lmp.max():.4f}] "
              f"$/MWh; max |LMP - HiGHS duals| {np.abs(lmp - lmp_h).max():.3e} (reported only); "
              f"binding line-hours {binding}")
        check(rel <= DL_OBJ_RTOL, f"[market] {kind} LP objective {rel:.3e} from HiGHS")
    check(sum(1 for lp in rec.lps if lp[0] == "sced") == 4 and rec.lps[0][0] == "da",
          "[market] the DA LP and 4 SCED hours were not captured")
    print(f"[market] DA + 4 SCED objectives within {worst:.3e} of HiGHS")


def bid_batch(torch, dev, case):
    """[bid-batch]: ``compute_day_ahead_bids_batch`` over 7 days as one lane
    axis against 7 calls of ``compute_day_ahead_bids`` on the same
    capacity-factor windows, with a fixed (state-neutral) forecaster."""
    from dispatches_tpu_torch.case_studies.renewables.wind_battery_double_loop import (
        MultiPeriodWindBattery,
    )
    from dispatches_tpu_torch.grid import Bidder, ThermalGeneratorModelData

    ren = {r.name: r for r in case.renewables}["4_WIND"]
    cfs = np.asarray(ren.rt_cap) / max(ren.rt_cap.max(), 1e-9)
    md = ThermalGeneratorModelData(gen_name="4_WIND", bus=ren.bus, p_min=0.0, p_max=120.0,
                                   startup_capacity=0.0, shutdown_capacity=135.0)
    mp = MultiPeriodWindBattery(model_data=md, wind_capacity_factors=cfs, wind_pmax_mw=120.0,
                                battery_pmax_mw=15.0, battery_energy_capacity_mwh=60.0)
    rng = np.random.default_rng(DL_SEED)
    scen = 20.0 + 5.0 * rng.random((3, 48))

    class Fixed:
        def forecast_day_ahead_prices(self, date, hour, bus, horizon, n):
            return scen[:n, :horizon]

        forecast_real_time_prices = forecast_day_ahead_prices

    bidder = Bidder(bidding_model_object=mp, day_ahead_horizon=48, real_time_horizon=4,
                    n_scenario=3, forecaster=Fixed(), device=dev)
    dates = [f"2020-07-{10 + i:02d}" for i in range(N_BID_DAYS)]
    t0 = time.perf_counter()
    batch = bidder.compute_day_ahead_bids_batch(dates)
    torch.cuda.synchronize()
    tb = time.perf_counter() - t0
    blk, fs = bidder.day_ahead_model, bidder.day_ahead_model.m.fs
    t0 = time.perf_counter()
    seq = {}
    for i, d in enumerate(dates):
        fs.params["windpower.capacity_factor"] = mp._cf_window(blk._time_idx + 24 * i, 48)
        seq[d] = bidder.compute_day_ahead_bids(date=d)
    torch.cuda.synchronize()
    ts = time.perf_counter() - t0
    worst = 0.0
    for d in dates:
        for t in range(48):
            a, b = batch[d][t]["4_WIND"]["p_cost"], seq[d][t]["4_WIND"]["p_cost"]
            check(len(a) == len(b), f"[bid-batch] {d} hour {t}: curves differ in length")
            for (pa, ca), (pb, cb) in zip(a, b):
                worst = max(worst, abs(pa - pb) / max(1.0, abs(pb)),
                            abs(ca - cb) / max(1.0, abs(cb)))
    print(f"[bid-batch] {N_BID_DAYS} days: one lane-axis solve {tb:.2f} s, {N_BID_DAYS} "
          f"sequential solves {ts:.2f} s; bids max rel diff {worst:.3e}")
    check(worst <= BID_RTOL, f"[bid-batch] batched bids {worst:.3e} from the sequential ones")


def dl_trace(torch, rec):
    """[dl-trace]: one warmed market hour (RT bids, SCED, tracking and a
    projection solve) under torch.profiler."""
    sim = rec.sim
    coord, case, lp = sim.coordinator, sim.case, sim._rt_lp
    hr, Hs = 12, sim.sced_horizon
    hours = np.clip(np.arange(hr, hr + Hs), 0, case.n_hours - 1)
    u_h = rec.u[np.clip(np.arange(hr, hr + Hs), 0, rec.u.shape[0] - 1)]
    date = "2020-07-10"
    n0 = len(rec.solves)

    def hour():
        bidder = coord.bidder
        prices = np.asarray(bidder.forecaster.forecast_real_time_prices(
            date, hr, bidder.bidding_model_object.model_data.bus, bidder.real_time_horizon,
            bidder.n_scenario))
        powers, res_bid = bidder._scenario_solve(bidder.real_time_model, prices)
        bids = bidder._curves(prices, powers, bidder.real_time_horizon)
        res, sol, lmp = lp.solve(lp.params_for(hours, u_h, rt=True, participant_bids=bids))
        pp = float(sum(np.asarray(sol[f"pp_{k}"]) for k in range(4))[0])
        coord.tracker.track_market_dispatch(np.full(4, pp), date=date, hour=hr)
        coord.projection_tracker.track_market_dispatch(np.full(4, pp), date=date, hour=hr)
        return res_bid, res, coord.tracker.res, coord.projection_tracker.res

    # the hour's four solvers are warm from the [double-loop] day
    torch.cuda.synchronize()
    out, prof, by_name, total, window = profile_run(torch, hour, "[dl-trace] market hour")
    its = [int(r.iterations) for r in out]
    print(f"[dl-trace] IPM iterations in the hour (RT bid, SCED, tracker, projection): {its}")
    if by_name:
        launches = sum(n for n, _ in by_name.values())
        print(f"[dl-trace] {launches} device launches over {sum(its)} Newton iterations: "
              f"{launches / max(sum(its), 1):.1f} per iteration")


def phase_double_loop(torch, dev):
    """Phase 7, with the sweep kernels' counts set to 0 before and read
    after: the double loop and the nuclear case run on the float64 IPM
    and launch neither sweep."""
    import tempfile

    from dispatches_tpu_torch.kernels import pdhg_sweep as ks

    ks.avg_sweep.launches = 0
    ks.halpern_sweep.launches = 0
    t0 = time.perf_counter()
    ne_price_taker(torch, dev)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="phase7-") as tmp:
        rec, case = double_loop(torch, dev, Path(tmp))
        market_checks(torch, dev, rec, case)
        bid_batch(torch, dev, case)
        dl_trace(torch, rec)
    print(f"[phase7] {time.perf_counter() - t0:.1f} s; sweep kernel launches during it: "
          f"halpern {ks.halpern_sweep.launches}, avg {ks.avg_sweep.launches}")
    check(ks.halpern_sweep.launches == 0 and ks.avg_sweep.launches == 0,
          "[phase7] the double loop launched a sweep kernel")


# ---------------------------------------------------------------------
# phase 8: the design-space sweep, its store and the sweep->surrogate workflow
# ---------------------------------------------------------------------

SWEEP_CHUNK = 128        # [sweep]: 366 x 2 = 732 points in 6 chunks (the last 92 live)
SWEEP_LHS_N = 2          # battery sizes per price profile (cut to 1 first if over time)
SWEEP_PDLP = {"tol": 1e-8, "dtype": "float64"}
SWEEP_HIGHS_PER_SIZE = 8  # [sweep]: HiGHS-checked points per battery size
SWEEP_RESUME_CHUNKS = 3  # [sweep-resume]: chunks in the first, cut-short run
SWEEP_SERVE_N = 64       # [sweep-serve]: points through the serve backend
SWEEP_SERVE_RTOL = 1e-8  # [sweep-serve] objectives vs [sweep]'s
N_CLUSTERS = 20          # [cluster]: the shipped RE surrogate's cluster count
CLUSTER_RTOL = 1e-9      # [cluster] inertia vs the plain numpy Lloyd
GOLD_RTOL, GOLD_ATOL = 2e-4, 1e-3   # [surrogate] vs tests/data/surrogate_goldens
MLP_CPU_RTOL = 1e-9                 # [surrogate] card-trained MLP vs the same recipe on the CPU


def _sweep_spec(lmps, n_lhs=SWEEP_LHS_N):
    """366 price profiles ($/kWh) x ``n_lhs`` battery sizes (kW, LHS)."""
    from dispatches_tpu_torch.sweep import SweepSpec, grid, lhs

    return SweepSpec((grid("lmp", lmps * 1e-3),
                      lhs({"battery.nameplate_power": (5e3, 50e3)}, n_lhs, seed=1)))


def _sweep_options(**kw):
    from dispatches_tpu_torch.sweep import SweepOptions

    kw.setdefault("chunk_size", SWEEP_CHUNK)
    return SweepOptions(solver="pdlp", solver_options=SWEEP_PDLP, **kw)


def _store_files(path):
    """{relative path: bytes} of a store's identity files (all but the
    run telemetry in progress.json)."""
    return {str(f.relative_to(path)): f.read_bytes() for f in sorted(Path(path).rglob("*"))
            if f.is_file() and f.name != "progress.json"}


def sweep_direct(torch, dev, main_run, work):
    """[sweep]: the 732-point spec through ``run_sweep``'s direct backend,
    float64 PDLP at tol 1e-8; 16 points against HiGHS."""
    from dispatches_tpu_torch.obs import registry
    from dispatches_tpu_torch.sweep import STATUS_OK, STATUS_RETRIED, run_sweep

    nlp, lp, lmps = main_run["nlp"], main_run["lp"], main_run["lmps"]
    spec = _sweep_spec(lmps)
    builds = registry.counter("program.builds")
    b0 = builds.value(label="sweep.direct")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    store = run_sweep(nlp, spec, store_dir=work / "sweep", options=_sweep_options(), device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    a = store.arrays()
    n = spec.n_points
    check(store.is_complete and n == len(lmps) * SWEEP_LHS_N, "[sweep] store not complete")
    check(a["obj"].shape == (n,) and np.all(np.isfinite(a["obj"])),
          f"[sweep] objectives not finite of shape ({n},)")
    st = a["status"]
    check(np.all((st == STATUS_OK) | (st == STATUS_RETRIED)),
          f"[sweep] statuses {np.bincount(st, minlength=4).tolist()}: a point quarantined "
          "or refine-failed")
    # point i is (profile i // n_lhs, battery size i % n_lhs): the first
    # SWEEP_HIGHS_PER_SIZE profiles at every size
    idx = np.array([r * SWEEP_LHS_N + s for s in range(SWEEP_LHS_N)
                    for r in range(SWEEP_HIGHS_PER_SIZE)])
    vals = spec.values_for(idx)
    d = nlp.default_params()
    ref = np.array([highs_objective(
        torch, nlp, lp, {"p": {**d["p"], "lmp": vals["lmp"][k]},
                         "fixed": {**d["fixed"], "battery.nameplate_power":
                                   vals["battery.nameplate_power"][k]}}, f"sweep point {i}")
        for k, i in enumerate(idx)])
    err = np.abs(a["obj"][idx] - ref) / np.maximum(np.abs(ref), 1.0)
    walls = [c["wall_s"] for _, c in sorted(store.progress()["chunks"].items(),
                                           key=lambda kv: int(kv[0]))]
    sizes = np.unique(a["inputs"][:, 1])
    print(f"[sweep] {n} points ({len(lmps)} price profiles x {SWEEP_LHS_N} battery sizes "
          f"{np.round(sizes).tolist()} kW), {len(walls)} chunks of {SWEEP_CHUNK} "
          f"(last {n - SWEEP_CHUNK * (len(walls) - 1)} live): {dt:.2f} s = {n / dt:.1f} points/s; "
          f"seconds per chunk {[round(w, 3) for w in walls]}, {dt - sum(walls):.3f} s outside "
          f"the chunk timers (solver build, store writes); converged share "
          f"{a['converged'].mean():.4f}; PDHG iterations mean {a['iterations'].mean():.1f} "
          f"max {a['iterations'].max()}; statuses ok/retried {int(np.sum(st == STATUS_OK))}/"
          f"{int(np.sum(st == STATUS_RETRIED))}; program signatures "
          f"{builds.value(label='sweep.direct') - b0:.0f}; peak_mem "
          f"{(torch.cuda.max_memory_allocated() - mem0) / 2**20:.1f} MiB above the sweep's start; "
          f"obj_rel_err_vs_highs({len(idx)}) max {err.max():.3e}")
    check(err.max() <= IPM_RTOL, f"[sweep] objective error {err.max():.3e} > {IPM_RTOL}")
    return store


def sweep_resume(torch, dev, main_run, work, ref_store):
    """[sweep-resume]: the same spec cut after SWEEP_RESUME_CHUNKS chunks,
    then resumed; every identity file byte-equal to [sweep]'s store."""
    from dispatches_tpu_torch.sweep import run_sweep

    nlp, spec = main_run["nlp"], _sweep_spec(main_run["lmps"])
    t0 = time.perf_counter()
    cut = run_sweep(nlp, spec, store_dir=work / "resume", device=dev,
                    options=_sweep_options(max_chunks=SWEEP_RESUME_CHUNKS))
    done_first = sorted(cut.completed)
    ran = []
    st = run_sweep(nlp, spec, store_dir=work / "resume", options=_sweep_options(), device=dev,
                   resume=True, on_chunk=lambda cid, n: ran.append(cid))
    torch.cuda.synchronize()
    a, b = _store_files(ref_store.path), _store_files(st.path)
    same = a.keys() == b.keys() and all(a[k] == b[k] for k in a)
    print(f"[sweep-resume] cut after chunks {done_first}, resumed chunks {ran}, "
          f"{time.perf_counter() - t0:.2f} s; {len(a)} identity files byte-equal to "
          f"[sweep]'s store: {same}")
    check(done_first == list(range(SWEEP_RESUME_CHUNKS)) and st.is_complete,
          "[sweep-resume] the cut or the resume did not run as planned")
    check(same, "[sweep-resume] the resumed store differs from [sweep]'s")


def sweep_serve(torch, dev, main_run, work, ref_store):
    """[sweep-serve]: the first SWEEP_SERVE_N points through the serve
    backend (a private SolveService, max_batch 64, warm starts off)."""
    from dispatches_tpu_torch.sweep import run_sweep

    n_prof = SWEEP_SERVE_N // SWEEP_LHS_N
    spec = _sweep_spec(main_run["lmps"][:n_prof])
    t0 = time.perf_counter()
    st = run_sweep(main_run["nlp"], spec, store_dir=work / "serve", device=dev,
                   options=_sweep_options(backend="serve", chunk_size=SWEEP_SERVE_N))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got, want = st.objectives(), ref_store.objectives()[:SWEEP_SERVE_N]
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    it_s, it_d = st.arrays()["iterations"], ref_store.arrays()["iterations"][:SWEEP_SERVE_N]
    print(f"[sweep-serve] {SWEEP_SERVE_N} points through SolveService (max_batch "
          f"{SWEEP_SERVE_N}, warm starts off): {dt:.2f} s = {SWEEP_SERVE_N / dt:.1f} points/s; "
          f"objectives vs [sweep] max rel {rel.max():.3e}; iterations equal on "
          f"{int(np.sum(it_s == it_d))}/{SWEEP_SERVE_N} points")
    check(st.is_complete, "[sweep-serve] store not complete")
    check(rel.max() <= SWEEP_SERVE_RTOL,
          f"[sweep-serve] objectives differ from [sweep]'s by {rel.max():.3e} > {SWEEP_SERVE_RTOL}")


def sweep_report(torch, store):
    """[sweep-report]: ``python -m dispatches_tpu_torch.sweep --report`` and
    ``--json`` on [sweep]'s store, in a subprocess."""
    outs = []
    for extra in ([], ["--json"]):
        r = subprocess.run([sys.executable, "-m", "dispatches_tpu_torch.sweep", "--report",
                            *extra, str(store.path)], capture_output=True, text=True,
                           cwd=ROOT, timeout=300)
        check(r.returncode == 0, f"[sweep-report] rc {r.returncode}: {r.stderr.strip()[-500:]}")
        outs.append(r.stdout)
    payload = json.loads(outs[1])
    n_chunks = len(store.chunk_plan())
    for line in outs[0].splitlines():
        print(f"[sweep-report] {line}")
    check(f"chunks {n_chunks}/{n_chunks} done" in outs[0], "[sweep-report] chunks not all done")
    check(payload["points_done"] == store.n_points,
          f"[sweep-report] points_done {payload['points_done']} != {store.n_points}")


def surrogates(torch, dev, store):
    """[surrogate]: a revenue MLP trained on [sweep]'s store on the card,
    then the five predictable shipped surrogates against their goldens."""
    from dispatches_tpu_torch.sweep import train_revenue_surrogate
    from dispatches_tpu_torch.workflow import TrainNNSurrogates, load_pretrained_surrogate

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer, params = train_revenue_surrogate(store, NN_size=[2, 16, 16, 1], epochs=400,
                                              device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    scaling = trainer._model_params
    pred = trainer.predict(params, scaling, store.arrays()["inputs"][:3], device=dev)
    r2 = np.asarray(scaling["R2"], dtype=float)
    print(f"[surrogate] revenue MLP [2, 16, 16, 1], 400 full-batch epochs on "
          f"{len(store.training_data()[1])} points: {dt:.2f} s; train loss "
          f"{scaling['train_loss']:.4e}, held-out R2 {r2.tolist()}")
    check(np.all(np.isfinite(r2)), "[surrogate] R2 not finite")
    check(pred.shape == (3, 1) and np.all(np.isfinite(pred)), "[surrogate] predictions")
    # the same recipe (seed, split, 400 full-batch Adam epochs) on the CPU
    host, host_params = train_revenue_surrogate(store, NN_size=[2, 16, 16, 1], epochs=400,
                                                device="cpu")
    host_pred = host.predict(host_params, host._model_params, store.arrays()["inputs"][:3],
                             device="cpu")
    flat = [np.concatenate([np.ravel(layer[k]) for layer in ps for k in ("W", "b")])
            for ps in (params, host_params)]
    w_rel = np.abs(flat[0] - flat[1]).max() / np.abs(flat[1]).max()
    p_rel = np.abs(pred - host_pred).max() / np.abs(host_pred).max()
    print(f"[surrogate] card vs CPU training, same recipe: weights max rel diff {w_rel:.3e}, "
          f"predictions {p_rel:.3e} (tolerance {MLP_CPU_RTOL:g})")
    check(w_rel <= MLP_CPU_RTOL and p_rel <= MLP_CPU_RTOL,
          f"[surrogate] the card's training departs from the CPU's beyond {MLP_CPU_RTOL:g}")
    worst = []
    for name in ("RE_revenue", "RE_20clusters_dispatch_frequency", "NE_revenue",
                 "NE_30clusters_dispatch_frequency", "FE_20clusters_dispatch_frequency"):
        p, sc = load_pretrained_surrogate(name)
        gold = np.load(ROOT / "tests" / "data" / "surrogate_goldens" / f"{name}_golden.npz")
        got = TrainNNSurrogates.predict(p, sc, gold["x"], device=dev)
        err = np.abs(got - gold["y"]) - GOLD_ATOL - GOLD_RTOL * np.abs(gold["y"])
        worst.append(f"{name} {np.abs(got - gold['y']).max():.3e}")
        check(got.shape == gold["y"].shape and np.all(err <= 0),
              f"[surrogate] {name} misses its golden beyond rtol {GOLD_RTOL}/atol {GOLD_ATOL}")
    print(f"[surrogate] shipped surrogates vs goldens on {dev.type} (max abs diff): "
          + ", ".join(worst))


def _lloyd_numpy(X, centers, n_iter=300, tol=1e-6):
    """The plain Lloyd loop in numpy, the port's arithmetic (expanded
    distances, empty clusters keep their centre); returns the inertia."""
    k = len(centers)
    for _ in range(n_iter):
        d2 = (X * X).sum(1)[:, None] - 2.0 * X @ centers.T + (centers * centers).sum(1)[None]
        lab = d2.argmin(1)
        onehot = np.eye(k)[lab]
        counts = onehot.sum(0)
        new = np.where(counts[:, None] > 0, onehot.T @ X / np.maximum(counts, 1.0)[:, None],
                       centers)
        shift = np.abs(new - centers).max()
        centers = new
        if not shift > tol:
            break
    d2 = (X * X).sum(1)[:, None] - 2.0 * X @ centers.T + (centers * centers).sum(1)[None]
    return float(d2.min(1).sum())


def clustering(torch, dev, main_run):
    """[cluster]: k-means of the 366 LMP days on the card against the plain
    numpy Lloyd from the same seeding; the soft-DTW recipe of
    tests/test_workflow_surrogates.py::test_soft_dtw_metric."""
    from dispatches_tpu_torch.workflow import clustering as cl

    X = np.asarray(main_run["lmps"], dtype=np.float64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    centers, labels, inertia = cl.kmeans_fit(X, N_CLUSTERS, seed=42, device=dev)
    dt = time.perf_counter() - t0
    c0 = cl._kmeanspp_init(torch.as_tensor(X), N_CLUSTERS,
                           torch.Generator(device="cpu").manual_seed(42)).numpy()
    want = _lloyd_numpy(X, c0)
    rel = abs(inertia - want) / abs(want)
    print(f"[cluster] kmeans_fit {X.shape[0]} x {X.shape[1]} LMP days, k {N_CLUSTERS}: "
          f"{dt:.2f} s, inertia {inertia:.6f} vs numpy Lloyd from the same seeding "
          f"{want:.6f} (rel {rel:.3e}); cluster sizes {np.bincount(labels, minlength=N_CLUSTERS).tolist()}")
    check(rel <= CLUSTER_RTOL, f"[cluster] inertia off the numpy Lloyd by {rel:.3e}")
    x = np.sin(np.linspace(0, 2 * np.pi, 24))
    z = np.full(24, 0.2)
    rng = np.random.default_rng(0)
    Xs = np.vstack([x[None, :] + 0.05 * rng.standard_normal((8, 24)),
                    z[None, :] + 0.05 * rng.standard_normal((8, 24))])
    t0 = time.perf_counter()
    _, lab, sd_inertia = cl.kmeans_fit_softdtw(Xs, 2, n_iter=4, barycenter_steps=8, device=dev)
    d = [float(cl.soft_dtw(torch.as_tensor(x, device=dev), torch.as_tensor(s, device=dev)))
         for s in (x, np.roll(x, 3), z)]
    print(f"[cluster] soft-DTW k-means (16 series, k 2, 4 iterations x 8 barycentre steps): "
          f"{time.perf_counter() - t0:.2f} s, labels {lab.tolist()}, inertia {sd_inertia:.6f}; "
          f"soft-DTW self/shifted/flat {d[0]:.4f} < {d[1]:.4f} < {d[2]:.4f}")
    check(len(set(lab[:8])) == 1 and len(set(lab[8:])) == 1 and lab[0] != lab[8],
          "[cluster] soft-DTW k-means did not separate the two groups")
    check(d[0] < d[1] < d[2], "[cluster] soft-DTW distances out of order")


def cashflows(torch, dev):
    """[cashflow]: NPV, IRR and PI at tests/test_utils.py's anchors."""
    from dispatches_tpu_torch.utils import irr, npv, profitability_index

    rate = 0.08
    annuity = np.array([0.0, 100.0, 100.0, 100.0])
    loan = np.array([-1000.0] + [1000 * rate / (1 - (1 + rate) ** -10)] * 10)
    pi_cash = np.array([-1000.0, 600.0, 600.0])
    t0 = time.perf_counter()
    got = {"npv": npv(annuity, 0.1, device=dev), "irr": irr(loan, device=dev),
           "pi": profitability_index(pi_cash, 0.1, device=dev)}
    check(all(v.device.type == dev.type for v in got.values()), "[cashflow] not on the device")
    got = {k: float(v) for k, v in got.items()}
    want = {"npv": 100 * (1 - 1.1**-3) / 0.1, "irr": rate,
            "pi": (600 / 1.1 + 600 / 1.21) / 1000}
    print(f"[cashflow] {time.perf_counter() - t0:.3f} s on {dev.type}: "
          + ", ".join(f"{k} {got[k]:.12g} (anchor {want[k]:.12g})" for k in got))
    check(abs(got["npv"] - want["npv"]) <= 1e-12 * want["npv"], "[cashflow] npv")
    check(abs(got["irr"] - rate) <= 1e-8, "[cashflow] irr")
    check(abs(got["pi"] - want["pi"]) <= 1e-12 * want["pi"], "[cashflow] pi")


def sweep_trace(torch, dev, main_run, work):
    """[sweep-trace]: one warmed 128-point chunk under torch.profiler."""
    from dispatches_tpu_torch.sweep import run_sweep

    n_prof = SWEEP_CHUNK // SWEEP_LHS_N
    spec = _sweep_spec(main_run["lmps"][:n_prof])

    def run():
        return run_sweep(main_run["nlp"], spec, store_dir=work / "trace", device=dev,
                         options=_sweep_options(), overwrite=True)

    run()
    store, _, by_name, total, window = profile_run(torch, run, "[sweep-trace] 128-point chunk")
    iters = int(store.arrays()["iterations"].max())
    if by_name:
        launches = sum(n for n, _ in by_name.values())
        checks = math.ceil(iters / K_STEPS)
        print(f"[sweep-trace] {launches} device launches over {checks} PDHG check intervals "
              f"(slowest point {iters} iterations): {launches / checks:.1f} per interval, "
              f"{total / 1e3 / checks:.3f} ms device time per interval")


def phase_sweep(torch, dev, main_run):
    """Phase 8, with the sweep kernels' counts set to 0 before and read
    after: the sweep engine solves through the per-scenario PDLP, and the
    workflow runs plain torch, so neither CUDA sweep is launched."""
    import tempfile

    from dispatches_tpu_torch.kernels import pdhg_sweep as ks

    ks.avg_sweep.launches = 0
    ks.halpern_sweep.launches = 0
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="phase8-") as tmp:
        work = Path(tmp)
        store = sweep_direct(torch, dev, main_run, work)
        sweep_resume(torch, dev, main_run, work, store)
        sweep_serve(torch, dev, main_run, work, store)
        sweep_report(torch, store)
        surrogates(torch, dev, store)
        clustering(torch, dev, main_run)
        cashflows(torch, dev)
        sweep_trace(torch, dev, main_run, work)
    print(f"[phase8] {time.perf_counter() - t0:.1f} s; sweep kernel launches during it: "
          f"halpern {ks.halpern_sweep.launches}, avg {ks.avg_sweep.launches}")
    check(ks.halpern_sweep.launches == 0 and ks.avg_sweep.launches == 0,
          "[phase8] the sweep engine launched a sweep kernel")


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    if not (ROOT / "dispatches_tpu_torch").is_dir():
        fail("dispatches_tpu_torch/ is not beside chip_smoke.py")
    sys.path.insert(0, str(ROOT))

    alone = {"7": lambda dev: phase_double_loop(torch, dev),
             "8": lambda dev: phase_sweep(torch, dev, flagship(torch, dev))}
    if sys.argv[1:2] == ["--only-phase"]:
        # a development run of one phase alone: no kernel build, no result line
        if sys.argv[2:] not in [[n] for n in alone]:
            fail(f"--only-phase takes one of {', '.join(alone)}")
        phase_device_info(torch)
        alone[sys.argv[2]](torch.device("cuda"))
        print(f"[only-phase {sys.argv[2]}] done (no result line: not the smoke test's full run)")
        return
    card = phase_device(torch)
    # the main path runs first, so its launch counts start from zero
    # before any comparison launch
    dev = torch.device("cuda")
    main_run, launches = phase_main_path(torch, dev)
    # the PEM price-taker's LP (an IPM design solve; no sweep launch):
    # phase 3 holds the kernels on its operator, phase 6 solves it
    pem = pem_batch_model(torch, dev)
    report = phase_kernels(torch, main_run["lp"], dev, pem["lp"])
    entry_run = phase_ipm_path(torch, dev, main_run)
    phase_serve_path(torch, dev, main_run, entry_run)
    phase_hydrogen(torch, dev, pem)
    phase_double_loop(torch, dev)
    phase_sweep(torch, dev, main_run)

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
