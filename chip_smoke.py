#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``dispatches_tpu_torch``) on one
NVIDIA GPU.  Run from the repository root: ``python3 chip_smoke.py``.

Phases (any failure exits nonzero; nothing is caught and passed over):

1. device: print the card's name and power limit (nvidia-smi), build the
   PDHG sweep kernels from ``dispatches_tpu_torch/csrc`` with nvcc;
2. kernels: hold each kernel (avg and halpern; f32, f64 and bf16-operand
   tiers; B = 4096 and a ragged B = 366) to its plain PyTorch version on
   the card at the main-path shapes (m 218, n 193, k 40), then time the
   f32 kernels against their plain versions in turns with CUDA events;
3. main path: build the 24-h wind+battery price-taker LP on ``cuda``,
   solve 366, 1024 and 4096 LMP scenarios through
   ``make_pdlp_batch_solver`` (halpern, f32, tol 1e-5), then 366 with
   ``algorithm="avg"`` and 366 with ``precision="bf16x-f32"``; check
   that the kernels were launched and that 16 scenarios agree with
   scipy's HiGHS on the port's own LP data to 1e-4 relative.

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
F32_TOL, F64_TOL = 1e-5, 1e-10  # kernel vs plain, relative to max(1, |want|)
H100_F32_FLOPS = 67e12          # CUDA-core f32 peak, H100 SXM data sheet
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
        text = log.read_text()
        regs = [int(w) for line in text.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:]) if nxt.startswith("registers")]
        spills = [line.strip() for line in text.splitlines()
                  if "spill" in line and " 0 bytes spill stores" not in line]
        print(f"[build] ptxas: max {max(regs) if regs else '?'} registers/thread, "
              f"{len(spills)} kernels with spills")
        for line in spills[:8]:
            print(f"[build]   {line}")
    return card


# ---------------------------------------------------------------------
# phase 2: kernels against their plain versions
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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernels(torch, lp, dev):
    from dispatches_tpu_torch.kernels import pdhg_sweep as ks
    from dispatches_tpu_torch.solvers.pdlp import PDLPOptions, _scalings

    K, G = lp["K"], lp["G"]
    A = np.vstack([K, G])
    m_eq = K.shape[0]
    report = {}
    for algo, wrapper, plain in (("halpern", ks.halpern_sweep, ks.halpern_sweep_reference),
                                 ("avg", ks.avg_sweep, ks.avg_sweep_reference)):
        _, dc, Ah, _ = _scalings(A, PDLPOptions(algorithm=algo))
        lb, ub = lp["lb"] / dc, lp["ub"] / dc
        errs = {}
        for tier, dtype, low, tol in (("f32", torch.float32, False, F32_TOL),
                                      ("f64", torch.float64, False, F64_TOL),
                                      ("bf16", torch.float32, True, F32_TOL)):
            lanes = 8
            for B in (4096, N_SCENARIOS):
                const, lane = _sweep_inputs(torch, Ah, lb, ub, m_eq, B, dtype, dev, seed=B)
                args = _args(algo, const, lane)
                got = wrapper(*args, k=K_STEPS, low_precision=low, lanes_per_block=lanes)
                want = plain(*args, k=K_STEPS, low_precision=low)
                torch.cuda.synchronize()
                err = max(float((g - w).abs().max()) for g, w in zip(got, want))
                scale = max(1.0, max(float(w.abs().max()) for w in want))
                finite = all(bool(torch.isfinite(g).all()) for g in got)
                ok = finite and err <= tol * scale
                print(f"[kernel] {algo:7s} {tier:4s} B={B:5d} lanes/block={lanes:2d} "
                      f"max|got-want|={err:.3e} scale={scale:.3e} tol={tol:.0e} "
                      f"{'ok' if ok else 'FAIL'}")
                check(ok, f"{algo} kernel disagrees with its plain version "
                          f"({tier}, B={B}): {err:.3e} > {tol:.0e} * {scale:.3e}")
                errs[(tier, B)] = err

        # timing at the main-path config (f32, B=4096), kernel and plain
        # version in turns (plain, kernel, kernel, plain) after warm-up
        B = 4096
        const, lane = _sweep_inputs(torch, Ah, lb, ub, m_eq, B, torch.float32, dev, seed=B)
        args = _args(algo, const, lane)

        def run_kernel():
            wrapper(*args, k=K_STEPS, lanes_per_block=8)

        def run_plain():
            plain(*args, k=K_STEPS)

        for fn in (run_kernel, run_plain):
            fn()
        torch.cuda.synchronize()
        plain_ms = [_time_ms(torch, run_plain, 3)]
        kern_ms = [_time_ms(torch, run_kernel, 20), _time_ms(torch, run_kernel, 20)]
        plain_ms.append(_time_ms(torch, run_plain, 3))
        m, n = Ah.shape
        nnz = int(np.count_nonzero(Ah))
        # bytes the function must move: each input read once (per lane
        # halpern reads x xa xs c | z za zs b | tau sig k0 and writes
        # x xt xs | z zt zs; avg reads x xs c | z zs b | tau sig and
        # writes x xs | z zs), plus the two dense matrices and bounds
        per_lane = (7 * (n + m) + 3) if algo == "halpern" else (5 * (n + m) + 2)
        nbytes = 4 * (B * per_lane + 2 * m * n + 2 * n + m)
        flops_needed = 4 * nnz * K_STEPS * B   # the products over Ah's nonzeros
        flops_dense = 4 * m * n * K_STEPS * B  # what the dense kernel does
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops_needed / H100_F32_FLOPS * 1e3
        report[algo] = {
            "max_abs_err": errs[("f32", 4096)],
            "ms": min(kern_ms), "plain_ms": min(plain_ms),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "dense_ops_ms": flops_dense / H100_F32_FLOPS * 1e3,
        }
        print(f"[kernel] {algo} f32 B={B} k={K_STEPS}: kernel {kern_ms[0]:.4f}/{kern_ms[1]:.4f} ms, "
              f"plain {plain_ms[0]:.4f}/{plain_ms[1]:.4f} ms, bound {report[algo]['bound_ms']:.4f} ms "
              f"({report[algo]['bound_by']}; Ah nnz {nnz}), dense-work bound "
              f"{report[algo]['dense_ops_ms']:.4f} ms")
        # the lanes-per-block knob: how the kernel time moves with the
        # lanes that share each matrix element loaded from L2
        sweep_ms = {}
        for lanes in (4, 16, 8):
            wrapper(*args, k=K_STEPS, lanes_per_block=lanes)
            sweep_ms[lanes] = _time_ms(
                torch, lambda: wrapper(*args, k=K_STEPS, lanes_per_block=lanes), 20)
        print(f"[kernel] {algo} f32 B={B} lanes/block -> ms: "
              + ", ".join(f"{k}: {v:.4f}" for k, v in sorted(sweep_ms.items())))
    return report


# ---------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------

def highs_objectives(torch, nlp, lp, lmps, cfs):
    """Objectives of the first scenarios solved by scipy's HiGHS on the
    port's own LP data (K, G, bounds; c, q, h derived on the host)."""
    from scipy.optimize import linprog

    cpu = torch.device("cpu")
    defaults = nlp.default_params()
    x0 = torch.zeros(nlp.n, dtype=torch.float64, device=cpu)
    bounds = [(None if not np.isfinite(lo) else lo, None if not np.isfinite(hi) else hi)
              for lo, hi in zip(lp["lb"], lp["ub"])]
    out = []
    for s in range(len(lmps)):
        p = {"p": {**defaults["p"], "lmp": lmps[s] * 1e-3,
                   "windpower.capacity_factor": cfs[s]},
             "fixed": defaults["fixed"]}
        c = torch.func.grad(lambda x: nlp.objective(x, p))(x0).numpy()
        q = -nlp.eq(x0, p).numpy()
        h = -nlp.ineq(x0, p).numpy()
        res = linprog(c, A_ub=lp["G"], b_ub=h, A_eq=lp["K"], b_eq=q,
                      bounds=bounds, method="highs")
        check(res.status == 0, f"HiGHS failed on scenario {s}: {res.message}")
        out.append(float(nlp.user_objective(torch.as_tensor(res.x), p)))
    return np.asarray(out)


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
        if lmp_b is lmps:
            rel = np.abs(obj[:N_HIGHS] - ref) / np.maximum(np.abs(ref), 1.0)
            line += f" obj_rel_err_vs_highs={rel.max():.3e}"
            check(rel.max() <= OBJ_RTOL,
                  f"{label} B={B}: objective error {rel.max():.3e} > {OBJ_RTOL}")
        print(line)
    launches = {"halpern": ks.halpern_sweep.launches, "avg": ks.avg_sweep.launches}
    check(all(v > 0 for v in launches.values()), f"kernel launch counts {launches}")
    return lp, launches


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
    lp, launches = phase_main_path(torch, dev)
    report = phase_kernels(torch, lp, dev)

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
