#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``dispatches_tpu_torch``) on one
NVIDIA GPU.  Run from the repository root: ``python3 chip_smoke.py``.

Phases (any failure exits nonzero; nothing is caught and passed over).
Phases 1-3 run alone; then phases 6, 7, 10 (split in two), 11, 12 and 13
run in child processes of this script beside phases 4, 5, 8 and 9
(``CHILD_GROUPS``), and phases 14 and 15, one after the other, each in one
more child once they have ended (``LATE_CHILD_GROUPS``), each child's
output echoed when it ends:

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
   B = 366 run is cut for phase 7's time), 16 lanes within 1e-6 of HiGHS; ``[pdlp1]`` the
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
   ``[pem]`` ``wind_battery_pem_optimize`` at T = 24 (168 cut for phase 9) against
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
   ``[bid-batch]`` 7 bid days as one lane axis equal
   to 7 sequential solves within 1e-6; ``[dl-trace]`` one warmed market hour under
   torch.profiler (``--only-phase 7`` only).
8. the design-space sweep and the sweep->surrogate workflow (float64
   per-scenario PDLP and plain torch; the sweep kernels' counts are read
   around it): ``[sweep]`` ``run_sweep`` over 366 price profiles x 1 LHS
   battery size (366 points; 2 sizes until phase 9) on phase 2's model, direct backend, chunks
   of 128, tol 1e-8: the store complete, every point OK or retried, 16
   points within 1e-6 of HiGHS; ``[sweep-resume]`` the same spec cut
   after 1 chunk and resumed, every store file but progress.json
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
9. serve durability and the fossil base (float64; the sweep kernels'
   counts are read around it): ``[journal]`` phase 2's 366 requests
   (and 8 IPM ones) through a journaled service, every accept record
   decoding bitwise to its params, an empty clean replay after
   ``drain()``; ``[crash]`` a child process (this script with a private
   flag) runs a journaled service, accepts the 366 requests, serves one
   batch of 64 and dies with ``os._exit``; a service recovering its
   directory resubmits exactly the open set once each and brings it to
   DONE (generation 2), 16 objectives within 1e-6 of HiGHS and all
   within 1e-6 of the uninterrupted runs; ``[snapshot]`` a service
   recovered from ``[journal]``'s drained directory restores the warm
   LRU, the bucket's warm index, P² markers and predictor weights
   bitwise, and its next batch starts warm; ``[traffic]`` a bursty
   (MMPP) stream of ~256 AR(1)-perturbed requests in schedule order on
   the service clock, all DONE; ``[iapws]`` IAPWS-95 Tables 7 and 8 and
   the transport check points on the card (1e-7 and 1e-6), within 1e-12
   of the CPU; ``[usc]`` the 437 MW USC plant built, initialized on the
   host and solved by Newton on the card at tests/test_usc_plant.py's
   anchors; ``[usc-trace]`` one warmed Newton solve under
   torch.profiler; ``[usc-power]`` 300 MW with the boiler flow free;
   ``[usc-pressure]`` 27 MPa main steam, re-initialized (cut for time,
   ``USC_PRESSURE_CUT``);
   ``[usc-horizon]`` the horizon-4 plant with per-period boiler flows,
   each power within 1e-6 of the JAX package's; ``[usc-ipm]`` the plant
   through ``solve_plant`` on the IPM, 3 iterations on the card and on the
   CPU, their iterates within 1e-6 (a whole IPM solve of this square
   system does not converge, see PERF.md).
10. the molten-salt storage chain and the fossil double-loop participant
   (float64 Newton on the card, SciPy trust-constr on the host; the sweep
   kernels' counts are read around it): ``[salt-hx]`` the charge and
   discharge HX on one-unit flowsheets, card vs CPU within 1e-10;
   ``[isp]`` the integrated USC + storage plant (n 792) from the JAX
   package's checkpoint, square and converged, with
   tests/test_storage_integrated.py's relations; ``[isp-init]`` the plant
   from scratch (host sweeps, then Newton), within 1e-6 of ``[isp]``; ``[isp-analysis]`` ``model_analysis``
   hot_empty at test_main_function's anchors; ``[mp-eval]`` one T = 3
   batched reduced-space evaluation against single lanes (1e-10), central
   differences (1e-5) and the CPU (1e-9); ``[mp-trace]`` one warmed
   evaluation under torch.profiler; ``[usc-bid-track]`` a DA bid and a
   tracking hour of the USC participant (2 outer iterations each in the
   whole run, one step from the start, 25 in ``--only-phase 10``), each
   improving its objective on the start's, the bid schedule moving and
   the tracked power moving toward the dispatch; ``[mp-usc]`` the T = 3
   price-taker (``--only-phase 10`` only: its solve outlasts the run).
11. the storage design studies and the concrete-TES branch (float64 Newton
   on the card, SciPy trust-constr on the host; the sweep kernels' counts
   are read around it): ``[tes]`` the charge, discharge and combined
   ConcreteTES of tests/test_concrete_tes.py, the reference profiles within
   1 K, the heat rates within 1 W (combined: 5) of the JAX package's
   solution (tests/data/concrete_tes_profiles.json), charge energy
   conservation, card vs CPU within 1e-9; ``[tube]`` the boil-through
   ConcreteTubeSide at 55,702.16 +- 1 J/mol; ``[scpc]`` the 692 MW
   supercritical plant without the TES (692 MW at 1%, the JAX package's
   landed value at 1e-6, the BFP turbine balancing the BFP, the card's x
   solving the CPU's residual to Newton's tol); ``[scpc-tes]`` the plant with
   the TES at a 0.1 HP split (625 MW at 1%, JAX's value at 1e-6, the
   charge flow, charging), then ``unfix_dof_for_optimization``;
   ``[charge-design]`` the solar-salt / HP design NLP from the JAX
   package's checkpoint at test_solar_hp_design's anchors (cold at maxiter
   150 in ``--only-phase 11``; in the whole run warm-started from that
   solve's decisions, ``CHARGE_WARM_START``); ``[design-trace]`` one warm
   evaluation of that design under torch.profiler;
   ``[discharge-design]`` the condenser-pump design NLP at
   test_condpump_design_anchor's anchors (maxiter 1 in the whole run,
   150 in ``--only-phase 11``); ``[charge-study]`` and ``[discharge-study]``
   the full enumerations with ``isolate=True``, each combination's child
   Python running concurrently (``--only-phase 11`` only), selecting
   solar/HP and condpump.
12. the execution layer's mesh paths, adaptive depth and cost cards (one
   card: a mesh names cuda:0 several times; the halpern kernel's count
   is read around the phase and must be above 0): ``[mesh]``
   ``scenario_sharded_solver`` over the float64 batch PDLP on the CUDA
   sweeps (tol 1e-8) at phase 2's 366 scenarios, on ("cuda:0",) and on
   cuda:0 four times (2 pad lanes), each with the unsplit run's iteration
   counts and objectives within 1e-8 relative, 16 lanes within 1e-6 of
   HiGHS, and the first shard bitwise the solve of its own 92 lanes;
   ``[dryrun]`` ``dryrun_multichip(4)``; ``[sweep-mesh]`` phase 8's
   spec through the mesh backend within 1e-8 of the direct backend;
   ``[bids-mesh]`` two days of ``compute_day_ahead_bids_batch`` on the
   73-bus synthetic case over a 2-entry mesh within 1e-9 of the mesh-free
   batch; ``[mlp-mesh]`` ``_train_mlp`` over 4 shards within 1e-9 of the
   unsplit training; ``[adaptive]`` phase 5's 366 requests with inflight
   2 and inflight_max 6, the depth trajectory and decisions printed and
   replayed from the recorded spans through a fresh controller;
   ``[profile]`` with cost cards on, a card with peak bytes for every
   ``serve.`` program signature and the admission prior set before the
   first dispatch completes.
13. the obs host tier (no hand-written kernel: the sweep kernels' counts
   are read around the phase and must be 0): ``[soak-real]``
   ``run_soak(virtual=False)`` on the real clock against phase 2's model
   (float64 PDLP, tol 1e-8; Poisson 24 requests/s for 20 s, AR(1) LMPs,
   max_batch 64, warm starts) with the flight recorder and the exporter
   armed: every request DONE, 16 objectives within 1e-6 of HiGHS,
   ``metrics.prom`` equal to a fresh render, two export records or more,
   every bundle of a known kind with its plan section, ``flight.errors``
   0; ``[soak]`` ``DEFAULT_SPEC`` in virtual time on the card, equal to
   the CPU's report in every virtual-time field, the spike spec's one
   coalesced ``burn_rate`` bundle and the crash-restart spec with nothing
   lost; ``[flight]`` deadline_miss (with the bucket's cost card),
   plan_error, nan_guard and quarantine bundles, and nothing written when
   disarmed; ``[ledger]`` phase 8's spec cut to 64 points, three times,
   the regression gate soft-passing, then passing, then failing on half
   the solves/s; ``[solverlog]`` the PDLP, IPM and Newton traces decoded
   on the card and on the CPU, equal rows; ``[obs-cli]``
   ``python -m dispatches_tpu_torch.obs`` (``--soak``, ``--report``,
   ``--prom``, ``--slo --check``, ``--ledger --check-regressions``) in
   child Pythons, with the JAX CLI's exit codes and JSON keys.
14. the multi-process tier (no hand-written kernel: the sweep kernels'
   counts are read around the phase and must be 0): ``[fleet]`` a
   ``FleetRouter`` over 3 in-process replicas on the card (journals each,
   phase 2's LP, float64 PDLP at tol 1e-8), the 366 scenarios on a
   ``FakeClock``, replica 1 killed after 120: every request DONE once,
   one failover, nothing lost, 16 objectives within 1e-6 of HiGHS, then
   16 repeats (affinity, warm starts after gossip) and ``n_replicas`` 1
   bitwise a bare service; ``[net]`` two ``python -m
   dispatches_tpu_torch.net --worker --model arbitrage --device cuda``
   processes behind ``connect_fleet``, 4 threaded submitters of 32
   requests with the lock sanitizer on: every request DONE once, 16
   objectives within 1e-6 of HiGHS, no lock-order inversion; then one
   worker SIGKILLed with requests open, re-homed from its journal with
   nothing lost; ``[net-trace]`` two more workers with ``NET_TRACE`` and
   ``OBS_FLEET_EXPORT_DIR``: a valid merged trace, every request's journey
   in 2 processes or more, both workers' process labels in the fleet
   ``metrics.prom``; ``[fleet-soak]`` the chaos-kill fleet soak on the
   card equal to the CPU's, nothing lost; ``[fleet-cli]`` ``python -m
   dispatches_tpu_torch.fleet`` in demo and worker mode, with the JAX
   CLI's keys.
15. the analysis passes and the steady-state contract, armed
   (``DISPATCHES_TPU_SANITIZE`` and ``DISPATCHES_TPU_WARN_RECOMPILE`` set
   in the phase's own process; the sweep kernels' counts are read around
   it): ``[lint]`` ``python -m dispatches_tpu_torch.analysis --check
   --json`` and ``--selftest`` in child Pythons, both exit 0, nothing new
   and no lock finding baselined; ``[recompiles]`` each program warmed
   once, then called again under ``assert_no_recompiles()`` with a
   ``RecompileWarning`` an error: phase 2's main path (B = 366, halpern,
   f32) as a counted program, launching the halpern kernel, keeping the
   kernel library it loaded and calling no builder of the library, the
   packed operator or the LP data, 16 lanes within 1e-4 of HiGHS; two
   identical rounds of 16 PDLP and 16 IPM
   requests through ``SolveService`` (programs = compiles = 2); 4
   ``SolverFactory("ipm")`` solves over new prices within 1e-6 of HiGHS;
   the 3-day wind-battery double loop of tests/test_analysis.py, one
   build per solver callable; ``[sanitize]`` 4 submitter threads of 16
   requests and a poller on an armed service (ready schedule): 64 DONE, 0
   lock-order inversions; ``nan_guard`` on a NaN warns; ``checkified(
   torch.log)`` raises on -1.0 and returns 0 on 1.0.

Phase 3 times every kernel tier at B = 366, 1024 and 4096.
``--only-phase 6``, ``7``, ``8``, ``9``, ``10``, ``11``, ``12``, ``13``, ``14`` and ``15`` run one of those
phases alone, for development (no kernel build, no result line; ``7``
with ``[dl-trace]``, ``10`` with ``[mp-usc]`` and ``[usc-bid-track]`` at
full depth, ``11`` with both enumerations; ``10`` and ``11`` also with
only the parts named after them: ``--only-phase 10 mp-usc``,
``--only-phase 11 charge-study``; ``--only-phase 11 discharge-study fwh9``
runs that enumeration over the sources named).  The line
before the last is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import gc
import json
import math
import os
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
    full_precision(torch)
    return card


def full_precision(torch):
    # full-precision products everywhere (the KKT checks, the plain
    # sweeps): TF32 would floor PDLP's accuracy
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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
    path."""
    from dispatches_tpu_torch.solvers import IPMOptions, make_ipm_solver

    nlp, lmps, cfs = main_run["nlp"], main_run["lmps"], main_run["cfs"]
    d = nlp.default_params()
    B = lmps.shape[0]
    params = {"p": {**d["p"], "lmp": torch.as_tensor(lmps * 1e-3, device=dev),
                    "windpower.capacity_factor": torch.as_tensor(cfs, device=dev)},
              "fixed": d["fixed"]}
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
        st, _, line = _lanes_line(res)
        err = np.abs(obj[:N_HIGHS] - main_run["ref"]) / np.maximum(np.abs(main_run["ref"]), 1.0)
        gap = np.abs(obj - main_run["pdlp_obj"]) / np.maximum(np.abs(obj), 1.0)
        print(f"[ipm] kkt={kkt:6s} B={B} {line} solve {dt * 1e3:.1f} ms "
              f"solves/s={B / dt:.1f} peak_mem={torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
              f"obj_rel_err_vs_highs({N_HIGHS}) max {err.max():.3e} "
              f"max_gap_to_batch_pdlp {gap.max():.3e}")
        check(err.max() <= IPM_RTOL, f"[ipm] {kkt}: objective error {err.max():.3e} > {IPM_RTOL} "
                                     f"(statuses {st[:N_HIGHS].tolist()})")


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
    phase_ipm(torch, dev, main_run)
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
        if rnd == 1:
            main_run["serve_obj"] = objs  # phase 9's [crash] holds recovery to it
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
# [pem]'s second horizon, T = 168, is cut to make room for phase 9
# (tests/test_torch_re_hybrid.py holds wind_battery_pem_optimize at T = 24)
PEM_HORIZONS = (H2_T,)
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
    """``wind_battery_pem_optimize`` at each of PEM_HORIZONS, against HiGHS
    on the port's own LP data."""
    from dispatches_tpu_torch.case_studies.renewables import wind_battery_pem_optimize

    for T_p in PEM_HORIZONS:
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
N_BID_DAYS = 7          # [bid-batch]: a week of bid days


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
    """[bid-batch]: ``compute_day_ahead_bids_batch`` over N_BID_DAYS days as
    one lane axis against as many calls of ``compute_day_ahead_bids`` on the
    same capacity-factor windows, with a fixed (state-neutral) forecaster."""
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
    projection solve) under torch.profiler (``--only-phase 7``; cut from
    the whole run for phase 10's time)."""
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


def phase_double_loop(torch, dev, only=False):
    """Phase 7, with the sweep kernels' counts set to 0 before and read
    after: the double loop and the nuclear case run on the float64 IPM
    and launch neither sweep.  ``only`` (``--only-phase 7``) runs
    ``[dl-trace]`` too."""
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
        if only:
            dl_trace(torch, rec)
        else:
            print("[dl-trace] cut from the whole run for time (--only-phase 7 runs it)")
    print(f"[phase7] {time.perf_counter() - t0:.1f} s; sweep kernel launches during it: "
          f"halpern {ks.halpern_sweep.launches}, avg {ks.avg_sweep.launches}")
    check(ks.halpern_sweep.launches == 0 and ks.avg_sweep.launches == 0,
          "[phase7] the double loop launched a sweep kernel")


# ---------------------------------------------------------------------
# phase 8: the design-space sweep, its store and the sweep->surrogate workflow
# ---------------------------------------------------------------------

SWEEP_CHUNK = 128        # [sweep]: 366 points in 3 chunks (the last 110 live)
# battery sizes per price profile: 2 (732 points) before phase 9, cut to 1
# to make room for it (phase 8's own first cut)
SWEEP_LHS_N = 1
SWEEP_PDLP = {"tol": 1e-8, "dtype": "float64"}
SWEEP_HIGHS_PER_SIZE = 16 // SWEEP_LHS_N  # [sweep]: 16 HiGHS-checked points in all
SWEEP_RESUME_CHUNKS = 1  # [sweep-resume]: chunks in the first, cut-short run (3 before phase 9)
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
    """[sweep]: the 366-point spec through ``run_sweep``'s direct backend,
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


# ---------------------------------------------------------------------
# phase 9: serve durability (journal, snapshots, traffic) and the fossil
# base (IAPWS-95, the Newton solver, the USC plant)
# ---------------------------------------------------------------------

CRASH_FLAG = "--crash-child"   # private: runs the [crash] child process
CRASH_CMD = [sys.executable, str(Path(__file__).resolve()), CRASH_FLAG]
CRASH_RC = 17                  # the child's one intended death
CRASH_BATCH = 64               # [crash]: lanes the child serves before it dies
N_IPM_WARM = 8                 # [journal]: IPM requests that fill the warm LRU
USC_MAIN_FLOW_FRACS = (1.0, 0.9, 0.8, 0.7)   # [usc-horizon]'s boiler flows
# [usc-horizon]: the JAX package's plant powers for those flows (MW; a run
# on a CPU, held by tests/test_torch_usc.py::test_horizon_plant_matches_jax)
USC_HORIZON_MW = (436.46443365, 390.78256508, 345.49945713, 300.58482839)
USC_RTOL = 1e-6                # [usc-horizon] powers vs the JAX package's
# [usc-pressure] (27 MPa, re-initialized) is cut for time;
# tests/test_torch_usc.py::test_change_pressure (slow) holds it on the CPU
USC_PRESSURE_CUT = True
USC_IPM_ITERS = 3              # [usc-ipm]: IPM iterations on the card and on the CPU
USC_IPM_RTOL = 1e-6            # [usc-ipm]: their iterates (as [hybrid-dense])
IAPWS_CARD_RTOL = 1e-12        # [iapws]: the card vs the CPU, dimensionless
TRAFFIC_WAIT_MS = 1500.0       # [traffic]: the batch-close wait on the service clock


def _journal_records(d):
    """Every record of the journal in ``d``, in write order."""
    out = []
    for seg in sorted(Path(d).glob("journal-*.jsonl")):
        for line in seg.read_text(encoding="utf-8").splitlines():
            if line.strip():
                out.append(json.loads(line))
    return out


def _same_tree(a, b):
    """Bitwise equality of two params trees of numpy leaves (dtype too)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_tree(a[k], b[k]) for k in a)
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _bucket_state(svc, label):
    """What a restore must carry over for one bucket: its index state as
    journal bytes, its P² markers, its guard and its predictor weights."""
    from dispatches_tpu_torch.serve import journal

    b = next(b for b in svc._buckets.values() if b.stats.label == label)
    p2 = b.est._p95
    trainer = b.predict_trainer
    return b, {
        "index": json.dumps(journal.encode_tree(b.warm_index.to_state())),
        "p2": (p2.p, list(p2._q), list(p2._n), list(p2._np), list(p2._dn), p2._count),
        "guard": (b.warm_guard.cold_iters_ema, b.warm_guard.mispredicts),
        "weights": (None if trainer is None or trainer.predictor is None else
                    {k: np.asarray(v).tobytes() for k, v in trainer.predictor.params.items()}),
    }


def serve_journal(torch, dev, main_run, work):
    """[journal]: phase 2's 366 requests (and N_IPM_WARM through an IPM
    bucket, which fills the warm LRU) through a journaled service; every
    accept record decodes bitwise to the params submitted; after drain()
    the replay's open set is empty behind the clean-shutdown marker."""
    from dispatches_tpu_torch.serve import ServeOptions, SolveService, journal

    nlp, lmps, cfs = main_run["nlp"], main_run["lmps"], main_run["cfs"]
    d = work / "journal"
    params = [_flagship_params(nlp, lmps, cfs, s) for s in range(N_SCENARIOS)]
    svc = SolveService(ServeOptions.from_env(max_wait_ms=SERVE_WAIT_MS),
                       journal_dir=str(d), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hs = [svc.submit(nlp, p) for p in params]
    svc.flush_all()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    res = [h.result() for h in hs]
    check(all(r.status == "DONE" for r in res), "[journal] a request did not finish DONE")
    objs = np.asarray([r.obj for r in res])
    check(np.all(np.isfinite(objs)), "[journal] objectives not finite")
    ipm = [svc.submit(nlp, params[s], solver="ipm") for s in range(N_IPM_WARM)]
    svc.flush_all()
    check(all(h.result().status == "DONE" for h in ipm), "[journal] an IPM request failed")
    recs = _journal_records(d)
    accepts = {r["id"]: r for r in recs if r["k"] == "a"}
    check(len(accepts) == N_SCENARIOS + N_IPM_WARM, f"[journal] {len(accepts)} accept records")
    bad = [h.request_id for h, p in zip(hs + ipm, params + params[:N_IPM_WARM])
           if not _same_tree(journal.decode_tree(accepts[h.request_id]["params"]), p)]
    check(not bad, f"[journal] payloads of requests {bad[:5]} do not decode bitwise")
    states = {b.stats.label: _bucket_state(svc, b.stats.label)[1]
              for b in svc._buckets.values() if b.warm}
    lru = {k: dict(v) for k, v in svc._warm._d.items()}
    out = svc.drain()
    rep = journal.replay(str(d))
    size = sum(f.stat().st_size for f in d.glob("journal-*.jsonl"))
    dur = svc.metrics()["durability"]
    print(f"[journal] {N_SCENARIOS} requests in {dt:.2f} s = {N_SCENARIOS / dt:.1f} requests/s "
          f"through a journaled service (+{N_IPM_WARM} IPM); {len(recs)} records in "
          f"{len(list(d.glob('journal-*.jsonl')))} segments, {size / 2**20:.2f} MiB; every payload "
          f"bitwise; snapshot writes {dur['snapshot_writes']} (drain's: {out['snapshot'] is not None});"
          f" replay after drain: {len(rep.open_requests)} open, clean_shutdown {rep.clean_shutdown}")
    check(out["snapshot"] is not None, "[journal] drain() wrote no snapshot")
    check(rep.open_requests == [] and rep.clean_shutdown,
          "[journal] the replay after drain() is not empty and clean")
    return {"dir": d, "objs": objs, "params": params, "states": states, "lru": lru,
            "generation": svc.generation}


def crash_child(journal_dir, device="cuda"):
    """The [crash] child: a journaled service on the card accepts phase
    2's 366 requests (max_batch above the stream, so no submit flushes),
    serves the oldest CRASH_BATCH of them as one batch, and dies with
    os._exit — no drain, no flush, no clean marker."""
    import dataclasses

    import torch

    from dispatches_tpu_torch.serve import ServeOptions, SolveService

    dev = torch.device(device)
    main_run = flagship(torch, dev)
    nlp, lmps, cfs = main_run["nlp"], main_run["lmps"], main_run["cfs"]
    svc = SolveService(ServeOptions.from_env(max_batch=2 * N_SCENARIOS,
                                             max_wait_ms=SERVE_WAIT_MS),
                       journal_dir=journal_dir, device=dev)
    hs = [svc.submit(nlp, _flagship_params(nlp, lmps, cfs, s)) for s in range(N_SCENARIOS)]
    svc.options = dataclasses.replace(svc.options, max_batch=CRASH_BATCH)
    hs[0].result()  # the oldest CRASH_BATCH requests, one batch, fenced
    print(json.dumps({"done": sum(h.done() for h in hs)}), flush=True)
    os._exit(CRASH_RC)


def serve_crash(torch, dev, main_run, jr, work):
    """[crash]: a child process running a journaled service dies after
    its first completed batch; a new service recovers from its
    directory, resubmits exactly the open set once each, and brings all
    of it to DONE; 16 recovered objectives against HiGHS, every one
    against the uninterrupted [journal] (and [serve]) results."""
    from dispatches_tpu_torch.serve import ServeOptions, SolveService, journal
    from dispatches_tpu_torch.serve.bucket import request_fingerprint

    nlp, lp, lmps, cfs = main_run["nlp"], main_run["lp"], main_run["lmps"], main_run["cfs"]
    d = work / "crash"
    t0 = time.perf_counter()
    child = subprocess.run(CRASH_CMD + [str(d)], capture_output=True, text=True, timeout=600)
    t_child = time.perf_counter() - t0
    check(child.returncode == CRASH_RC,
          f"[crash] the child exited {child.returncode}, not {CRASH_RC}: {child.stderr[-2000:]}")
    done = json.loads(child.stdout.strip().splitlines()[-1])["done"]
    check(0 < done < N_SCENARIOS, f"[crash] the child died with {done} of {N_SCENARIOS} done")
    rep = journal.replay(str(d))
    open_ids = [r["id"] for r in rep.open_requests]
    check(not rep.clean_shutdown and rep.accepted == N_SCENARIOS
          and len(open_ids) == N_SCENARIOS - done,
          f"[crash] journal: {rep.accepted} accepted, {len(open_ids)} open, clean "
          f"{rep.clean_shutdown}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc = SolveService(ServeOptions.from_env(max_wait_ms=SERVE_WAIT_MS), recover_dir=str(d),
                       recover_nlp=nlp, device=dev)
    rec = svc.recovery
    hs = svc.recovered_handles
    svc.flush_all()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(rec["recovered"] == len(open_ids) and rec["lost"] == 0 and len(hs) == len(open_ids),
          f"[crash] recovery {rec}")
    check(svc.generation == 2, f"[crash] generation {svc.generation}")
    # each open request resubmitted once: the recovered params are the
    # open set's, one for one, in accept order (request id s + 1 is scenario s)
    scen = [i - 1 for i in open_ids]
    check(all(_same_tree(h.params, jr["params"][s]) for h, s in zip(hs, scen)),
          "[crash] the recovered requests are not the open set")
    check(len({request_fingerprint(h.params) for h in hs}) == len(hs),
          "[crash] a request was resubmitted twice")
    res = [h.result() for h in hs]
    check(all(r.status == "DONE" for r in res), "[crash] a recovered request did not finish DONE")
    objs = np.asarray([r.obj for r in res])
    ref = highs_objectives(torch, nlp, lp, lmps[scen[:N_HIGHS]], cfs[scen[:N_HIGHS]])
    err_h = np.abs(objs[:N_HIGHS] - ref) / np.maximum(np.abs(ref), 1.0)
    want = jr["objs"][scen]
    err_j = np.abs(objs - want) / np.maximum(np.abs(want), 1.0)
    line = (f"[crash] child (pid exit {child.returncode}) died with {done} of {N_SCENARIOS} "
            f"DONE after {t_child:.1f} s; recovery resubmitted {rec['recovered']} (lost "
            f"{rec['lost']}, torn {rec['torn_records']}, {rec['recovery_ms']:.1f} ms) and served "
            f"them in {dt:.2f} s, generation {svc.generation}; obj_rel_err_vs_highs({N_HIGHS}) max "
            f"{err_h.max():.3e}; vs [journal]'s uninterrupted run max {err_j.max():.3e}")
    if "serve_obj" in main_run:
        want_s = main_run["serve_obj"][scen]
        err_s = np.abs(objs - want_s) / np.maximum(np.abs(want_s), 1.0)
        line += f"; vs [serve]'s max {err_s.max():.3e}"
        check(err_s.max() <= IPM_RTOL, f"[crash] {err_s.max():.3e} from [serve]'s objectives")
    print(line)
    check(err_h.max() <= IPM_RTOL, f"[crash] {err_h.max():.3e} from HiGHS")
    check(err_j.max() <= IPM_RTOL, f"[crash] {err_j.max():.3e} from [journal]'s objectives")
    svc.drain()
    check(journal.replay(str(d)).open_requests == [], "[crash] requests still open after drain")


def serve_snapshot(torch, dev, main_run, jr):
    """[snapshot]: a service recovered from [journal]'s drained directory
    restores the warm LRU, and each bucket's index, P² markers, guard and
    predictor weights (bitwise) as its label is rebuilt; the first batch
    of a third pass starts warm."""
    from dispatches_tpu_torch.serve import ServeOptions, SolveService
    from dispatches_tpu_torch.serve.bucket import request_fingerprint
    from dispatches_tpu_torch.solvers.pdlp import START_KIND_NAMES

    nlp, params = main_run["nlp"], jr["params"]
    svc = SolveService(ServeOptions.from_env(max_wait_ms=SERVE_WAIT_MS),
                       recover_dir=str(jr["dir"]), recover_nlp=nlp, device=dev)
    rec = svc.recovery
    check(rec["recovered"] == 0 and rec["clean_shutdown"], f"[snapshot] recovery {rec}")
    check(svc.generation == jr["generation"] + 1, f"[snapshot] generation {svc.generation}")
    lru = {k: dict(v) for k, v in svc._warm._d.items()}
    check(lru.keys() == jr["lru"].keys() and all(
        _same_tree(lru[k], jr["lru"][k]) for k in lru), "[snapshot] the warm LRU differs")
    first = svc.submit(nlp, params[0])  # rebuilds the PDLP bucket: its state applies
    label = first.bucket_label
    bucket, state = _bucket_state(svc, label)
    want = jr["states"][label]
    for key in ("index", "p2", "guard", "weights"):
        check(state[key] == want[key], f"[snapshot] bucket {label}: {key} differs")
    check(want["weights"] is not None, f"[snapshot] bucket {label} had no fitted predictor")
    dev_w = {k: v.cpu().numpy().tobytes() for k, v in bucket.predict_weights.items()}
    check(dev_w == want["weights"], "[snapshot] the device copy of the predictor differs")
    n_index = len(bucket.warm_index)
    # a request the restored index holds (its [journal] lane converged)
    # must start from it; one it does not hold may start cold
    held = [first.start is not None and int(first.start[2]) != 0] + [
        bucket.warm_index.exact((label, request_fingerprint(p))) is not None
        for p in params[1:CRASH_BATCH]]
    hs = [first] + [svc.submit(nlp, p) for p in params[1:CRASH_BATCH]]
    svc.flush_all()
    kinds = np.asarray([int(h.result().result.start_kind) for h in hs])
    counts = np.bincount(kinds, minlength=4)
    print(f"[snapshot] restored generation {svc.generation}: warm LRU {len(lru)} entries, bucket "
          f"{label}: index {n_index} entries, P2 count {state['p2'][5]}, predictor "
          f"{len(state['weights'])} tensors, all bitwise; third pass, first batch of "
          f"{len(hs)} ({sum(held)} held by the index): starts "
          + ", ".join(f"{START_KIND_NAMES[k]} {counts[k]}" for k in range(4)))
    check(not np.any(kinds[np.asarray(held)] == 0) and counts[0] < len(hs) // 2,
          "[snapshot] the third pass's first batch started cold")
    check(all(h.result().status == "DONE" for h in hs), "[snapshot] a request failed")
    svc.drain()


class _WarpClock:
    """The service clock for [traffic]: real time, except that an idle gap
    before the next scheduled arrival is skipped, not slept."""

    def __init__(self):
        self.base, self.real0 = 0.0, time.perf_counter()

    def __call__(self):
        return self.base + (time.perf_counter() - self.real0)

    def advance_to(self, t):
        if self() < t:
            self.base, self.real0 = t, time.perf_counter()


def serve_traffic(torch, dev, main_run):
    """[traffic]: a bursty (MMPP) stream of ~256 AR(1)-perturbed phase-2
    requests submitted in schedule order on the service's clock."""
    from dispatches_tpu_torch.serve import ServeOptions, SolveService, traffic

    nlp, lmps, cfs = main_run["nlp"], main_run["lmps"], main_run["cfs"]
    spec = traffic.TrafficSpec(process="bursty", rate_rps=24.0, duration_s=3.0, seed=3,
                               burst_factor=8.0, dwell_off_s=0.6, dwell_on_s=0.3,
                               perturb=("lmp",), rho=0.9, sigma=0.05)
    reqs = traffic.generate(spec, _flagship_params(nlp, lmps, cfs, 0))
    check(200 <= len(reqs) <= 320, f"[traffic] {len(reqs)} requests, not about 256")
    clock = _WarpClock()
    # one submit at a time: a batch closes at the first submit after its
    # oldest request waited TRAFFIC_WAIT_MS, so the wait must outlast a
    # batch's solve (~0.3-1.4 s on the card, [serve]) or every batch
    # carries one request
    svc = SolveService(ServeOptions.from_env(max_wait_ms=TRAFFIC_WAIT_MS), clock=clock,
                       device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hs = []
    for r in reqs:
        clock.advance_to(r.t)
        hs.append(svc.submit(nlp, r.params, deadline_ms=r.deadline_ms))
    svc.flush_all()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    span = clock() - reqs[0].t
    res = [h.result() for h in hs]
    check(all(r.status == "DONE" for r in res), "[traffic] a request did not finish DONE")
    m = svc.metrics()
    print(f"[traffic] bursty spec (rate {spec.rate_rps} rps x{spec.burst_factor} bursts, "
          f"{spec.duration_s} s, seed {spec.seed}): {len(reqs)} requests over {reqs[-1].t:.2f} s of "
          f"schedule, served in {span:.2f} s of service clock = {len(reqs) / span:.1f} requests/s "
          f"({wall:.2f} s wall), latency {_pct([r.latency_ms for r in res])}, "
          f"{m['batches']} batches (max_wait_ms {TRAFFIC_WAIT_MS:g}), occupancy "
          f"{m['occupancy_mean']:.3f}")


def phase_iapws_card(torch, dev):
    """[iapws]: Tables 7 and 8 of the IAPWS-95 release and the 2008/2011
    transport check points on the card, against the published values and
    against the same functions on the CPU."""
    from dispatches_tpu_torch.properties import iapws95 as w
    from dispatches_tpu_torch.properties import iapws_transport as tr

    t7 = np.array([  # T [K], rho [kg/m3], P [MPa], cv, s [kJ/kg/K], w [m/s]
        (300.0, 0.9965560e3, 0.992418352e-1, 4.13018112, 0.393062643, 1501.51914),
        (300.0, 0.1005308e4, 0.200022515e2, 4.06798347, 0.387405401, 1534.92501),
        (300.0, 0.1188202e4, 0.700004704e3, 3.46135580, 0.132609616, 2443.57992),
        (500.0, 0.435000e0, 0.999679423e-1, 1.50817541, 7.94488271, 548.314253),
        (500.0, 0.453200e1, 0.999938125e0, 1.66991025, 6.82502725, 535.739001),
        (500.0, 0.838025e3, 0.100003858e2, 3.22106219, 2.56690919, 1271.28441),
        (500.0, 0.1084564e4, 0.700000405e3, 3.07437693, 2.03237509, 2412.00877),
        (647.0, 0.358000e3, 0.220384756e2, 6.18315728, 4.32092307, 252.145078),
        (900.0, 0.241000e0, 0.100062559e0, 1.75890657, 9.16653194, 724.027147),
        (900.0, 0.526150e2, 0.200000690e2, 1.93510526, 6.59070225, 698.445674),
        (900.0, 0.870769e3, 0.700000006e3, 2.66422350, 4.17223802, 2019.33608)])
    t8 = np.array([(275.0, 0.698451167e-3, 0.999887406e3, 0.550664919e-2),
                   (450.0, 0.932203564e0, 0.890341250e3, 0.481200360e1),
                   (625.0, 0.169082693e2, 0.567090385e3, 0.118290280e3)])
    visc = np.array([(298.15, 998.0, 889.735100), (298.15, 1200.0, 1437.649467),
                     (373.15, 1000.0, 307.883622), (433.15, 1.0, 14.538324),
                     (433.15, 1000.0, 217.685358), (873.15, 1.0, 32.619287),
                     (873.15, 100.0, 35.802262), (873.15, 600.0, 77.430195),
                     (1173.15, 1.0, 44.217245), (1173.15, 100.0, 47.640433),
                     (1173.15, 400.0, 64.154608)])
    cond = np.array([(298.15, 0.0, 18.4341883), (298.15, 998.0, 607.712868),
                     (298.15, 1200.0, 799.038144), (873.15, 0.0, 79.1034659)])
    # Table 8: the Maxwell densities from the host solver, the pressures
    # and Gibbs energies on the card (the vapor side: well conditioned)
    sat = [w.sat_solve_T(T) for T in t8[:, 0]]
    dl = np.array([s[1] for s in sat])
    dv = np.array([s[2] for s in sat])

    def evaluate(device):
        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)

        d7, T7 = t(t7[:, 1] / w.RHOC), t(t7[:, 0])
        T8 = t(t8[:, 0])
        return {
            "p": w.p_dT(d7, T7) / 1e6, "cv": w.cv_dT(d7, T7) / w.MW / 1e3,
            "s": w.s_dT(d7, T7) / w.MW / 1e3, "w": w.w_dT(d7, T7),
            "psat": w.p_dT(t(dv), T8) / 1e6,
            "gsat": (w.g_dT(t(dl), T8) - w.g_dT(t(dv), T8)) / (w.R_MOL * T8),
            "mu": tr.visc_d(t(visc[:, 1]), t(visc[:, 0])) * 1e6,
            "k": tr.therm_cond(t(cond[:, 1]), t(cond[:, 0])) * 1e3,
        }

    card = {k: v.cpu().numpy() for k, v in evaluate(dev).items()}
    host = {k: v.numpy() for k, v in evaluate(torch.device("cpu")).items()}
    published = {"p": (t7[:, 2], 1e-7), "cv": (t7[:, 3], 1e-7), "s": (t7[:, 4], 1e-7),
                 "w": (t7[:, 5], 1e-7), "psat": (t8[:, 1], 1e-7),
                 "mu": (visc[:, 2], 1e-6), "k": (cond[:, 2], 1e-6)}
    errs = {k: float(np.max(np.abs(card[k] - v) / np.abs(v))) for k, (v, _) in published.items()}
    # card vs CPU, each quantity over the scale of its terms: p over
    # rho R T, the others over their own magnitude (at least 1)
    rho_rt = t7[:, 1] * w.R_MASS * t7[:, 0] / 1e6
    scale = {k: np.maximum(np.abs(host[k]), 1.0) for k in host}
    scale["p"] = rho_rt
    scale["gsat"] = np.ones_like(host["gsat"])
    dev_err = {k: float(np.max(np.abs(card[k] - host[k]) / scale[k])) for k in host}
    print("[iapws] published tables on the card, max rel: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f"; saturation |g_l - g_v|/RT max {np.abs(card['gsat']).max():.2e}; card vs CPU max "
          + f"{max(dev_err.values()):.2e} ({max(dev_err, key=dev_err.get)})")
    for k, (_, tol) in published.items():
        check(errs[k] <= tol, f"[iapws] {k}: {errs[k]:.3e} from the published table > {tol}")
    check(np.abs(card["gsat"]).max() <= 1e-9, "[iapws] saturation Gibbs energies differ")
    check(max(dev_err.values()) <= IAPWS_CARD_RTOL,
          f"[iapws] card vs CPU {dev_err} > {IAPWS_CARD_RTOL}")


def _carry_x0(nlp_old, nlp_new, x_old):
    """A solved x mapped between compiles with different fixed sets
    (tests/test_usc_plant.py's helper)."""
    x_old = x_old.detach().cpu().numpy()
    x0 = np.array(nlp_new.x0)
    for name in nlp_new.free_names:
        if name in nlp_old._slices:
            a, b, _ = nlp_old._slices[name]
            lo, hi, _ = nlp_new._slices[name]
            x0[lo:hi] = x_old[a:b] * nlp_old.var_scale[a:b] / nlp_new.fs.var_specs[name].scale
    return x0


def _usc_solve(torch, dev, tag, m, x0=None, init=None):
    """(initialize,) compile and solve_square on the card, with walls."""
    from dispatches_tpu_torch.case_studies.fossil import usc_plant as up
    from dispatches_tpu_torch.solvers import solve_square

    t0 = time.perf_counter()
    if init is not None:
        up.initialize(m, **init)
    t1 = time.perf_counter()
    nlp = m.fs.compile()
    t2 = time.perf_counter()
    res = solve_square(nlp, x0=x0, device=dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    print(f"{tag} n {nlp.n}: {int(res.iterations)} Newton iterations, max residual "
          f"{float(res.max_residual):.3e}, converged {bool(res.converged)}; initialize "
          f"{t1 - t0:.2f} s, compile {t2 - t1:.2f} s, solve {t3 - t2:.2f} s")
    check(bool(res.converged), f"{tag} Newton did not converge")
    return nlp, res, nlp.unravel(res.x)


def usc_plant(torch, dev, cut_pressure=False, ipm=True):
    """[usc], [usc-power], [usc-pressure], [usc-horizon], [usc-ipm] and
    [usc-trace]: the 437 MW USC plant built, initialized on the host and
    solved on the card at tests/test_usc_plant.py's anchors."""
    from dispatches_tpu_torch.case_studies.fossil import usc_plant as up
    from dispatches_tpu_torch.properties import iapws95 as w95
    from dispatches_tpu_torch.solvers import make_newton_solver

    m = up.build_plant_model()
    nlp, res, sol = _usc_solve(torch, dev, "[usc]", m, init={})
    power = float(sol["plant_power_out"][0])
    works = sum(float(sol[f"{u}.work_mechanical"][0]) for u in ("booster", "bfp", "bfpt", "cond_pump"))
    st = w95.flash_hp(sol["turbine_11.outlet.enth_mol"][0], sol["turbine_11.outlet.pressure"][0])
    anchors = {
        "plant_power_out": (power, 436.466, 0.01, None),
        "pump-train work balance": (works, 0.0, 1e4, None),
        "condenser pressure": (float(sol["condenser.outlet.pressure"][0]), 6895.5, None, 1e-3),
        "condenser temperature": (float(sol["condenser.outlet.eos.temperature"][0]), 311.87,
                                  None, 1e-3),
        "boiler inlet enthalpy": (float(sol["boiler.inlet.enth_mol"][0]), 23737.0, None, 2e-2),
        "boiler inlet pressure": (float(sol["boiler.inlet.pressure"][0]), 32216913.0, None, 1e-3),
    }
    print("[usc] " + ", ".join(f"{k} {v[0]:.6g}" for k, v in anchors.items())
          + f", turbine 11 exhaust {st['phase']} x {st['x']:.4f}")
    for k, (got, want, atol, rtol) in anchors.items():
        tol = atol if atol is not None else rtol * abs(want)
        check(abs(got - want) <= tol, f"[usc] {k} {got} vs {want}")
    check(st["phase"] == "two-phase" and 0.9 < st["x"] < 1.0, "[usc] turbine 11 exhaust not wet")

    # [usc-trace]: one warmed Newton solve under the profiler
    solver = make_newton_solver(nlp, device=dev)
    params = nlp.default_params()
    solver(params)
    torch.cuda.synchronize()
    tres, _, by_name, total, window = profile_run(torch, lambda: solver(params), "[usc-trace]")
    iters = int(tres.iterations)
    if by_name:
        launches = sum(n for n, _ in by_name.values())
        print(f"[usc-trace] {launches} device launches over {iters} Newton iterations: "
              f"{launches / iters:.1f} per iteration, {total / 1e3 / iters:.3f} ms device time "
              f"per iteration, {window / 1e3 / iters:.3f} ms of window per iteration")

    # [usc-power]: 300 MW, boiler flow free, warm from [usc]
    fs = m.fs
    fs.fix("plant_power_out", 300.0)
    fs.unfix(m["boiler"].inlet_state.flow_mol)
    nlp2 = fs.compile()
    _, _, sol2 = _usc_solve(torch, dev, "[usc-power]", m, x0=_carry_x0(nlp, nlp2, res.x))
    flow = float(sol2["boiler.inlet.flow_mol"][0])
    print(f"[usc-power] boiler flow at 300 MW: {flow:.4f} mol/s (tests: 12474.473 +- 2)")
    check(abs(flow - 12474.473) <= 2.0, f"[usc-power] boiler flow {flow}")
    fs.unfix("plant_power_out")
    fs.fix(m["boiler"].inlet_state.flow_mol, up.MAIN_FLOW)

    # [usc-pressure]: 27 MPa main steam, re-initialized
    if cut_pressure:
        print("[usc-pressure] cut for time")
    else:
        fs.fix(m["boiler"].outlet_state.pressure, 27e6)
        _, _, sol3 = _usc_solve(torch, dev, "[usc-pressure]", m, init={"main_pressure": 27e6})
        p3, q3 = float(sol3["plant_power_out"][0]), float(sol3["plant_heat_duty"][0])
        print(f"[usc-pressure] 27 MPa: plant power {p3:.4f} MW (446.15 +- 0.2), heat duty "
              f"{q3:.4f} MW (940.4 +- 0.5)")
        check(abs(p3 - 446.15) <= 0.2 and abs(q3 - 940.4) <= 0.5, "[usc-pressure] anchors")
        fs.fix(m["boiler"].outlet_state.pressure, up.MAIN_STEAM_PRESSURE)

    # [usc-horizon]: four periods, boiler flow fixed per period
    mh = up.build_plant_model(horizon=4)
    t0 = time.perf_counter()
    up.initialize(mh)
    t_init = time.perf_counter() - t0
    mh.fs.fix(mh["boiler"].inlet_state.flow_mol, np.asarray(USC_MAIN_FLOW_FRACS) * up.MAIN_FLOW)
    _, _, solh = _usc_solve(torch, dev, f"[usc-horizon] (initialize {t_init:.2f} s)", mh)
    ph = np.asarray(solh["plant_power_out"])
    rel = np.abs(ph - USC_HORIZON_MW) / np.asarray(USC_HORIZON_MW)
    print(f"[usc-horizon] plant powers {', '.join(f'{v:.8f}' for v in ph)} MW; max rel vs the "
          f"JAX package's {rel.max():.3e}")
    check(rel.max() <= USC_RTOL, f"[usc-horizon] powers {rel.max():.3e} > {USC_RTOL}")

    if not ipm:
        return
    # [usc-ipm]: the plant through solve_plant on the IPM (what
    # model_analysis runs), USC_IPM_ITERS iterations on the card and on the
    # CPU from initialize's start: the iterates agree.  A whole solve does
    # not converge (status 2 after 100 iterations on an H100: PERF.md)
    mi = up.build_plant_model()
    up.initialize(mi)
    runs = []
    for d in (dev, torch.device("cpu")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nlp_i, r = up.solve_plant(mi, device=d, max_iter=USC_IPM_ITERS)
        torch.cuda.synchronize()
        runs.append((r, time.perf_counter() - t0))
    (rc, tc), (rh, th) = runs
    x_rel = float((rc.x.cpu() - rh.x).abs().max() / rh.x.abs().max())
    pi = float(nlp_i.unravel(rc.x)["plant_power_out"][0])
    print(f"[usc-ipm] solve_plant on the IPM, {USC_IPM_ITERS} iterations: card {tc:.1f} s, CPU "
          f"{th:.1f} s; kkt error card {float(rc.kkt_error):.6e}, CPU {float(rh.kkt_error):.6e}; "
          f"iterate card vs CPU max rel {x_rel:.3e}; plant power {pi:.6f} MW (Newton {power:.6f})")
    check(bool(torch.isfinite(rc.x).all()), "[usc-ipm] iterate not finite")
    check(x_rel <= USC_IPM_RTOL, f"[usc-ipm] card vs CPU iterates {x_rel:.3e} > {USC_IPM_RTOL}")


def phase_fossil_serve(torch, dev, main_run, cut_pressure=USC_PRESSURE_CUT):
    """Phase 9, with the sweep kernels' counts set to 0 before and read
    after: the serve paths solve through the per-scenario PDLP and the IPM,
    the fossil path through Newton and the IPM, so neither CUDA sweep is
    launched."""
    import tempfile

    from dispatches_tpu_torch.kernels import pdhg_sweep as ks

    ks.avg_sweep.launches = 0
    ks.halpern_sweep.launches = 0
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="phase9-") as tmp:
        work = Path(tmp)
        jr = serve_journal(torch, dev, main_run, work)
        serve_crash(torch, dev, main_run, jr, work)
        serve_snapshot(torch, dev, main_run, jr)
        serve_traffic(torch, dev, main_run)
    phase_iapws_card(torch, dev)
    usc_plant(torch, dev, cut_pressure=cut_pressure)
    print(f"[phase9] {time.perf_counter() - t0:.1f} s; sweep kernel launches during it: "
          f"halpern {ks.halpern_sweep.launches}, avg {ks.avg_sweep.launches}")
    check(ks.halpern_sweep.launches == 0 and ks.avg_sweep.launches == 0,
          "[phase9] a serve or fossil path launched a sweep kernel")


# ---------------------------------------------------------------------
# phase 10: the molten-salt storage chain (salt HX, the lane-batched
# Newton, the reduced-space solver, the integrated plant, the multiperiod
# price-taker) and the fossil double-loop participant
# ---------------------------------------------------------------------

STORAGE_DATA = ROOT / "tests" / "data"
STORAGE_INIT = STORAGE_DATA / "integrated_storage_usc_init"        # JAX's checkpoint
STORAGE_SOLUTION = STORAGE_DATA / "integrated_storage_usc_solution"  # JAX's hot_empty solution
SALT_HX_RTOL = 1e-10        # [salt-hx]: card vs CPU, relative to max(1, |x|)
ISP_RTOL = 1e-6             # [isp]: test_initialized_state's relations
ISP_INIT_RTOL = 1e-6        # [isp-init]: x vs [isp]'s, relative to max(1, |x|)
# [mp-eval], [mp-usc] and [usc-bid-track] start at storage_multiperiod's
# FEASIBLE_DECISIONS: the hour-plant has no inner solution at its default
# decisions (ROADMAP.md §3)
MP_LMP = (22.0, 0.0, 200.0)
MP_BOILER_FRACS = (1.0, 0.97, 0.94)   # [mp-eval]: per-hour boiler flows x design
MP_EVAL_RTOL = 1e-10        # [mp-eval]: a lane vs its single-lane evaluation
MP_FD_H, MP_FD_RTOL = 1e-3, 1e-5      # [mp-eval]: dfU vs central differences
MP_CARD_RTOL = 1e-9         # [mp-eval]: card vs CPU
MP_USC_ITERS = 60           # [mp-usc]: test_multiperiod_solve_small's maxiter
BID_TRACK_ITERS = 25        # [usc-bid-track]: test_usc_bid_and_track_solves' maxiter
# ... and in the whole run, for time: one outer step per solve after the
# start's evaluation (PERF.md)
BID_TRACK_WHOLE_ITERS = 2
BID_TRACK_MOVE_MW = 0.1     # [usc-bid-track]: the least move of a schedule that counts


def _wall(torch):
    torch.cuda.synchronize()
    return time.perf_counter()


def _xrel(a, b):
    a = a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)
    b = b.detach().cpu().numpy() if hasattr(b, "detach") else np.asarray(b)
    return float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b))))


def salt_hx_units(torch, dev):
    """[salt-hx]: the charge and discharge HX on one-unit flowsheets
    (fixed inlets and area, ``_hx_sweep``'s warm start), solved by Newton
    on the card and on the CPU."""
    from dispatches_tpu_torch.case_studies.fossil import storage_integrated as isp
    from dispatches_tpu_torch.core.graph import Flowsheet
    from dispatches_tpu_torch.models.salt_hx import SaltSteamHX
    from dispatches_tpu_torch.solvers import solve_square

    for case, (side, w_in, w_out, steam, F_salt, T_in, area) in isp.HX_UNIT_CASES.items():
        fs = Flowsheet(horizon=1)
        hx = SaltSteamHX(fs, "hx", salt_side=side, water_in_phase=w_in, water_out_phase=w_out)
        for var, val in ((hx.water_in.flow_mol, steam["F"]), (hx.water_in.enth_mol, steam["h"]),
                         (hx.water_in.pressure, steam["P"]), (hx.salt_in.flow_mass, F_salt),
                         (hx.salt_in.temperature, T_in), (hx.salt_in.pressure, 101325.0),
                         (hx.area, area)):
            fs.fix(var, val)
        isp._hx_sweep(fs, hx, dict(steam), F_salt, T_in, area, water_hot=side == "tube")
        nlp = fs.compile()
        t0 = _wall(torch)
        rc = solve_square(nlp, device=dev)
        t1 = _wall(torch)
        rh = solve_square(nlp, device="cpu")
        sol = nlp.unravel(rc.x)
        q_w = float(sol[hx.heat_duty][0])
        gap = _xrel(rc.x.cpu(), rh.x)
        print(f"[salt-hx] {case} (n {nlp.n}): {int(rc.iterations)} Newton iterations on the card "
              f"({t1 - t0:.2f} s), {int(rh.iterations)} on the CPU; salt out "
              f"{float(sol[hx.salt_out.temperature][0]):.4f} K, duty {q_w / 1e6:.4f} MW; "
              f"card vs CPU {gap:.3e}")
        check(bool(rc.converged) and bool(rh.converged), f"[salt-hx] {case}: Newton did not converge")
        check(int(rc.iterations) == int(rh.iterations), f"[salt-hx] {case}: iterations differ")
        check(gap <= SALT_HX_RTOL, f"[salt-hx] {case}: card vs CPU {gap:.3e} > {SALT_HX_RTOL}")


def isp_square(torch, dev):
    """[isp]: the integrated plant from JAX's checkpoint, square solve on
    the card, tests/test_storage_integrated.py's relations."""
    from dispatches_tpu_torch.case_studies.fossil import storage_integrated as isp

    t0 = _wall(torch)
    m = isp.main(max_power=436, load_from_file=STORAGE_INIT, device=dev)
    t1 = _wall(torch)
    nlp, res = m.init_nlp, m.init_res
    sol = nlp.unravel(res.x)
    print(f"[isp] n {nlp.n}: {int(res.iterations)} Newton iterations (the JAX package: 1), max "
          f"residual {float(res.max_residual):.3e}, converged {bool(res.converged)}; {t1 - t0:.2f} s; "
          f"plant power {float(sol['plant_power_out'][0]):.6f} MW, net "
          f"{float(sol['net_power'][0]):.6f} MW")
    check(nlp.n == 792, f"[isp] n {nlp.n}, not 792")
    check(bool(res.converged) and float(res.max_residual) < 1e-7, "[isp] square solve")
    f_rh1 = float(sol["reheater_1.outlet.flow_mol"][0])
    rel = {
        "hxc steam = 0.1 x reheater 1": abs(float(sol["hxc.shell_inlet.flow_mol"][0]) - 0.1 * f_rh1)
        / (0.1 * f_rh1),
        "makeup = es turbine outflow": abs(float(sol["condenser_mix.makeup.flow_mol"][0])
                                           - float(sol["es_turbine.outlet.flow_mol"][0]))
        / abs(float(sol["es_turbine.outlet.flow_mol"][0])),
    }
    for k, v in rel.items():
        check(v <= ISP_RTOL, f"[isp] {k}: {v:.3e}")
    check(float(sol["es_turbine.work_mechanical"][0]) < -1e6, "[isp] es turbine does not generate")
    check(float(sol["hx_pump.work_mechanical"][0]) > 0.0, "[isp] hx pump does not consume")
    check(float(sol["coal_heat_duty"][0]) > float(sol["plant_heat_duty"][0]),
          "[isp] coal duty not above the plant's heat duty")
    return m


def isp_init(torch, dev, ref):
    """[isp-init]: the integrated plant from scratch: the USC plant's host
    initialize, the storage train's host sweep, then Newton on the card."""
    from dispatches_tpu_torch.case_studies.fossil import storage_integrated as isp

    t0 = _wall(torch)
    m = isp.main(max_power=436, device=dev)
    t1 = _wall(torch)
    res = m.init_res
    gap = _xrel(res.x, ref.init_res.x)
    print(f"[isp-init] {int(res.iterations)} Newton iterations to {float(res.max_residual):.3e}; "
          f"build, host initialization and solve {t1 - t0:.2f} s; x vs [isp]'s {gap:.3e}")
    check(bool(res.converged), "[isp-init] did not converge")
    check(gap <= ISP_INIT_RTOL, f"[isp-init] x {gap:.3e} from [isp]'s > {ISP_INIT_RTOL}")


def isp_analysis(torch, dev, m):
    """[isp-analysis]: model_analysis hot_empty warm-started from
    HOT_EMPTY_WARM_U and JAX's solution file, at test_main_function's
    anchors."""
    from dispatches_tpu_torch.case_studies.fossil import storage_integrated as isp
    from dispatches_tpu_torch.utils.checkpoint import load_state

    t0 = _wall(torch)
    out = isp.model_analysis(m, power=460, max_power=436, tank_scenario="hot_empty",
                             fix_power=False, maxiter=150, warm_start=isp.HOT_EMPTY_WARM_U,
                             load_solution=STORAGE_SOLUTION, device=dev)
    t1 = _wall(torch)
    res, sol = out["res"], out["sol"]
    evals = out["rs"].last_evaluations
    print(f"[isp-analysis] converged {res.converged} ({res.message}); {res.outer_iterations} outer "
          f"iterations, {evals} evaluations, {res.inner_failures} inner failures, {t1 - t0:.1f} s "
          f"({(t1 - t0) / max(evals, 1):.2f} s per evaluation)")
    anchors = {
        "revenue": (out["revenue"], 9649.22, 1e-1),
        "objective": (out["obj"], 5.386, 1e-1),
        "hxd area": (out["hxd_area"], 2204.88, 0.5),
        "plant power": (float(sol["plant_power_out"][0]), 436.0, 1e-2),
        "hxd salt flow": (float(sol["hxd.shell_inlet.flow_mass"][0]), 75000.0 / 3600.0,
                          1e-3 * 75000.0 / 3600.0),
        "salt inventory": (out["salt_inventory_hot"] + out["salt_inventory_cold"],
                           isp.SALT_AMOUNT, 1e-9 * isp.SALT_AMOUNT),
    }
    print("[isp-analysis] " + ", ".join(f"{k} {v[0]:.6f}" for k, v in anchors.items()))
    check(res.converged, f"[isp-analysis] not converged: {res.message}")
    for k, (got, want, tol) in anchors.items():
        check(abs(got - want) <= tol, f"[isp-analysis] {k} {got} vs {want} +- {tol}")
    saved = load_state(STORAGE_SOLUTION)["inits"]
    gaps = {k: float(np.max(np.abs(np.asarray(sol[k]) - saved[k]) / np.maximum(1.0, np.abs(saved[k]))))
            for k in saved if k in sol and np.shape(sol[k]) == np.shape(saved[k])}
    worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:5]
    print(f"[isp-analysis] gap to the JAX package's solution file over {len(gaps)} variables, "
          "relative to max(1, |JAX's|): largest " + ", ".join(
              f"{k} {v:.3e} (port {np.ravel(sol[k])[0]:.9g}, JAX {np.ravel(saved[k])[0]:.9g})"
              for k, v in worst))


def _single_lane(smp, mp, dev):
    """A one-hour BatchedReducedSpaceNLP on the multiperiod hour-plant
    (the per-lane reference of [mp-eval])."""
    from dispatches_tpu_torch.solvers.reduced import BatchedReducedSpaceNLP

    return BatchedReducedSpaceNLP(
        mp.nlp, list(smp.DECISIONS), 1, objective=lambda vb, p: vb["net_power"].sum(),
        u_scales={d: mp.brs.base._u_layout[d][3] for d in smp.DECISIONS}, device=dev)


def mp_eval(torch, dev):
    """[mp-eval] and [mp-trace]: one batched evaluation of the T = 3
    multiperiod model against single-lane evaluations, central
    differences and the CPU; then one warmed evaluation under the
    profiler."""
    from dispatches_tpu_torch.case_studies.fossil import storage_multiperiod as smp

    t0 = _wall(torch)
    mp = smp.MultiPeriodUscModel(n_time_points=3, periodic=True, lmp=np.asarray(MP_LMP),
                                 load_from_file=STORAGE_INIT, device=dev)
    brs = mp.brs
    U = smp.feasible_U(brs, 3, MP_BOILER_FRACS)
    X0 = np.tile(mp.nlp.x0, (3, 1))
    rp = brs.runtime_on_device()
    t1 = _wall(torch)
    out = brs._evaluate_b(U, X0, rp)
    t2 = _wall(torch)
    print(f"[mp-eval] T = 3 (n {mp.nlp.n}, m_u {brs.base.m_u}): build {t1 - t0:.2f} s, one batched "
          f"evaluation {t2 - t1:.2f} s; Newton iterations {out[11].tolist()}, converged "
          f"{out[9].tolist()}, max residuals {', '.join(f'{v:.2e}' for v in out[10])}")
    check(bool(out[9].all()), "[mp-eval] an hour-plant did not converge")
    one = _single_lane(smp, mp, dev)
    gaps = {"X": 0.0, "g": 0.0, "dG": 0.0}
    for t in range(3):
        o1 = one._evaluate_b(U[t:t + 1], X0[t:t + 1], one.runtime_on_device())
        check(int(o1[11][0]) == int(out[11][t]), f"[mp-eval] lane {t}: iterations differ")
        check(bool(o1[9][0]), f"[mp-eval] lane {t}: the single-lane solve did not converge")
        gaps["X"] = max(gaps["X"], _xrel(out[0][t], o1[0][0]))
        for k, i in (("g", 2), ("dG", 6)):
            scale = max(1.0, float(np.max(np.abs(o1[i][0]))))
            gaps[k] = max(gaps[k], float(np.max(np.abs(out[i][t] - o1[i][0]))) / scale)
        if t == 0:
            lane0 = o1
    print("[mp-eval] lanes vs single-lane evaluations: "
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
          + " (X per entry relative to max(1, |x|), g and dG to max(1, max |.|))")
    check(max(gaps.values()) <= MP_EVAL_RTOL,
          f"[mp-eval] lanes vs single lanes {gaps} > {MP_EVAL_RTOL}")
    # the adjoint gradient of the objective against central differences, on
    # lane 0's boiler flow and BFP split fraction
    fd_worst = 0.0
    for d in ("boiler.inlet.flow_mol", "ess_bfp_split.split_fraction_2"):
        j = brs.base._u_layout[d][0]
        fs_ = []
        for sgn in (1.0, -1.0):
            Up = U.copy()
            Up[0, j] += sgn * MP_FD_H
            o = brs._evaluate_b(Up, out[0], rp)
            check(bool(o[9].all()), f"[mp-eval] {d}: a perturbed solve did not converge")
            fs_.append(float(o[1]))
        fd = (fs_[0] - fs_[1]) / (2 * MP_FD_H)
        err = abs(fd - float(out[5][0, j])) / max(1.0, abs(fd))
        fd_worst = max(fd_worst, err)
        print(f"[mp-eval] dfU[0, {d}] adjoint {float(out[5][0, j]):.9f}, central difference "
              f"{fd:.9f} (h {MP_FD_H}): {err:.3e}")
    check(fd_worst <= MP_FD_RTOL, f"[mp-eval] adjoint vs central differences {fd_worst:.3e}")
    # card vs CPU on lane 0's single-lane evaluation
    cpu = torch.device("cpu")
    mp_c = smp.MultiPeriodUscModel(n_time_points=3, periodic=True, lmp=np.asarray(MP_LMP),
                                   load_from_file=STORAGE_INIT, device=cpu)
    one_c = _single_lane(smp, mp_c, cpu)
    t3 = time.perf_counter()
    oc = one_c._evaluate_b(U[:1], X0[:1], one_c.runtime_on_device())
    t4 = time.perf_counter()
    cw = max([_xrel(lane0[0], oc[0])]
             + [float(np.max(np.abs(lane0[i] - oc[i]))) / max(1.0, float(np.max(np.abs(oc[i]))))
                for i in (2, 5, 6)])
    print(f"[mp-eval] lane 0 card vs CPU {cw:.3e} (the CPU evaluation {t4 - t3:.2f} s)")
    check(cw <= MP_CARD_RTOL, f"[mp-eval] card vs CPU {cw:.3e} > {MP_CARD_RTOL}")

    # [mp-trace]: one T = 3 evaluation from the solved states (warmed by
    # the central differences) under the profiler
    Xw = out[0]
    torch.cuda.synchronize()
    res, _, by_name, total, window = profile_run(torch, lambda: brs._evaluate_b(U, Xw, rp),
                                                 "[mp-trace]")
    if by_name:
        launches = sum(n for n, _ in by_name.values())
        print(f"[mp-trace] one T = 3 evaluation ({res[11].tolist()} Newton iterations): "
              f"{launches} device launches, {total / 1e3:.3f} ms device time, "
              f"{window / 1e3:.3f} ms window")
    return mp


def _record_start(blk):
    """Wrap the block's batched evaluation so the first one, at the seeded
    decisions, is kept: ``[objective in the solver's sense, net power per
    hour]`` of the start."""
    from dispatches_tpu_torch.case_studies.fossil import storage_multiperiod as smp

    brs = blk.usc_mp.brs
    evaluate, start = brs._evaluate_b, []

    def first(U, Xw, rp):
        out = evaluate(U, Xw, rp)
        if not start:
            start.extend([-float(out[1]) / smp.OBJ_SCALE,
                          np.asarray(brs.stack_solution(out[0], U)["net_power"][:, 0])])
        return out

    brs._evaluate_b = first
    return start


def usc_bid_track(torch, dev, maxiter=BID_TRACK_ITERS):
    """[usc-bid-track]: tests/test_usc_double_loop.py's
    test_usc_bid_and_track_solves on the card (blocks seeded at the
    feasible decisions), ``maxiter`` outer iterations per solve; each
    solve must also improve its objective on the start's, the bid
    schedule must move and the tracked power must move toward the
    dispatch."""
    from dispatches_tpu_torch.case_studies.fossil import storage_multiperiod as smp
    from dispatches_tpu_torch.case_studies.fossil.multiperiod_double_loop import (
        MultiPeriodUsc,
        UscSelfScheduler,
        UscTracker,
    )
    from dispatches_tpu_torch.grid import ThermalGeneratorModelData
    from dispatches_tpu_torch.grid.forecaster import Backcaster

    md = ThermalGeneratorModelData(
        gen_name="1_USC", bus="1", p_min=284.0, p_max=436.0, min_down_time=4, min_up_time=8,
        ramp_up_60min=60.0, ramp_down_60min=60.0, shutdown_capacity=300.0,
        startup_capacity=300.0,
        production_cost_bid_pairs=[(284.0, 22.1), (350.0, 23.5), (436.0, 25.0)])
    hist = list(22.0 + 3.0 * np.random.default_rng(0).random(24))

    def seed(blk):
        blk._U = smp.feasible_U(blk.usc_mp.brs, blk.horizon)

    t0 = _wall(torch)
    bidder = UscSelfScheduler(
        bidding_model_object=MultiPeriodUsc(md, maxiter=maxiter,
                                            load_from_file=STORAGE_INIT, device=dev),
        day_ahead_horizon=2, real_time_horizon=2, n_scenario=1,
        forecaster=Backcaster({md.bus: hist}, {md.bus: list(hist)}))
    seed(bidder.day_ahead_model)
    start = _record_start(bidder.day_ahead_model)
    bids = bidder.compute_day_ahead_bids(date="2020-07-10")
    t1 = _wall(torch)
    out = bidder.day_ahead_model.out
    r = out["res"]
    sched = [bids[t][md.gen_name]["p_max"] for t in range(2)]
    move = float(np.max(np.abs(out["net_power"] - start[1])))
    print(f"[usc-bid-track] DA bid (H 2, maxiter {maxiter}): {t1 - t0:.1f} s, "
          f"{r.outer_iterations} outer iterations, "
          f"{bidder.day_ahead_model.usc_mp.brs.last_evaluations} evaluations, "
          f"{r.inner_failures} inner failures; objective {start[0]:.4f} at the start, "
          f"{r.obj:.4f} at the end; net power {', '.join(f'{p:.4f}' for p in start[1])} MW at "
          f"the start, schedule {', '.join(f'{p:.4f}' for p in sched)} MW")
    check(all(md.p_min - 1e-6 <= p <= md.p_max + 30.0 + 1e-6 for p in sched),
          f"[usc-bid-track] bids {sched} outside the envelope")
    check(r.obj > start[0], f"[usc-bid-track] DA objective {r.obj} not above the start's {start[0]}")
    check(move >= BID_TRACK_MOVE_MW, f"[usc-bid-track] DA schedule moved {move:.4f} MW")
    tracker = UscTracker(MultiPeriodUsc(md, maxiter=maxiter, load_from_file=STORAGE_INIT,
                                        device=dev), tracking_horizon=2)
    seed(tracker.model)
    start = _record_start(tracker.model)
    t2 = _wall(torch)
    tracker.track_market_dispatch([400.0, 410.0], date="2020-07-10", hour=0)
    t3 = _wall(torch)
    p0 = tracker.get_last_delivered_power()
    r = tracker.model.out["res"]
    print(f"[usc-bid-track] tracking hour [400, 410]: {t3 - t2:.1f} s, {r.outer_iterations} outer "
          f"iterations, {tracker.model.usc_mp.brs.last_evaluations} evaluations; objective "
          f"{start[0]:.4f} at the start, {r.obj:.4f} at the end; delivered {p0:.4f} MW (the "
          f"start's {start[1][0]:.4f}), carried power {tracker.model.usc_mp.previous_power}")
    check(r.obj > start[0], f"[usc-bid-track] tracking objective {r.obj} not above the start's "
          f"{start[0]}")
    check(abs(p0 - 400.0) <= abs(start[1][0] - 400.0) - BID_TRACK_MOVE_MW,
          f"[usc-bid-track] delivered {p0:.4f} MW did not move toward 400 from {start[1][0]:.4f}")
    check(bool(np.isfinite(p0)) and md.p_min - 1e-6 <= p0 <= md.p_max + 30.0,
          f"[usc-bid-track] delivered {p0}")
    check(tracker.model.usc_mp.previous_power == round(p0),
          "[usc-bid-track] the carried state did not advance")


def _log_evaluations(torch, brs, tag):
    """Wrap ``brs``' batched evaluation to print one line per evaluation
    as it ends (a long solve cut by its time limit still shows how far it
    got and what each evaluation cost)."""
    evaluate, t_start = brs._evaluate_b, _wall(torch)

    def logged(U, Xw, rp):
        t0 = _wall(torch)
        out = evaluate(U, Xw, rp)
        t1 = _wall(torch)
        print(f"{tag} evaluation at {t1 - t_start:.1f} s: {t1 - t0:.2f} s, objective "
              f"{float(out[1]):.6f}, Newton iterations {out[11].tolist()}, converged "
              f"{out[9].tolist()}", flush=True)
        return out

    brs._evaluate_b = logged


def mp_usc(torch, dev):
    """[mp-usc]: tests/test_storage_multiperiod.py's
    test_multiperiod_solve_small (T = 3, maxiter 60) on the card, from the
    feasible decisions."""
    from dispatches_tpu_torch.case_studies.fossil import storage_multiperiod as smp

    t0 = _wall(torch)
    mp = smp.MultiPeriodUscModel(n_time_points=3, load_from_file=STORAGE_INIT, periodic=True,
                                 lmp=np.asarray(MP_LMP), device=dev)
    _log_evaluations(torch, mp.brs, "[mp-usc]")
    out = mp.solve(U0=smp.feasible_U(mp.brs, 3), maxiter=MP_USC_ITERS)
    t1 = _wall(torch)
    res = out["res"]
    print(f"[mp-usc] T = 3: {t1 - t0:.1f} s, {res.outer_iterations} outer iterations, "
          f"{mp.brs.last_evaluations} evaluations, {res.inner_failures} inner failures, "
          f"converged {res.converged} ({res.message}); objective {out['obj']:.4f}, plant power "
          f"{', '.join(f'{v:.3f}' for v in out['plant_power'])} MW, hot tank "
          f"{', '.join(f'{v:.1f}' for v in out['hot_tank_level'])} kg")
    check(float(np.max(res.g_local)) < 1e-4, "[mp-usc] per-hour envelope violated")
    check(float(np.max(res.g_coupling)) < 1e-4, "[mp-usc] coupling rows violated")
    check(float(np.max(np.abs(res.eq_coupling))) < 1e-4, "[mp-usc] periodic row violated")
    check(bool(np.all(out["plant_power"] >= smp.MIN_POWER - 1e-3))
          and bool(np.all(out["plant_power"] <= smp.MAX_POWER + 1e-3)), "[mp-usc] plant power")
    check(bool(np.all(out["hxc_duty"] >= 10.0 - 1e-3)) and bool(np.all(out["hxd_duty"] >= 10.0 - 1e-3)),
          "[mp-usc] a storage train below 10 MW")
    check(abs(out["hot_tank_level"][-1] - mp.initial_hot_inventory)
          <= 1e-5 * mp.initial_hot_inventory, "[mp-usc] hot inventory not periodic")


STORAGE_PARTS = ("salt-hx", "isp", "isp-init", "isp-analysis", "mp-eval", "usc-bid-track",
                 "mp-usc")


def phase_storage(torch, dev, only=False, parts=STORAGE_PARTS):
    """Phase 10, with the sweep kernels' counts set to 0 before and read
    after: the storage chain solves through Newton and SciPy on the host,
    so neither CUDA sweep is launched.  ``only`` (``--only-phase 10``)
    runs the part cut from the whole run too, each at full depth;
    ``parts`` picks some of them (the whole run splits the phase in two
    child processes, ``CHILD_GROUPS``)."""
    from dispatches_tpu_torch.kernels import pdhg_sweep as ks

    ks.avg_sweep.launches = 0
    ks.halpern_sweep.launches = 0
    t0 = time.perf_counter()
    if "salt-hx" in parts:
        salt_hx_units(torch, dev)
    if {"isp", "isp-init", "isp-analysis"} & set(parts):
        m = isp_square(torch, dev)
        if "isp-init" in parts:
            isp_init(torch, dev, m)
        if "isp-analysis" in parts:
            isp_analysis(torch, dev, m)
    if "mp-eval" in parts:
        mp_eval(torch, dev)
    if "usc-bid-track" in parts:
        usc_bid_track(torch, dev, BID_TRACK_ITERS if only else BID_TRACK_WHOLE_ITERS)
    if "mp-usc" in parts and not only:
        print("[mp-usc] cut from the whole run for time (--only-phase 10 runs it; "
              "[usc-bid-track] drives MultiPeriodUscModel.solve)")
    elif "mp-usc" in parts:
        mp_usc(torch, dev)
    print(f"[phase10] {time.perf_counter() - t0:.1f} s; sweep kernel launches during it: "
          f"halpern {ks.halpern_sweep.launches}, avg {ks.avg_sweep.launches}")
    check(ks.halpern_sweep.launches == 0 and ks.avg_sweep.launches == 0,
          "[phase10] the storage chain launched a sweep kernel")


# ---------------------------------------------------------------------------
# phase 11: the storage design studies and the concrete-TES branch
# ---------------------------------------------------------------------------

TES_PROFILES = STORAGE_DATA / "concrete_tes_profiles.json"   # reference + JAX's solves
TES_CARD_RTOL = 1e-9        # [tes]: card vs CPU, relative to max(1, |x|)
TES_T_ATOL, TES_Q_ATOL, TES_COMBINED_ATOL = 1.0, 1.0, 5.0   # K, W, K and W
TUBE_H_OUT, TUBE_H_ATOL = 55702.16, 1.0   # [tube]: J/mol, test_solve_regression's
SCPC_JAX_RTOL = 1e-6        # [scpc], [scpc-tes]: net power vs the JAX package's landed value
DESIGN_ITERS = 150          # [charge-design], [discharge-design]: the anchor tests' maxiter
STUDY_ITERS = 120           # [charge-study], [discharge-study]: the JAX enumerations' maxiter
#: the whole run's design solves stop after this many outer iterations:
#: a cold design solve at maxiter 150 outlasts the run (888 s and 2,338 s
#: on the card, PERF.md)
WHOLE_DESIGN_ITERS = 1
#: [charge-design] in the whole run starts from the decisions of the cold
#: maxiter-150 solve (``tools/cpu_rehearsal.py phase11 charge-design``, the
#: port on the CPU, PERF.md), where that solve's cost was
#: ``CHARGE_WARM_COST`` $/yr; the card's evaluation there must agree within
#: ``CHARGE_WARM_RTOL`` (the inner Newton's tolerance, not the arithmetic)
CHARGE_WARM_START = {"ess_split.split_fraction_2": 0.2101741927487465,
                     "hxc.tube_inlet.flow_mass": 312.1209108537888,
                     "cooler.outlet.enth_mol": 20144.116054388563}
CHARGE_WARM_COST = 90554626.79294053
CHARGE_WARM_RTOL = 1e-8
DESIGN_PARTS = ("tes", "tube", "scpc", "scpc-tes", "charge-design", "design-trace",
                "discharge-design", "charge-study", "discharge-study")
#: tests/test_concrete_tes.py's model data (the reference test's)
TES_DATA = {
    "num_tubes": 10000, "num_segments": 20, "num_time_periods": 2, "tube_length": 64.9,
    "tube_diameter": 0.0105664, "face_area": 0.00847, "therm_cond_concrete": 1,
    "dens_mass_concrete": 2240, "cp_mass_concrete": 900,
    "init_temperature_concrete": [
        750, 732.631579, 715.2631579, 697.8947368, 680.5263158, 663.1578947, 645.7894737,
        628.4210526, 611.0526316, 593.6842105, 576.3157895, 558.9473684, 541.5789474,
        524.2105263, 506.8421053, 489.4736842, 472.1052632, 454.7368421, 437.3684211, 420],
    "flow_mol_charge": 0.00958 * 1000 / 18.01528, "inlet_pressure_charge": 19600000,
    "inlet_temperature_charge": 865, "flow_mol_discharge": 3 / 18.01528,
    "inlet_pressure_discharge": 8.5e5, "inlet_temperature_discharge": 355,
}


def _tes_build(mode, data):
    """tests/test_concrete_tes.py's unit in ``mode``, initialized on the
    host: (flowsheet, tes)."""
    from dispatches_tpu_torch.core.graph import Flowsheet
    from dispatches_tpu_torch.models.concrete_tes import ConcreteTES

    fs = Flowsheet(horizon=1)
    tes = ConcreteTES(fs, "tes", data, operating_mode=mode)
    if mode in ("charge", "combined"):
        tes.fix_inlet("charge", flow_mol_total=data["flow_mol_charge"] * data["num_tubes"],
                      temperature=data["inlet_temperature_charge"])
    if mode in ("discharge", "combined"):
        tes.fix_inlet("discharge", flow_mol_total=data["flow_mol_discharge"] * data["num_tubes"],
                      temperature=data["inlet_temperature_discharge"])
    tes.initialize()
    return fs, tes


def tes_units(torch, dev):
    """[tes]: the charge, discharge and combined ConcreteTES of
    tests/test_concrete_tes.py (its model data), solved by Newton on the
    card and on the CPU; the reference profiles within 1 K, the heat rates
    within 1 W of the JAX package's solution, the combined unit within 5
    of it (tests/data/concrete_tes_profiles.json), charge energy
    conservation, card vs CPU."""
    from dispatches_tpu_torch.solvers import solve_square

    ref = json.loads(TES_PROFILES.read_text())
    for mode in ("charge", "discharge", "combined"):
        fs, tes = _tes_build(mode, TES_DATA)
        nlp = fs.compile()
        t0 = _wall(torch)
        rc = solve_square(nlp, device=dev)
        t1 = _wall(torch)
        rh = solve_square(nlp, device="cpu")
        sol = nlp.unravel(rc.x)
        gap = _xrel(rc.x.cpu(), rh.x)
        wall = sol["tes.wall_temperature"][0]
        heat = sol["tes.heat_rate"][0]
        jx = ref["jax"][mode]
        errs = {}
        if mode == "charge":
            tf = sol["tes.charge.T_liq"][0] + sol["tes.charge.T_vap"][0] - tes.charge.sat.Tsat
            errs["wall p1 vs reference (K)"] = (np.abs(wall[0] - ref["reference"]["charge_wall_p1"]),
                                                TES_T_ATOL)
            errs["fluid p2 vs reference (K)"] = (np.abs(tf[1] - ref["reference"]["charge_fluid_p2"]),
                                                 TES_T_ATOL)
            errs["heat rate vs JAX (W)"] = (np.abs(heat - jx["heat_rate"]), TES_Q_ATOL)
            q_fluid = sol["tes.charge.segment_heat"][0].sum(axis=-1)
            cons = float(np.max(np.abs(heat.sum(axis=-1) + q_fluid) / np.abs(q_fluid)))
            check(cons <= 1e-8, f"[tes] charge energy balance {cons:.3e}")
        elif mode == "discharge":
            tf = (sol["tes.discharge.T_liq"][0] + sol["tes.discharge.T_vap"][0]
                  - tes.discharge.sat.Tsat)
            errs["wall p1 vs reference (K)"] = (
                np.abs(wall[0] - ref["reference"]["discharge_wall_p1"]), TES_T_ATOL)
            errs["fluid p1 vs reference (K)"] = (
                np.abs(tf[0][::-1] - ref["reference"]["discharge_fluid_p1_segment_order"]),
                TES_T_ATOL)
            errs["heat rate vs JAX (W)"] = (np.abs(heat - jx["heat_rate"]), TES_Q_ATOL)
        else:
            errs["wall vs JAX (K)"] = (np.abs(wall - jx["wall_temperature"]), TES_COMBINED_ATOL)
            errs["heat rate vs JAX (W)"] = (np.abs(heat - jx["heat_rate"]), TES_COMBINED_ATOL)
        print(f"[tes] {mode} (n {nlp.n}): {int(rc.iterations)} Newton iterations on the card "
              f"({t1 - t0:.2f} s), {int(rh.iterations)} on the CPU; card vs CPU {gap:.3e}; "
              + ", ".join(f"{k} {float(v.max()):.3e}" for k, (v, _) in errs.items()))
        check(bool(rc.converged) and bool(rh.converged), f"[tes] {mode}: Newton did not converge")
        check(gap <= TES_CARD_RTOL, f"[tes] {mode}: card vs CPU {gap:.3e} > {TES_CARD_RTOL}")
        for k, (v, tol) in errs.items():
            check(float(v.max()) <= tol, f"[tes] {mode}: {k} {float(v.max()):.3e} > {tol}")


def tube_unit(torch, dev):
    """[tube]: tests/test_heat_exchanger_tube.py's boil-through tube on
    the card: outlet enthalpy, flow, monotone node enthalpies."""
    from dispatches_tpu_torch.core.graph import Flowsheet
    from dispatches_tpu_torch.models import ConcreteTubeSide
    from dispatches_tpu_torch.properties import iapws95 as w95
    from dispatches_tpu_torch.solvers import solve_square

    fs = Flowsheet(horizon=1)
    u = ConcreteTubeSide(fs, "unit", finite_elements=20)
    for var, val in ((u.d_tube_inner, 0.01167), (u.d_tube_outer, 0.01167),
                     (u.tube_length, 4.85), (u.htc, 500.0), (u.inlet_state.flow_mol, 1.0),
                     (u.inlet_state.pressure, 101325.0),
                     (u.inlet_state.enth_mol, float(w95.props_tp(300.0, 101325.0, "liq")["h"])),
                     (u.temperature_wall, 1000.0)):
        fs.fix(var, val)
    u.initialize()
    nlp = fs.compile()
    t0 = _wall(torch)
    res = solve_square(nlp, device=dev)
    t1 = _wall(torch)
    sol = nlp.unravel(res.x)
    h_out = float(np.ravel(sol["unit.tube_outlet.enth_mol"])[0])
    flow = float(np.ravel(sol["unit.tube_outlet.flow_mol"])[0])
    h_nodes = np.ravel(sol["unit.enth_mol"])
    print(f"[tube] n {nlp.n}: {int(res.iterations)} Newton iterations ({t1 - t0:.2f} s), "
          f"converged {bool(res.converged)}; outlet {h_out:.4f} J/mol (want {TUBE_H_OUT} +- "
          f"{TUBE_H_ATOL}), flow {flow:.9f} mol/s")
    check(bool(res.converged), "[tube] Newton did not converge")
    check(abs(h_out - TUBE_H_OUT) <= TUBE_H_ATOL, f"[tube] outlet enthalpy {h_out}")
    check(abs(flow - 1.0) <= 1e-5, f"[tube] outlet flow {flow}")
    check(bool(np.all(np.diff(h_nodes) > 0)), "[tube] node enthalpies not monotone")


def scpc_plants(torch, dev, parts):
    """[scpc] and [scpc-tes]: the 692 MW supercritical plant without and
    with the concrete TES (0.1 HP split), host-initialized and solved by
    Newton on the card, at tests/test_scpc_plant.py's anchors and the JAX
    package's landed values."""
    from dispatches_tpu_torch.case_studies.fossil import scpc_plant as sp
    from dispatches_tpu_torch.solvers.newton import NewtonOptions

    for tes, tag in ((False, "[scpc]"), (True, "[scpc-tes]")):
        if tag[1:-1] not in parts:
            continue
        t0 = _wall(torch)
        m = sp.build_scpc_flowsheet(include_concrete_tes=tes)
        sp.initialize(m)
        t1 = _wall(torch)
        nlp, res = sp.solve_plant(m, device=dev)
        t2 = _wall(torch)
        sol = nlp.unravel(res.x)
        net = float(np.ravel(sol["net_power_output"])[0])
        jax_net = sp.JAX_NET_POWER_MW[tes]
        rel = abs(net - jax_net) / jax_net
        print(f"{tag} n {nlp.n}: build and host initialization {t1 - t0:.1f} s; "
              f"{int(res.iterations)} Newton iterations on the card ({t2 - t1:.1f} s), max residual "
              f"{float(res.max_residual):.3e}; net power {net!r} MW (the JAX package's "
              f"{jax_net!r}: {rel:.3e})")
        check(bool(res.converged), f"{tag} Newton did not converge")
        anchor = 625.0 if tes else 692.0
        check(abs(net - anchor) <= 1e-2 * anchor, f"{tag} net power {net} not within 1% of {anchor}")
        check(rel <= SCPC_JAX_RTOL, f"{tag} net power {rel:.3e} from the JAX package's")
        if not tes:
            wt = float(np.ravel(sol["bfpt.work_mechanical"])[0])
            wp = float(np.ravel(sol["bfp.work_mechanical"])[0])
            check(abs(wt + wp) <= 1e-9 * abs(wp), f"{tag} bfpt work {wt} vs bfp {wp}")
            x_cpu = res.x.cpu()
            r = nlp.eq(x_cpu, nlp.default_params())
            r_max = float(r.abs().max())
            print(f"{tag} the card's x on the CPU: max residual {r_max:.3e} (Newton tol "
                  f"{NewtonOptions().tol}); bfpt {wt / 1e6:.6f} MW, bfp {wp / 1e6:.6f} MW")
            check(r_max <= NewtonOptions().tol, f"{tag} CPU residual {r_max:.3e}")
        else:
            h_in = float(np.ravel(sol["tes.inlet_charge.enth_mol"])[0])
            h_out = float(np.ravel(sol["tes.outlet_charge.enth_mol"])[0])
            f_chg = float(np.ravel(sol["tes.inlet_charge.flow_mol"])[0])
            frel = abs(f_chg - 0.1 * sp.BOILER_FLOW) / (0.1 * sp.BOILER_FLOW)
            print(f"{tag} charge flow {f_chg:.6f} mol/s (0.1 x boiler: {frel:.3e}), h in "
                  f"{h_in:.3f}, out {h_out:.3f} J/mol")
            check(frel <= 1e-6, f"{tag} charge flow {frel:.3e} from 0.1 x the boiler flow")
            check(h_in > h_out, f"{tag} the TES does not charge")
            sp.unfix_dof_for_optimization(m)
            freed = [n for n in ("boiler.inlet.flow_mol", "hp_splitter.split_fraction_2",
                                 "tes.inlet_discharge.flow_mol") if not m.fs.var_specs[n].fixed]
            check(len(freed) == 3, f"{tag} unfix_dof_for_optimization freed {freed}")


def _design_line(tag, out, t, rs):
    res = out["res"]
    print(f"{tag} converged {res.converged} ({res.message}); {res.outer_iterations} outer "
          f"iterations, {rs.last_evaluations} evaluations, {res.inner_failures} inner failures, "
          f"{t:.1f} s ({t / max(rs.last_evaluations, 1):.2f} s per evaluation); cost "
          f"{out['cost']!r} $/yr")
    u = {k: float(np.ravel(v)[0]) for k, v in rs.u_physical(res.u).items()}
    print(f"{tag} decisions {json.dumps(u)}")


def charge_design(torch, dev, cold):
    """[charge-design]: Solar salt with the HP source from the JAX
    package's checkpoint at test_solar_hp_design's anchors: ``cold`` from
    the duty-consistent start at maxiter 150 (``--only-phase 11``: 888 s
    on the card, PERF.md), else from ``CHARGE_WARM_START`` at
    ``WHOLE_DESIGN_ITERS``, where the cost must be that solve's."""
    from dispatches_tpu_torch.case_studies.fossil import storage_charge_design as cd

    t0 = _wall(torch)
    m = cd.build_charge_model("solar_salt", "hp", load_from_file=STORAGE_INIT)
    if cold:
        out = cd.design_optimize(m, maxiter=DESIGN_ITERS, device=dev)
    else:
        out = cd.design_optimize(m, maxiter=WHOLE_DESIGN_ITERS, warm_start=CHARGE_WARM_START,
                                 device=dev)
    t1 = _wall(torch)
    print(f"[charge-design] {'cold, maxiter' if cold else 'warm start, maxiter'} "
          f"{DESIGN_ITERS if cold else WHOLE_DESIGN_ITERS}")
    _design_line("[charge-design]", out, t1 - t0, out["rs"])
    sol, res = out["sol"], out["res"]
    power, duty = float(sol["plant_power_out"][0]), float(sol["hxc.heat_duty"][0])
    print(f"[charge-design] area {out['hxc_area']!r} m2 (1838.2 +- 1%), salt flow "
          f"{out['salt_flow']:.4f} kg/s, salt out {out['salt_T_out']:.4f} K (max "
          f"{cd.SALT_T_MAX['solar_salt']}), plant {power!r} MW, duty {duty!r} W")
    check(res.converged or res.inner_failures == 0, "[charge-design] not converged, inner failures")
    check(abs(out["hxc_area"] - 1838.2) <= 1e-2 * 1838.2, f"[charge-design] area {out['hxc_area']}")
    check(abs(out["cost"] - 90.56e6) <= 0.02 * 90.56e6, f"[charge-design] cost {out['cost']}")
    check(abs(power - 400.0) <= 1e-6, f"[charge-design] plant power {power}")
    check(abs(duty - 150e6) <= 1.0, f"[charge-design] duty {duty}")
    check(out["salt_T_out"] < cd.SALT_T_MAX["solar_salt"], "[charge-design] salt above its maximum")
    if not cold:
        gap = abs(out["cost"] - CHARGE_WARM_COST) / CHARGE_WARM_COST
        print(f"[charge-design] cost vs the cold solve's {CHARGE_WARM_COST!r}: {gap:.3e}")
        check(gap <= CHARGE_WARM_RTOL, f"[charge-design] cost {gap:.3e} from the cold solve's")
    return out


def design_trace(torch, dev, out):
    """[design-trace]: one warm evaluation of the charge design NLP (its
    Newton solve from the solution, objective, constraints and adjoints)
    at ``out`` ([charge-design]'s result) under the profiler."""
    rs, res = out["rs"], out["res"]
    u = torch.as_tensor(np.asarray(res.u, dtype=np.float64), device=dev)
    x = torch.as_tensor(np.asarray(res.x, dtype=np.float64), device=dev)
    rs._evaluate_dev(u, x)   # warm
    torch.cuda.synchronize()
    ev, _, by_name, total, window = profile_run(torch, lambda: rs._evaluate_dev(u, x),
                                                "[design-trace]")
    if by_name:
        launches = sum(n for n, _ in by_name.values())
        print(f"[design-trace] one warm evaluation (n {rs.nlp.n}, converged {bool(ev[5])}): "
              f"{launches} device launches, {total / 1e3:.3f} ms device time, "
              f"{window / 1e3:.3f} ms window")


def discharge_design(torch, dev, maxiter):
    """[discharge-design]: the condenser-pump source at
    test_condpump_design_anchor's anchors: maxiter 150 in ``--only-phase
    11``, ``WHOLE_DESIGN_ITERS`` in the whole run (the active-set polish
    then lands on the same design: PERF.md)."""
    from dispatches_tpu_torch.case_studies.fossil import storage_discharge_design as dd

    t0 = _wall(torch)
    m = dd.build_discharge_model("condpump")
    t1 = _wall(torch)
    out = dd.design_optimize(m, maxiter=maxiter, device=dev)
    t2 = _wall(torch)
    print(f"[discharge-design] maxiter {maxiter}; build and host initialization {t1 - t0:.1f} s")
    _design_line("[discharge-design]", out, t2 - t1, out["rs"])
    sol, res = out["sol"], out["res"]
    power, duty = float(sol["plant_power_out"][0]), float(sol["hxd.heat_duty"][0])
    print(f"[discharge-design] area {out['hxd_area']!r} m2 (1912.2 +- 1%), salt out "
          f"{out['salt_T_out']!r} K (513.15 +- 1), storage turbine {out['es_power_mw']!r} MW, "
          f"plant {power!r} MW, duty {duty!r} W, polished converged {out['converged']}")
    check(out["converged"] or res.inner_failures == 0,
          "[discharge-design] not converged, inner failures")
    check(abs(power - 400.0) <= 1e-6, f"[discharge-design] plant power {power}")
    check(abs(duty - 148.5e6) <= 10.0, f"[discharge-design] duty {duty}")
    check(abs(out["hxd_area"] - 1912.2) <= 1e-2 * 1912.2, f"[discharge-design] area {out['hxd_area']}")
    check(abs(out["salt_T_out"] - 513.15) <= 1.0, f"[discharge-design] salt out {out['salt_T_out']}")
    check(20.0 < out["es_power_mw"] < 60.0, f"[discharge-design] storage turbine {out['es_power_mw']}")


def design_study(torch, dev, which, sources=None):
    """[charge-study] / [discharge-study]: the full enumeration with
    ``isolate=True`` (each combination in a child Python on the card);
    the best design must be solar salt / HP and the condenser pump.
    ``sources`` restricts the discharge study to some sources: it then
    prints their results and checks no winner."""
    from dispatches_tpu_torch.case_studies.fossil import storage_charge_design as cd
    from dispatches_tpu_torch.case_studies.fossil import storage_discharge_design as dd

    tag = f"[{which}-study]"
    t0 = time.perf_counter()

    def ended(r):
        # each combination's summary as its child ends (a run cut by its
        # time limit still shows the combinations that finished)
        print(f"{tag} at {time.perf_counter() - t0:.1f} s: {json.dumps(r, sort_keys=True)}",
              flush=True)

    if which == "charge":
        out = cd.run_design_study(load_from_file=STORAGE_INIT, maxiter=STUDY_ITERS, isolate=True,
                                  device=dev, on_result=ended)
        want = {"salt": "solar_salt", "source": "hp"}
    else:
        out = dd.run_design_study(sources=sources, maxiter=STUDY_ITERS, isolate=True,
                                  device=dev, on_result=ended)
        want = {"source": "condpump"}
        if sources is not None:
            print(f"{tag} {len(out['results'])} of the sources only ({', '.join(sources)}) in "
                  f"{time.perf_counter() - t0:.1f} s: no winner is checked")
            return
    t1 = time.perf_counter()
    best = out["best"]
    print(f"{tag} {len(out['results'])} combinations in {t1 - t0:.1f} s; best "
          f"{json.dumps(best, sort_keys=True)}")
    check(best is not None, f"{tag} no feasible design")
    check(all(best[k] == v for k, v in want.items()), f"{tag} best {best}, want {want}")


def discharge_sources(parts):
    """The discharge study's sources named among ``parts`` (after
    ``--only-phase 11 discharge-study``), or None for all of them: a run of
    the phase alone is held to 3,600 s, and the five sources at once did
    not finish inside that on one H100."""
    from dispatches_tpu_torch.case_studies.fossil import storage_discharge_design as dd

    return tuple(p for p in parts if p in dd.SOURCES) or None


def phase_designs(torch, dev, only=False, parts=DESIGN_PARTS):
    """Phase 11, with the sweep kernels' counts set to 0 before and read
    after: the design studies and the concrete-TES branch solve through
    Newton on the card and SciPy on the host, so neither CUDA sweep is
    launched.  The enumerations run only with ``only`` (``--only-phase
    11``); ``parts`` picks some parts (the whole run splits the phase in
    two child processes, ``CHILD_GROUPS``)."""
    from dispatches_tpu_torch.kernels import pdhg_sweep as ks

    ks.avg_sweep.launches = 0
    ks.halpern_sweep.launches = 0
    t0 = time.perf_counter()
    if "tes" in parts:
        tes_units(torch, dev)
    if "tube" in parts:
        tube_unit(torch, dev)
    if {"scpc", "scpc-tes"} & set(parts):
        scpc_plants(torch, dev, parts)
    out = charge_design(torch, dev, cold=only) if "charge-design" in parts else None
    if "design-trace" in parts:
        design_trace(torch, dev, out or charge_design(torch, dev, cold=False))
    if "discharge-design" in parts:
        discharge_design(torch, dev, DESIGN_ITERS if only else WHOLE_DESIGN_ITERS)
    for which in ("charge", "discharge"):
        if f"{which}-study" in parts and not only:
            print(f"[{which}-study] cut from the whole run for time (--only-phase 11 runs it)")
        elif f"{which}-study" in parts:
            design_study(torch, dev, which, sources=(
                discharge_sources(parts) if which == "discharge" else None))
    print(f"[phase11] {time.perf_counter() - t0:.1f} s; sweep kernel launches during it: "
          f"halpern {ks.halpern_sweep.launches}, avg {ks.avg_sweep.launches}")
    check(ks.halpern_sweep.launches == 0 and ks.avg_sweep.launches == 0,
          "[phase11] the design studies launched a sweep kernel")


# ---------------------------------------------------------------------
# phase 12: the execution layer's mesh paths, adaptive depth, cost cards
# ---------------------------------------------------------------------

MESH_ENTRIES = 4         # [mesh], [sweep-mesh], [mlp-mesh]: cuda:0 named four times
MESH_PDLP_TOL = 1e-8     # [mesh]: the float64 batch PDLP's tolerance
MESH_LANE_RTOL = 1e-8    # [mesh] objectives vs the unsplit run (the solve's tolerance)
MESH_BID_DAYS = 2        # [bids-mesh]: bid days over a 2-entry mesh
MESH_BID_RTOL = 1e-9     # [bids-mesh] vs the mesh-free day batch
MESH_MLP_RTOL = 1e-9     # [mlp-mesh] vs the unsplit training
ADAPTIVE_INFLIGHT, ADAPTIVE_MAX = 2, 6   # [adaptive]: the plan's window and its bound


def _repeated_mesh(dev, n, axis="scenario"):
    from dispatches_tpu_torch.parallel import Mesh

    return Mesh([dev] * n, axis_names=(axis,))


def _rel_max(got, want):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300)))


def mesh_solves(torch, dev, main_run):
    """[mesh]: ``scenario_sharded_solver`` over the batch PDLP on the CUDA
    sweeps (float64, tol 1e-8) at phase 2's 366 scenarios, on the mesh
    ("cuda:0",) and on cuda:0 named four times (366 is no multiple of 4:
    2 lanes padded), each held to the unsplit run and 16 lanes to HiGHS."""
    from dispatches_tpu_torch.kernels import pdhg_sweep as ks
    from dispatches_tpu_torch.parallel import Mesh, scenario_sharded_solver
    from dispatches_tpu_torch.solvers import BatchPDLPOptions, make_pdlp_batch_solver

    nlp, lp, lmps, cfs = main_run["nlp"], main_run["lp"], main_run["lmps"], main_run["cfs"]
    solver = make_pdlp_batch_solver(
        nlp, BatchPDLPOptions(tol=MESH_PDLP_TOL, dtype="float64", sweep="cuda"),
        lp_data=lp, device=dev)
    batched = {"lmp": lmps * 1e-3, "windpower.capacity_factor": cfs}
    d = nlp.default_params()
    params = {"p": {**d["p"], **batched}, "fixed": d["fixed"]}
    solver(params)  # warm-up: cuBLAS and the f64 kernels
    torch.cuda.synchronize()
    launches = ks.halpern_sweep.launches
    t0 = time.perf_counter()
    ref = solver(params)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    ref_obj, ref_it = ref.obj.cpu().numpy(), ref.iters.cpu().numpy()
    print(f"[mesh] unsplit: {N_SCENARIOS} lanes in {t_ref:.2f} s, iterations mean "
          f"{ref_it.mean():.1f} max {ref_it.max()}, halpern launches "
          f"{ks.halpern_sweep.launches - launches}")
    for mesh in (Mesh([dev]), _repeated_mesh(dev, MESH_ENTRIES)):
        solve = scenario_sharded_solver(nlp, mesh, batched_keys=tuple(batched),
                                        solver=solver, full_result=True)
        before = ks.halpern_sweep.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(batched)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_launch = ks.halpern_sweep.launches - before
        obj, it = res.obj.cpu().numpy(), res.iters.cpu().numpy()
        entries = len(mesh.devices)
        pad = (-N_SCENARIOS) % entries
        gap = _rel_max(obj, ref_obj)
        same_it = bool(np.array_equal(it, ref_it))
        err = np.abs(obj[:N_HIGHS] - main_run["ref"]) / np.maximum(np.abs(main_run["ref"]), 1.0)
        print(f"[mesh] {entries} entries ({pad} pad lanes, {(N_SCENARIOS + pad) // entries} "
              f"lanes a shard): {dt:.2f} s, halpern launches {n_launch}; vs unsplit: "
              f"iterations equal {same_it}, objectives max rel diff {gap:.3e}, bitwise "
              f"{bool(np.array_equal(obj, ref_obj))}; obj_rel_err_vs_highs({N_HIGHS}) max "
              f"{err.max():.3e}")
        check(obj.shape == (N_SCENARIOS,) and np.all(np.isfinite(obj)),
              f"[mesh] {entries} entries: objectives not finite of shape ({N_SCENARIOS},)")
        check(n_launch > 0, f"[mesh] {entries} entries: the halpern kernel was never launched")
        if entries > 1:
            # a shard is the solve of its own lanes: the first shard's 92
            # lanes solved alone, no mesh, bitwise
            k = (N_SCENARIOS + pad) // entries
            alone = solver({"p": {**d["p"], **{key: v[:k] for key, v in batched.items()}},
                            "fixed": d["fixed"]})
            shard_bitwise = bool(torch.equal(alone.obj.cpu(), res.obj[:k].cpu())
                                 and torch.equal(alone.iters.cpu(), res.iters[:k].cpu()))
            print(f"[mesh] the first shard's {k} lanes solved alone: bitwise the mesh's "
                  f"{shard_bitwise}; their objectives vs the 366-lane batch max rel diff "
                  f"{_rel_max(alone.obj.cpu().numpy(), ref_obj[:k]):.3e}")
            check(shard_bitwise, "[mesh] a shard differs from the solve of its own lanes")
        check(same_it, f"[mesh] {entries} entries: iteration counts differ from the unsplit run")
        check(gap <= MESH_LANE_RTOL, f"[mesh] {entries} entries: objectives {gap:.3e} from "
                                     f"the unsplit run")
        check(err.max() <= IPM_RTOL, f"[mesh] objective error {err.max():.3e} > {IPM_RTOL}")


def mesh_dryrun(torch, dev):
    """[dryrun]: ``dryrun_multichip(4)``: horizon 8, 9 scenarios on a
    4-entry mesh (one card visible: cuda:0 four times)."""
    from dispatches_tpu_torch.entry import dryrun_multichip

    t0 = time.perf_counter()
    objs = dryrun_multichip(MESH_ENTRIES)
    torch.cuda.synchronize()
    objs = objs.cpu().numpy()
    print(f"[dryrun] dryrun_multichip({MESH_ENTRIES}) on {torch.cuda.device_count()} visible "
          f"card(s): {len(objs)} objectives in {time.perf_counter() - t0:.2f} s, "
          f"{np.round(objs, 4).tolist()}")
    check(objs.shape == (2 * MESH_ENTRIES + 1,) and np.all(np.isfinite(objs)),
          "[dryrun] objectives not finite")


def sweep_mesh(torch, dev, main_run, work):
    """[sweep-mesh]: phase 8's 366-point spec through ``run_sweep``'s mesh
    backend on cuda:0 named four times, held to the direct backend."""
    from dispatches_tpu_torch.sweep import run_sweep

    nlp, spec = main_run["nlp"], _sweep_spec(main_run["lmps"])
    t0 = time.perf_counter()
    direct = run_sweep(nlp, spec, store_dir=work / "direct", options=_sweep_options(),
                       device=dev)
    t1 = time.perf_counter()
    meshed = run_sweep(nlp, spec, store_dir=work / "mesh", options=_sweep_options(backend="mesh"),
                       mesh=_repeated_mesh(dev, MESH_ENTRIES), device=dev)
    t2 = time.perf_counter()
    a, b = meshed.arrays(), direct.arrays()
    gap = _rel_max(a["obj"], b["obj"])
    print(f"[sweep-mesh] {spec.n_points} points: direct {t1 - t0:.2f} s, mesh backend over "
          f"{MESH_ENTRIES} entries {t2 - t1:.2f} s; objectives max rel diff {gap:.3e}, "
          f"iterations equal {bool(np.array_equal(a['iterations'], b['iterations']))}")
    check(meshed.is_complete and np.all(np.isfinite(a["obj"])), "[sweep-mesh] store")
    check(gap <= SWEEP_SERVE_RTOL, f"[sweep-mesh] objectives {gap:.3e} from the direct backend")


def bids_mesh(torch, dev, work):
    """[bids-mesh]: MESH_BID_DAYS days of ``compute_day_ahead_bids_batch``
    on the 73-bus synthetic case, over a 2-entry mesh and without one."""
    from dispatches_tpu_torch.case_studies.renewables.wind_battery_double_loop import (
        MultiPeriodWindBattery,
    )
    from dispatches_tpu_torch.grid import Bidder, ThermalGeneratorModelData
    from dispatches_tpu_torch.grid.market import load_rts_gmlc_case

    case = load_rts_gmlc_case(write_synthetic_rts(
        work / "rts73", DL_BUSES, DL_BRANCHES, DL_THERMAL, DL_RENEWABLE, seed=DL_SEED))
    ren = {r.name: r for r in case.renewables}["4_WIND"]
    cfs = np.asarray(ren.rt_cap) / max(ren.rt_cap.max(), 1e-9)
    md = ThermalGeneratorModelData(gen_name="4_WIND", bus=ren.bus, p_min=0.0, p_max=120.0,
                                   startup_capacity=0.0, shutdown_capacity=135.0)
    mp = MultiPeriodWindBattery(model_data=md, wind_capacity_factors=cfs, wind_pmax_mw=120.0,
                                battery_pmax_mw=15.0, battery_energy_capacity_mwh=60.0)
    scen = 20.0 + 5.0 * np.random.default_rng(DL_SEED).random((3, 48))

    class Fixed:
        def forecast_day_ahead_prices(self, date, hour, bus, horizon, n):
            return scen[:n, :horizon]

        forecast_real_time_prices = forecast_day_ahead_prices

    bidder = Bidder(bidding_model_object=mp, day_ahead_horizon=48, real_time_horizon=4,
                    n_scenario=3, forecaster=Fixed(), device=dev)
    dates = [f"2020-07-{10 + i:02d}" for i in range(MESH_BID_DAYS)]
    t0 = time.perf_counter()
    want = bidder.compute_day_ahead_bids_batch(dates)
    t1 = time.perf_counter()
    got = bidder.compute_day_ahead_bids_batch(
        dates, mesh=_repeated_mesh(dev, MESH_BID_DAYS, axis="day"))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    worst = 0.0
    for d in dates:
        for t in range(48):
            a, b = got[d][t]["4_WIND"]["p_cost"], want[d][t]["4_WIND"]["p_cost"]
            check(len(a) == len(b), f"[bids-mesh] {d} hour {t}: curves differ in length")
            for (pa, ca), (pb, cb) in zip(a, b):
                worst = max(worst, abs(pa - pb) / max(1.0, abs(pb)),
                            abs(ca - cb) / max(1.0, abs(cb)))
    print(f"[bids-mesh] {MESH_BID_DAYS} days: one lane-axis solve {t1 - t0:.2f} s, over a "
          f"{MESH_BID_DAYS}-entry mesh {t2 - t1:.2f} s; bids max rel diff {worst:.3e}")
    check(list(got) == dates, "[bids-mesh] days out of order")
    check(worst <= MESH_BID_RTOL, f"[bids-mesh] {worst:.3e} from the mesh-free day batch")


def mlp_mesh(torch, dev):
    """[mlp-mesh]: ``_train_mlp`` with each minibatch split over cuda:0
    named four times, held to the unsplit training on the card."""
    from dispatches_tpu_torch.workflow.surrogates import _train_mlp

    rng = np.random.default_rng(12)
    x = rng.standard_normal((512, 4))
    y = np.sin(x @ np.array([[1.0], [-2.0], [0.5], [0.25]])) + 0.1
    sizes = [4, 32, 32, 1]
    t0 = time.perf_counter()
    ref, ref_loss = _train_mlp(x, y, sizes, epochs=40, batch_size=64, device=dev)
    t1 = time.perf_counter()
    got, loss = _train_mlp(x, y, sizes, epochs=40, batch_size=64,
                           mesh=_repeated_mesh(dev, MESH_ENTRIES))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    w = [np.concatenate([np.ravel(layer[k]) for layer in m.to_params() for k in ("W", "b")])
         for m in (got, ref)]
    w_rel = np.abs(w[0] - w[1]).max() / np.abs(w[1]).max()
    print(f"[mlp-mesh] {sizes}, 40 epochs of 64-row minibatches: unsplit {t1 - t0:.2f} s, "
          f"{MESH_ENTRIES} shards {t2 - t1:.2f} s; weights max rel diff {w_rel:.3e}, loss "
          f"{loss:.6e} vs {ref_loss:.6e}")
    check(np.isfinite(loss) and w_rel <= MESH_MLP_RTOL,
          f"[mlp-mesh] weights {w_rel:.3e} from the unsplit training")


def adaptive_serve(torch, dev, main_run):
    """[adaptive]: phase 5's 366 requests through a service whose plan
    arms the depth controller (inflight 2, inflight_max 6); the recorded
    plan spans, replayed through a fresh controller, give the same depth
    trajectory and decisions."""
    from dispatches_tpu_torch.obs import trace
    from dispatches_tpu_torch.obs.online import TimelineAccumulator
    from dispatches_tpu_torch.plan import ExecutionPlan, PlanOptions
    from dispatches_tpu_torch.plan.adaptive import InflightDepthController
    from dispatches_tpu_torch.serve import ServeOptions, SolveService

    nlp, lmps, cfs = main_run["nlp"], main_run["lmps"], main_run["cfs"]
    plan = ExecutionPlan(PlanOptions(device=dev, inflight=ADAPTIVE_INFLIGHT,
                                     inflight_max=ADAPTIVE_MAX))
    svc = SolveService(ServeOptions(max_wait_ms=SERVE_WAIT_MS, plan=plan))
    ctrl, trail = plan.controller, []
    ingest = ctrl.ingest

    def record(ev):
        ingest(ev)
        if ev["name"] == "plan.fence":
            trail.append(ctrl.depth)

    ctrl.ingest = record
    trace.reset()
    trace.enable(True)
    t0 = time.perf_counter()
    try:
        hs = [svc.submit(nlp, _flagship_params(nlp, lmps, cfs, s)) for s in range(N_SCENARIOS)]
        svc.flush_all()
        torch.cuda.synchronize()
        events = trace.events()
    finally:
        trace.enable(False)
        trace.reset()
    dt = time.perf_counter() - t0
    check(all(h.result().status == "DONE" for h in hs), "[adaptive] a request failed")
    spans = [e for e in events if e["name"] in TimelineAccumulator.SPAN_NAMES
             and (e.get("args") or {}).get("plan") == plan.plan_id]
    fresh = InflightDepthController(base=ADAPTIVE_INFLIGHT, max_inflight=ADAPTIVE_MAX,
                                    plan=plan.plan_id, gauges=False)
    replay = []
    for e in spans:
        fresh.ingest(e)
        if e["name"] == "plan.fence":
            replay.append(fresh.depth)
    st = ctrl.acc.stalls()
    print(f"[adaptive] {N_SCENARIOS} requests in {dt:.2f} s, {len(trail)} fences; depth "
          f"trajectory {trail}; decisions {ctrl.decisions}; stalls (us) "
          + ", ".join(f"{k} {v:.0f}" for k, v in st.items())
          + f"; replay of {len(spans)} recorded spans: {replay == trail}, decisions "
          f"{fresh.decisions}")
    check(len(trail) > 0 and replay == trail and fresh.decisions == ctrl.decisions,
          "[adaptive] the recorded spans replay to another depth trajectory")
    check(all(1 <= x <= ADAPTIVE_MAX for x in trail), "[adaptive] depth left [1, inflight_max]")


def profile_cards(torch, dev, main_run):
    """[profile]: with ``OBS_PROFILE`` on, a card for every ``serve.``
    program signature with peak bytes above 0, and the admission prior set
    before the first dispatch completes.  Runs last: the flag is
    process-wide."""
    from dispatches_tpu_torch.obs import profile
    from dispatches_tpu_torch.serve import ServeOptions, SolveService, admission

    nlp, lmps, cfs = main_run["nlp"], main_run["lmps"], main_run["cfs"]
    profile.enable(True)
    profile.reset()
    priors = []
    observe = admission.ServiceTimeEstimate.observe_ms

    def spy(self, ms):
        if self.samples == 0:
            priors.append((self.label, self.estimate_ms(), ms))
        observe(self, ms)

    admission.ServiceTimeEstimate.observe_ms = spy
    try:
        svc = SolveService(ServeOptions(max_wait_ms=SERVE_WAIT_MS, max_batch=64), device=dev)
        hs = [svc.submit(nlp, _flagship_params(nlp, lmps, cfs, s % len(lmps)))
              for s in range(100)]
        svc.flush_all()
        torch.cuda.synchronize()
    finally:
        admission.ServiceTimeEstimate.observe_ms = observe
    check(all(h.result().status == "DONE" for h in hs), "[profile] a request failed")
    cards = profile.cards_for("serve.")
    per_bucket = {f"serve.{label}": (b.compiles,
                                     sum(c["label"] == f"serve.{label}" for c in cards))
                  for label, b in ((b.stats.label, b) for b in svc._buckets.values())}
    print(f"[profile] {len(cards)} cards; bucket programs (signatures, cards) {per_bucket}: "
          + "; ".join(f"{c['label']}#{c['count']} {c['shapes'][:2]} peak {c.get('peak_bytes')} B "
                      f"flops {c.get('flops')} first call {c['first_call_ms']:.1f} ms"
                      for c in cards)
          + f"; admission prior at the first completed dispatch (label, prior ms, measured ms): "
          f"{priors}; device memory sample {profile.sample_memory()}")
    check(per_bucket and all(n == k > 0 for n, k in per_bucket.values()),
          "[profile] a serve program signature has no card")
    check(all((c.get("peak_bytes") or 0) > 0 and c["backend"] == "gpu" for c in cards),
          "[profile] a card without peak bytes")
    check(priors and all(p is not None for _, p, _ in priors),
          "[profile] no admission prior before the first dispatch completed")
    profile.enable(False)


def phase_mesh(torch, dev):
    """Phase 12, with the sweep kernels' counts set to 0 before and read
    after: the mesh paths on cuda:0 (named several times), the adaptive
    depth controller and the cost cards."""
    import tempfile

    from dispatches_tpu_torch.kernels import pdhg_sweep as ks

    ks.avg_sweep.launches = 0
    ks.halpern_sweep.launches = 0
    t0 = time.perf_counter()
    main_run = flagship(torch, dev)
    main_run["ref"] = highs_objectives(torch, main_run["nlp"], main_run["lp"],
                                       main_run["lmps"][:N_HIGHS], main_run["cfs"][:N_HIGHS])
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="phase12-") as tmp:
        work = Path(tmp)
        parts = (("mesh", lambda: mesh_solves(torch, dev, main_run)),
                 ("dryrun", lambda: mesh_dryrun(torch, dev)),
                 ("sweep-mesh", lambda: sweep_mesh(torch, dev, main_run, work)),
                 ("bids-mesh", lambda: bids_mesh(torch, dev, work)),
                 ("mlp-mesh", lambda: mlp_mesh(torch, dev)),
                 ("adaptive", lambda: adaptive_serve(torch, dev, main_run)),
                 ("profile", lambda: profile_cards(torch, dev, main_run)))
        walls = []
        for name, run in parts:
            t_part = time.perf_counter()
            run()
            walls.append(f"{name} {time.perf_counter() - t_part:.1f}")
    print(f"[phase12] {time.perf_counter() - t0:.1f} s ({', '.join(walls)} s); sweep kernel "
          f"launches during it: halpern {ks.halpern_sweep.launches}, avg {ks.avg_sweep.launches}")
    check(ks.halpern_sweep.launches > 0, "[phase12] the halpern kernel was never launched")


# -- phase 13: the obs host tier ---------------------------------------------

SOAK_REAL_SPEC = {        # [soak-real]: phase 9's [traffic] model and rate, Poisson
    "traffic": {"process": "poisson", "rate_rps": 24.0, "duration_s": 20.0, "seed": 0,
                "perturb": ["lmp"], "rho": 0.9, "sigma": 0.05},
    "service": {"max_batch": 64, "max_wait_ms": 20.0, "inflight": 2, "warm_start": True},
}
SOAK_REAL_WARMUP = (1, 8)          # [soak-real]: lane counts run before the replay
SOAK_SPIKE = {"traffic": {"duration_s": 6.0, "rate_rps": 150.0},     # tests/test_soak.py:528
              "service_time": {"spikes": [[2.0, 6.0, 100.0]]}}
SOAK_RESTART = {"traffic": {"duration_s": 1.0, "rate_rps": 60.0, "seed": 23},   # test_durability.py:510
                "restart": {"enabled": True, "crash_at_s": 0.5, "snapshot_interval_s": 0.25}}
SOAK_RTOL = 1e-12        # [soak]: floats of the card's virtual report vs the CPU's
# [soak]: wall-clock fields of a report, not functions of virtual time
# (the timeline's times come from the tracer's wall-clock stamps)
SOAK_WALL_FIELDS = {("restart", "restart_recovery_ms"), ("restart_recovery_ms",),
                    ("service", "durability", "recovery", "recovery_ms"),
                    ("slo", "bundle_paths"), ("report_path",)}
LEDGER_POINTS = 64       # [ledger]: phase 8's spec cut to 64 points in one chunk
LEDGER_RUNS = 3
SOLVERLOG_RTOL = 1e-9    # [solverlog]: card vs CPU columns, relative to max(1, |v|)
NAN_GUARD_ITERS = 80     # [flight]: the NaN lane's PDLP max_iter (it can never converge)
QUARANTINE_POINTS, QUARANTINE_POINT = 2, 1   # [flight]: a 2-point sweep, point 1 poisoned
OBS_CLI_TIMEOUT_S = 300
# the JAX CLI's JSON keys (tests/test_torch_obs_cli.py holds the port's
# CLI to them on the CPU)
JAX_SOAK_KEYS = {"schema", "virtual", "spec", "duration_s", "requests", "latency_ms",
                 "queue_wait_ms", "slo", "drift", "timeline", "service", "faults", "restart",
                 "fleet", "soak_p99_ms", "slo_burn_max", "fault_recovery_rate",
                 "restart_recovery_ms", "lost_request_rate", "replica_lost_request_rate"}
JAX_REPORT_KEYS = {"spans", "metrics", "events_buffered", "events_dropped"}


def _soak_diff(got, want, path=()):
    """The first field where two soak reports differ beyond ``SOAK_RTOL``
    (wall-clock fields skipped, the timeline's batch count compared), or
    None."""
    if path in SOAK_WALL_FIELDS:
        return None
    if path == ("timeline",):
        same = (got is None) == (want is None) and (
            got is None or (set(got) == set(want) and got["n_batches"] == want["n_batches"]))
        return None if same else path
    if isinstance(want, dict):
        if not isinstance(got, dict) or list(got) != list(want):
            return path
        return next((d for k in want for d in [_soak_diff(got[k], want[k], path + (k,))] if d),
                    None)
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            return path
        return next((d for i, (g, w) in enumerate(zip(got, want))
                     for d in [_soak_diff(g, w, path + (i,))] if d), None)
    if isinstance(want, float) and not isinstance(want, bool):
        ok = isinstance(got, float) and abs(got - want) <= SOAK_RTOL * abs(want)
        return None if ok else path
    return None if (got == want and type(got) is type(want)) else path


def _soak_line(tag, r):
    c, lat = r["requests"], r["latency_ms"]["streaming"]
    return (f"[{tag}] {c['submitted']} requests ({c['done']} done, {c['timeout']} timeout, "
            f"{c['error']} error, {c['shed']} shed, {c['hung']} hung) over "
            f"{r['duration_s']:.2f} s; soak_p99_ms {r['soak_p99_ms']:.3f} (P2 p50 "
            f"{lat['p50']:.3f}, p95 {lat['p95']:.3f}); slo_burn_max {r['slo_burn_max']}, "
            f"{r['slo']['alerts_total']} alerts, {r['slo']['flight_bundles']} bundles")


def soak_virtual(torch, dev, work):
    """[soak]: ``DEFAULT_SPEC`` in virtual time on the card (the stub
    program runs there) and on the CPU, equal in every virtual-time
    field; the spike spec's one coalesced ``burn_rate`` bundle; the
    crash-restart spec with every accepted request terminal."""
    from dispatches_tpu_torch.obs import flight, soak

    t0 = time.perf_counter()
    card = soak.run_soak(device=dev)
    t1 = time.perf_counter()
    cpu = soak.run_soak(device="cpu")
    t2 = time.perf_counter()
    c = card["requests"]
    print(_soak_line("soak", card) + f"; {t1 - t0:.2f} s on the card, {t2 - t1:.2f} s on the CPU")
    check(c["hung"] == 0 and c["done"] == c["submitted"] == c["scheduled"] >= 1000,
          f"[soak] not every request DONE: {c}")
    diff = _soak_diff(card, cpu)
    check(diff is None, f"[soak] the card's report differs from the CPU's at {diff}")
    print(f"[soak] card vs CPU: equal in every virtual-time field (floats within {SOAK_RTOL:g})")
    flight.reset()
    try:
        spike = soak.run_soak(SOAK_SPIKE, device=dev, flight_dir=str(work / "spike"))
        kinds = [b["kind"] for b in flight.bundles(str(work / "spike"))]
    finally:
        flight.reset()
    print(_soak_line("soak-spike", spike) + f"; bundle kinds {kinds}")
    check(spike["slo_burn_max"] > 1.2 and kinds == ["burn_rate"]
          and spike["slo"]["flight_bundles"] == 1,
          "[soak] the spike did not fire exactly one coalesced burn_rate bundle")
    rs = soak.run_soak(SOAK_RESTART, device=dev, out_dir=str(work / "restart"))
    r = rs["restart"]
    print(_soak_line("soak-restart", rs) + f"; crash at {r['crash_at_s']} s: {r['open_at_crash']} "
          f"open, {r['recovered']} recovered, {r['lost']} lost, generation {r['generation']}, "
          f"recovery {r['restart_recovery_ms']:.1f} ms")
    check(rs["requests"]["hung"] == 0 and r["lost"] == 0
          and r["recovered"] == r["open_at_crash"] > 0 and r["generation"] == 2,
          "[soak] a request accepted before the crash did not end terminal")


def soak_real(torch, dev, main_run, work):
    """[soak-real]: ``run_soak(virtual=False)`` on ``time.monotonic``
    against the real solver on the card, with the flight recorder and the
    exporter armed; returns the path of the registry snapshot after it."""
    from collections import Counter

    from dispatches_tpu_torch.obs import export, flight, registry, soak
    from dispatches_tpu_torch.serve import service as service_mod

    nlp, lp = main_run["nlp"], main_run["lp"]
    out, fdir = work / "soak-real", work / "soak-real-flight"
    handles = []
    submit = service_mod.SolveService.submit

    def spy(self, *a, **k):
        h = submit(self, *a, **k)
        handles.append(h)
        return h

    errors0 = registry.counter("flight.errors").total()
    evicted0 = registry.counter("flight.evicted").total()
    flight.reset()
    service_mod.SolveService.submit = spy
    t0 = time.perf_counter()
    try:
        rep = soak.run_soak(SOAK_REAL_SPEC, nlp=nlp, virtual=False, out_dir=str(out),
                            flight_dir=str(fdir), warmup_lanes=SOAK_REAL_WARMUP, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prom = (out / export.PROM_FILE).read_text()
        fresh = export.render_prometheus()
        snapshot = registry.default_registry().snapshot()
        bundles = flight.bundles(str(fdir), full=True)
    finally:
        service_mod.SolveService.submit = submit
        flight.reset()
    c = rep["requests"]
    ph = rep["latency_ms"]["posthoc"]
    rps = c["done"] / rep["duration_s"]
    print(_soak_line("soak-real", rep) + f"; {rps:.1f} requests/s, latency posthoc p50 "
          f"{ph['p50']:.1f} / p95 {ph['p95']:.1f} / p99 {ph['p99']:.1f} ms; {wall:.1f} s wall")
    for o in rep["slo"]["objectives"]:
        print(f"[soak-real] slo {o['objective']}: target {o['target']:g}, burn_peak "
              f"{o['burn_peak']:.3f}, firing {any(x['firing'] for x in o['rules'])}")
    kinds = [b["kind"] for b in bundles]
    m = rep["service"]
    print(f"[soak-real] {m['batches']} batches, occupancy {m['occupancy_mean']:.3f}, warm hit "
          f"rate {m['warm_start']['hit_rate']:.3f}, {m['warm_start']['mispredicts']} warm "
          f"mispredicts; alerts {[a['objective'] for a in rep['slo']['alerts']]}; "
          f"{len(bundles)} bundles kept (of at most {flight.MAX_BUNDLES}; "
          f"{registry.counter('flight.evicted').total() - evicted0:g} evicted), by kind "
          f"{dict(sorted(Counter(kinds).items()))}")
    check(c["hung"] == 0 and c["done"] == c["submitted"] == c["scheduled"] > 0,
          f"[soak-real] not every request DONE: {c}")
    served = [h for h in handles[sum(SOAK_REAL_WARMUP):] if h.result().status == "DONE"]
    ref = np.asarray([highs_objective(torch, nlp, lp, h.params, f"request {h.request_id}")
                      for h in served[:N_HIGHS]])
    got = np.asarray([h.result().obj for h in served[:N_HIGHS]])
    err = np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)
    print(f"[soak-real] {len(ref)} DONE objectives vs HiGHS: max rel err {err.max():.3e}")
    check(len(ref) == N_HIGHS and err.max() <= IPM_RTOL,
          f"[soak-real] objective error {err.max():.3e} > {IPM_RTOL}")
    # metrics.prom: the final export's registry render, byte for byte,
    # then the process start-stamp gauge
    tail = prom[len(fresh):].splitlines()
    check(prom.startswith(fresh) and len(tail) == 3
          and tail[2] == (f'dispatches_tpu_process_start_us{{generation="1"}} '
                          f'{export._fmt(export.process_start_us())}'),
          "[soak-real] metrics.prom is not the registry's render")
    for line in prom.splitlines():
        if not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            float(value)
            check(name.startswith("dispatches_tpu_"), f"[soak-real] bad series {line!r}")
    records = [json.loads(x) for f in sorted(out.glob("telemetry-*.jsonl"))
               for x in f.read_text().splitlines()]
    print(f"[soak-real] metrics.prom {len(prom.splitlines())} lines, equal to a fresh render; "
          f"{len(records)} JSONL export records")
    check(len(records) >= 2, "[soak-real] fewer than two export records")
    check(bundles and len(bundles) <= flight.MAX_BUNDLES
          and all(k in flight.TRIGGER_KINDS and "plan" in b for k, b in zip(kinds, bundles)),
          "[soak-real] no bundle, too many, or one of an unknown kind or without its plan "
          "section")
    check(registry.counter("flight.errors").total() == errors0, "[soak-real] flight.errors > 0")
    path = work / "soak_real_snapshot.json"
    path.write_text(json.dumps(snapshot))
    return path


def flight_kinds(torch, dev, main_run, work):
    """[flight]: a bundle of each kind the card path reaches (deadline_miss
    with the bucket's cost card, plan_error, nan_guard, quarantine); the
    same run disarmed writes nothing.  The quarantine comes from the fault
    layer poisoning one point of a sweep on the plan's fence."""
    from dispatches_tpu_torch.faults import inject as faults
    from dispatches_tpu_torch.obs import flight, profile
    from dispatches_tpu_torch.serve import ServeOptions, SolveService
    from dispatches_tpu_torch.sweep import STATUS_QUARANTINED, run_sweep

    nlp, lmps, cfs = main_run["nlp"], main_run["lmps"], main_run["cfs"]

    def run(tag):
        t_run = time.perf_counter()
        svc = SolveService(ServeOptions(max_batch=8, max_wait_ms=SERVE_WAIT_MS), device=dev)
        ok = svc.submit(nlp, _flagship_params(nlp, lmps, cfs, 0))
        svc.flush_all()
        late = svc.submit(nlp, _flagship_params(nlp, lmps, cfs, 1), deadline_ms=0.001)
        svc.flush_all()
        faults.arm("serve.stage,times=1")
        try:
            bad = svc.submit(nlp, _flagship_params(nlp, lmps, cfs, 2))
            svc.flush_all()
        finally:
            faults.reset()
        p = _flagship_params(nlp, lmps, cfs, 3)
        p["p"]["lmp"] = np.array(p["p"]["lmp"])
        p["p"]["lmp"][5] = np.nan
        os.environ["DISPATCHES_TPU_SANITIZE"] = "1"
        try:
            nan = svc.submit(nlp, p, options={"max_iter": NAN_GUARD_ITERS})
            svc.flush_all()
        finally:
            del os.environ["DISPATCHES_TPU_SANITIZE"]
        check([h.result().status for h in (ok, late, bad)] == ["DONE", "TIMEOUT", "ERROR"]
              and nan.done(), f"[flight] {tag}: unexpected request statuses")
        t_sweep = time.perf_counter()
        faults.arm(f"plan.fence,poison_ids={QUARANTINE_POINT}")
        try:
            st = run_sweep(nlp, _sweep_spec(lmps[:QUARANTINE_POINTS]),
                           store_dir=work / f"quarantine-{tag}",
                           options=_sweep_options(chunk_size=QUARANTINE_POINTS, max_retries=1),
                           device=dev)
        finally:
            faults.reset()
        status = st.arrays()["status"]
        print(f"[flight] {tag} run: serve part {t_sweep - t_run:.1f} s, quarantine sweep "
              f"{time.perf_counter() - t_sweep:.1f} s")
        check(status[QUARANTINE_POINT] == STATUS_QUARANTINED
              and (np.delete(status, QUARANTINE_POINT) != STATUS_QUARANTINED).all(),
              f"[flight] {tag}: point {QUARANTINE_POINT} was not quarantined alone "
              f"({status.tolist()})")

    fdir = work / "flight"
    flight.reset()
    profile.enable(True)
    profile.reset()
    t0 = time.perf_counter()
    try:
        flight.enable(str(fdir))
        run("armed")
        found = flight.bundles(str(fdir), full=True)
        t1 = time.perf_counter()
        flight.enable("")
        writes = []
        write = flight._write_bundle
        flight._write_bundle = lambda *a, **k: writes.append(1) or write(*a, **k)
        try:
            run("disarmed")
        finally:
            flight._write_bundle = write
        after = sorted(os.listdir(fdir))
    finally:
        flight.reset()
        profile.enable(False)
        profile.reset()
    kinds = [b["kind"] for b in found]
    by_kind = {}
    for b in found:
        by_kind.setdefault(b["kind"], b)
    dm = by_kind.get("deadline_miss") or {}
    card = dm.get("cost_card") or {}
    print(f"[flight] armed run {t1 - t0:.1f} s: {len(found)} bundles, kinds {kinds}; "
          f"deadline_miss request {dm.get('trigger', {}).get('request_id')} cost card "
          f"{card.get('label')}#{card.get('count')} peak {card.get('peak_bytes')} B, plan section "
          f"{ {k: v for k, v in (dm.get('plan') or {}).items() if k != 'timeline_tail'} }; "
          f"disarmed run: {len(writes)} bundle writes, directory {len(after)} files")
    check(set(kinds) >= {"deadline_miss", "plan_error", "nan_guard", "quarantine"},
          f"[flight] missing kinds: {kinds}")
    check(all(k in flight.TRIGGER_KINDS and "plan" in b for k, b in zip(kinds, found)),
          "[flight] a bundle of an unknown kind or without its plan section")
    check(card.get("label") == dm["trigger"]["label"]
          and ((card.get("peak_bytes") or 0) > 0 or torch.device(dev).type == "cpu"),
          "[flight] the deadline_miss bundle lacks its bucket's cost card")
    qb = by_kind["quarantine"]["trigger"]
    check(qb["label"] == "sweep.direct" and qb["detail"]["point"] == QUARANTINE_POINT,
          f"[flight] the quarantine bundle does not name point {QUARANTINE_POINT}")
    check(len(found) <= flight.MAX_BUNDLES, "[flight] the directory outgrew MAX_BUNDLES")
    check(not writes and after == sorted(os.listdir(fdir)) and len(after) == len(found),
          "[flight] the disarmed run wrote a bundle")


def ledger_runs(torch, dev, main_run, work):
    """[ledger]: with ``OBS_LEDGER_DIR`` set, phase 8's spec cut to 64
    points in one chunk, three times; the gate soft-passes, then passes,
    and fails on a copy with a fourth record at half the solves/s."""
    from dispatches_tpu_torch.obs import ledger
    from dispatches_tpu_torch.sweep import run_sweep

    lmps = main_run["lmps"]
    ldir = work / "ledger"
    os.environ["DISPATCHES_TPU_OBS_LEDGER_DIR"] = str(ldir)
    verdicts = []
    try:
        for i in range(LEDGER_RUNS):
            run_sweep(main_run["nlp"], _sweep_spec(lmps[:LEDGER_POINTS]),
                      store_dir=work / f"ledger-store-{i}",
                      options=_sweep_options(chunk_size=LEDGER_POINTS), device=dev)
            verdicts.append(ledger.check_regressions(dir=ldir))
    finally:
        del os.environ["DISPATCHES_TPU_OBS_LEDGER_DIR"]
    recs = ledger.load(ldir)
    for r in recs:
        print(f"[ledger] {r['kind']}/{r['workload']}/{r['backend']}: {r['metrics']} {r['extra']}")
    check(len(recs) == LEDGER_RUNS and all(
        r["backend"] == torch.device(dev).type
        and {"solves_per_sec", "pdhg_iters_mean", "compile_count"} <= set(r["metrics"])
        for r in recs), f"[ledger] records lack backend {torch.device(dev).type} or a metric")
    check(all(v["ok"] for v in verdicts) and [len(v["insufficient"]) for v in verdicts] == [1, 1, 0]
          and verdicts[-1]["checked"], f"[ledger] gate verdicts {verdicts}")
    bad = work / "ledger-regressed"
    bad.mkdir()
    (bad / ledger.LEDGER_FILE).write_bytes((ldir / ledger.LEDGER_FILE).read_bytes())
    fourth = dict(recs[-1], metrics=dict(recs[-1]["metrics"],
                                         solves_per_sec=recs[-1]["metrics"]["solves_per_sec"] / 2))
    ledger.append(fourth, dir=bad)
    regressed = ledger.check_regressions(dir=bad)
    print("[ledger] " + ledger.format_check(verdicts[-1]).strip().replace("\n", " | "))
    print("[ledger] half the solves/s: " + ledger.format_check(regressed).strip().replace("\n", " | "))
    check(not regressed["ok"] and regressed["regressions"][0]["metric"] == "solves_per_sec",
          "[ledger] the gate passed a record at half the solves/s")
    return ldir


def solverlog_tables(torch, dev, main_run):
    """[solverlog]: the PDLP, IPM and Newton traces decoded on the card
    and on the CPU: equal rows and ``it`` columns, floats within
    ``SOLVERLOG_RTOL`` of max(1, |v|)."""
    from dispatches_tpu_torch.case_studies.fossil import storage_integrated as isp
    from dispatches_tpu_torch.core.graph import Flowsheet
    from dispatches_tpu_torch.entry import _build_nlp, _lmp_batch
    from dispatches_tpu_torch.models.salt_hx import SaltSteamHX
    from dispatches_tpu_torch.obs import solverlog
    from dispatches_tpu_torch.solvers import (IPMOptions, PDLPOptions, make_ipm_solver,
                                              make_pdlp_solver)
    from dispatches_tpu_torch.solvers.newton import make_newton_solver

    nlp, lmps, cfs = main_run["nlp"], main_run["lmps"], main_run["cfs"]
    enlp = _build_nlp()
    d = enlp.default_params()
    entry_p = {"p": {**d["p"], "lmp": _lmp_batch(8, T)[0]}, "fixed": d["fixed"]}
    case, (side, w_in, w_out, steam, F_salt, T_in, area) = next(iter(isp.HX_UNIT_CASES.items()))
    fs = Flowsheet(horizon=1)
    hx = SaltSteamHX(fs, "hx", salt_side=side, water_in_phase=w_in, water_out_phase=w_out)
    for var, val in ((hx.water_in.flow_mol, steam["F"]), (hx.water_in.enth_mol, steam["h"]),
                     (hx.water_in.pressure, steam["P"]), (hx.salt_in.flow_mass, F_salt),
                     (hx.salt_in.temperature, T_in), (hx.salt_in.pressure, 101325.0),
                     (hx.area, area)):
        fs.fix(var, val)
    isp._hx_sweep(fs, hx, dict(steam), F_salt, T_in, area, water_hot=side == "tube")
    hnlp = fs.compile()
    runs = (("pdlp", solverlog.decode_pdlp, _flagship_params(nlp, lmps, cfs, 0),
             lambda d_: make_pdlp_solver(nlp, PDLPOptions(tol=1e-8, dtype="float64"), trace=True,
                                         device=d_)),
            ("ipm", solverlog.decode_ipm, entry_p,
             lambda d_: make_ipm_solver(enlp, IPMOptions(max_iter=60), trace=True, device=d_)),
            (f"newton[{case}]", solverlog.decode_newton, hnlp.default_params(),
             lambda d_: make_newton_solver(hnlp, trace=True, device=d_)))
    for name, decode, params, make in runs:
        t0 = time.perf_counter()
        res, tr = make(dev)(params)
        card = decode(tr, res)
        t1 = time.perf_counter()
        res, tr = make("cpu")(params)
        cpu = decode(tr, res)
        t2 = time.perf_counter()
        worst = 0.0
        for k, w in cpu.columns.items():
            g = card.columns[k]
            if np.issubdtype(w.dtype, np.integer):
                check(np.array_equal(g, w), f"[solverlog] {name}: column {k} differs")
            else:
                worst = max(worst, float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1.0),
                                                initial=0.0)))
        print(f"[solverlog] {name}: {card.iterations} rows on the card ({t1 - t0:.2f} s), "
              f"{cpu.iterations} on the CPU ({t2 - t1:.2f} s), columns {list(card.columns)}, "
              f"max card vs CPU {worst:.3e}; last row card {card.tail(1)} CPU {cpu.tail(1)}")
        check(card.iterations == cpu.iterations > 0, f"[solverlog] {name}: rows differ")
        check(worst <= SOLVERLOG_RTOL, f"[solverlog] {name}: card vs CPU {worst:.3e}")


def obs_cli(torch, work, snapshot, ledger_dir):
    """[obs-cli]: ``python -m dispatches_tpu_torch.obs`` in child Pythons
    on the card, all at once; each exits as the JAX CLI would on the same
    inputs and prints the JAX CLI's JSON keys."""
    from dispatches_tpu_torch.obs import ledger, slo

    with open(snapshot) as f:
        slo_rc = 1 if slo.violations(slo.evaluate(slo.load_spec(), json.load(f))) else 0
    gate_rc = 0 if ledger.check_regressions(dir=ledger_dir)["ok"] else 1
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DISPATCHES_TPU_OBS", "DISPATCHES_TPU_SANITIZE"))}
    env["PYTHONUNBUFFERED"] = "1"
    runs = {"soak": (["--soak", "--json", "--duration", "2"], 0),
            "report": (["--report", "--json"], 0),
            "prom": (["--prom"], 0),
            "slo": (["--slo", "--check", "--metrics-file", str(snapshot)], slo_rc),
            "ledger": (["--ledger", "--check-regressions", "--ledger-dir", str(ledger_dir)],
                       gate_rc)}
    procs = {}
    t0 = time.perf_counter()
    for name, (argv, _) in runs.items():
        out = open(work / f"cli-{name}.out", "w+")
        procs[name] = (subprocess.Popen([sys.executable, "-m", "dispatches_tpu_torch.obs", *argv],
                                        stdout=out, stderr=subprocess.STDOUT, env=env, cwd=ROOT),
                       out)
    try:
        for name, (proc, out) in procs.items():
            try:
                rc = proc.wait(timeout=max(1.0, t0 + OBS_CLI_TIMEOUT_S - time.perf_counter()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                fail(f"[obs-cli] --{name} still running after {OBS_CLI_TIMEOUT_S} s")
            out.seek(0)
            text = out.read()
            argv, want_rc = runs[name]
            if rc != want_rc:
                sys.stdout.write(text[-4000:])
            check(rc == want_rc, f"[obs-cli] {' '.join(argv)} exited {rc}, the JAX CLI {want_rc}")
            if name == "soak":
                keys = set(json.loads(text))
                check(keys == JAX_SOAK_KEYS, f"[obs-cli] --soak keys {sorted(keys ^ JAX_SOAK_KEYS)}")
                summary = f"keys equal, {json.loads(text)['requests']['done']} done"
            elif name == "report":
                payload = json.loads(text)
                check(set(payload) == JAX_REPORT_KEYS, f"[obs-cli] --report keys {sorted(payload)}")
                summary = f"keys equal, spans {sorted(payload['spans'])}"
            elif name == "prom":
                lines = [x for x in text.splitlines() if x and not x.startswith("#")]
                check(lines and all(x.startswith("dispatches_tpu_") for x in lines),
                      "[obs-cli] --prom printed a line that is not a series")
                summary = f"{len(lines)} series"
            else:
                summary = text.strip().splitlines()[-1]
            print(f"[obs-cli] {' '.join(argv)}: exit {rc} ({summary})")
    finally:
        for proc, out in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
    print(f"[obs-cli] five CLIs in {time.perf_counter() - t0:.1f} s")


def phase_obs(torch, dev):
    """Phase 13, with the sweep kernels' counts set to 0 before and read
    after (no kernel lies on this path): the obs host tier on the card."""
    import tempfile

    from dispatches_tpu_torch.kernels import pdhg_sweep as ks

    ks.avg_sweep.launches = 0
    ks.halpern_sweep.launches = 0
    t0 = time.perf_counter()
    main_run = flagship(torch, dev)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="phase13-") as tmp:
        work = Path(tmp)
        got = {}
        parts = (("soak-real", lambda: got.update(snapshot=soak_real(torch, dev, main_run, work))),
                 ("soak", lambda: soak_virtual(torch, dev, work)),
                 ("flight", lambda: flight_kinds(torch, dev, main_run, work)),
                 ("ledger", lambda: got.update(ledger=ledger_runs(torch, dev, main_run, work))),
                 ("solverlog", lambda: solverlog_tables(torch, dev, main_run)),
                 ("obs-cli", lambda: obs_cli(torch, work, got["snapshot"], got["ledger"])))
        walls = []
        for name, run in parts:
            t_part = time.perf_counter()
            run()
            walls.append(f"{name} {time.perf_counter() - t_part:.1f}")
    print(f"[phase13] {time.perf_counter() - t0:.1f} s ({', '.join(walls)} s); sweep kernel "
          f"launches during it: halpern {ks.halpern_sweep.launches}, avg {ks.avg_sweep.launches}")
    check(ks.halpern_sweep.launches == 0 and ks.avg_sweep.launches == 0,
          "[phase13] a sweep kernel was launched on the obs path")



# ---------------------------------------------------------------------------
# phase 14: the multi-process tier (fleet router, net workers, distributed
# tracing, the soak's fleet section, the fleet CLI)
# ---------------------------------------------------------------------------

FLEET_REPLICAS = 3         # [fleet]: in-process replicas behind the router
FLEET_KILLED = 1           # [fleet]: the replica killed ...
FLEET_KILL_AFTER = 120     # ... after this many of the 366 requests
FLEET_MAX_BATCH = 32       # [fleet]: lanes per batch (a batch closes only when full)
FLEET_STEP_S = 0.005       # [fleet]: fake-clock seconds between requests
FLEET_HEARTBEAT_MS = 250.0
FLEET_GOSSIP_S = 0.5
FLEET_REPEATS = 16         # [fleet]: scenarios sent again after the failover
FLEET_PARITY_N = 64        # [fleet]: requests through n_replicas 1 and a bare service
NET_T = 12                 # the worker's arbitrage LP horizon (net/worker.py)
NET_SUBMITTERS, NET_PER_SUBMITTER = 4, 32    # [net]: threaded submitters
NET_KILL_REQUESTS = 32     # [net]: requests sent just before the SIGKILL
NET_TRACE_SUBMITTERS, NET_TRACE_PER = 2, 8   # [net-trace]
NET_HEARTBEAT_MS = 5_000.0  # the JAX multi-process tests' timeouts
NET_DEADLINE_MS = 60_000.0
NET_WAIT_S = 180.0         # [net], [net-trace]: the longest wait for every request
WORKER_THREADS = "2"       # BLAS and torch threads per worker process
# [net], [net-trace]: the workers' batch-close wait on the real clock.  At
# the default 10 ms a worker closes a batch every request or two, and each
# float64 PDLP batch is ~1.5 s of launches whatever its width (run A, PR
# 14: 0.9 requests/s); 200 ms lets a batch gather the submitters' burst.
NET_MAX_WAIT_MS = 200.0
WORKER_START_S = 120.0     # a worker's ready line within this
FLEET_SOAK = {             # tests/test_fleet.py:478-503, the chaos-kill spec
    "traffic": {"rate_rps": 120.0, "duration_s": 2.0, "seed": 3, "deadline_ms": 2000.0},
    "service": {"max_batch": 4, "max_wait_ms": 10.0, "inflight": 2},
    "service_time": {"base_ms": 5.0, "per_lane_ms": 0.5, "jitter_ms": 0.5},
    "fleet": {"n_replicas": 3, "kill": [[0, 1.0]], "heartbeat_timeout_ms": 150.0,
              "gossip_interval_s": 0.5}}
FLEET_CLI_TIMEOUT_S = 300
# the JAX fleet CLI's JSON keys (tests/test_torch_fleet.py and
# tests/test_torch_net.py hold the port's CLI to them on the CPU)
JAX_FLEET_KEYS = ["submitted", "solved", "timeouts", "errors", "shed", "queue_depth", "flushes",
                  "batches", "compile_count", "programs", "deadline", "warm_start", "fleet",
                  "hung"]
JAX_FLEET_REMOTE_KEYS = JAX_FLEET_KEYS + ["fleet_counters", "trace"]
# a child Python that dies with the process that started it (the same
# PR_SET_PDEATHSIG as the phase children), then runs a module as -m would
_DIE_WITH_PARENT = ("import ctypes, runpy, signal, sys; "
                    "ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL); "
                    "runpy.run_module(sys.argv.pop(1), run_name='__main__', alter_sys=True)")


def _child_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DISPATCHES_TPU_OBS", "DISPATCHES_TPU_SANITIZE",
                                "DISPATCHES_TPU_NET", "DISPATCHES_TPU_FLEET"))}
    env.update(PYTHONUNBUFFERED="1", OMP_NUM_THREADS=WORKER_THREADS,
               MKL_NUM_THREADS=WORKER_THREADS, OPENBLAS_NUM_THREADS=WORKER_THREADS, **extra)
    return env


def _start_module(module, argv, out, err, **env):
    """``python -m module argv`` in a child that dies with this process."""
    return subprocess.Popen([sys.executable, "-c", _DIE_WITH_PARENT, module, *argv],
                            stdout=out, stderr=err, text=True, env=_child_env(**env), cwd=ROOT)


def _start_workers(work, tag, dev, n=2, **env):
    """Start ``n`` ``python -m dispatches_tpu_torch.net --worker --model
    arbitrage`` processes on ``dev``, each journaling into its own
    directory under ``work``; :func:`_await_workers` reads their ready
    lines."""
    started = []
    for i in range(n):
        err = work / f"{tag}-{i}.err"
        with open(err, "w") as err_file:
            proc = _start_module("dispatches_tpu_torch.net",
                                 ["--worker", "--port", "0", "--model", "arbitrage", "--device",
                                  str(dev), "--journal-dir", str(work / f"{tag}-{i}"),
                                  "--tick-ms", "5", "--max-wait-ms", str(NET_MAX_WAIT_MS)],
                                 subprocess.PIPE, err_file, **env)
        started.append((proc, None, err))
    return started


def _await_workers(started, tag):
    """``[(proc, port, stderr path)]`` once each worker printed its ready
    line (within ``WORKER_START_S``)."""
    import select

    out = []
    t_end = time.perf_counter() + WORKER_START_S
    for proc, _, err in started:
        ready = select.select([proc.stdout], [], [], max(0.0, t_end - time.perf_counter()))[0]
        line = proc.stdout.readline() if ready else ""
        if not line:
            proc.kill()
            sys.stdout.write(err.read_text()[-4000:])
        check(line, f"[{tag}] a worker printed no ready line within {WORKER_START_S:.0f} s")
        msg = json.loads(line)
        check(msg.get("ready") and msg["pid"] == proc.pid, f"[{tag}] bad ready line {line!r}")
        out.append((proc, int(msg["port"]), err))
    return out


def _stop_workers(workers):
    for proc, _, _ in workers:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def _arbitrage_params(nlp, prices, i):
    d = nlp.default_params()
    return {"p": {**d["p"], "price": prices[i]}, "fixed": d["fixed"]}


def _terminal_once(handles, tag):
    """Every handle terminal, with exactly one status each (a handle
    completes once; its status is one of the terminal ones)."""
    statuses = [h.status for h in handles]
    check(all(h.done() for h in handles)
          and all(s in ("DONE", "TIMEOUT", "ERROR", "SHED") for s in statuses),
          f"[{tag}] {sum(not h.done() for h in handles)} of {len(handles)} requests not terminal")
    return {s: statuses.count(s) for s in sorted(set(statuses))}


def _same_result(a, b):
    """Two lane results equal bit for bit (tensors, arrays, scalars)."""
    import torch

    if a is None or b is None:
        return a is b
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.dtype == y.dtype and torch.equal(x, y)):
                return False
        elif np.asarray(x).tobytes() != np.asarray(y).tobytes():
            return False
    return len(a) == len(b)


def fleet_inprocess(torch, dev, main_run, work):
    """[fleet]: a ``FleetRouter`` over 3 in-process ``SolveService``
    replicas on the card (journals each), the 366 scenarios as requests
    on a ``FakeClock``, replica 1 killed after 120 and failed over by the
    heartbeat; then 16 repeats (affinity, warm starts after gossip); then
    ``n_replicas`` 1 against a bare service, bitwise."""
    from dispatches_tpu_torch.fleet import FleetOptions, FleetRouter
    from dispatches_tpu_torch.obs.soak import FakeClock
    from dispatches_tpu_torch.serve import ServeOptions, SolveService, request_fingerprint

    nlp, lmps, cfs = main_run["nlp"], main_run["lmps"], main_run["cfs"]
    clk = FakeClock()

    def make_service(replica_id, journal_dir, clock=clk):
        return SolveService(ServeOptions.from_env(max_batch=FLEET_MAX_BATCH, max_wait_ms=1e9),
                            clock=clock, journal_dir=journal_dir, device=dev)

    router = FleetRouter(FleetOptions(n_replicas=FLEET_REPLICAS,
                                      heartbeat_timeout_ms=FLEET_HEARTBEAT_MS,
                                      gossip_interval_s=FLEET_GOSSIP_S),
                         clock=clk, make_service=make_service, durable_dir=str(work / "fleet"))
    fail_s = []
    fail = router._fail_replica

    def timed_fail(replica, now):
        t = time.perf_counter()
        fail(replica, now)
        fail_s.append(time.perf_counter() - t)

    router._fail_replica = timed_fail
    handles, open_at_kill = [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(N_SCENARIOS):
        handles.append(router.submit(nlp, _flagship_params(nlp, lmps, cfs, s)))
        clk.advance(FLEET_STEP_S)
        router.poll()
        if s + 1 == FLEET_KILL_AFTER:
            open_at_kill = router.replicas[FLEET_KILLED].queue_depth()
            router.kill(FLEET_KILLED)
    clk.advance(FLEET_HEARTBEAT_MS / 1e3 + FLEET_STEP_S)
    router.poll()
    router.flush_all()
    router.poll()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _terminal_once(handles, "fleet")
    stats = router.fleet_stats()
    per = {name: p["submitted"] for name, p in stats["per_replica"].items()}
    print(f"[fleet] {N_SCENARIOS} requests through {FLEET_REPLICAS} replicas in {wall:.2f} s = "
          f"{N_SCENARIOS / wall:.1f} requests/s (fake clock, max_batch {FLEET_MAX_BATCH}); "
          f"statuses {counts}; routed per replica {per}; replica {FLEET_KILLED} killed after "
          f"{FLEET_KILL_AFTER} with {open_at_kill} queued: failovers {stats['failovers']}, "
          f"rehomed {stats['rehomed']}, rehome_lost {stats['rehome_lost']}, re-home "
          f"{sum(fail_s) * 1e3:.1f} ms; gossip {stats['gossip']}")
    check(counts == {"DONE": N_SCENARIOS}, f"[fleet] not every request DONE: {counts}")
    check(stats["failovers"] == 1 and stats["rehome_lost"] == 0
          and stats["rehomed"] >= open_at_kill and stats["alive"] == FLEET_REPLICAS - 1 and stats["bridges_open"] == 0,
          f"[fleet] failover: {stats['failovers']} failovers, {stats['rehomed']} rehomed, "
          f"{stats['rehome_lost']} lost, {stats['bridges_open']} bridges open")
    ref = highs_objectives(torch, nlp, main_run["lp"], lmps[:N_HIGHS], cfs[:N_HIGHS])
    got = np.asarray([h.result().obj for h in handles[:N_HIGHS]])
    err = np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)
    print(f"[fleet] {N_HIGHS} DONE objectives vs HiGHS: max rel err {err.max():.3e}")
    check(err.max() <= IPM_RTOL, f"[fleet] objective error {err.max():.3e} > {IPM_RTOL}")
    # repeats: affinity sends each back to its home while it lives
    hits, reps, orphaned = 0, [], 0
    for s in range(FLEET_REPEATS):
        params = _flagship_params(nlp, lmps, cfs, s)
        home = router._affinity.get(request_fingerprint(params))
        reps.append(router.submit(nlp, params))
        orphaned += int(home == FLEET_KILLED)
        hits += int(home is not None and home != FLEET_KILLED
                    and router._affinity[request_fingerprint(params)] == home)
    router.flush_all()
    _terminal_once(reps, "fleet")
    kinds = np.bincount([int(h.result().result.start_kind) for h in reps], minlength=4)
    print(f"[fleet] {FLEET_REPEATS} repeats: affinity hits {hits}, {orphaned} homed on the "
          f"killed replica and routed anew; start kinds cold/exact/neighbor/predicted = "
          f"{'/'.join(str(k) for k in kinds)}; warm hit rate "
          f"{router.metrics()['warm_start']['hit_rate']:.3f}")
    router.drain()
    # n_replicas 1: a pass-through, bitwise a bare service
    clk1 = FakeClock()
    bare = make_service(None, None, clock=clk1)
    single = FleetRouter(FleetOptions(n_replicas=1), clock=clk1,
                         make_service=lambda i, jd: make_service(i, jd, clock=clk1))
    pairs = []
    for s in range(FLEET_PARITY_N):
        params = _flagship_params(nlp, lmps, cfs, s)
        pairs.append((bare.submit(nlp, params), single.submit(nlp, params)))
        clk1.advance(FLEET_STEP_S)
        bare.poll()
        single.poll()
    bare.flush_all()
    single.flush_all()
    same = sum(hb.request_id == hf.request_id and hb.result().status == hf.result().status
               == "DONE" and hb.result().obj == hf.result().obj
               and _same_result(hb.result().result, hf.result().result) for hb, hf in pairs)
    print(f"[fleet] n_replicas 1 vs a bare service: {same} of {FLEET_PARITY_N} requests "
          f"bitwise equal (ids, statuses, objectives, every result field)")
    check(same == FLEET_PARITY_N, "[fleet] n_replicas 1 is not bitwise the bare service")
    return {"rps": N_SCENARIOS / wall, "rehome_ms": sum(fail_s) * 1e3}


def _rpc_quantiles():
    from dispatches_tpu_torch.obs import registry

    entry = registry.default_registry().snapshot().get("net.rpc_ms") or {}
    return ", ".join(f"{label.partition('=')[2]} n {int(v['count'])} p50 {v['p50']:.2f} / "
                     f"p95 {v['p95']:.2f} / p99 {v['p99']:.2f} ms"
                     for label, v in sorted((entry.get("values") or {}).items()))


def _submit_threads(router, nlp, prices, n_threads, per, tag):
    """``n_threads`` submitters of ``per`` requests each, waiting on their
    handles (``result()`` drives the remote queues), while this thread
    polls the router; returns the handles in price order."""
    import threading

    handles = [[] for _ in range(n_threads)]
    errors = []

    def submitter(k):
        try:
            for i in range(per):
                handles[k].append(router.submit(
                    nlp, _arbitrage_params(nlp, prices, k * per + i),
                    deadline_ms=NET_DEADLINE_MS))
            for h in handles[k]:
                h.result(timeout=NET_WAIT_S)
        except Exception as exc:
            errors.append(f"{type(exc).__name__}: {exc}")

    threads = [threading.Thread(target=submitter, args=(k,)) for k in range(n_threads)]
    for t in threads:
        t.start()
    t_end = time.perf_counter() + NET_WAIT_S
    while any(t.is_alive() for t in threads) and time.perf_counter() < t_end:
        router.poll()
        time.sleep(0.005)
    for t in threads:
        t.join(timeout=5.0)
    check(not errors and not any(t.is_alive() for t in threads),
          f"[{tag}] a submitter failed or hung: {errors[:3]}")
    return [h for hs in handles for h in hs]


def _vs_highs(torch, nlp, lp, prices, idx, handles, tag):
    ref = np.asarray([highs_objective(torch, nlp, lp, _arbitrage_params(nlp, prices, i),
                                      f"{tag} request {i}") for i in idx])
    got = np.asarray([handles[i].result().obj for i in idx])
    err = np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)
    check(err.max() <= IPM_RTOL, f"[{tag}] objective error {err.max():.3e} > {IPM_RTOL}")
    return err.max()


def net_workers(torch, dev, work, workers):
    """[net]: ``connect_fleet`` over two worker processes serving the
    serve CLI's arbitrage LP on the card; 4 threaded submitters with the
    lock sanitizer on; then a SIGKILL of one worker with requests open."""
    from dispatches_tpu_torch.analysis import runtime
    from dispatches_tpu_torch.fleet import FleetOptions, connect_fleet
    from dispatches_tpu_torch.serve.__main__ import _arbitrage_nlp
    from dispatches_tpu_torch.solvers import make_lp_data

    nlp = _arbitrage_nlp(NET_T)
    lp = make_lp_data(nlp, device="cpu")
    n = NET_SUBMITTERS * NET_PER_SUBMITTER
    prices = 30.0 + 10.0 * np.random.default_rng(14).standard_normal((n + NET_KILL_REQUESTS, NET_T))
    os.environ["DISPATCHES_TPU_SANITIZE"] = "1"  # read when the locks are built
    runtime.reset_lock_order()
    try:
        router = connect_fleet([("127.0.0.1", port) for _, port, _ in workers],
                               options=FleetOptions(n_replicas=len(workers),
                                                    heartbeat_timeout_ms=NET_HEARTBEAT_MS,
                                                    gossip_interval_s=FLEET_GOSSIP_S))
        t0 = time.perf_counter()
        handles = _submit_threads(router, nlp, prices, NET_SUBMITTERS, NET_PER_SUBMITTER, "net")
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("DISPATCHES_TPU_SANITIZE", None)
    counts = _terminal_once(handles, "net")
    report = runtime.lock_order_report()
    stats = router.fleet_stats()
    offsets = {name: p["clock_offset_us"] for name, p in stats["per_replica"].items()}
    routed = {name: p["submitted"] for name, p in stats["per_replica"].items()}
    print(f"[net] {n} requests from {NET_SUBMITTERS} threads through {len(workers)} workers in "
          f"{wall:.2f} s = {n / wall:.1f} requests/s; statuses {counts}; routed {routed}; clock "
          f"offsets (us) {offsets}; lock-order edges {len(report['edges'])}, inversions "
          f"{len(report['inversions'])}, net locks held {sorted(k for k in report['holds'] if k.startswith('net.'))}")
    check(counts == {"DONE": n} and len({h._rid for h in handles}) == n,
          f"[net] not every request DONE exactly once: {counts}")
    check(report["inversions"] == [], f"[net] lock-order inversions {report['inversions'][:2]}")
    err = _vs_highs(torch, nlp, lp, prices, range(N_HIGHS), handles, "net")
    print(f"[net] {N_HIGHS} DONE objectives vs HiGHS (the serve CLI's LP, T = {NET_T}): max rel "
          f"err {err:.3e}")
    print(f"[net] rpc latency (client-observed): {_rpc_quantiles()}")
    # the SIGKILL: requests go out, one worker dies with some of them open
    kill = []
    for i in range(n, n + NET_KILL_REQUESTS):
        kill.append(router.submit(nlp, _arbitrage_params(nlp, prices, i),
                                  deadline_ms=NET_DEADLINE_MS))
    # no poll since these went out: every request routed to the victim is
    # still open on the router's books when it dies
    victim = router.replicas[0]
    open_at_kill = len(victim.service._handles)
    workers[0][0].kill()
    t_kill = time.perf_counter()
    t_end = t_kill + NET_WAIT_S
    while (router.failovers == 0 or not all(h.done() for h in kill)) \
            and time.perf_counter() < t_end:
        router.poll()
        try:
            router.flush_all()
        except Exception:
            pass  # the dead worker's flush: fail-stop containment in the next poll
        time.sleep(0.01)
    t_done = time.perf_counter() - t_kill
    counts = _terminal_once(kill, "net")
    stats = router.fleet_stats()
    print(f"[net] SIGKILL of {victim.name} (pid {victim.worker_pid}) with {open_at_kill} of "
          f"the {NET_KILL_REQUESTS} just sent open: failovers {stats['failovers']}, rehomed "
          f"{stats['rehomed']}, rehome_lost {stats['rehome_lost']}; every request terminal "
          f"{t_done:.2f} s after the kill (heartbeat timeout {NET_HEARTBEAT_MS / 1e3:.0f} s); "
          f"statuses {counts}")
    check(stats["failovers"] == 1 and stats["rehome_lost"] == 0
          and stats["rehomed"] >= open_at_kill > 0 and counts == {"DONE": NET_KILL_REQUESTS},
          f"[net] SIGKILL failover: {stats['failovers']} failovers, {stats['rehomed']} rehomed, "
          f"{stats['rehome_lost']} lost, statuses {counts}")
    err = _vs_highs(torch, nlp, lp, prices[n:], range(N_HIGHS), kill, "net")
    print(f"[net] {N_HIGHS} of the SIGKILL batch vs HiGHS: max rel err {err:.3e}")
    router.drain()
    return {"rps": n / wall, "rehome_s": t_done}


def net_trace(torch, dev, work, workers):
    """[net-trace]: the two-worker set-up with ``NET_TRACE`` on both sides
    and ``OBS_FLEET_EXPORT_DIR`` set: one merged Chrome trace, every
    request's journey in spans of 2 processes or more, the fleet
    ``metrics.prom`` labelled with both workers."""
    from dispatches_tpu_torch.fleet import FleetOptions, connect_fleet
    from dispatches_tpu_torch.obs import distributed, report, trace
    from dispatches_tpu_torch.serve.__main__ import _arbitrage_nlp

    nlp = _arbitrage_nlp(NET_T)
    n = NET_TRACE_SUBMITTERS * NET_TRACE_PER
    prices = 30.0 + 10.0 * np.random.default_rng(15).standard_normal((n, NET_T))
    export_dir = work / "fleet-export"
    distributed.enable(True)
    trace.enable(True)
    trace.reset()
    os.environ["DISPATCHES_TPU_OBS_FLEET_EXPORT_DIR"] = str(export_dir)
    try:
        router = connect_fleet([("127.0.0.1", port) for _, port, _ in workers],
                               options=FleetOptions(n_replicas=len(workers),
                                                    heartbeat_timeout_ms=NET_HEARTBEAT_MS,
                                                    gossip_interval_s=60.0))
        handles = _submit_threads(router, nlp, prices, NET_TRACE_SUBMITTERS, NET_TRACE_PER,
                                  "net-trace")
        router._exporter.export()
        remotes = router.trace_exports()
        path = work / "merged_trace.json"
        n_events = distributed.export_merged_trace(path, trace.events(), remotes)
    finally:
        os.environ.pop("DISPATCHES_TPU_OBS_FLEET_EXPORT_DIR", None)
        distributed.enable(False)
        trace.enable(False)
    counts = _terminal_once(handles, "net-trace")
    events = report.load_chrome_trace(path)
    problems = report.validate_chrome_trace(events)
    negative = sum(e.get("ts", 0.0) < 0.0 or e.get("dur", 0.0) < 0.0 for e in events)
    worker_pids = {proc.pid for proc, _, _ in workers}
    journeys = [report.journey_processes(events, h._rid) for h in handles]
    crossed = sum(len(p) >= 2 and bool(worker_pids & set(p)) for p in journeys)
    stats = router.fleet_stats()["per_replica"]
    prom = (export_dir / "metrics.prom").read_text()
    labels = [f'process="{name}:pid{p["pid"]}"' for name, p in stats.items()]
    print(f"[net-trace] {n} traced requests, statuses {counts}; merged trace {n_events} events "
          f"from {1 + len(remotes)} processes, {len(problems)} problems, {negative} negative "
          f"timestamps or durations; journeys across 2+ processes {crossed} of {n}; fleet "
          f"metrics.prom {len(prom.splitlines())} lines, labels "
          f"{[lbl for lbl in labels if lbl in prom]}")
    check(counts == {"DONE": n}, f"[net-trace] not every request DONE: {counts}")
    check(problems == [] and negative == 0 and len(remotes) == len(workers),
          f"[net-trace] merged trace invalid: {problems[:4]}, {negative} negative")
    check(crossed == n, f"[net-trace] {n - crossed} journeys stayed in one process")
    check(all(lbl in prom for lbl in labels), "[net-trace] a worker's process label is missing")
    router.drain()


def fleet_soak(torch, dev):
    """[fleet-soak]: the chaos-kill fleet soak on the card and on the CPU,
    equal in every virtual-time field, nothing lost; then the spec at 1
    replica and at 3 without the kill (virtual time)."""
    from dispatches_tpu_torch.obs import soak

    t0 = time.perf_counter()
    card = soak.run_soak(json.loads(json.dumps(FLEET_SOAK)), device=dev)
    t1 = time.perf_counter()
    cpu = soak.run_soak(json.loads(json.dumps(FLEET_SOAK)), device="cpu")
    t2 = time.perf_counter()
    c, ft = card["requests"], card["fleet"]
    print(_soak_line("fleet-soak", card) + f"; fleet {ft['alive']}/{ft['n_replicas']} alive, "
          f"failovers {ft['failovers']}, rehomed {ft['rehomed']}, replica_lost_request_rate "
          f"{card['replica_lost_request_rate']}; {t1 - t0:.2f} s on the card, {t2 - t1:.2f} s on "
          f"the CPU")
    diff = _soak_diff(card, cpu)
    check(diff is None, f"[fleet-soak] the card's report differs from the CPU's at {diff}")
    check(card["replica_lost_request_rate"] == 0.0 and c["hung"] == 0 and ft["failovers"] == 1
          and c["done"] + c["timeout"] + c["error"] + c["shed"] == c["submitted"],
          f"[fleet-soak] a request was lost or hung: {c}")
    rows = {}
    for n in (1, 3):
        spec = json.loads(json.dumps(FLEET_SOAK))
        spec["fleet"] = {"enabled": True, "n_replicas": n, "heartbeat_timeout_ms": 150.0,
                         "gossip_interval_s": 0.5}
        r = soak.run_soak(spec, device=dev)
        rows[n] = (r["requests"]["done"] / r["duration_s"], r["latency_ms"]["posthoc"]["p99"])
    print(f"[fleet-soak] virtual time, no kill: 1 replica {rows[1][0]:.2f} requests/s p99 "
          f"{rows[1][1]:.3f} ms; 3 replicas {rows[3][0]:.2f} requests/s p99 {rows[3][1]:.3f} ms; "
          f"ratio 3:1 throughput {rows[3][0] / rows[1][0]:.4f}, p99 {rows[3][1] / rows[1][1]:.4f} "
          f"(virtual-time figures, not card time)")


def start_fleet_cli(work, dev):
    """[fleet-cli]: start ``python -m dispatches_tpu_torch.fleet`` in demo
    mode and in worker mode (2 workers, a merged trace and a merged
    exposition) in child Pythons; joined by :func:`join_fleet_cli`."""
    runs = {"demo": ["--stats", "--json", "--device", str(dev)],
            "workers": ["--workers", "2", "--trace-export", str(work / "cli-trace.json"),
                        "--prom-out", str(work / "cli.prom"), "--json", "--device", str(dev)]}
    procs = {}
    for name, argv in runs.items():
        out = open(work / f"fleet-cli-{name}.out", "w+")
        procs[name] = (_start_module("dispatches_tpu_torch.fleet", argv, out, subprocess.STDOUT),
                       out, argv, time.perf_counter())
    return procs


def join_fleet_cli(procs):
    from dispatches_tpu_torch.obs import report

    for name, (proc, out, argv, t0) in procs.items():
        try:
            rc = proc.wait(timeout=max(1.0, t0 + FLEET_CLI_TIMEOUT_S - time.perf_counter()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            fail(f"[fleet-cli] {name} still running after {FLEET_CLI_TIMEOUT_S} s")
        out.seek(0)
        text = out.read()
        out.close()
        if rc != 0:
            sys.stdout.write(text[-4000:])
        check(rc == 0, f"[fleet-cli] {' '.join(argv)} exited {rc}")
        payload = json.loads(text.strip().splitlines()[-1])
        want = JAX_FLEET_KEYS if name == "demo" else JAX_FLEET_REMOTE_KEYS
        check(list(payload) == want, f"[fleet-cli] {name} keys {list(payload)}")
        check(payload["hung"] == 0, f"[fleet-cli] {name}: {payload['hung']} hung")
        line = (f"[fleet-cli] {' '.join(argv)}: exit {rc}, keys as the JAX CLI's, "
                f"{payload['solved']} solved of {payload['submitted']}, "
                f"{payload['fleet']['alive']}/{payload['fleet']['n_replicas']} replicas alive")
        if name == "workers":
            tr = payload["trace"]
            check(tr["valid"] and tr["processes"] == 3
                  and report.validate_chrome_trace(report.load_chrome_trace(tr["path"])) == [],
                  f"[fleet-cli] merged trace invalid: {tr['problems']}")
            line += f", merged trace {tr['events']} events from {tr['processes']} processes"
        print(f"{line}; joined {time.perf_counter() - t0:.1f} s after its start")


def phase_fleet(torch, dev):
    """Phase 14, with the sweep kernels' counts set to 0 before and read
    after (no kernel lies on this path): the multi-process tier on the
    card."""
    import tempfile

    from dispatches_tpu_torch.kernels import pdhg_sweep as ks

    ks.avg_sweep.launches = 0
    ks.halpern_sweep.launches = 0
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="phase14-") as tmp:
        work = Path(tmp)
        # one pair of workers, or the CLI children, at a time: each is a
        # CUDA context on the one card, which time-slices between busy
        # contexts and so slows every launch-bound phase running beside
        # this one (run C, PR 14: 4 workers and 2 CLI children at once
        # took phase 13's real-clock soak from 24.6 s to 260.3 s)
        live, cli, walls, got = [], {}, [], {}

        def part(name, run):
            t_part = time.perf_counter()
            run()
            walls.append(f"{name} {time.perf_counter() - t_part:.1f}")

        def swap_workers(tag, **env):
            _stop_workers(live)
            live[:] = _start_workers(work, tag, dev, **env)

        try:
            swap_workers("net", DISPATCHES_TPU_SANITIZE="1")  # they start during [fleet]
            main_run = flagship(torch, dev)
            part("fleet", lambda: got.update(fleet=fleet_inprocess(torch, dev, main_run, work)))
            part("net", lambda: got.update(net=net_workers(
                torch, dev, work, _await_workers(live, "net"))))
            swap_workers("net-trace", DISPATCHES_TPU_NET_TRACE="1")
            part("fleet-soak", lambda: fleet_soak(torch, dev))
            part("net-trace", lambda: net_trace(torch, dev, work, _await_workers(live,
                                                                                 "net-trace")))
            _stop_workers(live)
            cli = start_fleet_cli(work, dev)
            part("fleet-cli", lambda: join_fleet_cli(cli))
        finally:
            _stop_workers(live)
            for proc, out, _, _ in cli.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                out.close()
    print(f"[phase14] {time.perf_counter() - t0:.1f} s ({', '.join(walls)} s); fleet "
          f"{got['fleet']['rps']:.1f} requests/s in process, re-home {got['fleet']['rehome_ms']:.1f} "
          f"ms; net {got['net']['rps']:.1f} requests/s through 2 workers, SIGKILL to all terminal "
          f"{got['net']['rehome_s']:.2f} s; sweep kernel launches during it: halpern "
          f"{ks.halpern_sweep.launches}, avg {ks.avg_sweep.launches}")
    check(ks.halpern_sweep.launches == 0 and ks.avg_sweep.launches == 0,
          "[phase14] a sweep kernel was launched on the fleet path")


# ---------------------------------------------------------------------
# phase 15: the analysis passes and the steady-state contract on the card
# ---------------------------------------------------------------------

LINT_TIMEOUT_S = 300       # [lint]: each analysis CLI child
P15_SERVE_WAVES = 2        # [recompiles] (b): waves of (8 PDLP at T 8, 8 IPM at T 12) a round
P15_FACTORY_PRICES = 4     # [recompiles] (c): new prices after the warm solve
P15_DL_DAYS = 3            # [recompiles] (d): co-sim days, the first the warm-up
P15_DL_PUSHES = 12         # [recompiles] (d): RT bids and tracking pushes a day (2 h each)
SANITIZE_THREADS = 4       # [sanitize]: submitter threads ...
SANITIZE_PER_THREAD = 16   # ... of this many requests each, beside one polling thread
P15_ARMED = {"DISPATCHES_TPU_SANITIZE": "1", "DISPATCHES_TPU_WARN_RECOMPILE": "1"}


def lint_cli(torch):
    """[lint]: ``python -m dispatches_tpu_torch.analysis --check --json`` and
    ``--selftest`` in child Pythons: both exit 0, nothing new beyond the
    baseline and no lock finding in it."""
    out = {}
    for args in (["--check", "--json"], ["--selftest"]):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "dispatches_tpu_torch.analysis", *args],
                              capture_output=True, text=True, cwd=ROOT, timeout=LINT_TIMEOUT_S,
                              env=_child_env())
        out[args[0]] = (proc, time.perf_counter() - t0)
        check(proc.returncode == 0, f"[lint] {' '.join(args)} exited {proc.returncode}:\n"
              f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    doc = json.loads(out["--check"][0].stdout)
    rules = sorted({f["rule"] for f in doc["findings"]})
    print(f"[lint] --check --json: exit 0 in {out['--check'][1]:.1f} s, schema {doc['schema']}, "
          f"counts {json.dumps(doc['counts'], sort_keys=True)}, baselined rules {rules}; "
          f"--selftest: exit 0 in {out['--selftest'][1]:.1f} s "
          f"({out['--selftest'][0].stdout.strip()})")
    check(doc["schema"] == 1 and doc["counts"]["new"] == 0, "[lint] new findings")
    check(not {"GL009", "GL010", "GL011", "GL012"} & set(rules), "[lint] a lock finding is baselined")


def _steady(torch, tag, run):
    """``run()`` under ``assert_no_recompiles()``, a RecompileWarning raised
    as an error; returns its result and wall (synchronized)."""
    import warnings

    from dispatches_tpu_torch.analysis import RecompileWarning, assert_no_recompiles

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RecompileWarning)
        with assert_no_recompiles():
            out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def recompiles_main_path(torch, dev, main_run):
    """[recompiles] (a): phase 2's main path (the batch PDLP at B = 366,
    halpern, f32, tol 1e-5) as a counted program, warmed once, then solved
    again: the halpern kernel launches, nothing is built, and 16 lanes
    agree with HiGHS.

    The program counter's signature is the same on both calls by
    construction, so "nothing is built" is held on what a rebuild would
    redo: the kernel library stays the one object the warm solve loaded,
    and the steady solve calls none of the builders of the library
    (``library_path``), of the packed operator (``pack_operator``) or of
    the LP's data and scalings (``make_lp_data``, ``_scalings``)."""
    from dispatches_tpu_torch.analysis import CountedProgram, recompile_counts
    from dispatches_tpu_torch.kernels import pdhg_sweep as ks
    from dispatches_tpu_torch.solvers import BatchPDLPOptions, make_pdlp_batch_solver
    from dispatches_tpu_torch.solvers import pdlp_batch as pb

    nlp, lp, lmps, cfs = main_run["nlp"], main_run["lp"], main_run["lmps"], main_run["cfs"]
    defaults = nlp.default_params()
    params = {"p": {**defaults["p"], "lmp": torch.as_tensor(lmps * 1e-3, device=dev),
                    "windpower.capacity_factor": torch.as_tensor(cfs, device=dev)},
              "fixed": defaults["fixed"]}
    solver = CountedProgram(make_pdlp_batch_solver(
        nlp, BatchPDLPOptions(tol=1e-5, dtype="float32"), lp_data=lp, device=dev),
        label="phase15.main_path")
    warm = solver(params)
    builds = dict(recompile_counts())
    lib0 = ks._lib  # the library the warm solve loaded (None: the CPU's plain sweep)
    spied = {"library_path": ks, "pack_operator": ks, "make_lp_data": pb, "_scalings": pb}
    originals = {name: getattr(mod, name) for name, mod in spied.items()}
    rebuilds = dict.fromkeys(spied, 0)

    def spy(name):
        def counted(*a, **kw):
            rebuilds[name] += 1
            return originals[name](*a, **kw)
        return counted

    launches0 = ks.halpern_sweep.launches
    for name, mod in spied.items():
        setattr(mod, name, spy(name))
    try:
        res, wall = _steady(torch, "main-path", lambda: solver(params))
    finally:
        for name, mod in spied.items():
            setattr(mod, name, originals[name])
    launches = ks.halpern_sweep.launches - launches0
    obj, iters = res.obj.cpu().numpy(), res.iters.cpu().numpy()
    ref = highs_objectives(torch, nlp, lp, lmps[:N_HIGHS], cfs[:N_HIGHS])
    rel = np.abs(obj[:N_HIGHS] - ref) / np.maximum(np.abs(ref), 1.0)
    drift = float(np.abs(obj - warm.obj.cpu().numpy()).max())
    print(f"[recompiles] main path B={N_SCENARIOS} halpern/f32: {wall * 1e3:.1f} ms, halpern "
          f"launches {launches} (iters_max {iters.max()}), program builds "
          f"{solver._graft_counter.count} (unchanged), builder calls {rebuilds}, kernel library "
          f"{'the warm one' if ks._lib is lib0 else 'RELOADED'}, obj_rel_err_vs_highs "
          f"{rel.max():.3e}, max |obj - warm obj| {drift:.3e}")
    check(obj.shape == (N_SCENARIOS,) and np.all(np.isfinite(obj)), "[recompiles] main path obj")
    check(launches > 0 and launches == math.ceil(iters.max() / K_STEPS),
          f"[recompiles] main path: {launches} halpern launches for max {iters.max()} iterations")
    check(solver._graft_counter.count == 1 and recompile_counts() == builds,
          "[recompiles] the main path built a program")
    check((lib0 is not None or dev.type != "cuda") and ks._lib is lib0
          and not any(rebuilds.values()),
          f"[recompiles] the steady main path rebuilt: library {'kept' if ks._lib is lib0 else 'reloaded'}, "
          f"builder calls {rebuilds}")
    check(rel.max() <= OBJ_RTOL, f"[recompiles] main path vs HiGHS {rel.max():.3e}")
    return wall, launches


def recompiles_serve(torch, dev):
    """[recompiles] (b): tests/test_serve.py's steady state on the card: two
    identical rounds of 16 PDLP (T = 8, tol 1e-9, f64) and 16 IPM (T = 12)
    requests through ``SolveService``; one 16-lane program per bucket, the
    second round built nothing and returned the first round's objectives."""
    from dispatches_tpu_torch.obs.soak import FakeClock
    from dispatches_tpu_torch.serve import RequestStatus, ServeOptions, SolveService
    from dispatches_tpu_torch.serve.__main__ import _arbitrage_nlp

    clock = FakeClock()
    svc = SolveService(ServeOptions(max_batch=16, max_wait_ms=1e9, warm_start=False),
                       clock=clock, device=dev)
    nlps = {8: _arbitrage_nlp(8), 12: _arbitrage_nlp(12)}
    rng = np.random.default_rng(15)

    def params(T):
        d = nlps[T].default_params()
        return {"p": {**d["p"], "price": 30.0 + 10.0 * rng.standard_normal(T)}, "fixed": d["fixed"]}

    reqs = []
    for _ in range(P15_SERVE_WAVES):
        reqs += [("pdlp", 8, params(8)) for _ in range(8)]
        reqs += [("ipm", 12, params(12)) for _ in range(8)]

    def run_round():
        handles = []
        for kind, T, p in reqs:
            clock.advance(1e-4)
            handles.append(svc.submit(nlps[T], p, solver=kind, options=(
                {"tol": 1e-9, "dtype": "float64"} if kind == "pdlp" else {"max_iter": 200})))
        svc.flush_all()
        return [h.result() for h in handles]

    round1 = run_round()
    m = svc.metrics()
    check(all(r.status == RequestStatus.DONE for r in round1), "[recompiles] serve round 1")
    check(m["programs"] == m["compile_count"] == 2, f"[recompiles] serve round 1: {m['programs']} "
          f"programs, {m['compile_count']} compiles")
    round2, wall = _steady(torch, "serve", run_round)
    m2 = svc.metrics()
    gap = max(abs(a.obj - b.obj) for a, b in zip(round1, round2))
    print(f"[recompiles] serve: round 2 of {len(reqs)} requests {wall * 1e3:.1f} ms, programs "
          f"{m2['programs']}, compile_count {m2['compile_count']}, solved {m2['solved']}, lane counts "
          f"pdlp {m2['buckets']['pdlp#0']['lane_counts']} ipm {m2['buckets']['ipm#1']['lane_counts']}, "
          f"max |obj round 2 - round 1| {gap:.3e}")
    check(all(r.status == RequestStatus.DONE for r in round2), "[recompiles] serve round 2")
    check(m2["compile_count"] == m2["programs"] == 2 and m2["solved"] == 2 * len(reqs),
          "[recompiles] serve round 2 built a program")
    check(gap <= 1e-9 * max(1.0, max(abs(r.obj) for r in round1)),
          f"[recompiles] serve: round 2 moved an objective by {gap:.3e}")
    return wall


def recompiles_factory(torch, dev):
    """[recompiles] (c): ``SolverFactory("ipm")`` on the storage LP, warmed
    once, then over new prices: one ``factory.ipm`` build, every solve
    converged and within 1e-6 of HiGHS."""
    from dispatches_tpu_torch.solvers import SolverFactory, make_lp_data

    nlp = _storage_lp(torch)
    lp = make_lp_data(nlp, device=dev)
    factory = SolverFactory("ipm", device=dev)
    rng = np.random.default_rng(16)

    def priced():
        p = nlp.default_params()
        p["p"]["price"] = np.abs(30.0 + 20.0 * rng.standard_normal(T))
        return p

    factory.solve(nlp, priced())
    ps = [priced() for _ in range(P15_FACTORY_PRICES)]
    results, wall = _steady(torch, "factory", lambda: [factory.solve(nlp, p) for p in ps])
    counter = factory._cache.get(nlp, ())[0]._graft_counter
    rel = max(abs(float(r.obj) - ref) / max(abs(ref), 1.0) for r, ref in zip(
        results, [highs_objective(torch, nlp, lp, p, "factory price") for p in ps]))
    print(f"[recompiles] factory: {len(ps)} ipm solves {wall * 1e3:.1f} ms, {counter.label} builds "
          f"{counter.count}, obj_rel_err_vs_highs {rel:.3e}")
    check(all(bool(r.converged) for r in results), "[recompiles] factory: a solve did not converge")
    check((counter.label, counter.count) == ("factory.ipm", 1), "[recompiles] factory rebuilt")
    check(rel <= IPM_RTOL, f"[recompiles] factory vs HiGHS {rel:.3e}")
    return wall


def recompiles_double_loop(torch, dev):
    """[recompiles] (d): tests/test_analysis.py's 3-day wind-battery double
    loop on the card: after the first day, two more days (a DA bid, 12 RT
    bids and 12 tracking solves each) build nothing; one build per solver
    callable, the projection tracker's counter at 0."""
    from dispatches_tpu_torch.case_studies.renewables.wind_battery_double_loop import (
        MultiPeriodWindBattery,
    )
    from dispatches_tpu_torch.grid import (
        DoubleLoopCoordinator,
        RenewableGeneratorModelData,
        SelfScheduler,
        Tracker,
    )

    n_hr, da_h, rt_h = 24 // P15_DL_PUSHES, 8, 4
    cfs = 0.3 + 0.4 * np.random.default_rng(7).random(24 * (P15_DL_DAYS + 1))
    md = RenewableGeneratorModelData(gen_name="4_WIND", bus="4", p_min=0.0, p_max=120.0)

    def mp():
        return MultiPeriodWindBattery(model_data=md, wind_capacity_factors=cfs, wind_pmax_mw=120,
                                      battery_pmax_mw=15, battery_energy_capacity_mwh=60)

    class Forecaster:
        def forecast_day_ahead_prices(self, date, hour, bus, horizon, n):
            base = 25.0 + 5.0 * np.sin(np.arange(horizon) + hour)
            return np.stack([base * (1.0 + 0.1 * s) for s in range(n)])

        forecast_real_time_prices = forecast_day_ahead_prices

    coord = DoubleLoopCoordinator(
        SelfScheduler(bidding_model_object=mp(), day_ahead_horizon=da_h, real_time_horizon=rt_h,
                      n_scenario=1, forecaster=Forecaster(), max_iter=120, device=dev),
        Tracker(tracking_model_object=mp(), tracking_horizon=rt_h, n_tracking_hour=n_hr,
                max_iter=120, device=dev),
        Tracker(tracking_model_object=mp(), tracking_horizon=da_h, n_tracking_hour=n_hr,
                max_iter=120, device=dev))
    check(coord._pushes_per_day == P15_DL_PUSHES, "[recompiles] double loop pushes per day")

    def day(date):
        coord.request_da_bids(date)
        for k in range(P15_DL_PUSHES):
            bids = coord.request_rt_bids(date, k * n_hr)
            coord.push_rt_dispatch(date, k * n_hr, bids[0]["4_WIND"]["p_max"], {"4": 27.0})

    dates = [f"2020-07-1{k}" for k in range(P15_DL_DAYS)]
    t0 = time.perf_counter()
    day(dates[0])
    warm_wall = time.perf_counter() - t0
    counters = [coord.bidder.day_ahead_model.solve._graft_counter,
                coord.bidder.real_time_model.solve._graft_counter, coord.tracker._solve._graft_counter]
    _, wall = _steady(torch, "double-loop", lambda: [day(d) for d in dates[1:]])
    stats = coord.tracker.implemented_stats
    last = coord.tracker.power_output
    print(f"[recompiles] double loop: day 1 (warm-up) {warm_wall:.1f} s, days 2-{P15_DL_DAYS} "
          f"{wall:.1f} s; builds {[c.count for c in counters]} "
          f"({', '.join(c.label for c in counters)}), projection tracker "
          f"{coord.projection_tracker._solve._graft_counter.count}; {len(stats)} tracked pushes, "
          f"the last tracking solve status {int(coord.tracker.res.status)}, power {last.tolist()}")
    check([c.count for c in counters] == [1, 1, 1], "[recompiles] double loop rebuilt a solver")
    check(coord.projection_tracker._solve._graft_counter.count == 0,
          "[recompiles] the projection tracker was solved")
    check(len(stats) == P15_DL_DAYS * P15_DL_PUSHES
          and coord.bidder.day_ahead_model._time_idx == P15_DL_DAYS * 24,
          "[recompiles] the co-sim did not advance three days")
    check(int(coord.tracker.res.status) == 0 and np.all(np.isfinite(last)),
          "[recompiles] the last tracking solve did not converge to finite powers")
    return wall


def sanitize_smoke(torch, dev):
    """[sanitize]: the JAX CI gates job's armed smoke on the card: 4
    submitter threads of 16 requests each and one polling thread on an
    armed ``SolveService`` (the ready schedule); all 64 DONE and no
    lock-order inversion.  Then ``nan_guard`` on a NaN iterate warns, and
    ``checkified(torch.log)`` raises on -1.0 and returns log(1.0) = 0."""
    import threading
    import warnings

    from dispatches_tpu_torch.analysis import (
        SanitizedLock,
        SanitizeWarning,
        checkified,
        drain_sanitize_events,
        lock_order_report,
        nan_guard,
        reset_lock_order,
    )
    from dispatches_tpu_torch.obs.soak import StubNLP, make_stub_solver
    from dispatches_tpu_torch.plan import ExecutionPlan, PlanOptions
    from dispatches_tpu_torch.serve import RequestStatus, ServeOptions, SolveService

    reset_lock_order()
    plan = ExecutionPlan(PlanOptions(inflight=2, schedule="ready", device=dev))
    svc = SolveService(ServeOptions(max_batch=4, max_wait_ms=5.0, warm_start=False, plan=plan),
                       device=dev)
    check(isinstance(svc._lock, SanitizedLock) and isinstance(plan._lock, SanitizedLock)
          and isinstance(plan._fence_lock, SanitizedLock), "[sanitize] the guards are not armed")
    nlp, solver = StubNLP(), make_stub_solver()
    handles, errs = [], []

    def submitter():
        try:
            for _ in range(SANITIZE_PER_THREAD):
                handles.append(svc.submit(nlp, nlp.default_params(), solver="pdlp",
                                          base_solver=solver))
        except Exception as exc:  # noqa: BLE001 - reported below
            errs.append(exc)

    def poller(stop):
        while not stop.is_set():
            svc.poll()

    t0 = time.perf_counter()
    stop = threading.Event()
    threads = [threading.Thread(target=submitter) for _ in range(SANITIZE_THREADS)]
    threads.append(threading.Thread(target=poller, args=(stop,)))
    for t in threads:
        t.start()
    for t in threads[:-1]:
        t.join(timeout=300)
    stop.set()
    threads[-1].join(timeout=60)
    check(not any(t.is_alive() for t in threads), "[sanitize] a thread is still running")
    svc.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    report = lock_order_report()
    done = sum(h.result().status == RequestStatus.DONE for h in handles)
    print(f"[sanitize] {len(handles)} requests from {SANITIZE_THREADS} threads + 1 poller in "
          f"{wall * 1e3:.1f} ms: {done} DONE, {len(report['edges'])} order edges, "
          f"{len(report['inversions'])} inversions, errors {errs}")
    check(not errs and len(handles) == SANITIZE_THREADS * SANITIZE_PER_THREAD
          and done == len(handles), "[sanitize] a request did not end DONE")
    check(report["inversions"] == [], f"[sanitize] inversions {report['inversions']}")

    drain_sanitize_events()
    bad = torch.tensor([1.0, float("nan")], dtype=torch.float64, device=dev)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        nan_guard("phase15.iterate", bad)
    events = drain_sanitize_events()
    check(events == ["phase15.iterate"] and any(issubclass(w.category, SanitizeWarning)
                                                for w in seen), "[sanitize] nan_guard did not warn")
    log = checkified(torch.log)
    one = log(torch.tensor([1.0], dtype=torch.float64, device=dev))
    try:
        log(torch.tensor([-1.0], dtype=torch.float64, device=dev))
        raised = None
    except FloatingPointError as exc:
        raised = str(exc)
    print(f"[sanitize] nan_guard events {events}; checkified(torch.log)(1.0) = "
          f"{float(one[0])}, (-1.0) raised: {raised}")
    check(float(one[0]) == 0.0, "[sanitize] checkified(torch.log)(1.0) != 0")
    check(raised is not None and "nan" in raised, "[sanitize] checkified did not raise on a NaN")
    return wall


def phase_analysis(torch, dev):
    """Phase 15, with the sweep kernels' counts set to 0 before and read
    after: the analysis passes and the steady-state contract on the card.
    The phase arms ``DISPATCHES_TPU_SANITIZE`` and
    ``DISPATCHES_TPU_WARN_RECOMPILE`` in its own process (a child of the
    whole run) before it builds anything: every serve and plan guard is a
    sanitized lock and every nan_guard checks its tensors."""
    from dispatches_tpu_torch.kernels import pdhg_sweep as ks

    os.environ.update(P15_ARMED)
    ks.avg_sweep.launches = 0
    ks.halpern_sweep.launches = 0
    t0 = time.perf_counter()
    lint_cli(torch)
    walls = {}
    wall, launches = recompiles_main_path(torch, dev, flagship(torch, dev))
    walls["main-path"] = wall
    walls["serve"] = recompiles_serve(torch, dev)
    walls["factory"] = recompiles_factory(torch, dev)
    walls["double-loop"] = recompiles_double_loop(torch, dev)
    walls["sanitize"] = sanitize_smoke(torch, dev)
    print(f"[phase15] {time.perf_counter() - t0:.1f} s (steady walls: "
          f"{', '.join(f'{k} {v:.2f} s' for k, v in walls.items())}); sweep kernel launches during "
          f"it: halpern {ks.halpern_sweep.launches} ({launches} in [recompiles]' steady main path), "
          f"avg {ks.avg_sweep.launches}")
    check(ks.halpern_sweep.launches >= launches > 0, "[phase15] the main path launched no halpern")
    check(ks.avg_sweep.launches == 0, "[phase15] an avg sweep was launched")


# The whole run drives these groups of phases in child processes (this
# script with a private flag), started after phase 3's kernel timings and
# running beside phases 4, 5, 8 and 9 in the main process: every phase
# after 3 is host-bound (the card idle 91-98% of a traced window,
# PERF.md §5), so they share the card and the host's cores.  Each child
# reads its own sweep-kernel counts around its phase.
CHILD_FLAG = "--phase-child"
CHILD_GROUPS = (("6",), ("7",), ("10", "salt-hx", "isp", "isp-init", "isp-analysis"),
                ("10", "mp-eval", "usc-bid-track", "mp-usc"),
                ("11",), ("12",), ("13",))
# started one after another once every group above has ended.  Phase 14's
# [net] holds each RPC to a 30 s deadline: beside the groups above (whose
# host threads share 8 cores, and put phase 13's real-clock soak into its
# one-request-per-batch mode) its flush p99 reached 23.0 s on the parent
# tree and past 30 s on this one, on one H100; alone it stays far inside.
# Phase 15 comes last: its double loop is one more busy CUDA context.
LATE_CHILD_GROUPS = (("14",), ("15",))
CHILD_THREADS = "2"        # BLAS and torch threads per child (8 host cores in all)
WHOLE_RUN_S = 1140.0       # the run fails itself past this, inside the 1,200 s limit


def whole_run_phase(torch, dev, phase, parts=()):
    """Phase 6, 7, 10, 11 (``parts`` of it), 12, 13, 14 or 15 at the whole run's depth."""
    if phase == "15":
        phase_analysis(torch, dev)
    elif phase == "14":
        phase_fleet(torch, dev)
    elif phase == "13":
        phase_obs(torch, dev)
    elif phase == "12":
        phase_mesh(torch, dev)
    elif phase == "6":
        phase_hydrogen(torch, dev, pem_batch_model(torch, dev))
    elif phase == "7":
        phase_double_loop(torch, dev)
    elif phase == "10":
        phase_storage(torch, dev, parts=parts)
    else:
        phase_designs(torch, dev, parts=parts or DESIGN_PARTS)


def phase_child(torch, parent, phase, parts):
    """A child process of the whole run: it dies with its parent
    (PR_SET_PDEATHSIG), and drives one group of ``CHILD_GROUPS`` or
    ``LATE_CHILD_GROUPS``."""
    import ctypes
    import signal

    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    if os.getppid() != parent:
        fail(f"[child {phase}] its parent {parent} is gone")
    full_precision(torch)
    whole_run_phase(torch, torch.device("cuda"), phase, parts)


def start_children(groups=CHILD_GROUPS):
    """Start every group of ``groups``, its standard output and error
    into files under build/ (echoed when the child is joined)."""
    import tempfile

    (ROOT / "build").mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONUNBUFFERED="1", OMP_NUM_THREADS=CHILD_THREADS,
               MKL_NUM_THREADS=CHILD_THREADS, OPENBLAS_NUM_THREADS=CHILD_THREADS)
    children = []
    for group in groups:
        out = tempfile.TemporaryFile("w+", dir=ROOT / "build")
        err = tempfile.TemporaryFile("w+", dir=ROOT / "build")
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), CHILD_FLAG, str(os.getpid()),
             *group], stdout=out, stderr=err, env=env, cwd=ROOT)
        children.append((group, proc, out, err, time.perf_counter()))
    print(f"[children] started {len(children)}: "
          + "; ".join(" ".join(g) for g in groups))
    return children


def join_children(children, t_start):
    """Wait for each child (until ``WHOLE_RUN_S`` after ``t_start``), echo
    its output, and fail if one failed or is still running."""
    for group, proc, out, err, t0 in children:
        name = " ".join(group)
        try:
            rc = proc.wait(timeout=max(1.0, t_start + WHOLE_RUN_S - time.perf_counter()))
        except subprocess.TimeoutExpired:
            rc = None
            proc.kill()
            proc.wait()
        out.seek(0)
        sys.stdout.write(out.read())
        err.seek(0)
        sys.stderr.write(err.read())
        sys.stdout.flush()
        sys.stderr.flush()
        print(f"[child {name}] exit {rc}; started at {t0 - t_start:.1f} s of the run, joined at "
              f"{time.perf_counter() - t_start:.1f} s")
        check(rc is not None, f"[child {name}] still running {WHOLE_RUN_S:.0f} s into the run")
        check(rc == 0, f"[child {name}] failed (exit {rc})")


def stop_children(children):
    for _, proc, out, err, _ in children:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
        err.close()


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    if not (ROOT / "dispatches_tpu_torch").is_dir():
        fail("dispatches_tpu_torch/ is not beside chip_smoke.py")
    sys.path.insert(0, str(ROOT))

    if sys.argv[1:2] == [CRASH_FLAG]:
        crash_child(sys.argv[2])  # [crash]'s child: exits with CRASH_RC
    if sys.argv[1:2] == [CHILD_FLAG]:
        phase_child(torch, int(sys.argv[2]), sys.argv[3], sys.argv[4:])
        return
    alone = {"6": lambda dev: whole_run_phase(torch, dev, "6"),
             "7": lambda dev: phase_double_loop(torch, dev, only=True),
             "8": lambda dev: phase_sweep(torch, dev, flagship(torch, dev)),
             "9": lambda dev: phase_fossil_serve(torch, dev, flagship(torch, dev)),
             "10": lambda dev: phase_storage(torch, dev, only=True,
                                             parts=sys.argv[3:] or STORAGE_PARTS),
             "11": lambda dev: phase_designs(torch, dev, only=True,
                                             parts=sys.argv[3:] or DESIGN_PARTS),
             "12": lambda dev: phase_mesh(torch, dev),
             "13": lambda dev: phase_obs(torch, dev),
             "14": lambda dev: phase_fleet(torch, dev),
             "15": lambda dev: phase_analysis(torch, dev)}
    if sys.argv[1:2] == ["--only-phase"]:
        # a development run of one phase alone: no kernel build, no result
        # line; phases 10 and 11 take a list of their parts, and phase 11's
        # discharge-study the sources it is restricted to
        from dispatches_tpu_torch.case_studies.fossil.storage_discharge_design import SOURCES

        part_names = {"10": STORAGE_PARTS, "11": DESIGN_PARTS + SOURCES}
        parts = set(sys.argv[3:])
        if sys.argv[2:3] not in [[n] for n in alone] or (
                parts and (sys.argv[2] not in part_names
                           or parts - set(part_names[sys.argv[2]])
                           or (parts & set(SOURCES) and "discharge-study" not in parts))):
            fail(f"--only-phase takes one of {', '.join(alone)}; 10 also takes parts of "
                 f"{', '.join(STORAGE_PARTS)}; 11 of {', '.join(DESIGN_PARTS)} (and, with "
                 f"discharge-study, sources of {', '.join(SOURCES)})")
        phase_device_info(torch)
        alone[sys.argv[2]](torch.device("cuda"))
        print(f"[only-phase {sys.argv[2]}] done (no result line: not the smoke test's full run)")
        return
    t_start = time.perf_counter()
    card = phase_device(torch)
    # the main path runs first, so its launch counts start from zero
    # before any comparison launch
    dev = torch.device("cuda")
    main_run, launches = phase_main_path(torch, dev)
    # the PEM price-taker's LP (an IPM design solve; no sweep launch):
    # phase 3 holds the kernels on its operator, phase 6 solves it
    pem = pem_batch_model(torch, dev)
    report = phase_kernels(torch, main_run["lp"], dev, pem["lp"])
    # phase 3's timings are taken alone on the card; from here on the
    # children's phases run beside this process's
    children = start_children()
    try:
        entry_run = phase_ipm_path(torch, dev, main_run)
        phase_serve_path(torch, dev, main_run, entry_run)
        phase_sweep(torch, dev, main_run)
        phase_fossil_serve(torch, dev, main_run)
        print(f"[main] phases 1-5, 8 and 9 done at {time.perf_counter() - t_start:.1f} s")
        join_children(children, t_start)
        for group in LATE_CHILD_GROUPS:
            late = start_children((group,))
            children += late
            join_children(late, t_start)
    finally:
        stop_children(children)
    print(f"[whole] {time.perf_counter() - t_start:.1f} s")

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
