#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py``'s hydrogen-hybrid phase on the CPU, and count
the work one interior-point Newton iteration dispatches.

    python3 tools/cpu_rehearsal.py ops [--horizon 24]
    python3 tools/cpu_rehearsal.py phase6 [units] [pem] [batch] [hybrid]

``ops`` counts the aten operations that one Newton iteration of the IPM
dispatches (the difference between ``max_iter=3`` and ``max_iter=1``,
halved), for phase 4's flagship LP at 8 lanes and for the full hybrid on
both KKT paths.  On the card nearly every such operation is one kernel
launch, so the counts stand in for launches per iteration before a card
run measures them.  ``phase6`` runs phase 6's functions on the CPU with
the CUDA synchronisation calls stubbed: control flow, iteration counts
and accuracy, never a device time.  The sweep kernels take their plain
versions on the CPU and count no launch, so ``[pem-pdlp]``'s launch check
fails here by design; failed checks are printed, not fatal.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

CPU = torch.device("cpu")


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def ops_per_iteration(nlp, params, kkt):
    from dispatches_tpu_torch.solvers import IPMOptions, make_ipm_solver

    counts = {}
    for it in (1, 3):
        solver = make_ipm_solver(nlp, IPMOptions(max_iter=it, kkt=kkt), device=CPU)
        mode = _OpCount()
        with mode:
            solver(params)
        counts[it] = mode.n
    return (counts[3] - counts[1]) / 2


def count_ops(horizon):
    from dispatches_tpu_torch.case_studies.renewables import (
        wind_battery_pem_tank_turb_nlp,
        wind_battery_pricetaker_nlp,
    )

    lmps, cfs = cs.scenarios(8, np.random.default_rng(0))
    _, flag = wind_battery_pricetaker_nlp(cs.T, {
        "wind_mw": cs.WIND_MW, "batt_mw": cs.BATT_MW, "design_opt": False,
        "extant_wind": True, "capacity_factors": cfs[0], "DA_LMPs": lmps[0]})
    d = flag.default_params()
    params = {"p": {**d["p"], "lmp": torch.as_tensor(lmps * 1e-3),
                    "windpower.capacity_factor": torch.as_tensor(cfs)}, "fixed": d["fixed"]}
    print(f"flagship LP (8 lanes, kkt=auto): {ops_per_iteration(flag, params, 'auto'):.1f} "
          "operations per Newton iteration")
    _, hyb = wind_battery_pem_tank_turb_nlp(horizon, cs._h2_params(horizon))
    for kkt in ("structured", "dense"):
        print(f"full hybrid T={horizon} (n={hyb.n}, kkt={kkt}): "
              f"{ops_per_iteration(hyb, hyb.default_params(), kkt):.1f} "
              "operations per Newton iteration")


def phase6(parts):
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    failed = []

    def check(cond, msg):
        if not cond:
            print(f"check failed: {msg}")
            failed.append(msg)

    cs.check = check
    if "units" in parts:
        cs.h2_units(torch, CPU)
    if "pem" in parts:
        cs.pem_optimize(torch, CPU)
    if "batch" in parts:
        pem = cs.pem_batch_model(torch, CPU)
        cs.pem_batch(torch, CPU, pem)
        cs.pem_pdlp(torch, CPU, pem)
    if "hybrid" in parts:
        cs.hybrid_paths(torch, CPU, cs.hybrid(torch, CPU))
    print(f"{len(failed)} check(s) failed")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    ops = sub.add_parser("ops", help="operations per IPM Newton iteration")
    ops.add_argument("--horizon", type=int, default=cs.H2_T)
    ph = sub.add_parser("phase6", help="chip_smoke.py phase 6 on the CPU")
    ph.add_argument("parts", nargs="*", default=["units", "pem", "batch", "hybrid"],
                    choices=["units", "pem", "batch", "hybrid"])
    args = ap.parse_args(argv)
    if args.cmd == "ops":
        count_ops(args.horizon)
    else:
        phase6(args.parts)


if __name__ == "__main__":
    main()
