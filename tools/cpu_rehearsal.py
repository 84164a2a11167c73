#!/usr/bin/env python3
"""Rehearse phases 6, 7 and 8 of ``chip_smoke.py`` on the CPU, and count
the operations their solver iterations dispatch.

    python3 tools/cpu_rehearsal.py ops [--horizon 24]
    python3 tools/cpu_rehearsal.py phase6 [units] [pem] [batch] [hybrid]
    python3 tools/cpu_rehearsal.py ops7 [--buses 73]
    python3 tools/cpu_rehearsal.py phase7 [--buses 5]
    python3 tools/cpu_rehearsal.py phase8 [--ops-only]

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

``ops7`` counts the same for the double loop's hourly solves on the
synthetic case of ``--buses`` buses (73: phase 7's size): the SCED LP
(H = 4), the Bidder's real-time stacked program (H = 4, 3 scenarios) and
the Tracker (H = 4).  ``phase7`` runs phase 7 on the CPU on the synthetic
case of ``--buses`` buses (5: the tier-1 tests' size; the card runs 73),
the trace replaced by a plain call.

``phase8`` counts the aten operations of phase 8's sweep: per PDLP check
interval of a 128-lane chunk of the sweep's points (the difference between
``max_iter=120`` and ``max_iter=40``, halved) and per IRR Newton step
(``iters=3`` against ``iters=1``); then, unless ``--ops-only``, it runs
phase 8 on the CPU at the card's sizes (732 points, chunks of 128) and
prints the phase's own lines, seconds per chunk among them.
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


def _stub_cuda():
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.memory_allocated = lambda *a, **k: 0


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
    _stub_cuda()
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


def _synthetic(buses, work):
    sizes = {5: (5, 7, 5, 2), 73: (73, 120, 73, 81)}[buses]
    return cs.write_synthetic_rts(Path(work) / f"rts{buses}", *sizes, seed=cs.DL_SEED)


def count_ops7(buses):
    import tempfile

    from dispatches_tpu_torch.case_studies.renewables.wind_battery_double_loop import (
        MultiPeriodWindBattery,
    )
    from dispatches_tpu_torch.grid import Bidder, ThermalGeneratorModelData, Tracker
    from dispatches_tpu_torch.grid.market import _DispatchLP, load_rts_gmlc_case

    with tempfile.TemporaryDirectory() as work:
        case = load_rts_gmlc_case(_synthetic(buses, work))
    lp = _DispatchLP(case, 4, "4_WIND", "4", device=CPU)
    u = np.ones((4, len(lp.th)))
    bids = {t: {"4_WIND": {"p_cost": [(0.0, 0.0), (60.0, 600.0), (120.0, 2400.0)]}}
            for t in range(4)}
    p = lp.params_for(np.arange(12, 16), u, rt=True, participant_bids=bids)
    print(f"SCED LP ({buses} buses, H=4, n={lp.nlp.n}, m_ineq={lp.nlp.m_ineq}): "
          f"{ops_per_iteration(lp.nlp, p, 'dense'):.1f} operations per Newton iteration")
    md = ThermalGeneratorModelData(gen_name="4_WIND", bus="4", p_min=0.0, p_max=120.0)

    def mp():
        return MultiPeriodWindBattery(model_data=md, wind_capacity_factors=np.full(96, 0.5),
                                      wind_pmax_mw=120.0, battery_pmax_mw=15.0,
                                      battery_energy_capacity_mwh=60.0)

    class Fixed:
        def forecast_day_ahead_prices(self, date, hour, bus, horizon, n):
            return 20.0 + 5.0 * np.random.default_rng(0).random((n, horizon))

        forecast_real_time_prices = forecast_day_ahead_prices

    bidder = Bidder(bidding_model_object=mp(), day_ahead_horizon=48, real_time_horizon=4,
                    n_scenario=3, forecaster=Fixed(), device=CPU)
    blk = bidder.real_time_model
    sp = blk.stacked.default_params()
    sp["p"]["energy_price"] = Fixed().forecast_day_ahead_prices(None, 0, None, 4, 3)
    print(f"RT bid stacked program (H=4, S=3, n={blk.stacked.n}): "
          f"{ops_per_iteration(blk.stacked, sp, 'auto'):.1f} operations per Newton iteration")
    tr = Tracker(tracking_model_object=mp(), tracking_horizon=4, device=CPU)
    tr.model.m.fs.params["market_dispatch"] = np.full(4, 60.0)
    print(f"Tracker (H=4, n={tr.nlp.n}): "
          f"{ops_per_iteration(tr.nlp, tr.nlp.default_params(), 'auto'):.1f} "
          "operations per Newton iteration")


def phase7(buses):
    import tempfile

    _stub_cuda()
    failed = []

    def check(cond, msg):
        if not cond:
            print(f"check failed: {msg}")
            failed.append(msg)

    cs.check = check
    cs.profile_run = lambda torch_, run, tag: (run(), None, {}, 0.0, 0.0)
    sizes = {5: (5, 7, 5, 2), 73: (73, 120, 73, 81)}[buses]
    cs.DL_BUSES, cs.DL_BRANCHES, cs.DL_THERMAL, cs.DL_RENEWABLE = sizes
    cs.ne_price_taker(torch, CPU)
    with tempfile.TemporaryDirectory() as work:
        rec, case = cs.double_loop(torch, CPU, Path(work))
        cs.market_checks(torch, CPU, rec, case)
        cs.bid_batch(torch, CPU, case)
        cs.dl_trace(torch, rec)
    print(f"{len(failed)} check(s) failed")


def count_ops8():
    from dispatches_tpu_torch.solvers import PDLPOptions, make_pdlp_solver
    from dispatches_tpu_torch.utils import irr

    run = cs.flagship(torch, CPU)
    nlp, spec = run["nlp"], cs._sweep_spec(run["lmps"])
    vals = spec.values_for(np.arange(cs.SWEEP_CHUNK))
    d = nlp.default_params()
    params = {"p": {**d["p"], "lmp": vals["lmp"]},
              "fixed": {**d["fixed"], "battery.nameplate_power": vals["battery.nameplate_power"]}}
    counts = {}
    for it in (40, 120):
        solver = make_pdlp_solver(nlp, PDLPOptions(max_iter=it, **cs.SWEEP_PDLP),
                                  lp_data=run["lp"], device=CPU)
        mode = _OpCount()
        with mode:
            solver(params)
        counts[it] = mode.n
    print(f"PDLP f64, {cs.SWEEP_CHUNK} lanes: {(counts[120] - counts[40]) / 2:.1f} "
          "operations per check interval (40 PDHG steps)")
    cash = np.array([-1000.0] + [150.0] * 10)
    counts = {}
    for it in (1, 3):
        mode = _OpCount()
        with mode:
            irr(cash, iters=it, device=CPU)
        counts[it] = mode.n
    print(f"irr: {(counts[3] - counts[1]) / 2:.1f} operations per Newton step")


def phase8():
    import tempfile

    _stub_cuda()
    failed = []

    def check(cond, msg):
        if not cond:
            print(f"check failed: {msg}")
            failed.append(msg)

    cs.check = check
    cs.profile_run = lambda torch_, run, tag: (run(), None, {}, 0.0, 0.0)
    run = cs.flagship(torch, CPU)
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        store = cs.sweep_direct(torch, CPU, run, work)
        cs.sweep_resume(torch, CPU, run, work, store)
        cs.sweep_serve(torch, CPU, run, work, store)
        cs.sweep_report(torch, store)
        cs.surrogates(torch, CPU, store)
        cs.clustering(torch, CPU, run)
        cs.cashflows(torch, CPU)
    print(f"{len(failed)} check(s) failed")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    ops = sub.add_parser("ops", help="operations per IPM Newton iteration")
    ops.add_argument("--horizon", type=int, default=cs.H2_T)
    ph = sub.add_parser("phase6", help="chip_smoke.py phase 6 on the CPU")
    ph.add_argument("parts", nargs="*", default=["units", "pem", "batch", "hybrid"],
                    choices=["units", "pem", "batch", "hybrid"])
    o7 = sub.add_parser("ops7", help="operations per Newton iteration of the hourly solves")
    o7.add_argument("--buses", type=int, default=73, choices=[5, 73])
    p7 = sub.add_parser("phase7", help="chip_smoke.py phase 7 on the CPU")
    p7.add_argument("--buses", type=int, default=5, choices=[5, 73])
    p8 = sub.add_parser("phase8", help="chip_smoke.py phase 8 on the CPU")
    p8.add_argument("--ops-only", action="store_true",
                    help="only count operations per PDLP check and IRR step")
    args = ap.parse_args(argv)
    if args.cmd == "phase8":
        count_ops8()
        if not args.ops_only:
            phase8()
    elif args.cmd == "ops":
        count_ops(args.horizon)
    elif args.cmd == "ops7":
        count_ops7(args.buses)
    elif args.cmd == "phase7":
        phase7(args.buses)
    else:
        phase6(args.parts)


if __name__ == "__main__":
    main()
