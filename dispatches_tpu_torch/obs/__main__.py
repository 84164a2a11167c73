"""CLI for the observability layer (counterpart of
``dispatches_tpu/obs/__main__.py``: the same flags and JSON keys, plus
``--device``, where the demo workloads and the soak run; ``cuda`` unless
given).

::

    # run the built-in demo workload with tracing on, print the rollup
    python -m dispatches_tpu_torch.obs --report
    python -m dispatches_tpu_torch.obs --report --json

    # also write the Chrome trace (open in https://ui.perfetto.dev)
    python -m dispatches_tpu_torch.obs --report --export-trace /tmp/trace.json

    # aggregate a previously exported trace file instead of running
    python -m dispatches_tpu_torch.obs --report --trace-file /tmp/trace.json

    # perf ledger: render the trend, or gate on regressions (exits
    # non-zero when the latest record regressed beyond tolerance)
    python -m dispatches_tpu_torch.obs --ledger [--json] [--ledger-dir DIR]
    python -m dispatches_tpu_torch.obs --check-regressions [--ledger-dir DIR]

    # SLO attainment + burn from the registry quantiles (--check exits
    # non-zero when an objective with data is violated)
    python -m dispatches_tpu_torch.obs --slo [--json] [--slo-spec PATH] [--check]

    # flight-recorder bundles (DISPATCHES_TPU_OBS_FLIGHT_DIR)
    python -m dispatches_tpu_torch.obs --flight [--json] [--flight-dir DIR]

    # execution-plan pipeline timeline: overlap efficiency, inflight
    # occupancy, stall attribution (runs a dispatch-ahead plan demo, or
    # reconstructs from a saved trace)
    python -m dispatches_tpu_torch.obs --timeline [--json] [--trace-file PATH]

    # registry as Prometheus text exposition (obs.export)
    python -m dispatches_tpu_torch.obs --prom

    # soak harness: replay a deterministic traffic spec against a
    # SolveService in virtual time, grade SLO burn rates continuously,
    # dump flight bundles on alerts, write soak_report.json
    python -m dispatches_tpu_torch.obs --soak [--json] [--spec FILE]
        [--duration S] [--real] [--out DIR]

The demo workload is a small batch-serve session (the same battery
arbitrage LP the serve CLI uses) with obs force-enabled, so the report
exercises the real instrumentation: serve batch spans, program-build
``compile`` instants, and the registry counters they feed.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from dispatches_tpu_torch.obs import registry, report, trace


def _demo_workload(device=None) -> None:
    """Tiny serve session under forced tracing (2 requests, T=4) on
    ``device`` (``cuda`` unless given)."""
    import numpy as np

    from dispatches_tpu_torch.serve import ServeOptions, SolveService
    from dispatches_tpu_torch.serve.__main__ import _arbitrage_nlp

    service = SolveService(ServeOptions(max_batch=2, max_wait_ms=1e9),
                           device=device)
    nlp = _arbitrage_nlp(4)
    defaults = nlp.default_params()
    rng = np.random.default_rng(0)
    handles = []
    for _ in range(2):
        price = 30.0 + 10.0 * rng.standard_normal(4)
        params = {"p": {**defaults["p"], "price": price},
                  "fixed": defaults["fixed"]}
        handles.append(service.submit(nlp, params, solver="pdlp"))
    service.flush_all()
    for h in handles:
        h.result()


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m dispatches_tpu_torch.obs",
        description="tracing/metrics report for dispatches_tpu_torch",
    )
    parser.add_argument("--report", action="store_true",
                        help="print the span/metrics rollup")
    parser.add_argument("--json", action="store_true",
                        help="emit the report as JSON instead of text")
    parser.add_argument("--export-trace", metavar="PATH",
                        help="write buffered events as Chrome trace JSON")
    parser.add_argument("--trace-file", metavar="PATH",
                        help="aggregate an exported trace file instead of "
                             "running the demo workload")
    parser.add_argument("--ledger", action="store_true",
                        help="render the perf-ledger trend")
    parser.add_argument("--check-regressions", action="store_true",
                        help="gate the latest ledger record against the "
                             "trailing-window median; exit 1 on regression "
                             "(soft-pass while a group has <3 records)")
    parser.add_argument("--ledger-dir", metavar="DIR", default=None,
                        help="ledger directory (default: the "
                             "DISPATCHES_TPU_OBS_LEDGER_DIR flag, then "
                             "./perf_ledger)")
    parser.add_argument("--window", type=int, default=None, metavar="N",
                        help="trailing-window length for the gate")
    parser.add_argument("--tol", type=float, default=None,
                        help="regression tolerance fraction (default: the "
                             "DISPATCHES_TPU_OBS_LEDGER_TOL flag, then 0.3)")
    parser.add_argument("--slo", action="store_true",
                        help="grade SLO objectives from the registry "
                             "quantiles (runs the demo workload when the "
                             "live registry has no serve data)")
    parser.add_argument("--slo-spec", metavar="PATH", default=None,
                        help="SLO spec JSON (default: the "
                             "DISPATCHES_TPU_OBS_SLO flag, then the "
                             "built-in example objectives)")
    parser.add_argument("--metrics-file", metavar="PATH", default=None,
                        help="with --slo: grade a saved registry snapshot "
                             "JSON instead of the live process")
    parser.add_argument("--check", action="store_true",
                        help="with --slo: exit 1 when any objective with "
                             "data is violated (no-data objectives "
                             "soft-pass)")
    parser.add_argument("--flight", action="store_true",
                        help="list flight-recorder bundles (--json dumps "
                             "their full contents)")
    parser.add_argument("--flight-dir", metavar="DIR", default=None,
                        help="bundle directory (default: the "
                             "DISPATCHES_TPU_OBS_FLIGHT_DIR flag)")
    parser.add_argument("--timeline", action="store_true",
                        help="reconstruct the execution-plan pipeline "
                             "timeline (overlap efficiency, inflight "
                             "occupancy, stall attribution) from a "
                             "dispatch-ahead demo run or --trace-file")
    parser.add_argument("--prom", action="store_true",
                        help="print the metrics registry as Prometheus "
                             "text exposition (runs the demo workload "
                             "when the registry is empty)")
    parser.add_argument("--soak", action="store_true",
                        help="replay a traffic spec against a stub "
                             "SolveService, grade SLO burn rates, and "
                             "write a soak report (virtual-time by "
                             "default)")
    parser.add_argument("--spec", metavar="PATH", default=None,
                        help="with --soak: soak spec JSON (default: the "
                             "DISPATCHES_TPU_SOAK_SPEC flag, then the "
                             "built-in spec)")
    parser.add_argument("--duration", type=float, default=None,
                        metavar="S",
                        help="with --soak: override the traffic "
                             "duration in (virtual) seconds")
    parser.add_argument("--real", action="store_true",
                        help="with --soak: run on the real clock "
                             "instead of virtual time")
    parser.add_argument("--out", metavar="DIR", default=None,
                        help="with --soak: directory for "
                             "soak_report.json and exporter records "
                             "(default: the DISPATCHES_TPU_SOAK_"
                             "REPORT_DIR flag, then stdout only)")
    parser.add_argument("--device", default=None,
                        help="device the demo workloads and the soak run "
                             "on (default: cuda)")
    args = parser.parse_args(argv)

    if args.soak:
        return _soak_main(args)

    if args.ledger or args.check_regressions:
        return _ledger_main(args)
    if args.slo:
        return _slo_main(args)
    if args.flight:
        return _flight_main(args)
    if args.timeline:
        return _timeline_main(args)
    if args.prom:
        return _prom_main(args)

    if not (args.report or args.export_trace):
        parser.print_help()
        return 2

    if args.trace_file:
        events = report.load_chrome_trace(args.trace_file)
        snapshot = None
    else:
        trace.enable(True)
        _demo_workload(args.device)
        events = trace.events()
        snapshot = registry.default_registry().snapshot()

    if args.export_trace:
        from dispatches_tpu_torch.obs import timeline as _timeline

        # counter tracks: Perfetto draws the in-flight depth of every
        # plan in the trace as a lane under the spans
        merged = list(events) + _timeline.counter_events(events)
        n = trace.export_chrome_trace(args.export_trace, merged)
        print(f"wrote {n} event(s) to {args.export_trace}", file=sys.stderr)
        if trace.dropped():
            print(f"WARNING: {trace.dropped()} event(s) were evicted from "
                  "the ring buffer — the exported trace is truncated "
                  "(raise DISPATCHES_TPU_OBS_BUFFER)", file=sys.stderr)

    if args.report:
        if args.json:
            payload = {
                "spans": report.aggregate_spans(events),
                "metrics": snapshot or {},
                "events_buffered": len(events),
                "events_dropped": trace.dropped(),
            }
            print(json.dumps(payload, indent=2, sort_keys=True))
        else:
            print(report.format_report(events, snapshot,
                                       dropped=trace.dropped()), end="")
    return 0


def _plan_demo_workload(device=None) -> None:
    """Dispatch-ahead plan session under forced tracing: one
    ExecutionPlan (inflight=2) on ``device`` staging and submitting 6
    small batches of a toy iterative kernel back-to-back, then draining
    — the smallest run that produces a meaningful pipeline timeline."""
    import numpy as np
    import torch

    from dispatches_tpu_torch.plan import ExecutionPlan, PlanOptions

    plan = ExecutionPlan(PlanOptions(inflight=2, mesh=None, donate=False,
                                     device=device))

    def fn(x):
        for _ in range(16):
            x = torch.tanh(x) * 1.01 + 0.05
        return x

    program = plan.program(fn, label="obs.timeline_demo", donate=False)
    lanes = 8
    for i in range(6):
        batch = np.full((lanes, 256), 0.1 * (i + 1), dtype=np.float32)
        staged = plan.stage(batch, lanes=lanes, donate=False)
        plan.submit(program, (staged,), n_live=lanes, lanes=lanes)
    plan.drain()


def _timeline_main(args) -> int:
    from dispatches_tpu_torch.obs import timeline

    if args.trace_file:
        events = report.load_chrome_trace(args.trace_file)
    else:
        trace.enable(True)
        _plan_demo_workload(args.device)
        events = trace.events()
    tl = timeline.build_timeline(events)
    if args.export_trace:
        merged = list(events) + timeline.counter_events(events)
        n = trace.export_chrome_trace(args.export_trace, merged)
        print(f"wrote {n} event(s) to {args.export_trace}",
              file=sys.stderr)
    if args.json:
        print(json.dumps({"timeline": tl}, indent=2, sort_keys=True))
    else:
        print(timeline.format_timeline(tl), end="")
    return 0


def _prom_main(args) -> int:
    from dispatches_tpu_torch.obs import export as obs_export

    if not registry.default_registry().metrics():
        # cold process: populate the registry with a real (small) run
        trace.enable(True)
        _demo_workload(args.device)
    sys.stdout.write(obs_export.render_prometheus())
    return 0


def _slo_main(args) -> int:
    from dispatches_tpu_torch.obs import slo

    spec = slo.load_spec(args.slo_spec)
    if args.metrics_file:
        with open(args.metrics_file) as f:
            snapshot = json.load(f)
    else:
        snapshot = registry.default_registry().snapshot()
        if "serve.latency_ms" not in snapshot:
            # cold process: grade a real (small) serve run, like --report
            trace.enable(True)
            _demo_workload(args.device)
            snapshot = registry.default_registry().snapshot()
    rows = slo.evaluate(spec, snapshot)
    bad = slo.violations(rows)
    if args.json:
        print(json.dumps({"spec": spec.name, "results": rows,
                          "ok": not bad}, indent=2, sort_keys=True))
    else:
        print(slo.format_results(spec, rows))
    return 1 if (args.check and bad) else 0


def _flight_main(args) -> int:
    from dispatches_tpu_torch.obs import flight

    directory = args.flight_dir
    found = flight.bundles(directory, full=args.json)
    if args.json:
        print(json.dumps({"bundles": found}, indent=2, sort_keys=True,
                         default=str))
    else:
        if not found:
            print("no flight bundles"
                  + (f" in {directory}" if directory else
                     " (set DISPATCHES_TPU_OBS_FLIGHT_DIR or "
                     "--flight-dir)"))
        for b in found:
            rid = b.get("request_id")
            print(f"{b['path']}: {b['kind']}"
                  + (f" request_id={rid}" if rid is not None else "")
                  + (f" bucket={b['bucket']}" if b.get("bucket") else ""))
    return 0


def _soak_main(args) -> int:
    import os

    from dispatches_tpu_torch.analysis.flags import flag_name
    from dispatches_tpu_torch.obs import soak

    spec_path = args.spec or os.environ.get(flag_name("SOAK_SPEC")) \
        or None
    overrides = None
    duration = args.duration
    if duration is None:
        env_dur = os.environ.get(flag_name("SOAK_DURATION_S"), "")
        if env_dur:
            try:
                duration = float(env_dur)
            except ValueError:
                duration = None
    if duration is not None:
        overrides = {"traffic": {"duration_s": float(duration)}}
    out_dir = args.out or os.environ.get(
        flag_name("SOAK_REPORT_DIR")) or None
    spec = soak.load_soak_spec(spec_path, overrides=overrides)
    report_ = soak.run_soak(spec, virtual=not args.real,
                            out_dir=out_dir,
                            flight_dir=args.flight_dir or None,
                            device=args.device)
    if args.json:
        print(json.dumps(report_, indent=2, sort_keys=True,
                         default=str))
    else:
        print(soak.format_soak_report(report_), end="")
    return 0


def _ledger_main(args) -> int:
    from dispatches_tpu_torch.obs import ledger

    records = ledger.load(args.ledger_dir)
    rc = 0
    if args.ledger:
        if args.json:
            print(json.dumps({"records": records},
                             indent=2, sort_keys=True))
        else:
            print(ledger.format_trend(records), end="")
    if args.check_regressions:
        kw = {}
        if args.window is not None:
            kw["window"] = args.window
        result = ledger.check_regressions(records, tol=args.tol, **kw)
        if args.json and not args.ledger:
            print(json.dumps(result, indent=2, sort_keys=True))
        else:
            print(ledger.format_check(result), end="")
        rc = 0 if result["ok"] else 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
