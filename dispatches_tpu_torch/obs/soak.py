"""Soak harness: replay a traffic spec against a ``SolveService`` with
streaming SLO grading, burn-rate alerting, and online stall attribution
(counterpart of ``dispatches_tpu/obs/soak.py``).

What do p99, the error budget, and the pipeline stall split look like
after *hours of churn*?  This module answers it without needing hours:
the whole replay runs on the service's injectable clock, so virtual
time is advanced request-to-request and a test replays thousands of
requests in seconds of wall time, while the real-clock mode runs the
same spec on ``time.monotonic`` against the real solver on the card.

One ``run_soak(spec)`` call wires the whole streaming stack together:

* ``serve.traffic`` generates the deterministic open-loop request
  stream (arrival process + correlated parameter perturbations);
* per-request latency / queue-wait observations tee into
  ``obs.online`` P² estimators, burn-rate monitors built over
  ``obs.slo`` objectives, and KS drift detectors (latency and
  ``pdhg_iters``);
* plan lifecycle spans stream into the incremental
  :class:`~dispatches_tpu_torch.obs.online.TimelineAccumulator` via
  ``trace.add_sink`` — live overlap/stall gauges with no post-hoc scan;
* burn-rate alerts fire the flight recorder (``burn_rate`` kind, so
  the per-kind cooldown coalesces a sustained violation into one
  bundle) and the ``ContinuousExporter`` ticks on the same clock;
* the ``faults`` section arms a chaos scenario over a window of the
  replay, with load shedding; the ``restart`` section kills the service
  without drain and rebuilds it from its journal and snapshot;
* the result is a schema-stable soak report (``SOAK_SCHEMA``) whose
  headline ``soak_p99_ms`` / ``slo_burn_max`` feed the perf ledger.

In virtual mode the service *execution* time is modeled
(:class:`ServiceTimeModel`: base + per-lane cost + seeded jitter, with
spike windows for alert-path tests) by a plan subclass that advances
the fake clock inside the fence — the device still runs the (tiny)
stub program, but the latency distribution the SLOs grade is the
model's, deterministic and hours-compressible: every field that is a
function of virtual time and the seed equals the JAX package's report
on the same spec.

The replay runs on ``device`` (``cuda`` unless the caller asks for the
CPU).  The spec's ``fleet`` section replays against a
:class:`~dispatches_tpu_torch.fleet.FleetRouter` over several services,
each on its own modeled busy timeline, with kill windows failed over by
the router's heartbeat timeout.

CLI: ``python -m dispatches_tpu_torch.obs --soak [--json] [--spec FILE]
[--duration S] [--real] [--out DIR] [--device DEV]``.
"""

from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

from dispatches_tpu_torch.faults import inject as _faults
from dispatches_tpu_torch.obs import flight as obs_flight
from dispatches_tpu_torch.obs import online
from dispatches_tpu_torch.obs import registry as obs_registry
from dispatches_tpu_torch.obs import slo as obs_slo
from dispatches_tpu_torch.obs import trace as obs_trace

__all__ = [
    "SOAK_SCHEMA",
    "DEFAULT_SPEC",
    "FakeClock",
    "ServiceTimeModel",
    "StubNLP",
    "make_stub_solver",
    "load_soak_spec",
    "run_soak",
    "format_soak_report",
]

SOAK_SCHEMA = 1


class FakeClock:
    """Monotone virtual clock (seconds); the soak driver advances it,
    the service/plan/exporter/flight-cooldown all read it."""

    __slots__ = ("t",)

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        if dt > 0:
            self.t += float(dt)

    def advance_to(self, t: float) -> None:
        if t > self.t:
            self.t = float(t)


@dataclass(frozen=True)
class ServiceTimeModel:
    """Virtual per-batch execution time: ``base_ms + per_lane_ms *
    lanes`` plus exponential jitter, multiplied by ``factor`` inside
    any ``(t0_s, t1_s, factor)`` spike window (measured on the virtual
    clock) — spikes are how tests inject an SLO violation."""

    base_ms: float = 2.0
    per_lane_ms: float = 0.25
    jitter_ms: float = 0.5
    seed: int = 0
    spikes: Tuple[Tuple[float, float, float], ...] = ()

    def sampler(self, clock: Callable[[], float]):
        import numpy as np

        rng = np.random.default_rng(self.seed + 0x50AC)

        def service_time_s(ticket) -> float:
            ms = self.base_ms + self.per_lane_ms * float(ticket.lanes)
            if self.jitter_ms > 0:
                ms += float(rng.exponential(self.jitter_ms))
            now = clock()
            for t0, t1, factor in self.spikes:
                if t0 <= now < t1:
                    ms *= factor
            return ms / 1e3

        return service_time_s


def _soak_plan(options, clock: FakeClock, service_time_s):
    """An ``ExecutionPlan`` whose fence advances the virtual clock by
    the modeled execution time of the batch being completed — so
    fence-time latency accounting sees queue wait + modeled service
    time instead of the stub kernel's microseconds."""
    from dispatches_tpu_torch.plan.execution import ExecutionPlan

    class _SoakPlan(ExecutionPlan):
        def _complete_oldest(self):
            if self._window:
                clock.advance(service_time_s(self._window[0]))
            return super()._complete_oldest()

    # the plan reads the virtual clock too: the fence watchdog
    # (PlanOptions.fence_timeout_ms) and injected hang_s faults both
    # consume virtual time, so hang scenarios soak deterministically
    return _SoakPlan(options, clock=clock)


class _ReplicaClock:
    """Per-replica view of the shared :class:`FakeClock` plus a
    transient ``lead``, applied only while a fence completes so the
    replica's latency/deadline accounting sees the batch's modeled
    finish instant.  Replicas each have their own busy timeline, so a
    fleet soak models genuine overlap — advancing the one global clock
    per batch would serialize the replicas and cap measured scaling at
    1/n no matter how well the router spread the load."""

    __slots__ = ("base", "lead")

    def __init__(self, base: FakeClock):
        self.base = base
        self.lead = 0.0

    def __call__(self) -> float:
        return self.base() + self.lead


def _fleet_plan(options, global_clock: FakeClock,
                replica_clock: _ReplicaClock, service_time_s, state: Dict):
    """The fleet-mode counterpart of :func:`_soak_plan`: the fence does
    NOT advance the global clock.  Each batch starts when the replica
    is free (``max(now, busy_until)``), finishes ``service_time`` later,
    and the replica clock *leads* to that finish instant only while the
    completion bookkeeping runs — the global clock stays on the arrival
    schedule, and the driver accounts the busy tails at the end."""
    from dispatches_tpu_torch.plan.execution import ExecutionPlan

    class _FleetSoakPlan(ExecutionPlan):
        def _complete_oldest(self):
            if not self._window:
                return super()._complete_oldest()
            start = max(global_clock(), state["busy_until"])
            finish = start + service_time_s(self._window[0])
            state["busy_until"] = finish
            replica_clock.lead = max(finish - global_clock(), 0.0)
            try:
                return super()._complete_oldest()
            finally:
                replica_clock.lead = 0.0

    return _FleetSoakPlan(options, clock=replica_clock)


# ---------------------------------------------------------------------------
# minimal-compile stub workload
# ---------------------------------------------------------------------------


class StubNLP:
    """The smallest object the service's pdlp-with-``base_solver`` path
    accepts: just ``default_params()``.  Virtual soaks use it so a replay
    runs only the trivial stub program, never a real solver."""

    def __init__(self, n: int = 8):
        import numpy as np

        self.n = int(n)
        self._price = np.linspace(1.0, 2.0, self.n)

    def default_params(self) -> Dict:
        import numpy as np

        return {"p": {"price": np.array(self._price)}, "fixed": {}}


class StubResult(NamedTuple):
    obj: object
    converged: object
    iters: object


class WarmStubResult(NamedTuple):
    x: object
    z: object
    obj: object
    converged: object
    iters: object
    start_kind: object


def make_stub_solver(warm: bool = False):
    """A lane-batched ``solve(params)`` for the stub, on whatever device
    the service stages the lanes on: objective and a deterministic
    params-dependent ``iters`` (so the pdhg-iters drift detector has a
    real signal), always converged.  ``iters`` is the JAX stub's: the
    mean price in float64, rounded to float32.

    ``warm=True`` returns the warm start contract variant —
    ``solve(params, (x0, z0, kind))`` echoing ``x``/``z``/``start_kind``
    with warm lanes converging in fewer iters — so soaks exercise the
    serve warm-start machinery (``warm_contract`` bucket opts) and the
    crash-restart scenario can measure warm-hit-rate continuity."""
    import torch

    def _iters(price):
        # the stream's parameter level: a drifting price signal shows up
        # as a drifting iteration distribution
        return (20.0 + 40.0 * price.mean(-1)).to(torch.float32)

    if warm:
        from dispatches_tpu_torch.solvers.pdlp import START_COLD

        def solve_warm(params, start):
            x0, z0, kind = start
            price = params["p"]["price"]
            # the "solution" tracks the params, so neighbor retrieval of
            # a nearby request's x/z is a meaningful start
            x = price + 0.0 * x0
            z = price.mean(-1, keepdim=True) + 0.0 * z0
            base = _iters(price)
            return WarmStubResult(
                x=x, z=z, obj=price.sum(-1),
                converged=torch.ones_like(base, dtype=torch.bool),
                iters=torch.where(kind == START_COLD, base, 0.4 * base),
                start_kind=kind.to(torch.int32))

        return solve_warm

    def solve(params):
        price = params["p"]["price"]
        iters = _iters(price)
        return StubResult(obj=price.sum(-1),
                          converged=torch.ones_like(iters, dtype=torch.bool),
                          iters=iters)

    return solve


# ---------------------------------------------------------------------------
# spec handling
# ---------------------------------------------------------------------------

#: the default virtual soak: ~5 virtual seconds of Poisson traffic at
#: 250 rps (≈1.2k requests) with a correlated price stream, graded
#: against budgets sized for the service-time model.  Sections merge
#: shallowly: a spec file overrides per key, not per section.
DEFAULT_SPEC: Dict = {
    "traffic": {
        "process": "poisson",
        "rate_rps": 250.0,
        "duration_s": 5.0,
        "seed": 0,
        "perturb": ["price"],
        "rho": 0.9,
        "sigma": 0.05,
    },
    "service": {"max_batch": 8, "max_wait_ms": 20.0, "inflight": 2,
                "warm_start": False, "fence_timeout_ms": None},
    "service_time": {"base_ms": 2.0, "per_lane_ms": 0.25,
                     "jitter_ms": 0.5, "seed": 0, "spikes": []},
    "slo": {"latency_p99_ms": 200.0, "queue_wait_p95_ms": 100.0,
            "deadline_miss_ratio": 0.01},
    # [fast_s, slow_s, threshold] pairs sized for minutes-long soaks
    # (the canonical SRE 5m/1h pairs assume a 30-day budget horizon)
    "burn_rules": [[2.0, 10.0, 1.5], [5.0, 30.0, 1.2]],
    "check_interval_s": 0.5,
    "export_interval_s": 5.0,
    # chaos: a faults/inject.py scenario armed over a [start_s, stop_s)
    # window of the replay (virtual seconds from t0; stop_s None = the
    # whole tail), plus the service's load-shed knobs.  scenario None
    # (the default) arms nothing — the baseline replay is untouched.
    "faults": {"scenario": None, "start_s": 0.0, "stop_s": None,
               "shed_queue_depth": None, "shed_on_burn": False},
    # crash-restart: kill the service
    # WITHOUT drain at crash_at_s of virtual time — in-flight batches
    # and queued requests vanish exactly like a dead process — then
    # rebuild from the durability directory (write-ahead journal +
    # learned-state snapshot) and keep replaying.  Virtual mode only.
    "restart": {"enabled": False, "crash_at_s": None,
                "snapshot_interval_s": 1.0},
    # fleet (docs/fleet.md): replay against a FleetRouter over
    # n_replicas SolveServices instead of a bare service.  ``enabled``
    # None = auto (fleet when n_replicas > 1); True forces the fleet
    # path even at n_replicas == 1 (the bench A/B baseline, so both
    # arms share the routing/plan mechanics); False never.  ``kill`` is
    # a list of [replica_id, at_s] fail-stop windows (virtual seconds
    # from t0) — detection and failover run on the heartbeat timeout,
    # per-replica journals re-home the open requests onto survivors.
    # Virtual mode only; mutually exclusive with ``restart``.
    "fleet": {"enabled": None, "n_replicas": 1, "kill": [],
              "heartbeat_timeout_ms": 250.0, "gossip_interval_s": 1.0,
              "shed_queue_depth": None},
}


def load_soak_spec(path: Optional[str] = None,
                   overrides: Optional[Dict] = None) -> Dict:
    """DEFAULT_SPEC with a spec file and explicit overrides merged over
    it (per-section shallow merge; unknown sections rejected)."""
    spec = {k: (dict(v) if isinstance(v, dict) else v)
            for k, v in DEFAULT_SPEC.items()}
    from_file = None
    if path:
        with open(path) as f:
            from_file = json.load(f)
    for layer in (from_file, overrides):
        if not layer:
            continue
        unknown = sorted(set(layer) - set(DEFAULT_SPEC))
        if unknown:
            raise ValueError(f"unknown soak spec sections: {unknown}")
        for k, v in layer.items():
            if isinstance(spec.get(k), dict) and isinstance(v, dict):
                spec[k].update(v)
            else:
                spec[k] = v
    return spec


def _slo_spec(slo: Dict) -> "obs_slo.SLOSpec":
    """The soak's objectives as a real ``obs.slo`` spec (ungrouped:
    the soak grades the service aggregate, not per-bucket series)."""
    return obs_slo.spec_from_dict({
        "name": "soak",
        "objectives": [
            {"name": "soak_latency_p99", "kind": "quantile",
             "metric": "serve.latency_ms", "p": "p99",
             "target": slo["latency_p99_ms"]},
            {"name": "soak_queue_wait_p95", "kind": "quantile",
             "metric": "serve.queue_wait_ms", "p": "p95",
             "target": slo["queue_wait_p95_ms"]},
            {"name": "soak_deadline_miss_ratio", "kind": "ratio",
             "num": {"metric": "serve.deadline",
                     "labels": {"event": "missed"}},
             "den": {"metric": "serve.requests",
                     "labels": {"event": "submitted"}},
             "target": slo["deadline_miss_ratio"]},
        ],
    })


# ---------------------------------------------------------------------------
# the replay driver
# ---------------------------------------------------------------------------


def run_soak(spec: Optional[Dict] = None, *, nlp=None, base_solver=None,
             solver: str = "pdlp", virtual: bool = True,
             clock: Optional[Callable[[], float]] = None,
             out_dir: Optional[str] = None,
             flight_dir: Optional[str] = None,
             warmup_lanes: Tuple[int, ...] = (),
             device=None) -> Dict:
    """Replay one traffic spec against a ``SolveService``; returns the
    soak report (and writes ``soak_report.json`` plus exporter records
    under ``out_dir`` when given).

    Virtual mode (default) runs the stub workload on a
    :class:`FakeClock` with modeled service times; ``virtual=False``
    replays on ``time.monotonic`` against the real solver for ``nlp``
    (or the stub when none is given — then wall time is real but
    execution is still the stub kernel).

    ``warmup_lanes`` pre-compiles the per-lane-count programs before
    the streaming instruments attach (default-params requests, results
    discarded) so real-clock soaks measure steady-state tails, not
    compile spikes; the warmup requests do still show up in the
    service-level ``metrics()`` section of the report.

    The service and its plan (every replica's, in fleet mode) run on
    ``device`` (``cuda`` unless given).  The ``fleet`` section is
    virtual-only and excludes the ``restart`` section (``ValueError``
    otherwise, as in the JAX package).
    """
    from dispatches_tpu_torch import resolve_device
    from dispatches_tpu_torch.plan.execution import ExecutionPlan, PlanOptions
    from dispatches_tpu_torch.serve import traffic as traffic_mod
    from dispatches_tpu_torch.serve.service import (RequestStatus, ServeOptions,
                                                    SolveService)

    spec = load_soak_spec(overrides=spec)
    tspec = traffic_mod.spec_from_dict(spec["traffic"])
    svc_cfg = spec["service"]
    fault_cfg = spec["faults"]
    fault_scenario = fault_cfg.get("scenario")
    shed_depth = fault_cfg.get("shed_queue_depth")

    if virtual:
        clk = clock if clock is not None else FakeClock()
    else:
        clk = clock if clock is not None else time.monotonic

    # -- service + plan ----------------------------------------------------
    inflight_max = svc_cfg.get("inflight_max")
    fence_timeout = svc_cfg.get("fence_timeout_ms")
    plan_opts = PlanOptions(
        device=resolve_device(device),
        inflight=int(svc_cfg.get("inflight", 2)),
        schedule=str(svc_cfg.get("schedule", "fifo")),
        inflight_max=(None if inflight_max is None else int(inflight_max)),
        fence_timeout_ms=(None if fence_timeout is None
                          else float(fence_timeout)))
    model = None
    if virtual:
        model = ServiceTimeModel(
            base_ms=spec["service_time"]["base_ms"],
            per_lane_ms=spec["service_time"]["per_lane_ms"],
            jitter_ms=spec["service_time"]["jitter_ms"],
            seed=int(spec["service_time"].get("seed", 0)),
            spikes=tuple(tuple(s) for s in spec["service_time"]["spikes"]))

    def _new_plan():
        if virtual:
            return _soak_plan(plan_opts, clk, model.sampler(clk))
        return ExecutionPlan(plan_opts)

    warm_on = bool(svc_cfg.get("warm_start", False))
    submit_opts = None
    if nlp is None:
        nlp = StubNLP()
        if base_solver is None:
            base_solver = make_stub_solver(warm=warm_on)
            solver = "pdlp"
            if warm_on:
                # opt the stub buckets into the serve warm machinery:
                # the stub's start vectors are (n,)-primal, (1,)-dual
                submit_opts = {"warm_contract": True,
                               "warm_dims": (nlp.n, 1)}

    # crash-restart durability directory (journal + snapshots)
    restart_cfg = spec.get("restart") or {}
    restart_enabled = bool(restart_cfg.get("enabled")) and virtual
    durable_dir = None
    if restart_enabled:
        import os as _os
        import tempfile as _tempfile

        durable_dir = (_os.path.join(str(out_dir), "durable") if out_dir
                       else _tempfile.mkdtemp(prefix="soak-durable-"))
    snap_interval = float(restart_cfg.get("snapshot_interval_s") or 1.0)

    # fleet tier (docs/fleet.md): n replicas behind a FleetRouter
    fleet_cfg = spec.get("fleet") or {}
    n_replicas = int(fleet_cfg.get("n_replicas") or 1)
    _fleet_flag = fleet_cfg.get("enabled")
    fleet_mode = (bool(_fleet_flag) if _fleet_flag is not None
                  else n_replicas > 1)
    if fleet_mode and not virtual:
        raise ValueError("the fleet soak section is virtual-only (the "
                         "per-replica busy timelines live on the fake "
                         "clock)")
    if fleet_mode and restart_enabled:
        raise ValueError("fleet and restart soak sections are mutually "
                         "exclusive: fleet failover IS the restart "
                         "story (journal handoff instead of rebuild)")

    def _serve_options(p):
        return ServeOptions(
            max_batch=int(svc_cfg["max_batch"]),
            max_wait_ms=float(svc_cfg["max_wait_ms"]),
            warm_start=warm_on, plan=p,
            shed_queue_depth=(None if shed_depth is None
                              else int(shed_depth)),
            adaptive_wait=bool(svc_cfg.get("adaptive_wait", False)))

    router = None
    replica_busy: Dict[int, Dict] = {}
    if fleet_mode:
        import os as _os

        from dispatches_tpu_torch.fleet import FleetOptions, FleetRouter

        def _make_replica(replica_id, journal_dir):
            rclk = _ReplicaClock(clk)
            state = {"busy_until": 0.0}
            replica_busy[replica_id] = state
            plan = _fleet_plan(plan_opts, clk, rclk, model.sampler(clk),
                               state)
            return SolveService(_serve_options(plan), clock=rclk,
                                journal_dir=journal_dir,
                                snapshot_interval_s=(
                                    snap_interval if journal_dir
                                    else None))

        fleet_shed = fleet_cfg.get("shed_queue_depth")
        router = FleetRouter(
            FleetOptions(
                n_replicas=n_replicas,
                heartbeat_timeout_ms=float(
                    fleet_cfg.get("heartbeat_timeout_ms") or 250.0),
                gossip_interval_s=float(
                    fleet_cfg.get("gossip_interval_s") or 1.0),
                shed_queue_depth=(None if fleet_shed is None
                                  else int(fleet_shed))),
            clock=clk, make_service=_make_replica,
            durable_dir=(_os.path.join(str(out_dir), "fleet-durable")
                         if out_dir and n_replicas > 1 else None))
        service = router
    else:
        plan = _new_plan()
        service = SolveService(
            _serve_options(plan), clock=clk, journal_dir=durable_dir,
            snapshot_interval_s=(snap_interval if durable_dir else None))

    # pre-compile the lane-count programs before any instrument is
    # attached: warmup latency is compile latency, not tail signal
    if warmup_lanes:
        warm_defaults = nlp.default_params()
        for k in warmup_lanes:
            warm = [service.submit(nlp, warm_defaults, solver=solver,
                                   options=submit_opts,
                                   base_solver=base_solver)
                    for _ in range(int(k))]
            service.flush_all()
            for h in warm:
                h.result()

    # -- streaming instruments ---------------------------------------------
    lat_stream = online.StreamingQuantiles()
    qw_stream = online.StreamingQuantiles()
    lat_drift = online.DriftDetector()
    iters_drift = online.DriftDetector()
    rules = tuple(online.BurnRateRule(*r) for r in spec["burn_rules"])
    slo_spec = _slo_spec(spec["slo"])
    monitors = online.monitors_from_spec(
        slo_spec, rules=rules,
        check_interval_s=float(spec["check_interval_s"]))
    lat_mons = [m for m in monitors if m.metric == "serve.latency_ms"]
    qw_mons = [m for m in monitors if m.metric == "serve.queue_wait_ms"]
    ratio_mons = [m for m in monitors if m.kind == "ratio"]
    if fault_cfg.get("shed_on_burn"):
        # sustained-burn load shedding: any monitor rule firing sheds
        # new submissions until its windows drain back under threshold
        # (the router exposes the same shed_signal contract)
        service.shed_signal = lambda: any(m.firing for m in monitors)

    acc_plan_id = (service.plan.plan_id if router is None
                   else router.replicas[0].service.plan.plan_id)
    acc = online.TimelineAccumulator(plan=acc_plan_id)
    latencies: List[float] = []
    alerts: List[Dict] = []
    bundle_paths: List[str] = []

    trace_was_on = obs_trace.enabled()
    if not trace_was_on:
        obs_trace.enable(True)  # plan lifecycle spans feed the sink
    obs_trace.add_sink(acc.ingest)

    if flight_dir:
        obs_flight.enable(str(flight_dir))
    obs_flight.set_clock(clk)

    exporter = None
    if out_dir:
        from dispatches_tpu_torch.obs.export import (ContinuousExporter,
                                                     ExportOptions)

        exporter = ContinuousExporter(
            ExportOptions(directory=str(out_dir),
                          interval_s=float(spec["export_interval_s"])),
            clock=clk)
        if router is None:
            service.attach_exporter(exporter)
        # fleet mode ticks the exporter from the driver loop instead:
        # attaching to one replica would stop exporting when it dies

    # latency/queue-wait tee: the service's window ``record`` calls
    # happen exactly at fence/dispatch time, so shadowing them on the
    # instance is the zero-copy streaming feed (restored in finally).
    tees: List[Tuple[object, Callable, Callable]] = []

    def _tee_service(svc) -> None:
        orig_lat = svc._latency.record
        orig_qw = svc._queue_wait.record

        def _lat_record(label: str, ms: float) -> None:
            now = clk()
            latencies.append(float(ms))
            lat_stream.observe(ms)
            lat_drift.observe(ms)
            for m in lat_mons:
                m.observe(now, ms)
            orig_lat(label, ms)

        def _qw_record(label: str, ms: float) -> None:
            now = clk()
            qw_stream.observe(ms)
            for m in qw_mons:
                m.observe(now, ms)
            orig_qw(label, ms)

        svc._latency.record = _lat_record
        svc._queue_wait.record = _qw_record
        tees.append((svc, orig_lat, orig_qw))

    # Fleet mode tees every replica; observations land on the shared
    # stream with global-clock timestamps either way.
    if router is None:
        _tee_service(service)
    else:
        for _rep in router.replicas:
            _tee_service(_rep.service)

    # -- crash-restart -----------------------------------------------------
    restart_state: Dict = {"done": False, "info": None}
    crash_at = restart_cfg.get("crash_at_s")

    def _maybe_crash() -> None:
        """Kill the service without drain at the spec'd virtual
        instant, rebuild it from the durability directory, and splice
        the recovered handles back into the replay."""
        nonlocal service
        if (not restart_enabled or restart_state["done"]
                or crash_at is None or clk() < t0 + float(crash_at)):
            return
        restart_state["done"] = True
        pre_warm = service.metrics()["warm_start"]
        open_handles = [h for h in pending if not h.done()]
        survivors = [h for h in pending if h.done()]
        pending.clear()
        pending.extend(survivors)
        # the crash: drop the service AND its plan with no drain —
        # queued requests and in-flight batches vanish exactly as if
        # the process died; only the journal + snapshot survive
        dead, orig_lat, orig_qw = tees.pop()
        dead._latency.record = orig_lat
        dead._queue_wait.record = orig_qw
        t_wall = time.perf_counter()
        service = SolveService(
            _serve_options(_new_plan()), clock=clk,
            recover_dir=durable_dir, recover_nlp=nlp,
            recover_base_solver=base_solver,
            snapshot_interval_s=snap_interval)
        recovery_ms = (time.perf_counter() - t_wall) * 1e3
        if fault_cfg.get("shed_on_burn"):
            service.shed_signal = lambda: any(m.firing for m in monitors)
        if exporter is not None:
            service.attach_exporter(exporter)
        _tee_service(service)
        pending.extend(service.recovered_handles)
        rec = service.recovery or {}
        recovered = int(rec.get("recovered", 0))
        restart_state["info"] = {
            "enabled": True,
            "crash_at_s": float(crash_at),
            "open_at_crash": len(open_handles),
            "recovered": recovered,
            "lost": max(len(open_handles) - recovered, 0),
            "restart_recovery_ms": round(recovery_ms, 3),
            "warm_hit_rate_pre": pre_warm["hit_rate"],
            "generation": service.generation,
        }

    # -- replay ------------------------------------------------------------
    requests = traffic_mod.generate(tspec, nlp.default_params())
    poll_dt = max(float(svc_cfg["max_wait_ms"]) / 1e3, 1e-3)
    pending: deque = deque()
    counts = {"scheduled": len(requests), "submitted": 0, "done": 0,
              "timeout": 0, "error": 0, "shed": 0, "deadline_missed": 0}

    # chaos bookkeeping: counter snapshots so the report reads this
    # replay's deltas, not process-lifetime totals
    inj0 = _faults.injected_total()
    rec0 = _faults.recovered_total()
    retries0 = obs_registry.counter("plan.retries").total()
    shed0 = obs_registry.counter("serve.shed").total()
    fault_state = {"armed": False, "restore": None, "was_armed": False}

    def _fault_window(now: float) -> None:
        """Arm the spec's scenario inside its virtual window (and put
        back whatever was armed before once it closes)."""
        if fault_scenario is None:
            return
        start = t0 + float(fault_cfg.get("start_s") or 0.0)
        stop_s = fault_cfg.get("stop_s")
        stop = None if stop_s is None else t0 + float(stop_s)
        if (not fault_state["armed"] and not fault_state["was_armed"]
                and now >= start and (stop is None or now < stop)):
            fault_state["restore"] = _faults.arm(fault_scenario)
            fault_state["armed"] = fault_state["was_armed"] = True
        elif fault_state["armed"] and stop is not None and now >= stop:
            _faults.arm(fault_state["restore"])
            fault_state["armed"] = False

    def _check_alerts() -> None:
        now = clk()
        for m in monitors:
            for a in m.update(now):
                alerts.append(a)
                if obs_flight.enabled():
                    p = obs_flight.trigger(
                        "burn_rate", label=a["objective"], detail=a)
                    if p is not None:
                        bundle_paths.append(p)

    # fleet kill windows: fail-stop replicas mid-replay; detection and
    # failover run on the router's heartbeat timeout inside poll()
    kill_windows = [
        {"replica": int(k[0]), "at_s": float(k[1]), "fired": False}
        for k in (fleet_cfg.get("kill") or [])] if fleet_mode else []

    def _maybe_kill() -> None:
        now = clk()
        for kw in kill_windows:
            if not kw["fired"] and now >= t0 + kw["at_s"]:
                kw["fired"] = True
                try:
                    router.kill(kw["replica"])
                except KeyError:
                    pass  # a spec naming a nonexistent replica is inert

    def _harvest() -> None:
        _fault_window(clk())
        _maybe_crash()
        if fleet_mode:
            _maybe_kill()
            if exporter is not None:
                exporter.maybe_export(clk())
        while pending and pending[0].done():
            h = pending.popleft()
            sr = h._result
            now = clk()
            missed = False
            if sr.status == RequestStatus.DONE:
                counts["done"] += 1
                if h.deadline_at is not None:
                    missed = (h.submitted_at + sr.latency_ms / 1e3
                              > h.deadline_at)
                iters = getattr(sr.result, "iters", None)
                if iters is not None:
                    iters_drift.observe(float(iters))
            elif sr.status == RequestStatus.ERROR:
                counts["error"] += 1
                missed = True
            elif sr.status == RequestStatus.SHED:
                # refused at submit: no latency signal, no deadline
                # grade — the shed counter is its own SLO input
                counts["shed"] += 1
            else:
                counts["timeout"] += 1
                missed = True
            if missed:
                counts["deadline_missed"] += 1
            if h.deadline_at is not None or missed:
                for m in ratio_mons:
                    m.observe(now, 1.0 if missed else 0.0)
        _check_alerts()

    t0 = clk()
    try:
        for req in requests:
            target = t0 + req.t
            if virtual:
                while clk() + poll_dt <= target:
                    clk.advance(poll_dt)
                    service.poll()
                    _harvest()
                clk.advance_to(target)
            else:
                while clk() < target:
                    time.sleep(min(poll_dt, max(target - clk(), 0.0)))
                    service.poll()
                    _harvest()
            pending.append(service.submit(
                nlp, req.params, solver=solver, options=submit_opts,
                base_solver=base_solver, deadline_ms=req.deadline_ms))
            counts["submitted"] += 1
            _harvest()
        # drain the tail: one more wait quantum, then a pipelined flush
        if virtual:
            clk.advance(poll_dt)
        service.poll()
        service.flush_all()
        _harvest()
        if fleet_mode:
            # fire any kills scheduled past the last arrival, then let
            # the heartbeat silence age so detection + failover run,
            # drain the re-homed twins, and pump the orphan bridges
            for kw in kill_windows:
                if not kw["fired"]:
                    clk.advance_to(t0 + kw["at_s"])
                    _harvest()
            clk.advance(float(fleet_cfg.get("heartbeat_timeout_ms")
                              or 250.0) / 1e3 + poll_dt)
            service.poll()
            service.flush_all()
            service.poll()
            _harvest()
            # the throughput headline's wall clock is when the LAST
            # replica went idle — account the modeled busy tails the
            # arrival schedule never reached
            for state in replica_busy.values():
                clk.advance_to(state["busy_until"])
            if pending:
                # an orphan whose re-home was lost never completes;
                # count completed stragglers stuck behind it, leave
                # the rest to the hung/lost accounting below
                done_stragglers = [h for h in pending if h.done()]
                open_stragglers = len(pending) - len(done_stragglers)
                pending.clear()
                pending.extend(done_stragglers)
                _harvest()
                pending.clear()  # the open ones count as hung below
                if open_stragglers:
                    obs_registry.counter(
                        "fleet.lost",
                        "requests lost across a failover (orphans "
                        "whose re-home could not land)").inc(
                            open_stragglers)
        elif pending:
            raise RuntimeError(
                f"{len(pending)} request(s) left incomplete after flush_all")
        now = clk()
        if exporter is not None:
            exporter.export(now)
    finally:
        if fault_state["armed"]:
            _faults.arm(fault_state["restore"])
            fault_state["armed"] = False
        for svc, orig_lat, orig_qw in tees:
            svc._latency.record = orig_lat
            svc._queue_wait.record = orig_qw
        obs_trace.remove_sink(acc.ingest)
        obs_flight.set_clock(None)
        if not trace_was_on:
            obs_trace.enable(False)

    # -- report ------------------------------------------------------------
    posthoc = None
    if latencies:
        xs = sorted(latencies)
        posthoc = {
            "count": len(xs),
            "mean": sum(xs) / len(xs),
            "p50": online.interp_quantile(xs, 0.5),
            "p95": online.interp_quantile(xs, 0.95),
            "p99": online.interp_quantile(xs, 0.99),
        }
    burn_max = max((m.burn_peak for m in monitors), default=0.0)
    lat_summary = lat_stream.summary()
    injected = _faults.injected_total() - inj0
    recovered = _faults.recovered_total() - rec0
    recovery_rate = (recovered / injected) if injected else 1.0
    terminal = (counts["done"] + counts["timeout"] + counts["error"]
                + counts["shed"])
    counts["hung"] = counts["submitted"] - terminal
    restart_report: Dict = {"enabled": bool(restart_enabled)}
    lost_rate = None
    recovery_ms = None
    if restart_state["info"] is not None:
        restart_report = dict(restart_state["info"])
        restart_report["warm_hit_rate_post"] = (
            service.metrics()["warm_start"]["hit_rate"])
        lost_rate = (restart_report["lost"] / counts["submitted"]
                     if counts["submitted"] else 0.0)
        restart_report["lost_request_rate"] = round(lost_rate, 6)
        recovery_ms = restart_report["restart_recovery_ms"]
    fleet_report: Dict = {"enabled": bool(fleet_mode)}
    replica_lost_rate = None
    if fleet_mode:
        fs = router.fleet_stats()
        # a request the fleet accepted but never brought to a terminal
        # status — the headline the chaos gate pins to zero
        replica_lost_rate = (counts["hung"] / counts["submitted"]
                             if counts["submitted"] else 0.0)
        fleet_report.update({
            "n_replicas": fs["n_replicas"],
            "alive": fs["alive"],
            "failovers": fs["failovers"],
            "rehomed": fs["rehomed"],
            "rehome_lost": fs["rehome_lost"],
            "fleet_shed": fs["fleet_shed"],
            "gossip": fs["gossip"],
            "kills": [{"replica": kw["replica"], "at_s": kw["at_s"],
                       "fired": kw["fired"]} for kw in kill_windows],
            "replica_lost_request_rate": round(replica_lost_rate, 6),
            # fleet-aggregate warm hit rate (dead replicas contribute
            # their at-death snapshot): the failover smoke pins this
            # non-degraded vs a kill-free run of the same stream
            "warm_hit_rate": round(
                router.metrics()["warm_start"]["hit_rate"], 6),
            "per_replica": fs["per_replica"],
        })
    report = {
        "schema": SOAK_SCHEMA,
        "virtual": bool(virtual),
        "spec": {**spec, "traffic": tspec.to_dict()},
        "duration_s": round(now - t0, 6),
        "requests": counts,
        "latency_ms": {"streaming": lat_summary, "posthoc": posthoc},
        "queue_wait_ms": {"streaming": qw_stream.summary()},
        "slo": {
            "objectives": [m.state(now) for m in monitors],
            "alerts": alerts,
            "alerts_total": len(alerts),
            "flight_bundles": len(bundle_paths),
            "bundle_paths": bundle_paths,
        },
        "drift": {"latency": lat_drift.result(),
                  "pdhg_iters": iters_drift.result()},
        "timeline": acc.result(),
        "service": service.metrics(),
        "faults": {
            "armed": fault_state["was_armed"],
            "scenario": (str(fault_scenario)
                         if isinstance(fault_scenario, str)
                         else fault_scenario),
            "injected": int(injected),
            "recovered": int(recovered),
            "plan_retries": int(
                obs_registry.counter("plan.retries").total() - retries0),
            "shed": int(
                obs_registry.counter("serve.shed").total() - shed0),
            "recovery_rate": round(recovery_rate, 6),
        },
        "restart": restart_report,
        "fleet": fleet_report,
        "soak_p99_ms": lat_summary.get("p99"),
        "slo_burn_max": round(burn_max, 4),
        "fault_recovery_rate": round(recovery_rate, 6),
        "restart_recovery_ms": recovery_ms,
        "lost_request_rate": lost_rate,
        "replica_lost_request_rate": (
            None if replica_lost_rate is None
            else round(replica_lost_rate, 6)),
    }
    if out_dir:
        import os

        os.makedirs(str(out_dir), exist_ok=True)
        path = os.path.join(str(out_dir), "soak_report.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(report, f, default=str)
        os.replace(tmp, path)
        report["report_path"] = path
    return report


def format_soak_report(report: Dict) -> str:
    """Human-readable rendering for ``--soak``."""
    lines = [f"== soak report ({'virtual' if report['virtual'] else 'real'} "
             f"clock, {report['duration_s']:.2f} s) =="]
    c = report["requests"]
    lines.append(
        f"requests: {c['submitted']} submitted, {c['done']} done, "
        f"{c['timeout']} timeout, {c.get('error', 0)} error, "
        f"{c.get('shed', 0)} shed, {c['deadline_missed']} deadline-missed")
    fl = report.get("faults")
    if fl and fl.get("armed"):
        lines.append(
            f"faults: {fl['injected']} injected, {fl['recovered']} "
            f"recovered (rate {fl['recovery_rate']:.3f}), "
            f"{fl['plan_retries']} plan retr{'y' if fl['plan_retries'] == 1 else 'ies'}, "
            f"{fl['shed']} shed")
    ft = report.get("fleet")
    if ft and ft.get("enabled") and "n_replicas" in ft:
        kills = sum(1 for k in ft.get("kills", ()) if k["fired"])
        lines.append(
            f"fleet: {ft['alive']}/{ft['n_replicas']} replicas alive, "
            f"{kills} killed, {ft['failovers']} failover(s), "
            f"{ft['rehomed']} re-homed, {ft['rehome_lost']} lost in "
            f"handoff (replica_lost_request_rate "
            f"{ft['replica_lost_request_rate']:.4f})")
    rs = report.get("restart")
    if rs and rs.get("enabled") and "open_at_crash" in rs:
        lines.append(
            f"restart: crash at {rs['crash_at_s']:.2f}s, "
            f"{rs['open_at_crash']} open, {rs['recovered']} recovered, "
            f"{rs['lost']} lost (rate {rs['lost_request_rate']:.4f}), "
            f"recovery {rs['restart_recovery_ms']:.1f} ms, "
            f"warm hit {rs['warm_hit_rate_pre']:.3f}"
            f"->{rs['warm_hit_rate_post']:.3f}")
    s = report["latency_ms"]["streaming"]
    ph = report["latency_ms"]["posthoc"]

    def _ms(v):
        return "-" if v is None else f"{v:.2f}"

    lines.append(
        f"latency ms (streaming P2): p50 {_ms(s.get('p50'))}  "
        f"p95 {_ms(s.get('p95'))}  p99 {_ms(s.get('p99'))}"
        + ("" if ph is None else
           f"   (posthoc p99 {_ms(ph['p99'])})"))
    qs = report["queue_wait_ms"]["streaming"]
    lines.append(
        f"queue wait ms: p50 {_ms(qs.get('p50'))}  "
        f"p95 {_ms(qs.get('p95'))}  p99 {_ms(qs.get('p99'))}")
    slo = report["slo"]
    lines.append(
        f"slo: burn_max {report['slo_burn_max']:.3f}, "
        f"{slo['alerts_total']} alert(s), "
        f"{slo['flight_bundles']} flight bundle(s)")
    for o in slo["objectives"]:
        firing = any(r["firing"] for r in o["rules"])
        lines.append(
            f"  {o['objective']:<28s} target {o['target']:<10g} "
            f"burn_peak {o['burn_peak']:.3f}"
            + ("  FIRING" if firing else ""))
    for name, d in report["drift"].items():
        ks = d["ks"]
        lines.append(
            f"drift[{name}]: ks "
            + ("-" if ks is None else f"{ks:.3f}")
            + (" DRIFTED" if d["drifted"] else ""))
    tl = report["timeline"]
    if tl is not None:
        st = tl["stall"]
        lines.append(
            f"online timeline: {tl['n_batches']} batches, overlap "
            f"{tl['overlap_efficiency']:.3f}, stall {st['stall_pct']:.1f}% "
            f"[fence {st['fence_bound_us'] / 1e3:.2f} ms, host-stage "
            f"{st['host_stage_bound_us'] / 1e3:.2f} ms, queue-empty "
            f"{st['queue_empty_us'] / 1e3:.2f} ms]")
    if "report_path" in report:
        lines.append(f"report: {report['report_path']}")
    return "\n".join(lines) + "\n"
