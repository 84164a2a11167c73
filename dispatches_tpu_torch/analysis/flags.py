"""Registry of the ``DISPATCHES_TPU_*`` environment flags the port reads.

The port keeps the JAX package's flag names and meanings, so one setting
steers both packages.  Only the flags this package reads are registered
here; a flag is added in the same change that reads it.  graftlint rule
GL006 checks every ``os.environ``/``os.getenv`` read of a
``DISPATCHES_TPU_*`` name in the package against ``REGISTERED_FLAGS``
(with ``_PREFIX``).

Not registered, because nothing here reads them: the JAX package's
``COMPILE_CACHE`` and ``NO_COMPILE_CACHE`` (XLA's persistent compile
cache; torch compiles nothing per input shape) and ``NO_X64`` (JAX's
float64 mode; the port states every dtype), and its test-lane flags
``SLOW`` and ``EXTENDED``, which only tests read.

Stdlib only: the linter imports this module to learn the registry.
"""

from __future__ import annotations

import os

# name (without the DISPATCHES_TPU_ prefix) -> what setting it does
REGISTERED_FLAGS = {
    "DATA": "override the vendored reference-data directory "
    "(case_studies.renewables.load_parameters.data_dir)",
    "RTS_GMLC": "override the RTS-GMLC source-data directory "
    "(workflow.managed)",
    "WARN_RECOMPILE": "warn whenever a counted program "
    "(analysis.runtime.ProgramCounter) runs a new argument signature "
    "after its first (analysis.runtime.RecompileWarning)",
    "SANITIZE": "enable runtime NaN/Inf guards on solver iterates "
    "(analysis.runtime.nan_guard; costs one device sync per guard)",
    "PDLP_ALGO": "override PDLPOptions.algorithm ('avg' | 'halpern') "
    "(solvers.pdlp.resolve_pdlp_algorithm; read at solver-build time)",
    "PDLP_PRECISION": "override PDLPOptions.precision ('f32' | "
    "'bf16x-f32' | 'f32-f64') (solvers.pdlp.resolve_pdlp_precision; "
    "read at solver-build time)",
    "PDLP_REFINE_ROUNDS": "override PDLPOptions.refine_rounds, the max "
    "high-tier refinement epochs after a low-precision PDLP solve "
    "(solvers.pdlp.resolve_pdlp_refine_rounds)",
    "SERVE_MAX_BATCH": "solve-service flush threshold / max lanes per "
    "dispatched batch (serve.ServeOptions.from_env)",
    "SERVE_MAX_WAIT_MS": "solve-service max age of the oldest queued "
    "request before a forced flush (serve.ServeOptions.from_env)",
    "SERVE_MAX_QUEUE": "solve-service total pending-request bound; a "
    "full queue flushes oldest-first (serve.ServeOptions.from_env)",
    "SERVE_SHED_QUEUE_DEPTH": "solve-service load-shedding rung: "
    "pending-queue depth at/above which new submits complete "
    "immediately as SHED (serve.ServeOptions.from_env; unset = off)",
    "SERVE_DEGRADE_MISPREDICTS": "solve-service degradation rung: "
    "consecutive warm-start mispredicts per bucket before it falls back "
    "to cold starts (serve.ServeOptions.from_env; default 4)",
    "SERVE_DEGRADE_REFINE_FAILS": "solve-service degradation rung: "
    "refine-failed lanes per bf16x-f32 bucket before new submits "
    "redirect to an f32 twin bucket (serve.ServeOptions.from_env; "
    "default 3)",
    "SERVE_ADAPTIVE_WAIT": "solve-service adaptive batch forming "
    "(serve.ServeOptions.from_env; unset = fixed SERVE_MAX_WAIT_MS)",
    "SERVE_HOLD_MAX_MS": "solve-service adaptive batch forming: cap on "
    "how long a slack-rich bucket may hold past SERVE_MAX_WAIT_MS "
    "(serve.ServeOptions.from_env; default 4x SERVE_MAX_WAIT_MS)",
    "SERVE_JOURNAL_DIR": "arm the solve-service write-ahead request "
    "journal + learned-state snapshots in this directory; a service "
    "built with recover_dir= resubmits every request that was open at "
    "death (serve.journal; unset = no durability, zero overhead)",
    "SERVE_SNAPSHOT_INTERVAL_S": "seconds between periodic learned-"
    "state snapshots when the journal is armed (serve.snapshot; "
    "default 30)",
    "PLAN_INFLIGHT": "execution-plan dispatch-ahead window: max batches "
    "dispatched but not yet fenced (plan.PlanOptions.from_env; default 2)",
    "PLAN_DEVICES": "execution-plan device count: > 1 builds a "
    "parallel.scenario_mesh of that many entries on the plan's device "
    "(the first n visible cards on cuda) when no explicit mesh is given "
    "(plan.PlanOptions.from_env)",
    "PLAN_MAX_RETRIES": "execution-plan full-batch retry budget before "
    "lane bisection (plan.PlanOptions.from_env; default 2)",
    "PLAN_RETRY_BACKOFF_MS": "execution-plan base backoff between batch "
    "retries, doubled per attempt, capped at 250 ms "
    "(plan.PlanOptions.from_env; default 5)",
    "PLAN_SCHEDULE": "execution-plan fence order: 'fifo' or 'ready' "
    "(probe each ticket's CUDA event; FIFO when no probe) "
    "(plan.PlanOptions.from_env)",
    "PLAN_INFLIGHT_MAX": "arms the adaptive in-flight depth controller: "
    "AIMD moves the dispatch window within [1, this bound] from live "
    "stall attribution (plan.adaptive; plan.PlanOptions.from_env)",
    "PLAN_FENCE_TIMEOUT_MS": "execution-plan fence watchdog on the plan "
    "clock; a batch that exceeds it is retried/bisected "
    "(plan.PlanOptions.from_env; unset = unbounded fences)",
    "WARMSTART": "kill-switch for cross-request PDLP warm starts, ON by "
    "default (serve.warmstart.enabled; read at bucket-build time)",
    "WARMSTART_K": "neighbors averaged per warm-start retrieval "
    "(serve.warmstart.default_k; default 4)",
    "WARMSTART_RADIUS": "normalized-RMS distance gate of warm-start "
    "retrieval (serve.warmstart.default_radius; default 0.25)",
    "WARMSTART_PREDICT": "kill-switch for the learned warm-start "
    "predictor rung, ON by default (learn.predictor.predict_enabled)",
    "WARMSTART_PREDICT_HIDDEN": "hidden width of the warm-start "
    "predictor MLP (learn.predictor.default_hidden; default 32)",
    "WARMSTART_PREDICT_REFIT_N": "completed warm-bucket results between "
    "online predictor refits (learn.train.default_refit_every; default 64)",
    "FAULTS": "arm the fault-injection layer with a scenario spec "
    "(faults.inject; same grammar as the JAX package)",
    "OBS": "enable span/instant recording in the obs tracer (obs.trace)",
    "OBS_BUFFER": "obs tracer ring-buffer capacity in events "
    "(obs.trace; default 65536)",
    "OBS_PROFILE": "cost cards: the first call of each new argument "
    "signature of a plan program records label, count, backend, shapes, "
    "argument/output bytes, CUDA peak bytes and matmul flops "
    "(obs.profile; read when a program is built)",
    "OBS_EXPORT_DIR": "continuous-exporter output directory; setting "
    "it arms the periodic JSONL time-series + metrics.prom writer that "
    "SolveService ticks from submit/poll (obs.export; unset = exporter "
    "disarmed, zero writes)",
    "OBS_EXPORT_INTERVAL_S": "continuous-exporter seconds between "
    "interval records on the service clock (obs.export; default 10)",
    "OBS_EXPORT_MAX_FILES": "continuous-exporter JSONL rotation: files "
    "kept before the oldest is deleted (obs.export; default 8)",
    "OBS_EXPORT_MAX_RECORDS": "continuous-exporter JSONL rotation: "
    "records per file before starting the next (obs.export; default "
    "1024)",
    "OBS_FLIGHT_DIR": "flight-recorder bundle directory; setting it "
    "arms the trigger hooks (deadline miss, quarantine/refine-fail, "
    "nan-guard trip, solver non-convergence, burn-rate alerts) in "
    "serve/sweep/runtime (obs.flight; unset = recorder disarmed, zero "
    "writes)",
    "OBS_FLIGHT_COOLDOWN_S": "flight-recorder per-trigger-kind "
    "cooldown override in seconds, applied to every kind (obs.flight; "
    "unset = per-kind defaults: 30 s for burn_rate, 0 for the "
    "event-shaped kinds)",
    "OBS_LEDGER_DIR": "perf-ledger directory; setting it also enables "
    "the automatic ledger writes from the sweep engine (obs.ledger; "
    "unset = no writes)",
    "OBS_LEDGER_TOL": "perf-ledger regression tolerance as a fraction "
    "of the trailing-window median (obs.ledger --check-regressions; "
    "default 0.3)",
    "OBS_SLO": "default SLO spec JSON path for `python -m "
    "dispatches_tpu_torch.obs --slo` (obs.slo; unset = built-in example "
    "objectives)",
    "SOAK_SPEC": "default soak spec JSON path for `python -m "
    "dispatches_tpu_torch.obs --soak` (obs.soak; unset = built-in "
    "DEFAULT_SPEC; `--spec` wins over the flag)",
    "SOAK_DURATION_S": "override the soak traffic duration in seconds "
    "for `--soak` (obs.soak; `--duration` wins over the flag)",
    "SOAK_REPORT_DIR": "directory `--soak` writes soak_report.json "
    "and exporter records into (obs.soak; `--out` wins; unset with no "
    "--out = report to stdout only)",
    "FLEET_REPLICAS": "fleet-serve replica count behind the "
    "FleetRouter façade; 1 (the default) is a pass-through that "
    "constructs no gossip/heartbeat machinery "
    "(fleet.FleetOptions.from_env)",
    "FLEET_HEARTBEAT_MS": "fleet-serve heartbeat timeout on the "
    "router clock: a replica whose last beat is older is declared "
    "dead and failed over (journal replay + re-home onto survivors) "
    "(fleet.FleetOptions.from_env; default 500)",
    "FLEET_GOSSIP_INTERVAL_S": "fleet-serve seconds between gossip "
    "rounds exchanging warm-start index entries and admission "
    "service-time estimates between replicas "
    "(fleet.FleetOptions.from_env; default 5)",
    "NET_PORT": "default TCP port for `python -m dispatches_tpu_torch.net "
    "--worker` (net.__main__; 0 = kernel-assigned ephemeral port, "
    "printed on the ready line; `--port` wins over the flag)",
    "NET_CONNECT_TIMEOUT_MS": "RPC client connection-dial timeout in "
    "milliseconds (net.rpc.RpcClient; default 500)",
    "NET_RPC_RETRIES": "RPC client retry budget per call on transport "
    "errors, with capped-exponential backoff between attempts "
    "(net.rpc.RpcClient; default 2; 0 = fail on first error)",
    "NET_HEARTBEAT_MS": "deadline for a remote replica's heartbeat "
    "ping RPC — never retried: a missed ping is a lost beat the "
    "router's timeout logic must see (fleet.remote.RemoteReplicaHandle; "
    "default 100)",
    "NET_TRACE": "arm wire-level distributed tracing: RpcClient "
    "attaches a trace context (request id, origin pid/generation, "
    "parent span) to every frame, RpcServer opens child spans under "
    "it, and workers record spans for trace_export pulls "
    "(obs.distributed.enabled; disarmed = one cached-boolean branch "
    "on the RPC hot path)",
    "OBS_FLEET_EXPORT_DIR": "arm the fleet-mode continuous exporter in "
    "this directory: the FleetRouter's ContinuousExporter merges live "
    "remote-replica registry snapshots (process-labeled) into one "
    "metrics.prom alongside the router's own series "
    "(fleet.FleetRouter / obs.export.ContinuousExporter; unset = "
    "per-process export only)",
    "SWEEP_CHUNK": "sweep-engine points per chunk == checkpoint/resume "
    "granularity (sweep.SweepOptions.from_env)",
    "SWEEP_MAX_RETRIES": "sweep-engine point-wise retry budget before a "
    "non-finite result is quarantined (sweep.SweepOptions.from_env)",
    "SWEEP_RESULT_DIR": "sweep-engine default ResultStore directory "
    "(sweep.SweepOptions.from_env)",
}

_PREFIX = "DISPATCHES_TPU_"


def flag_name(short: str) -> str:
    """Full environment-variable name for a registered flag."""
    if short not in REGISTERED_FLAGS:
        raise KeyError(
            f"{_PREFIX}{short} is not registered in "
            "dispatches_tpu_torch.analysis.flags.REGISTERED_FLAGS"
        )
    return _PREFIX + short


def flag_enabled(short: str) -> bool:
    """Truthiness of a registered boolean flag ('' and '0' are off)."""
    val = os.environ.get(flag_name(short), "")
    return val not in ("", "0", "false", "False")
