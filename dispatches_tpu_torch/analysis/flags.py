"""Registry of the ``DISPATCHES_TPU_*`` environment flags the port reads.

The port keeps the JAX package's flag names, so one setting steers both
packages.  Only the flags this package reads are registered here; a
flag is added in the same change that reads it.  Stdlib only.
"""

from __future__ import annotations

import os

# name (without the DISPATCHES_TPU_ prefix) -> what setting it does
REGISTERED_FLAGS = {
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
    "SERVE_JOURNAL_DIR": "arms the write-ahead request journal in the "
    "JAX package; not ported yet, so a set value makes SolveService "
    "raise NotImplementedError (serve.service)",
    "PLAN_INFLIGHT": "execution-plan dispatch-ahead window: max batches "
    "dispatched but not yet fenced (plan.PlanOptions.from_env; default 2)",
    "PLAN_DEVICES": "execution-plan device count; > 1 needs the mesh, "
    "not ported yet (plan.PlanOptions.from_env raises for it in "
    "ExecutionPlan)",
    "PLAN_MAX_RETRIES": "execution-plan full-batch retry budget before "
    "lane bisection (plan.PlanOptions.from_env; default 2)",
    "PLAN_RETRY_BACKOFF_MS": "execution-plan base backoff between batch "
    "retries, doubled per attempt, capped at 250 ms "
    "(plan.PlanOptions.from_env; default 5)",
    "PLAN_SCHEDULE": "execution-plan fence order: 'fifo' or 'ready' "
    "(probe each ticket's CUDA event; FIFO when no probe) "
    "(plan.PlanOptions.from_env)",
    "PLAN_INFLIGHT_MAX": "arms the adaptive in-flight depth controller "
    "in the JAX package; not ported yet, so ExecutionPlan raises for it "
    "(plan.PlanOptions.from_env)",
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
    "OBS_PROFILE": "AOT cost cards in the JAX package; not ported yet, so "
    "a set value makes SolveService and run_sweep raise "
    "NotImplementedError",
    "OBS_EXPORT_DIR": "continuous telemetry export in the JAX package; "
    "not ported yet, so a set value makes SolveService raise "
    "NotImplementedError",
    "OBS_FLIGHT_DIR": "flight-recorder bundles in the JAX package; not "
    "ported yet, so a set value makes SolveService and run_sweep raise "
    "NotImplementedError",
    "OBS_LEDGER_DIR": "perf-ledger directory in the JAX package; not "
    "ported yet, so a set value makes run_sweep raise NotImplementedError",
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
