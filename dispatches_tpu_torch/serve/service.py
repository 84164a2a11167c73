"""``SolveService``: a micro-batching solve layer over the lane-batched
solvers (counterpart of ``dispatches_tpu/serve/service.py``).

Callers submit *individual* solve requests (``submit(...) ->
SolveHandle``; ``solve_many`` for synchronous drivers); the service
groups them into shape buckets by program fingerprint
(``serve/bucket.py``), pads each batch to a small menu of power-of-two
lane counts, and drains the queue through ONE lane-batched program per
bucket — the port's PDLP solver with a lane axis (the counterpart of the
JAX package's ``jax.vmap(make_pdlp_solver)``) or its IPM.

All dispatch goes through :class:`dispatches_tpu_torch.plan.ExecutionPlan`:
the plan owns the device, staging and the dispatch-ahead window; the
service keeps only the queueing policy.  The service runs on ``cuda``
unless the caller passes ``device="cpu"`` (or a plan of its own).

Dispatch policy
---------------
* a bucket flushes when it reaches ``max_batch`` pending requests;
* any bucket whose OLDEST request has waited ``max_wait_ms`` flushes on
  the next ``submit``/``poll`` (queue mutation is guarded by a lock, and
  host-side staging happens outside it);
* the total queue is bounded by ``max_queue``: when full, the bucket
  holding the oldest pending request is flushed first (backpressure);
* a request whose ``deadline_ms`` expired before its batch dispatched
  completes with ``RequestStatus.TIMEOUT`` and is dropped from the batch.

Warm starts
-----------
IPM-path requests are warm-started from an in-memory LRU of previous
solutions keyed by request fingerprint (``utils/checkpoint.solution_x0``
reconstitutes ``x0`` behind its layout guard).  PDLP-path requests
(service-built solvers only) climb a start ladder per bucket: exact
fingerprint, then the learned predictor (its head runs on the device
through ``ExecutionPlan.run_inline``), then radius-gated parameter-space
k-NN (``serve/warmstart.py``), else a zero start — which reproduces the
cold arithmetic bit for bit, so one ``(x0, z0, kind)`` stack carries
mixed warm/cold lanes through one program.  A
:class:`warmstart.MispredictGuard` counts starts that converge slower
than the cold baseline estimate; ``DISPATCHES_TPU_WARMSTART`` kills the
whole feature.

Failure domains
---------------
No handle ever hangs: every dispatch-path exception completes all
affected handles with ``RequestStatus.ERROR``.  Batches ride the plan's
retry + lane-bisection recovery through a ``restage`` callback that
rebuilds any lane subset from host data.  On top sits the
graceful-degradation ladder, each rung counted (``serve.degrade`` /
``serve.shed``): predictor → k-NN, warm → cold, bf16 → f32 twin bucket,
and load shedding (``RequestStatus.SHED``).

Durability
----------
``journal_dir`` (or ``DISPATCHES_TPU_SERVE_JOURNAL_DIR``) arms the
write-ahead request journal (``serve/journal.py``) and the periodic
learned-state snapshots (``serve/snapshot.py``) in one directory: every
accepted request is journaled before its handle can complete, with
status records as it moves on.  ``recover_dir`` rebuilds a service from a
predecessor's directory: the snapshot restores the warm-start caches,
admission estimators, predictors and degradation rungs, and the
journal's open requests are resubmitted (once each, through the ``orig``
re-accept link) via ``recover_nlp``/``recover_base_solver`` into
``recovered_handles``.  ``drain()`` writes a final snapshot and the
clean-shutdown marker.  Disarmed, the service holds no journal object.

``ServeOptions.mesh`` goes to the plan: batches whose lane count divides
the mesh run as lane shards, one per mesh entry.  With
``DISPATCHES_TPU_OBS_PROFILE`` on, each bucket program's first call of a
lane count records a cost card, which seeds the admission estimate
before the first dispatch completes.

Telemetry
---------
``DISPATCHES_TPU_OBS_EXPORT_DIR`` arms a continuous exporter
(``obs/export.py``) at construction, ticked from ``submit``/``poll`` on
the service clock (or attach one with :meth:`SolveService.attach_exporter`).
``DISPATCHES_TPU_OBS_FLIGHT_DIR`` arms the flight recorder
(``obs/flight.py``): deadline misses, non-converged lanes, dispatch
failures, warm mispredicts, degradation rungs and load shedding each
dump a bundle.  Disarmed, each hook is one ``is None`` or ``enabled()``
check before any context is built.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from dispatches_tpu_torch.analysis.flags import flag_name
from dispatches_tpu_torch.analysis.runtime import sanitized_lock
from dispatches_tpu_torch.faults import inject as _faults
from dispatches_tpu_torch.learn import predictor as learn_predictor
from dispatches_tpu_torch.learn import train as learn_train
from dispatches_tpu_torch.obs import export as obs_export
from dispatches_tpu_torch.obs import flight as obs_flight
from dispatches_tpu_torch.obs import registry as obs_registry
from dispatches_tpu_torch.obs import trace as obs_trace
from dispatches_tpu_torch.plan import ExecutionPlan, PlanOptions
from dispatches_tpu_torch.serve import admission, warmstart
from dispatches_tpu_torch.serve import journal as journal_mod
from dispatches_tpu_torch.serve import snapshot as snapshot_mod
from dispatches_tpu_torch.serve.bucket import (
    freeze_options,
    params_signature,
    request_fingerprint,
)
from dispatches_tpu_torch.serve.metrics import (
    BucketStats,
    LatencyWindow,
    QueueWaitWindow,
    format_stats,
)
from dispatches_tpu_torch.solvers.ipm import IPMOptions, make_ipm_solver
from dispatches_tpu_torch.solvers.pdlp import (
    PDLPOptions,
    START_COLD,
    START_EXACT,
    START_KIND_NAMES,
    START_NEIGHBOR,
    START_PREDICTED,
    make_lp_data,
    make_pdlp_solver,
    resolve_pdlp_precision,
)
from dispatches_tpu_torch.utils.tree import tree_map

__all__ = [
    "RequestStatus",
    "ServeOptions",
    "ServeResult",
    "SolveHandle",
    "SolveService",
    "get_default_service",
    "set_default_service",
]

_PDLP_FIELDS = set(PDLPOptions.__dataclass_fields__)
#: held while a bucket is built: building differentiates the model with
#: ``torch.func.jacfwd``, whose forward-AD levels are process-wide state
#: in torch, so two threads building at once (concurrent first submits,
#: a worker's RPC threads) corrupt each other's levels.  A leaf lock: no
#: other lock is taken under it.
_BUILD_LOCK = threading.Lock()
_IPM_FIELDS = set(IPMOptions._fields)


def _np(a) -> np.ndarray:
    """Host numpy view of an array or tensor (one device→host copy)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class RequestStatus:
    QUEUED = "QUEUED"
    DONE = "DONE"
    TIMEOUT = "TIMEOUT"
    #: terminal: the request's dispatch failed (its lane was isolated as
    #: guilty by plan bisection, or the whole batch's dispatch raised)
    ERROR = "ERROR"
    #: terminal: load-shed at submit — the request was never queued
    SHED = "SHED"


@dataclass(frozen=True)
class ServeOptions:
    """Dispatch-policy knobs (env-overridable, see ``from_env``); the JAX
    package's fields."""

    max_batch: int = 64        # flush threshold == max lanes per dispatch
    max_wait_ms: float = 10.0  # oldest-request age that forces a flush
    max_queue: int = 1024      # total pending bound (backpressure)
    warm_start: bool = True    # feed cached solutions back as starts
    warm_cache_size: int = 512
    latency_window: int = 4096
    #: optional 1-D device mesh (``parallel.sharding.scenario_mesh``):
    #: batches whose lane count divides the mesh are dispatched as lane
    #: shards, one per mesh entry; other batches stay whole.  Lane counts
    #: map to one placement each, so the one-program-per-(bucket,
    #: lane-count) accounting is unchanged.
    mesh: Optional[object] = None
    #: caller-owned :class:`ExecutionPlan`; None builds one from
    #: ``PlanOptions.from_env()`` on the service's device
    plan: Optional[object] = None
    #: service-level default precision tier of the buckets it builds
    pdlp_precision: Optional[str] = None
    #: load-shedding rung: pending depth at/above which submits SHED
    shed_queue_depth: Optional[int] = None
    #: degradation rung 1: consecutive warm mispredicts before cold
    degrade_mispredicts: int = 4
    #: degradation rung 2: refine-failed lanes before the f32 twin
    degrade_refine_fails: int = 3
    #: adaptive batch forming (deadline- and service-time-aware close)
    adaptive_wait: bool = False
    #: adaptive-wait hold cap (None = 4 × max_wait_ms)
    hold_max_ms: Optional[float] = None
    #: safety factor on the service-time estimate
    deadline_guard: float = 1.25

    @classmethod
    def from_env(cls, **overrides) -> "ServeOptions":
        """Defaults with ``DISPATCHES_TPU_SERVE_*`` env overrides."""
        env: Dict = {}
        raw = os.environ.get(flag_name("SERVE_MAX_BATCH"), "")
        if raw:
            env["max_batch"] = int(raw)
        raw = os.environ.get(flag_name("SERVE_MAX_WAIT_MS"), "")
        if raw:
            env["max_wait_ms"] = float(raw)
        raw = os.environ.get(flag_name("SERVE_MAX_QUEUE"), "")
        if raw:
            env["max_queue"] = int(raw)
        raw = os.environ.get(flag_name("SERVE_SHED_QUEUE_DEPTH"), "")
        if raw:
            env["shed_queue_depth"] = int(raw)
        raw = os.environ.get(flag_name("SERVE_DEGRADE_MISPREDICTS"), "")
        if raw:
            env["degrade_mispredicts"] = int(raw)
        raw = os.environ.get(flag_name("SERVE_DEGRADE_REFINE_FAILS"), "")
        if raw:
            env["degrade_refine_fails"] = int(raw)
        raw = os.environ.get(flag_name("SERVE_ADAPTIVE_WAIT"), "")
        if raw:
            env["adaptive_wait"] = raw not in ("0", "false", "False")
        raw = os.environ.get(flag_name("SERVE_HOLD_MAX_MS"), "")
        if raw:
            env["hold_max_ms"] = float(raw)
        env.update(overrides)
        return cls(**env)


class ServeResult(NamedTuple):
    status: str
    result: Optional[object]   # lane-sliced LPResult/IPMResult (DONE only)
    obj: Optional[float]       # scalar objective (DONE only)
    latency_ms: float


class SolveHandle:
    """Future-style handle for one submitted request.  ``result()``
    blocks by draining the owning bucket (synchronous service)."""

    __slots__ = ("_service", "_bucket", "params", "x0", "submitted_at",
                 "deadline_at", "warm_key", "_result", "request_id",
                 "_t_submit_us", "start", "param_vec")

    def __init__(self, service, bucket, params, submitted_at, deadline_at,
                 request_id):
        self._service = service
        self._bucket = bucket
        self.params = params
        self.x0 = None
        self.submitted_at = submitted_at
        self.deadline_at = deadline_at
        self.warm_key = None
        #: warm-bucket (pdlp) lanes: per-lane ``(x0, z0, kind)`` start
        #: staged at submit; ``param_vec`` feeds the neighbor index
        self.start = None
        self.param_vec = None
        self._result = None
        #: monotonic per-service id minted at submit
        self.request_id = request_id
        # trace-clock submit timestamp for the retroactive journey spans
        self._t_submit_us = obs_trace.now_us()

    @property
    def bucket_label(self) -> str:
        return self._bucket.stats.label

    @property
    def status(self) -> str:
        return RequestStatus.QUEUED if self._result is None else self._result.status

    def done(self) -> bool:
        return self._result is not None

    def result(self, timeout: Optional[float] = None) -> ServeResult:
        """Drain the owning bucket until this request completes;
        ``timeout`` (seconds on the service's clock) bounds the drain
        with ``TimeoutError``."""
        deadline = (None if timeout is None
                    else self._service._clock() + timeout)
        while self._result is None:
            if self._service._flush_bucket(self._bucket) == 0:
                raise RuntimeError(
                    "request is neither pending nor completed — was the "
                    "service reset while this handle was outstanding?"
                )
            if (deadline is not None and self._result is None
                    and self._service._clock() >= deadline):
                raise TimeoutError(
                    f"request {self.request_id} still pending after "
                    f"{timeout} s (bucket {self.bucket_label!r})"
                )
        return self._result

    def _complete(self, serve_result: ServeResult) -> None:
        self._result = serve_result


class _WarmStartCache:
    """In-memory counterpart of ``utils/checkpoint.warm_start_from``:
    holds the UNRAVELED physical solution dict per request fingerprint
    and reconstitutes ``x0`` through ``checkpoint.solution_x0`` (a
    changed model yields None — a cold start — never a mis-shaped
    vector)."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._d: "OrderedDict[object, dict]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._d)

    def get(self, key, nlp) -> Optional[np.ndarray]:
        from dispatches_tpu_torch.utils.checkpoint import solution_x0

        sol = self._d.get(key)
        if sol is None:
            return None
        self._d.move_to_end(key)
        return solution_x0(sol, nlp)

    def put(self, key, nlp, lane_result) -> None:
        self._d[key] = nlp.unravel(lane_result.x)
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)


def _predict_head_fn(n: int):
    """Lane-batched predictor head for the warm-start ladder's rung 0.

    ``(weights, vecs, (x0, z0, kind)) -> (x0', z0', kind)``: lanes whose
    kind is ``START_PREDICTED`` get their zero placeholder start replaced
    by the MLP's prediction; every other lane passes through.  Weights
    are an argument, so online refits rebuild nothing, and the output is
    the solver program's start stack, on the device."""

    def head(weights, vecs, start):
        x0, z0, kind = start
        y = learn_predictor.forward(weights, vecs)
        is_pred = (kind == START_PREDICTED)[:, None]
        return (torch.where(is_pred, y[:, :n].to(x0.dtype), x0),
                torch.where(is_pred, y[:, n:].to(z0.dtype), z0),
                kind)

    return head


class _Bucket:
    """One shape bucket: a resolved solver kind, its plan program
    (signature-counted inside ``ExecutionPlan.program``), and the
    pending queue."""

    def __init__(self, nlp, solver: str, options: Dict, label: str,
                 plan: ExecutionPlan, warm_start: bool = False):
        self.nlp = nlp
        self.pending: "deque[SolveHandle]" = deque()
        # graceful-degradation ladder state: rung 0 (predictor → k-NN),
        # rung 1 (warm → cold), rung 2 (bf16 → f32 twin via `rebuild`)
        self.predict_consec_mispredicts = 0
        self.predict_fallback = False
        self.predict_trainer = None
        self.predict_program = None
        self.predict_weights = None  # device tensors of the live fit
        self.warm_consec_mispredicts = 0
        self.warm_fallback = False
        self.refine_fails = 0
        self.redirect: Optional["_Bucket"] = None
        self.rebuild = None
        dev = plan.device
        kind = solver.lower()
        opts = dict(options or {})
        self.precision = resolve_pdlp_precision(opts.get("precision"))
        base = opts.pop("base_solver", None)
        # caller-supplied base_solver opt-in to the warm start contract;
        # warm_dims declares the (n, m) start-vector sizes
        warm_contract = bool(opts.pop("warm_contract", False))
        warm_dims = opts.pop("warm_dims", None)
        self.warm = False
        warm_nm = None  # (n, m) start-vector dims for warm-capable pdlp
        warm_dtype = np.float64
        if base is not None:
            kind = "ipm" if kind in ("auto", "ipm", "ipopt") else "pdlp"
            if (kind == "pdlp" and warm_start and warm_contract
                    and warm_dims is not None):
                warm_nm = (int(warm_dims[0]), int(warm_dims[1]))
                warm_dtype = np.dtype(opts.get("dtype", "float64"))
        elif kind in ("auto", "pdlp", "cbc"):
            lp_kw = {k: v for k, v in opts.items() if k in _PDLP_FIELDS}
            lp_kw.setdefault("tol", 1e-8)
            lp_kw.setdefault("dtype", "float64")
            try:
                lp_data = make_lp_data(nlp, device=dev)
                base = make_pdlp_solver(nlp, PDLPOptions(**lp_kw),
                                        lp_data=lp_data, device=dev)
                kind = "pdlp"
                if warm_start:
                    warm_nm = (int(np.asarray(lp_data["lb"]).size),
                               int(lp_data["K"].shape[0]
                                   + lp_data["G"].shape[0]))
                    warm_dtype = np.dtype(lp_kw["dtype"])
            except ValueError:
                if kind != "auto":
                    raise
                kind = "ipm"
        elif kind not in ("ipm", "ipopt"):
            raise ValueError(
                f"unknown serve solver kind {solver!r}; expected "
                "'auto', 'pdlp', 'cbc', 'ipm' or 'ipopt'"
            )
        if base is None:  # ipm / ipopt / auto-fallback
            ipm_kw = {k: v for k, v in opts.items() if k in _IPM_FIELDS}
            base = make_ipm_solver(
                nlp, IPMOptions(**ipm_kw) if ipm_kw else IPMOptions(),
                device=dev)
            kind = "ipm"
        self.kind = kind
        self.stats = BucketStats(label)
        self.est = admission.ServiceTimeEstimate(label)
        self.arrivals = admission.ArrivalEstimate()
        self.obs_latency = obs_registry.histogram(
            "serve.latency_ms", "per-request solve latency"
        ).labeled(bucket=label)
        self.obs_queue_wait = obs_registry.histogram(
            "serve.queue_wait_ms", "request queue wait (submit -> dispatch)"
        ).labeled(bucket=label)
        if kind == "ipm":
            # x0 always passed: one program signature per lane count
            # whether lanes are cold (default x0) or warm-started
            self.default_x0 = np.asarray(nlp.x0) * np.asarray(nlp.var_scale)
            self.program = plan.program(
                base, label=f"serve.{label}", vmap_axes=(0, 0),
                donate_argnums=(1,) if plan.options.donate else ())
        elif warm_nm is not None:
            # warm-capable pdlp bucket: every lane carries a
            # (x0, z0, kind) start; cold lanes pass zeros, which
            # reproduce the cold init arithmetic bit for bit
            self.default_x0 = None
            n, m = warm_nm
            self.warm = True
            self.warm_dtype = warm_dtype
            self.warm_cold_start = (np.zeros(n, warm_dtype),
                                    np.zeros(m, warm_dtype),
                                    np.int32(START_COLD))
            self.warm_index = warmstart.WarmStartIndex()
            self.warm_guard = warmstart.MispredictGuard()
            # ladder rung 0, the learned predictor: kill-switch OFF
            # means nothing is constructed.  The head is a separate
            # program, so its signatures are not in bucket.compiles.
            if learn_predictor.predict_enabled():
                self.predict_trainer = learn_train.OnlineTrainer(n, m, device=dev)
                self.warm_pred_start = (self.warm_cold_start[0],
                                        self.warm_cold_start[1],
                                        np.int32(START_PREDICTED))
                self.predict_program = plan.program(
                    _predict_head_fn(n),
                    label=f"serve.{label}.predict",
                    vmap_axes=(None, 0, 0),
                    donate_argnums=(2,) if plan.options.donate else ())
            self.program = plan.program(
                base, label=f"serve.{label}", vmap_axes=(0, 0),
                donate_argnums=(1,) if plan.options.donate else ())
        else:
            self.default_x0 = None
            self.program = plan.program(base, label=f"serve.{label}",
                                        vmap_axes=0, donate_argnums=())

    @property
    def compiles(self) -> int:
        return self.program.compiles


class SolveService:
    """Micro-batching solve service over the lane-batched solvers.

    ``clock`` is injectable (defaults to ``time.monotonic``) so tests
    drive the max-wait / deadline policy deterministically.  ``device``
    (``cuda`` unless given) is where the service's own plan stages
    batches; a caller-owned plan (``ServeOptions.plan``) carries its
    own device.

    Durability: ``journal_dir`` (or ``DISPATCHES_TPU_SERVE_JOURNAL_DIR``)
    arms the write-ahead journal and the snapshot writer (every
    ``snapshot_interval_s`` on the service clock; default
    ``DISPATCHES_TPU_SERVE_SNAPSHOT_INTERVAL_S`` or 30 s) in one
    directory.  ``recover_dir`` restores a predecessor's snapshot and
    resubmits its journal's open requests through ``recover_nlp`` and
    ``recover_base_solver`` (a callable, as ``submit``'s ``base_solver``),
    landing them in ``recovered_handles`` with counts in ``recovery``; a
    recovering service journals into that directory unless given
    another."""

    def __init__(self, options: Optional[ServeOptions] = None, *,
                 clock: Callable[[], float] = time.monotonic,
                 device=None,
                 journal_dir: Optional[str] = None,
                 recover_dir: Optional[str] = None,
                 recover_nlp=None, recover_base_solver=None,
                 snapshot_interval_s: Optional[float] = None):
        self.options = options if options is not None else ServeOptions.from_env()
        self._clock = clock
        if self.options.plan is not None:
            self.plan = self.options.plan
            if device is not None and torch.device(device) != self.plan.device:
                raise ValueError(
                    f"device={device!r} disagrees with the plan's device "
                    f"{self.plan.device}")
        else:
            self.plan = ExecutionPlan(
                PlanOptions.from_env(mesh=self.options.mesh, device=device))
        # guards queue mutation only — host-side staging runs outside it
        self._lock = sanitized_lock("serve.service", reentrant=True)
        self._buckets: Dict = {}
        self._latency = LatencyWindow(self.options.latency_window)
        self._queue_wait = QueueWaitWindow(self.options.latency_window)
        self._warm = _WarmStartCache(self.options.warm_cache_size)
        self._warm_hits = 0
        self._warm_misses = 0
        self._warm_neighbor_hits = 0
        self._warm_predicted = 0
        self._submitted = 0
        self._solved = 0
        self._timeouts = 0
        self._errors = 0
        self._shed = 0
        self._flushes = 0
        #: injectable shed signal: while it returns True, new submits
        #: complete immediately as SHED
        self.shed_signal: Optional[Callable[[], bool]] = None
        self._deadline_requests = 0   # submitted with a deadline
        self._deadline_missed = 0     # TIMEOUT or completed past deadline
        self._request_seq = itertools.count(1)
        self._draining = False
        # process-wide mirrors (obs.registry); the per-service numbers
        # above stay authoritative for format_stats()
        _requests = obs_registry.counter(
            "serve.requests", "solve-service request events")
        self._obs_submitted = _requests.labeled(event="submitted")
        self._obs_solved = _requests.labeled(event="solved")
        self._obs_timeout = _requests.labeled(event="timeout")
        self._obs_error = _requests.labeled(event="error")
        self._obs_shed_evt = _requests.labeled(event="shed")
        self._obs_shed = obs_registry.counter(
            "serve.shed", "requests load-shed at submit "
            "(queue-depth / burn-signal rung; label = bucket)")
        self._obs_degrade = obs_registry.counter(
            "serve.degrade", "graceful-degradation rungs engaged "
            "(rung=predict_knn|warm_cold|precision; label = bucket)")
        self._obs_predict_starts = obs_registry.counter(
            "predict.starts", "warm-start lanes seeded by the learned "
            "predictor (ladder rung 0; label = bucket)")
        self._obs_predict_refits = obs_registry.counter(
            "predict.refits", "online warm-start predictor refits from "
            "the replay buffer, ticked from poll (label = bucket)")
        self._obs_predict_mispredicts = obs_registry.counter(
            "predict.mispredicts", "predicted starts that converged "
            "slower than the cold-baseline EMA (label = bucket)")
        self._obs_batches = obs_registry.counter(
            "serve.batches", "solve-service batches dispatched")
        _deadline = obs_registry.counter(
            "serve.deadline", "deadline outcomes for deadline-bearing "
            "requests (event=met|missed)")
        self._obs_deadline_met = _deadline.labeled(event="met")
        self._obs_deadline_missed = _deadline.labeled(event="missed")
        self._obs_queue_depth = obs_registry.gauge(
            "serve.queue_depth", "solve-service pending requests across "
            "all buckets (flight bundles snapshot it at trigger time)")
        self._obs_queue_depth.set(0.0)
        # continuous export: armed by OBS_EXPORT_DIR and ticked from
        # submit/poll on the service's own clock — disarmed, the hot path
        # pays one `is None` check
        self._exporter = None
        if obs_export.enabled():
            try:
                self._exporter = obs_export.ContinuousExporter(
                    clock=self._clock)
            except Exception:
                self._exporter = None
        # durability: write-ahead journal + learned-state snapshots share
        # one directory; disarmed, the hot paths pay one `is None` branch
        self.generation = 1
        self._restored_buckets: Dict[str, Dict] = {}
        self.recovered_handles: List[SolveHandle] = []
        self.recovery: Optional[Dict] = None
        # while recovering, the journal id each resubmission supersedes
        self._resubmit_origin: Optional[int] = None
        self._journal = None
        self._snapshots = None
        durable_dir = journal_dir
        if durable_dir is None and journal_mod.enabled():
            durable_dir = journal_mod.default_dir()
        if durable_dir is None and recover_dir is not None:
            # recovering implies staying durable, in the same directory
            durable_dir = recover_dir
        replayed = None
        t0_recover = 0.0
        if recover_dir is not None:
            t0_recover = time.perf_counter()
            state = snapshot_mod.load_state(recover_dir)
            if state is not None:
                snapshot_mod.apply_to_service(self, state)
            replayed = journal_mod.replay(recover_dir)
            if replayed.max_id:
                # ids stay unique across generations sharing the directory
                self._request_seq = itertools.count(replayed.max_id + 1)
        if durable_dir is not None:
            if snapshot_interval_s is None:
                raw = os.environ.get(flag_name("SERVE_SNAPSHOT_INTERVAL_S"), "")
                snapshot_interval_s = (float(raw) if raw
                                       else snapshot_mod.DEFAULT_INTERVAL_S)
            self._journal = journal_mod.RequestJournal(durable_dir)
            self._snapshots = snapshot_mod.SnapshotWriter(
                durable_dir, interval_s=float(snapshot_interval_s))
        if replayed is not None:
            self._resubmit(replayed, recover_nlp, recover_base_solver, t0_recover)
        if self.generation > 1:
            try:
                obs_export.set_restart_generation(self.generation)
            except Exception:
                pass

    def _resubmit(self, replayed, nlp, base_solver, t0: float) -> None:
        """Constructor-time recovery: resubmit every request the journal
        says was QUEUED or DISPATCHED at death.  Deadlines restart their
        relative budget (the original instant lived on a dead process's
        clock)."""
        recovered = 0
        lost = replayed.lost
        for rec in replayed.open_requests:
            if nlp is None:
                lost += 1
                continue
            try:
                self._resubmit_origin = rec.get("id")
                handle = self.submit(
                    nlp, rec["params"], solver=rec["solver"],
                    options=rec["options"], deadline_ms=rec["deadline_ms"],
                    base_solver=base_solver)
            except Exception:
                lost += 1
                continue
            finally:
                self._resubmit_origin = None
            self.recovered_handles.append(handle)
            recovered += 1
        self.recovery = {
            "recovered": recovered,
            "lost": lost,
            "clean_shutdown": replayed.clean_shutdown,
            "torn_records": replayed.torn,
            "recovery_ms": (time.perf_counter() - t0) * 1e3,
        }

    def attach_exporter(self, exporter) -> None:
        """Attach a caller-built :class:`obs.export.ContinuousExporter`
        (tests and the soak pass one on their own clock; production arms
        one through ``DISPATCHES_TPU_OBS_EXPORT_DIR`` at construction)."""
        self._exporter = exporter

    # -- bucket resolution -------------------------------------------------

    def _bucket_for(self, nlp, solver: str, options: Dict, params,
                    base_solver) -> _Bucket:
        opts = dict(options or {})
        if self.options.pdlp_precision is not None:
            opts.setdefault("precision", self.options.pdlp_precision)
        # fold the RESOLVED precision tier into the bucket key
        prec = resolve_pdlp_precision(opts.pop("precision", None))
        opts["precision"] = prec
        opts_key = freeze_options(opts)
        key = (id(nlp), solver.lower(), opts_key, prec,
               params_signature(params),
               id(base_solver) if base_solver is not None else None)
        bucket = self._buckets.get(key)
        # id() keys can collide after GC reuses an address; the bucket
        # pins the nlp strongly, so a mismatch is a different object
        if bucket is not None and bucket.nlp is not nlp:
            bucket = None
        if bucket is None:
            label = f"{solver.lower()}#{len(self._buckets)}"
            if base_solver is not None:
                opts["base_solver"] = base_solver
            warm = self.options.warm_start and warmstart.enabled()
            with _BUILD_LOCK:
                bucket = _Bucket(nlp, solver, opts, label, self.plan,
                                 warm_start=warm)
            bucket.rebuild = (nlp, solver, dict(opts), warm)
            # double-checked insert: two first-submit threads can both
            # miss and build; the loser's twin is discarded unseen
            inserted = False
            with self._lock:
                raced = self._buckets.get(key)
                if raced is not None and raced.nlp is nlp:
                    bucket = raced
                else:
                    self._buckets[key] = bucket
                    inserted = True
            if inserted:
                # recovery: learned state a snapshot stashed under this
                # label (the one bucket identity that survives a process)
                restored = self._restored_buckets.pop(label, None)
                if restored is not None:
                    try:
                        snapshot_mod.apply_bucket_state(bucket, restored)
                    except Exception:
                        pass  # a stale snapshot must never block serving
        # degradation rung 2 leaves a redirect on the original bucket
        while bucket.redirect is not None:
            bucket = bucket.redirect
        return bucket

    # -- submission --------------------------------------------------------

    def _now(self) -> float:
        """Service clock read, plus any armed ``service.clock`` skew."""
        now = self._clock()
        if _faults.armed():
            now += _faults.clock_skew()
        return now

    def submit(self, nlp, params=None, x0=None, *, solver: str = "auto",
               options: Optional[Dict] = None,
               deadline_ms: Optional[float] = None,
               warm_key=None, base_solver=None) -> SolveHandle:
        """Queue one solve request and return its handle.

        ``params`` follows ``nlp.default_params()`` structure (defaults
        used when None).  ``x0`` (physical, IPM path only) overrides the
        warm-start cache.  ``deadline_ms`` is relative to submission; an
        expired request completes with ``TIMEOUT``.  ``base_solver`` lets
        a caller supply its own lane-batched ``solve(params, x0)``
        callable (bucketed by identity).  When the load-shedding rung
        fires, the handle completes immediately with ``SHED``."""
        if self._draining:
            raise RuntimeError(
                "service is draining: submissions are closed")
        now = self._now()
        self.poll(now)
        params = nlp.default_params() if params is None else params
        bucket = self._bucket_for(nlp, solver, options, params, base_solver)
        deadline_at = None if deadline_ms is None else now + deadline_ms / 1e3
        shed_depth = self.options.shed_queue_depth
        if ((shed_depth is not None
             and self._queue_depth() >= shed_depth)
                or (self.shed_signal is not None and self.shed_signal())):
            return self._shed_request(bucket, params, now, deadline_at)
        while self._queue_depth() >= self.options.max_queue:
            if self._flush_oldest() == 0:
                break  # nothing pending anywhere (max_queue == 0 edge)
        handle = SolveHandle(self, bucket, params, now, deadline_at,
                             next(self._request_seq))
        if deadline_at is not None:
            self._deadline_requests += 1
        if bucket.kind == "ipm":
            handle.warm_key = (warm_key if warm_key is not None
                               else (bucket.stats.label,
                                     request_fingerprint(params)))
            if x0 is None and self.options.warm_start:
                x0 = self._warm.get(handle.warm_key, nlp)
                if x0 is None:
                    self._warm_misses += 1
                else:
                    self._warm_hits += 1
            # cast to the bucket's x0 dtype on ingest (host staging,
            # before the lock)
            handle.x0 = np.asarray(
                bucket.default_x0 if x0 is None else _np(x0),
                dtype=bucket.default_x0.dtype)
        elif bucket.warm and bucket.warm_fallback:
            # degradation rung 1: cold starts, no lookups, no write-back
            handle.start = bucket.warm_cold_start
        elif bucket.warm:
            handle.warm_key = (warm_key if warm_key is not None
                               else (bucket.stats.label,
                                     request_fingerprint(params)))
            # exact fingerprint, then the predictor, then radius-gated
            # neighbors, else a zero start (bitwise the cold init)
            handle.param_vec = warmstart.param_vector(params)
            dt = bucket.warm_dtype
            trainer = bucket.predict_trainer
            sol = bucket.warm_index.exact(handle.warm_key)
            if sol is not None:
                self._warm_hits += 1
                handle.start = (np.asarray(sol[0], dt),
                                np.asarray(sol[1], dt),
                                np.int32(START_EXACT))
            elif (trainer is not None and not bucket.predict_fallback
                    and trainer.ready()):
                # ladder rung 0: the zero placeholder tagged
                # START_PREDICTED; the predict head fills it on the
                # device at dispatch time
                self._warm_predicted += 1
                self._obs_predict_starts.inc(bucket=bucket.stats.label)
                handle.start = bucket.warm_pred_start
            else:
                nb = bucket.warm_index.nearest(handle.param_vec)
                if nb is not None:
                    self._warm_neighbor_hits += 1
                    handle.start = (np.asarray(nb[0], dt),
                                    np.asarray(nb[1], dt),
                                    np.int32(START_NEIGHBOR))
                else:
                    self._warm_misses += 1
                    handle.start = bucket.warm_cold_start
        if self._journal is not None:
            # write-ahead: the accept record must be durable before the
            # handle enters the queue, where a concurrent flush could
            # complete it
            self._journal.accept(
                handle.request_id, request_fingerprint(params),
                solver=solver, options=options, deadline_ms=deadline_ms,
                t=now, params=params, origin=self._resubmit_origin)
        with self._lock:
            bucket.pending.append(handle)
            bucket.stats.record_submitted()
            bucket.arrivals.observe(now)
            self._submitted += 1
            # the flush decision and the exported depth under the same
            # lock that appended
            should_flush = len(bucket.pending) >= self.options.max_batch
            depth = self._queue_depth()
        self._obs_submitted.inc()
        self._obs_queue_depth.set(float(depth))
        if should_flush:
            self._flush_bucket(bucket)
        if self._exporter is not None:
            self._exporter.maybe_export(self._clock())
        return handle

    def _shed_request(self, bucket: _Bucket, params, now: float,
                      deadline_at: Optional[float]) -> SolveHandle:
        """Load-shedding rung: complete a request as ``SHED`` at submit
        time, before it ever deepens the queue."""
        label = bucket.stats.label
        handle = SolveHandle(self, bucket, params, now, deadline_at,
                             next(self._request_seq))
        handle._complete(ServeResult(RequestStatus.SHED, None, None, 0.0))
        with self._lock:
            bucket.stats.record_submitted()
            bucket.stats.record_shed()
            self._submitted += 1
            self._shed += 1
        self._obs_submitted.inc()
        self._obs_shed_evt.inc()
        self._obs_shed.inc(bucket=label)
        if obs_trace.enabled():
            t_us = obs_trace.now_us()
            obs_trace.complete(
                "serve.request", handle._t_submit_us,
                t_us - handle._t_submit_us, request_id=handle.request_id,
                bucket=label, status=RequestStatus.SHED)
        if obs_flight.enabled():
            obs_flight.trigger(
                "shed", request_id=handle.request_id, bucket=label,
                label=f"serve.{label}",
                solver_options={"kind": bucket.kind,
                                "precision": bucket.precision},
                detail={"queue_depth": self._queue_depth(),
                        "shed_queue_depth": self.options.shed_queue_depth})
        return handle

    def solve(self, nlp, params=None, x0=None, **submit_kw):
        """Blocking single solve through the service; returns the raw
        lane result (LPResult/IPMResult)."""
        sr = self.submit(nlp, params, x0, **submit_kw).result()
        if sr.status != RequestStatus.DONE:
            raise RuntimeError(f"serve solve finished with status {sr.status}")
        return sr.result

    def solve_many(self, nlp, params_list: Sequence, x0s=None,
                   **submit_kw) -> List[ServeResult]:
        """Submit a list of requests for one nlp, drain, and return
        results in submission order."""
        handles = [
            self.submit(nlp, p, None if x0s is None else x0s[i], **submit_kw)
            for i, p in enumerate(params_list)
        ]
        self.flush_all()
        return [h.result() for h in handles]

    # -- dispatch ----------------------------------------------------------

    def poll(self, now: Optional[float] = None) -> int:
        """Flush every bucket whose batch is due to close (after
        ``max_wait_ms``, or at the instant :meth:`_close_due_at` computes
        with ``adaptive_wait``); then refit due predictors.  Returns the
        number of requests dispatched or timed out."""
        now = self._now() if now is None else now
        n = 0
        for bucket in self._buckets_by_slack(now):
            while bucket.pending and now >= self._close_due_at(bucket, now):
                n += self._flush_bucket(bucket)
        if self._exporter is not None:
            self._exporter.maybe_export(now)
        if self._snapshots is not None:
            try:
                self._snapshots.maybe_snapshot(self, now)
            except Exception:
                pass  # a full disk must not take serving down with it
        # online predictor refit — the one expensive learn call, at most
        # one per refit_every completed results per bucket
        for bucket in list(self._buckets.values()):
            trainer = bucket.predict_trainer
            if (trainer is None or bucket.predict_fallback
                    or not trainer.due()):
                continue
            try:
                trainer.refit()
            except Exception:
                continue  # bad data must never take serving down
            dev = self.plan.device
            bucket.predict_weights = {
                k: torch.as_tensor(v, device=dev)
                for k, v in trainer.predictor.params.items()}
            self._obs_predict_refits.inc(bucket=bucket.stats.label)
        return n

    def flush_all(self) -> int:
        """Drain every pending request through the plan's dispatch-ahead
        window, then drain the plan; returns how many were handled."""
        n = 0
        for bucket in self._buckets_by_slack():
            while bucket.pending:
                n += self._dispatch_bucket(bucket)[0]
        self.plan.drain()
        return n

    # -- admission policy (adaptive batch forming) -------------------------

    def _close_due_at(self, bucket: _Bucket, now: float) -> float:
        """The instant this bucket's current batch should close: the
        oldest request's age reaching ``max_wait_ms``; with
        ``adaptive_wait``, earlier when a tight deadline needs it and
        later (up to ``hold_max_ms``) while the next arrival is free."""
        oldest = bucket.pending[0]
        wait_s = self.options.max_wait_ms / 1e3
        due = oldest.submitted_at + wait_s
        if not self.options.adaptive_wait:
            return due
        est_s = bucket.est.estimate_s()
        guard = self.options.deadline_guard
        deadlines = [r.deadline_at for r in bucket.pending
                     if r.deadline_at is not None]
        tightest = min(deadlines) if deadlines else None
        if tightest is not None and est_s is not None:
            latest_safe = tightest - est_s * guard
            if latest_safe < due:
                return max(latest_safe, oldest.submitted_at)
        if len(bucket.pending) >= self.options.max_batch:
            return now  # full batch: nothing left to coalesce
        gap_s = bucket.arrivals.gap_s()
        if gap_s is not None:
            hold_ms = (self.options.hold_max_ms
                       if self.options.hold_max_ms is not None
                       else 4.0 * self.options.max_wait_ms)
            hold_cap = oldest.submitted_at + hold_ms / 1e3
            eta = now + gap_s
            free = (tightest is None or est_s is None
                    or eta + est_s * guard <= tightest)
            if free:
                return min(max(due, eta), hold_cap)
        return due

    def _buckets_by_slack(self, now: Optional[float] = None) -> List[_Bucket]:
        """Dispatch order across buckets: tightest deadline slack first
        with ``adaptive_wait``; creation order (and no clock read)
        otherwise."""
        buckets = list(self._buckets.values())
        if not self.options.adaptive_wait:
            return buckets
        now = self._now() if now is None else now

        def slack(bucket: _Bucket) -> float:
            deadlines = [r.deadline_at for r in bucket.pending
                         if r.deadline_at is not None]
            if not deadlines:
                return float("inf")
            est_s = bucket.est.estimate_s() or 0.0
            return min(deadlines) - now - est_s

        return sorted(buckets, key=slack)

    def _queue_depth(self) -> int:
        # list() snapshot: a concurrent first-submit may insert a bucket
        return sum(len(b.pending) for b in list(self._buckets.values()))

    def _flush_oldest(self) -> int:
        """Backpressure relief: flush the bucket holding the oldest
        pending request."""
        oldest = None
        for bucket in list(self._buckets.values()):
            if bucket.pending and (
                    oldest is None
                    or bucket.pending[0].submitted_at
                    < oldest.pending[0].submitted_at):
                oldest = bucket
        return 0 if oldest is None else self._flush_bucket(oldest)

    def _flush_bucket(self, bucket: _Bucket) -> int:
        """Synchronous flush: dispatch one batch through the plan and
        fence it; returns the number of requests completed."""
        n, ticket = self._dispatch_bucket(bucket)
        if ticket is not None:
            self.plan.collect(ticket)
        return n

    def _dispatch_bucket(self, bucket: _Bucket):
        """Triage + host-side staging + plan dispatch for up to
        max_batch requests of one bucket: ``(n_popped, ticket|None)``.
        Completion bookkeeping runs from the plan's fence callback; only
        the queue pop holds the lock."""
        with self._lock:
            n = min(len(bucket.pending), self.options.max_batch)
            if n == 0:
                return 0, None
            self._flushes += 1
            requests = [bucket.pending.popleft() for _ in range(n)]
        self._obs_queue_depth.set(float(self._queue_depth()))
        now = self._now()
        tracing = obs_trace.enabled()
        label = bucket.stats.label
        live: List[SolveHandle] = []
        timed_out: List[int] = []
        for r in requests:
            if r.deadline_at is not None and now >= r.deadline_at:
                timed_out.append(r.request_id)
                r._complete(ServeResult(
                    RequestStatus.TIMEOUT, None, None,
                    (now - r.submitted_at) * 1e3))
                bucket.stats.record_timeout()
                self._timeouts += 1
                self._deadline_missed += 1
                self._obs_timeout.inc()
                self._obs_deadline_missed.inc()
                if tracing:
                    t_us = obs_trace.now_us()
                    obs_trace.complete(
                        "serve.request", r._t_submit_us,
                        t_us - r._t_submit_us, request_id=r.request_id,
                        bucket=label, status=RequestStatus.TIMEOUT)
                if obs_flight.enabled():
                    obs_flight.trigger(
                        "deadline_miss", request_id=r.request_id,
                        bucket=label, label=f"serve.{label}",
                        params_fingerprint=request_fingerprint(r.params),
                        solver_options={"kind": bucket.kind,
                                        "precision": bucket.precision},
                        detail={"status": RequestStatus.TIMEOUT,
                                "waited_ms": (now - r.submitted_at) * 1e3})
            else:
                live.append(r)
        if self._journal is not None and timed_out:
            self._journal.status(timed_out, RequestStatus.TIMEOUT)
        if not live:
            return n, None
        dispatch_us = obs_trace.now_us() if tracing else 0.0
        for r in live:  # queue wait = submit -> this dispatch instant
            wait_ms = (now - r.submitted_at) * 1e3
            self._queue_wait.record(label, wait_ms)
            bucket.obs_queue_wait.observe(wait_ms)
        plan = self.plan
        argnums = bucket.program.donate_argnums
        max_batch = self.options.max_batch

        def _stage_subset(subset: Sequence[SolveHandle], lanes_s: int):
            """Stack + place one lane subset from host data, padded to
            ``lanes_s`` lanes (handles keep their params/x0/start after
            dispatch, so fence-time recovery can always rebuild)."""
            batched = plan.stage(
                plan.stack([r.params for r in subset], lanes=lanes_s),
                lanes=lanes_s, donate=0 in argnums)
            if bucket.kind == "ipm":
                stack = plan.stage(
                    plan.stack([r.x0 for r in subset], lanes=lanes_s),
                    lanes=lanes_s, donate=1 in argnums)
                return (batched, stack), lanes_s
            if bucket.warm:
                stack = plan.stage(
                    plan.stack([r.start for r in subset], lanes=lanes_s),
                    lanes=lanes_s, donate=1 in argnums)
                if (bucket.predict_weights is not None
                        and any(int(r.start[2]) == START_PREDICTED
                                for r in subset)):
                    # rung-0 inference, batched on the device: the head
                    # fills the PREDICTED lanes and passes every other
                    # lane through; its output IS the start stack
                    dt = bucket.warm_dtype
                    d = int(bucket.predict_weights["in_mean"].numel())
                    vec_rows = [
                        (np.zeros(d, dt) if r.param_vec is None
                         else np.asarray(r.param_vec, dt))
                        for r in subset]
                    vec_stack = plan.stage(
                        plan.stack(vec_rows, lanes=lanes_s), lanes=lanes_s)
                    stack = plan.run_inline(
                        bucket.predict_program,
                        (bucket.predict_weights, vec_stack, stack))
                return (batched, stack), lanes_s
            return (batched,), lanes_s

        lanes = plan.lanes_for(len(live), max_batch)

        def _restage(idxs):
            # a retried or bisected subset runs at the batch's own width
            # (padded by repeating its last lane): the same program shape
            # gives each lane the bits it would have had in the batch
            sub = [live[i] for i in idxs]
            args_s, _ = _stage_subset(sub, lanes)
            return args_s, lanes, [r.request_id for r in sub]

        if self._journal is not None:
            self._journal.status([r.request_id for r in live], "DISPATCHED")
        faults_armed = _faults.armed()
        try:
            if faults_armed:
                _faults.check("serve.stage", label=f"serve.{label}",
                              request_ids=[r.request_id for r in live])
            # host-side staging: stack on the host, one transfer per
            # leaf; the padded lanes repeat the last live request
            args, _ = _stage_subset(live, lanes)
            ticket = plan.submit(
                bucket.program, args, n_live=len(live), lanes=lanes,
                on_done=lambda t: self._complete_batch(
                    bucket, live, lanes, dispatch_us, now, t),
                request_ids=([r.request_id for r in live]
                             if tracing or faults_armed else None),
                restage=_restage)
        except Exception as exc:  # noqa: BLE001 — no-hang contract
            _faults.note_recovered(exc)
            self._fail_requests(bucket, live, exc)
            return n, None
        return n, ticket

    def _fail_requests(self, bucket: _Bucket,
                       requests: Sequence[SolveHandle], exc) -> None:
        """No-hang guarantee: every handle of a failed dispatch path
        completes with a terminal ``ERROR``; ``exc`` is the failure,
        named in the flight bundle."""
        end = self._clock()
        tracing = obs_trace.enabled()
        label = bucket.stats.label
        for r in requests:
            self._complete_error(bucket, r, end, tracing)
        if obs_flight.enabled():
            obs_flight.trigger(
                "plan_error", bucket=label, label=f"serve.{label}",
                solver_options={"kind": bucket.kind,
                                "precision": bucket.precision},
                detail={"error": repr(exc),
                        "request_ids": [r.request_id for r in requests]})

    def _complete_error(self, bucket: _Bucket, r: SolveHandle,
                        end: float, tracing: bool) -> None:
        latency = (end - r.submitted_at) * 1e3
        r._complete(ServeResult(RequestStatus.ERROR, None, None, latency))
        if self._journal is not None:
            self._journal.status([r.request_id], RequestStatus.ERROR)
        bucket.stats.record_error()
        self._errors += 1
        self._obs_error.inc()
        if tracing:
            t_us = obs_trace.now_us()
            obs_trace.complete(
                "serve.request", r._t_submit_us, t_us - r._t_submit_us,
                request_id=r.request_id, bucket=bucket.stats.label,
                status=RequestStatus.ERROR)

    def _degrade(self, bucket: _Bucket, rung: str) -> None:
        """Degradation rungs 0 (``predict_knn``: predictor → k-NN) and 1
        (``warm_cold``: warm → cold starts), sticky until restart."""
        attr = "predict_fallback" if rung == "predict_knn" else "warm_fallback"
        if getattr(bucket, attr):
            return
        setattr(bucket, attr, True)
        label = bucket.stats.label
        self._obs_degrade.inc(rung=rung, bucket=label)
        if obs_flight.enabled():
            obs_flight.trigger(
                "degrade", bucket=label, label=f"serve.{label}",
                solver_options={"kind": bucket.kind,
                                "precision": bucket.precision},
                detail={"rung": rung,
                        "consecutive_mispredicts": (
                            bucket.predict_consec_mispredicts
                            if rung == "predict_knn"
                            else bucket.warm_consec_mispredicts)})

    def _degrade_precision(self, bucket: _Bucket) -> None:
        """Degradation rung 2: repeated refine-fails mean the bf16 inner
        tier cannot certify this workload — build an f32 twin bucket and
        redirect new submissions to it."""
        if bucket.redirect is not None or bucket.rebuild is None:
            return
        if resolve_pdlp_precision("f32") != "f32":
            return  # env pinned the tier; there is nothing to fall to
        nlp, solver, opts, warm = bucket.rebuild
        opts = dict(opts)
        opts["precision"] = "f32"
        label = f"{bucket.stats.label}.f32"
        with _BUILD_LOCK:
            twin = _Bucket(nlp, solver, opts, label, self.plan,
                           warm_start=warm)
        twin.rebuild = (nlp, solver, opts, warm)
        bucket.redirect = twin
        # a first-class bucket: poll/flush_all/queue-depth walk _buckets
        self._buckets[("degraded", label)] = twin
        self._obs_degrade.inc(rung="precision", bucket=bucket.stats.label)
        if obs_flight.enabled():
            obs_flight.trigger(
                "degrade", bucket=bucket.stats.label,
                label=f"serve.{bucket.stats.label}",
                solver_options={"kind": bucket.kind,
                                "precision": bucket.precision},
                detail={"rung": "precision", "to": "f32",
                        "refine_fails": bucket.refine_fails})

    def _complete_batch(self, bucket: _Bucket, live: List[SolveHandle],
                        lanes: int, dispatch_us: float,
                        dispatched_at: float, ticket) -> None:
        """Fence-time bookkeeping for one dispatched batch (runs from the
        plan's ``on_done``).  ``ticket.error.guilty`` names the lanes
        bisection could not save; with no result at all, every handle
        fails — never hangs."""
        tracing = obs_trace.enabled()
        label = bucket.stats.label
        bucket.stats.record_batch(len(live), lanes)
        self._obs_batches.inc(bucket=label)
        end = self._clock()
        bucket.est.observe_ms((end - dispatched_at) * 1e3)
        end_us = obs_trace.now_us() if tracing else 0.0
        if tracing:
            obs_trace.complete(
                "serve.batch", dispatch_us, end_us - dispatch_us,
                bucket=label, lanes=lanes, live=len(live))
        res = ticket.result
        err = ticket.error
        if res is None:
            cause = err.cause if err is not None else RuntimeError(
                "batch completed with no result")
            self._fail_requests(bucket, live, cause)
            return
        guilty = frozenset(err.guilty) if err is not None else frozenset()
        # one device→host copy per field the bookkeeping reads
        objs = _np(res.obj)
        flight_on = obs_flight.enabled()
        warm = bucket.warm and not bucket.warm_fallback
        kinds = iters_arr = xs_h = zs_h = None
        if warm:
            kinds = _np(res.start_kind).reshape(-1)
            iters_arr = _np(res.iters).reshape(-1)
            xs_h, zs_h = _np(res.x), _np(res.z)
        refine_watch = (bucket.precision == "bf16x-f32"
                        and bucket.redirect is None)
        conv = None
        if flight_on or warm or refine_watch:
            conv_arr = getattr(res, "converged", None)
            if conv_arr is not None:
                conv = _np(conv_arr).reshape(-1)
        refined = None
        if refine_watch and conv is not None:
            refined_arr = getattr(res, "refined", None)
            if refined_arr is not None:
                refined = _np(refined_arr).reshape(-1)
        n_done = 0
        done_ids: List[int] = []
        for i, r in enumerate(live):
            if i in guilty:
                # its slot in `res` is NaN filler: fail exactly this one
                self._complete_error(bucket, r, end, tracing)
                if flight_on:
                    obs_flight.trigger(
                        "plan_error", request_id=r.request_id,
                        bucket=label, label=f"serve.{label}",
                        params_fingerprint=request_fingerprint(r.params),
                        solver_options={"kind": bucket.kind,
                                        "precision": bucket.precision},
                        detail={"lane": i,
                                "error": (repr(err.cause)
                                          if err is not None else None)})
                continue
            n_done += 1
            done_ids.append(r.request_id)
            lane = tree_map(lambda a, _i=i: a[_i], res)
            latency = (end - r.submitted_at) * 1e3
            r._complete(ServeResult(
                RequestStatus.DONE, lane, float(objs[i]), latency))
            self._latency.record(label, latency)
            bucket.obs_latency.observe(latency)
            bucket.stats.record_solved()
            self._solved += 1
            missed_deadline = (r.deadline_at is not None
                               and end > r.deadline_at)
            if r.deadline_at is not None:
                if missed_deadline:
                    self._deadline_missed += 1
                    self._obs_deadline_missed.inc()
                else:
                    self._obs_deadline_met.inc()
            if tracing:
                obs_trace.complete(
                    "serve.queue_wait", r._t_submit_us,
                    dispatch_us - r._t_submit_us,
                    request_id=r.request_id, bucket=label)
                obs_trace.complete(
                    "serve.dispatch", dispatch_us, end_us - dispatch_us,
                    request_id=r.request_id, bucket=label, lanes=lanes,
                    start_kind=(START_KIND_NAMES[int(kinds[i])]
                                if kinds is not None else "cold"))
                obs_trace.complete(
                    "serve.request", r._t_submit_us,
                    end_us - r._t_submit_us, request_id=r.request_id,
                    bucket=label, status=RequestStatus.DONE)
            if flight_on and (missed_deadline
                              or (conv is not None and i < conv.size
                                  and not bool(conv[i]))):
                obs_flight.trigger(
                    "deadline_miss" if missed_deadline
                    else "solver_nonconverged",
                    request_id=r.request_id, bucket=label,
                    label=f"serve.{label}",
                    params_fingerprint=request_fingerprint(r.params),
                    solver_options={"kind": bucket.kind,
                                    "precision": bucket.precision},
                    detail={"latency_ms": latency,
                            "obj": float(objs[i]),
                            "converged": (None if conv is None
                                          or i >= conv.size
                                          else bool(conv[i]))})
            if (refined is not None and i < conv.size
                    and not bool(conv[i]) and i < refined.size
                    and float(refined[i]) > 0):
                bucket.refine_fails += 1
                if bucket.refine_fails >= self.options.degrade_refine_fails:
                    self._degrade_precision(bucket)
            if (bucket.kind == "ipm" and self.options.warm_start
                    and np.isfinite(objs[i])):
                self._warm.put(r.warm_key, bucket.nlp, lane)
            if warm:
                self._warm_feedback(bucket, r, i, kinds, iters_arr, conv,
                                    objs, xs_h, zs_h)
        if self._journal is not None and done_ids:
            self._journal.status(done_ids, RequestStatus.DONE)
        self._obs_solved.inc(n_done)

    def _warm_feedback(self, bucket: _Bucket, r: SolveHandle, i: int, kinds,
                       iters_arr, conv, objs, xs_h, zs_h) -> None:
        """Mispredict accounting, the ladder's degradation streaks, and
        the write-back of a converged, finite lane into the neighbor
        index and the predictor's replay buffer."""
        label = bucket.stats.label
        kind_i = int(kinds[i])
        it_i = float(iters_arr[i])
        if kind_i == START_COLD:
            bucket.warm_guard.observe_cold(it_i)
        elif bucket.warm_guard.observe_warm(it_i):
            # slower than the cold baseline: predicted lanes carry their
            # own streak, so the ladder degrades one rung at a time
            if kind_i == START_PREDICTED:
                bucket.predict_consec_mispredicts += 1
                self._obs_predict_mispredicts.inc(bucket=label)
            else:
                bucket.warm_consec_mispredicts += 1
            if obs_flight.enabled():
                obs_flight.trigger(
                    "warm_mispredict", request_id=r.request_id,
                    bucket=label, label=f"serve.{label}",
                    params_fingerprint=request_fingerprint(r.params),
                    solver_options={"kind": bucket.kind,
                                    "precision": bucket.precision},
                    detail={"start_kind": START_KIND_NAMES[kind_i],
                            "iters": it_i,
                            "cold_iters_ema":
                                bucket.warm_guard.cold_iters_ema})
            if kind_i == START_PREDICTED:
                if (bucket.predict_consec_mispredicts
                        >= self.options.degrade_mispredicts):
                    self._degrade(bucket, "predict_knn")
            elif (bucket.warm_consec_mispredicts
                    >= self.options.degrade_mispredicts):
                self._degrade(bucket, "warm_cold")
        elif kind_i == START_PREDICTED:
            bucket.predict_consec_mispredicts = 0
        else:
            bucket.warm_consec_mispredicts = 0
        # only converged, finite lanes may seed future starts
        if ((conv is None or (i < conv.size and bool(conv[i])))
                and np.isfinite(objs[i]) and r.param_vec is not None):
            bucket.warm_index.add(r.warm_key, r.param_vec, xs_h[i], zs_h[i])
            if (bucket.predict_trainer is not None
                    and not bucket.predict_fallback):
                bucket.predict_trainer.observe(r.param_vec, xs_h[i], zs_h[i])

    # -- lifecycle ---------------------------------------------------------

    def drain(self) -> Dict:
        """Graceful shutdown: stop intake, drain every pending request,
        write a final snapshot, and journal the clean-shutdown marker — a
        recovery from this directory then finds nothing open.  Returns
        ``{"handled", "snapshot"}``; a second ``drain`` is a no-op."""
        if self._draining:
            return {"handled": 0, "snapshot": None}
        self._draining = True
        handled = self.flush_all()
        snapshot_path = None
        if self._snapshots is not None:
            try:
                snapshot_path = self._snapshots.snapshot(self)
            except Exception:
                snapshot_path = None
        if self._journal is not None:
            self._journal.shutdown(clean=True)
            self._journal.close()
        return {"handled": handled, "snapshot": snapshot_path}

    # -- telemetry ---------------------------------------------------------

    def metrics(self) -> Dict:
        """Plain-dict service telemetry, the JAX package's keys."""
        buckets = {}
        for b in self._buckets.values():
            d = b.stats.as_dict(b.compiles)
            d["latency_ms"] = self._latency.summary_ms(bucket=b.stats.label)
            d["queue_wait_ms"] = self._queue_wait.summary_ms(
                bucket=b.stats.label)
            d["service_time_est_ms"] = b.est.estimate_ms()
            d["service_time_samples"] = b.est.samples
            buckets[b.stats.label] = d
        live = sum(b.stats.live_dispatched for b in self._buckets.values())
        lanes = sum(b.stats.lanes_dispatched for b in self._buckets.values())
        return {
            "submitted": self._submitted,
            "solved": self._solved,
            "timeouts": self._timeouts,
            "errors": self._errors,
            "shed": self._shed,
            "queue_depth": self._queue_depth(),
            "flushes": self._flushes,
            "batches": sum(b.stats.batches for b in self._buckets.values()),
            "occupancy_mean": (live / lanes) if lanes else None,
            # distinct (bucket, padded-lane-count) program signatures run
            "compile_count": sum(b.compiles for b in self._buckets.values()),
            "programs": sum(len(b.stats.lane_counts)
                            for b in self._buckets.values()),
            "latency": self._latency.summary(),
            "queue_wait": self._queue_wait.summary_ms(),
            "deadline": {
                "requests": self._deadline_requests,
                "missed": self._deadline_missed,
                "miss_rate": (self._deadline_missed / self._submitted
                              if self._submitted else 0.0),
            },
            "warm_start": self._warm_start_metrics(),
            "durability": {
                "journaled": self._journal is not None,
                "snapshot_writes": (0 if self._snapshots is None
                                    else self._snapshots.writes),
                "generation": self.generation,
                "recovery": self.recovery,
            },
            "buckets": buckets,
            "cost_cards": self._cost_cards(),
        }

    def _cost_cards(self) -> Dict:
        """Per-bucket cost cards (the newest of each), present only when
        profiling is enabled."""
        cost_cards: Dict = {}
        try:
            from dispatches_tpu_torch.obs import profile

            if profile.enabled():
                for b in self._buckets.values():
                    cards = profile.cards_for(f"serve.{b.stats.label}")
                    if cards:
                        cost_cards[b.stats.label] = cards[-1]
        except Exception:
            pass
        return cost_cards

    def _warm_start_metrics(self) -> Dict:
        """hits = exact (ipm LRU + pdlp fingerprint), predicted =
        learned-predictor starts, neighbor_hits = pdlp k-NN retrievals,
        misses = cold starts; size counts LRU entries + every bucket
        index entry."""
        warm_buckets = [b for b in self._buckets.values() if b.warm]
        served = (self._warm_hits + self._warm_predicted
                  + self._warm_neighbor_hits)
        lookups = served + self._warm_misses
        return {
            "hits": self._warm_hits,
            "predicted": self._warm_predicted,
            "neighbor_hits": self._warm_neighbor_hits,
            "misses": self._warm_misses,
            "mispredicts": sum(b.warm_guard.mispredicts
                               for b in warm_buckets),
            "hit_rate": (served / lookups if lookups else 0.0),
            "size": len(self._warm) + sum(len(b.warm_index)
                                          for b in warm_buckets),
        }

    def format_stats(self) -> str:
        """The ``--stats`` text report (``serve/__main__.py``)."""
        return format_stats(self.metrics())


_default_service: Optional[SolveService] = None


def get_default_service(device=None) -> SolveService:
    """The process-wide shared service (``SolverFactory('serve')`` routes
    here unless handed an explicit instance), built on ``device``
    (``cuda`` unless given) at first use."""
    global _default_service
    if _default_service is None:
        _default_service = SolveService(device=device)
    elif device is not None and torch.device(device) != _default_service.plan.device:
        raise ValueError(
            f"the default service runs on {_default_service.plan.device}, "
            f"not {device!r}; pass service= or set_default_service()")
    return _default_service


def set_default_service(service: Optional[SolveService]) -> Optional[SolveService]:
    """Swap the shared service; returns the previous one."""
    global _default_service
    prev = _default_service
    _default_service = service
    return prev
