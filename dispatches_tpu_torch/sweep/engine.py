"""Fault-tolerant chunked execution of :class:`~.spec.SweepSpec` sweeps
(counterpart of ``dispatches_tpu/sweep/engine.py``).

Where the reference runs one solver subprocess per design point from
shell loops, here the whole sweep is planned into shape-stable chunks
sized to the serve layer's power-of-two lane menu
(``serve.bucket.pad_lanes``, so a chunk program runs one signature per
lane width across chunks) and executed through one of three backends
behind the same spec:

* ``direct`` — each chunk staged and dispatched through an
  :class:`~dispatches_tpu_torch.plan.ExecutionPlan` program (mesh
  placement when the plan carries one).  The port's solvers batch lanes
  themselves (a params leaf with one leading axis more than its default
  is the lane axis), so the program is the solver itself where the JAX
  package vmaps a per-scenario one;
* ``mesh`` — ``parallel.scenario_sharded_solver`` over a device mesh
  (``mesh=``, else ``parallel.scenario_mesh()`` on the sweep's device);
* ``serve`` — per-point requests through a
  :class:`~dispatches_tpu_torch.serve.SolveService` (shared with live
  traffic, or a private warm-start-free instance).

Telemetry: with ``DISPATCHES_TPU_OBS_FLIGHT_DIR`` set, a quarantined or
refine-failed point dumps a flight bundle (``obs/flight.py``); with
``DISPATCHES_TPU_OBS_LEDGER_DIR`` set, a finished run appends one record
to the perf ledger (``obs/ledger.py``), never failing the sweep.

Device: a sweep runs on ``device`` (``cuda`` unless the caller passes
``device="cpu"``); a caller-owned ``plan=`` or ``service=`` brings its
own device instead.

Robustness:

* every completed chunk is checkpointed atomically into a
  :class:`~.store.ResultStore` before the next starts, so a killed sweep
  loses at most one chunk of work;
* ``resume=True`` skips completed chunks and — because chunk contents
  and padding are pure functions of the spec — the finished store is
  bitwise identical to an uninterrupted run's;
* a non-finite lane result is retried point-wise (``max_retries``) and
  then QUARANTINED: recorded with status + NaN objective, never
  poisoning the other lanes or the downstream surrogate labels.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch

from dispatches_tpu_torch import resolve_device
from dispatches_tpu_torch.analysis.flags import flag_name
from dispatches_tpu_torch.faults import inject as _faults
from dispatches_tpu_torch.obs import flight as obs_flight
from dispatches_tpu_torch.obs import registry as obs_registry
from dispatches_tpu_torch.obs import trace as obs_trace
from dispatches_tpu_torch.plan import PlanError
from dispatches_tpu_torch.serve.bucket import request_fingerprint
from dispatches_tpu_torch.sweep.spec import SweepSpec
from dispatches_tpu_torch.sweep.store import (
    STATUS_OK,
    STATUS_QUARANTINED,
    STATUS_REFINE_FAILED,
    STATUS_RETRIED,
    ResultStore,
)
from dispatches_tpu_torch.utils.tree import tree_map

__all__ = ["SweepOptions", "run_sweep"]

@dataclass(frozen=True)
class SweepOptions:
    """Sweep-engine knobs (env-overridable, see ``from_env``)."""

    chunk_size: int = 64       # points per chunk == checkpoint granularity
    max_retries: int = 1       # point-wise retries before quarantine
    result_dir: str = "sweep_store"  # default ResultStore directory
    backend: str = "direct"    # "direct" | "mesh" | "serve"
    #: "ipm"/"pdlp" (an "auto" serve bucket also works), or a prebuilt
    #: lane-batched ``callable(params) -> result`` with an ``.obj`` field:
    #: swept leaves carry the lane axis, the others are the defaults
    solver: Union[str, Callable] = "ipm"
    solver_options: Optional[Mapping] = None  # IPMOptions/PDLPOptions fields
    max_chunks: Optional[int] = None  # stop this run after N chunks
    #: opt-in chunk-to-chunk warm starts (direct backend, pdlp solver):
    #: each chunk's points are ordered by parameter distance to the
    #: previous chunk's centroid and seeded from its recorded solutions
    #: through the same radius-gated neighbor retrieval serve uses
    #: (``serve/warmstart.py``; the DISPATCHES_TPU_WARMSTART kill-switch
    #: also applies).  Retries always re-solve cold; resumed runs
    #: re-derive identical seeds from the store.
    warm_start: bool = False

    @classmethod
    def from_env(cls, **overrides) -> "SweepOptions":
        """Defaults with ``DISPATCHES_TPU_SWEEP_*`` env overrides applied
        (flags registered in ``analysis.flags``)."""
        env: Dict = {}
        raw = os.environ.get(flag_name("SWEEP_CHUNK"), "")
        if raw:
            env["chunk_size"] = int(raw)
        raw = os.environ.get(flag_name("SWEEP_MAX_RETRIES"), "")
        if raw:
            env["max_retries"] = int(raw)
        raw = os.environ.get(flag_name("SWEEP_RESULT_DIR"), "")
        if raw:
            env["result_dir"] = raw
        env.update(overrides)
        return cls(**env)


def _resolve_solver(nlp, solver, solver_options, device):
    """(lane-batched solver on ``device``, kind label) for the direct
    and mesh backends."""
    if callable(solver):
        return solver, "custom"
    kind = str(solver).lower()
    opts = dict(solver_options or {})
    if kind in ("pdlp", "cbc"):
        from dispatches_tpu_torch.solvers.pdlp import PDLPOptions, make_pdlp_solver

        kw = {k: v for k, v in opts.items()
              if k in PDLPOptions.__dataclass_fields__}
        return make_pdlp_solver(nlp, PDLPOptions(**kw), device=device), "pdlp"
    if kind in ("ipm", "ipopt"):
        from dispatches_tpu_torch.solvers.ipm import IPMOptions, make_ipm_solver

        kw = {k: v for k, v in opts.items() if k in IPMOptions._fields}
        return make_ipm_solver(nlp, IPMOptions(**kw), device=device), "ipm"
    raise ValueError(
        f"unknown sweep solver {solver!r}; expected 'ipm', 'ipopt', "
        "'pdlp', 'cbc', or a prebuilt callable")


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _extract(res, n_live: int):
    """(obj, converged, iterations, refined) host arrays from a batched
    result (IPMResult / LPResult / any ``.obj``-bearing tuple), padding
    stripped.  ``refined`` is the per-lane iterative-refinement epoch
    count (zeros for solvers without a mixed-precision tail)."""
    obj = np.asarray(_host(res.obj)[:n_live], dtype=np.float64)
    conv = getattr(res, "converged", None)
    conv = (_host(conv)[:n_live].astype(bool) if conv is not None
            else np.isfinite(obj))

    def per_lane(a):
        if a is None:
            return np.zeros(n_live, np.int64)
        a = _host(a)
        return (np.full(n_live, int(a)) if a.ndim == 0 else a[:n_live]).astype(np.int64)

    iters = per_lane(getattr(res, "iterations", getattr(res, "iters", None)))
    return obj, conv, iters, per_lane(getattr(res, "refined", None))


def _failed_chunk(n_live: int):
    """The all-lanes-failed grade: non-finite objectives, nothing
    converged — exactly what the pointwise retry loop keys on."""
    return (np.full(n_live, np.nan), np.zeros(n_live, bool),
            np.zeros(n_live, np.int64), np.zeros(n_live, np.int64))


def _pad_rows(values: Dict[str, np.ndarray], width: int):
    """Repeat the last point to fill ``width`` lanes (shape-stable
    dispatch; the padded lanes are masked out by the caller's slice)."""
    out = {}
    for k, v in values.items():
        v = np.asarray(v)
        if width > len(v):
            v = np.concatenate([v, np.repeat(v[-1:], width - len(v), axis=0)])
        out[k] = v
    return out


def _seeds_from_prev(prev_sol, inputs: np.ndarray):
    """Per-point ``(x0, z0, kind)`` seed stacks for one chunk, retrieved
    from the previous chunk's solutions through the serve warm-start
    index (same normalized k-NN + radius gate); gated-out points get
    zero rows — bitwise the cold init."""
    from dispatches_tpu_torch.serve import warmstart
    from dispatches_tpu_torch.solvers.pdlp import START_NEIGHBOR

    p_inputs, p_x, p_z = prev_sol
    index = warmstart.WarmStartIndex(capacity=max(len(p_inputs), 1))
    for row in range(len(p_inputs)):
        index.add(None, p_inputs[row], p_x[row], p_z[row])
    n_pts = len(inputs)
    x0 = np.zeros((n_pts, p_x.shape[1]), np.float64)
    z0 = np.zeros((n_pts, p_z.shape[1]), np.float64)
    kind = np.zeros(n_pts, np.int32)
    for i in range(n_pts):
        nb = index.nearest(inputs[i])
        if nb is not None:
            x0[i], z0[i], kind[i] = nb[0], nb[1], START_NEIGHBOR
    return x0, z0, kind


def run_sweep(nlp, spec: SweepSpec, *,
              store_dir=None,
              options: Optional[SweepOptions] = None,
              resume: bool = False,
              overwrite: bool = False,
              base_params=None,
              mesh=None,
              service=None,
              plan=None,
              on_chunk: Optional[Callable[[int, int], None]] = None,
              device=None,
              ) -> ResultStore:
    """Plan + execute ``spec`` against ``nlp``; returns the (possibly
    partial, if ``options.max_chunks`` capped the run) ``ResultStore``.

    ``base_params`` overrides ``nlp.default_params()`` as the template
    every point is written into (its content hash is pinned in the
    manifest, so a resume with different base params is refused).
    ``on_chunk(cid, n_chunks)`` fires after each chunk is durably
    recorded — an exception from it (or a kill) loses nothing already
    recorded.  ``plan`` injects a caller-owned
    :class:`~dispatches_tpu_torch.plan.ExecutionPlan` into the direct
    backend and ``service`` a caller-owned ``SolveService`` into the
    serve backend; each brings its own device.  Otherwise the sweep runs
    on ``device`` (``cuda`` unless given; without a card that raises).
    ``mesh`` places the direct backend's chunks on a device mesh and is
    the mesh backend's mesh (default: ``parallel.scenario_mesh()`` on
    ``device``).
    """
    opts = options if options is not None else SweepOptions.from_env()
    if opts.chunk_size < 1:
        raise ValueError("chunk_size must be >= 1")
    backend = opts.backend.lower()
    if backend not in ("direct", "mesh", "serve"):
        raise ValueError(
            f"unknown sweep backend {opts.backend!r}; expected 'direct', "
            "'mesh', or 'serve'")
    own = {"direct": plan, "serve": service}.get(backend)
    dev = None if own is not None else resolve_device(device)
    defaults = nlp.default_params() if base_params is None else base_params
    names_p = tuple(k for k in spec.swept_names if k in defaults["p"])
    names_f = tuple(k for k in spec.swept_names if k in defaults["fixed"])
    unknown = set(spec.swept_names) - set(names_p) - set(names_f)
    if unknown:
        raise KeyError(
            f"spec sweeps unknown param/fixed names {sorted(unknown)}")

    kind = opts.solver if isinstance(opts.solver, str) else "custom"
    precision = None
    if kind != "custom":
        from dispatches_tpu_torch.solvers.pdlp import resolve_pdlp_precision

        # resolve (env override included) at plan time so the manifest
        # pins the tier the objectives were actually solved at
        precision = resolve_pdlp_precision(
            (opts.solver_options or {}).get("precision"))
    warm_eff = False
    if opts.warm_start:
        if backend != "direct":
            raise ValueError(
                "SweepOptions.warm_start is direct-backend only "
                f"(got backend={opts.backend!r})")
        if kind not in ("pdlp", "cbc"):
            raise ValueError(
                "SweepOptions.warm_start requires solver='pdlp' (the "
                f"primal–dual start contract); got {opts.solver!r}")
        from dispatches_tpu_torch.serve import warmstart

        # kill-switch resolved at plan time, like precision, and pinned
        # in the manifest: warm-seeded chunks are not interchangeable
        # with cold ones
        warm_eff = warmstart.enabled()
    store = ResultStore.open_or_create(
        store_dir if store_dir is not None else opts.result_dir,
        spec, opts.chunk_size, resume=resume, overwrite=overwrite,
        backend=opts.backend, solver=kind, precision=precision,
        params_fingerprint=request_fingerprint(defaults),
        warm_start=warm_eff)

    if backend == "direct":
        solve_chunk = _direct_backend(nlp, opts, defaults, warm_eff,
                                      plan=plan, device=dev, mesh=mesh)
    elif backend == "mesh":
        solve_chunk = _mesh_backend(nlp, opts, names_p, names_f,
                                    mesh=mesh, device=dev)
    else:
        solve_chunk = _serve_backend(nlp, opts, defaults, service=service,
                                     device=dev)

    chunks = store.chunk_plan()
    ran = 0
    # chunk-to-chunk warm seeding (opt-in, direct/pdlp only): the
    # previous chunk's (inputs, x, z) — re-read from the store on
    # resume, so a resumed run derives the exact seeds the killed run
    # would have and converges to the same bytes
    warm_seed = getattr(solve_chunk, "supports_seeds", False)
    prev_sol = None
    for cid, start, stop in chunks:
        if cid in store.completed:
            if warm_seed:
                done = store.load_chunk(cid)
                prev_sol = ((done["inputs"], done["x"], done["z"])
                            if "x" in done else None)
            continue
        if opts.max_chunks is not None and ran >= opts.max_chunks:
            break
        idxs = np.arange(start, stop)
        seeds = None
        if warm_seed and prev_sol is not None:
            # order this chunk's points by parameter distance to the
            # previous chunk's centroid (a pure function of the spec),
            # then retrieve each point's radius-gated neighbor seed
            centroid = prev_sol[0].mean(axis=0)
            d = np.linalg.norm(spec.inputs_for(idxs) - centroid, axis=1)
            idxs = idxs[np.argsort(d, kind="stable")]
            seeds = _seeds_from_prev(prev_sol, spec.inputs_for(idxs))
        values = spec.values_for(idxs)
        n_live = len(idxs)
        t0 = time.perf_counter()
        with obs_trace.span("sweep.chunk", chunk=int(cid), points=int(n_live)):
            try:
                if warm_seed:
                    obj, conv, iters, refined = solve_chunk(
                        values, n_live, point_ids=[int(i) for i in idxs],
                        seeds=seeds)
                    chunk_x = solve_chunk.last_x.copy()
                    chunk_z = solve_chunk.last_z.copy()
                else:
                    obj, conv, iters, refined = solve_chunk(
                        values, n_live, point_ids=[int(i) for i in idxs])
            except PlanError:
                # every lane guilty (plan retry + bisection found no
                # innocents): grade the whole chunk non-finite so each
                # point rides the pointwise retry → quarantine machinery
                obj, conv, iters, refined = _failed_chunk(n_live)
                if warm_seed:
                    n_var_ws, m_con_ws = solve_chunk.seed_dims
                    chunk_x = np.zeros((n_live, n_var_ws), np.float64)
                    chunk_z = np.zeros((n_live, m_con_ws), np.float64)
            # serve backend: the service request ids of this chunk's
            # points, so the quarantine path names the same id the
            # serve.request trace spans carry
            rids = list(getattr(solve_chunk, "last_request_ids", None) or [])
            status = np.zeros(n_live, dtype=np.int8)
            retries = np.zeros(n_live, dtype=np.int16)
            for j in np.where(~np.isfinite(obj))[0]:
                rid = rids[j] if j < len(rids) else None
                for attempt in range(1, opts.max_retries + 1):
                    single = {k: np.asarray(v)[j:j + 1] for k, v in values.items()}
                    try:
                        o1, c1, i1, r1 = solve_chunk(
                            single, 1, point_ids=[int(idxs[j])])
                    except PlanError:
                        # the lone lane is the guilty lane: grade the
                        # attempt failed and keep retrying/quarantine
                        o1, c1, i1, r1 = _failed_chunk(1)
                    retry_rids = getattr(solve_chunk, "last_request_ids", None)
                    if retry_rids:
                        rid = retry_rids[0]
                    retries[j] = attempt
                    obs_trace.instant("sweep.retry", point=int(idxs[j]),
                                      attempt=attempt, request_id=rid)
                    if np.isfinite(o1[0]):
                        obj[j], conv[j], iters[j] = o1[0], c1[0], i1[0]
                        refined[j] = r1[0]
                        status[j] = STATUS_RETRIED
                        if warm_seed:  # retries re-solve cold
                            chunk_x[j] = solve_chunk.last_x[0]
                            chunk_z[j] = solve_chunk.last_z[0]
                        break
                else:
                    status[j] = STATUS_QUARANTINED
                    conv[j] = False
                    obs_trace.instant("sweep.quarantine", point=int(idxs[j]),
                                      request_id=rid)
                    if obs_flight.enabled():
                        obs_flight.trigger(
                            "quarantine", request_id=rid,
                            label="sweep." + opts.backend.lower(),
                            detail={"point": int(idxs[j]),
                                    "retries": int(retries[j]),
                                    "obj": (float(obj[j])
                                            if np.isfinite(obj[j])
                                            else None)})
            # a finite point that consumed refinement epochs yet still
            # missed tol carries a low-tier-accuracy objective: keep it
            # out of training_data (like non-finite quarantine) but
            # distinct in --report
            refine_failed = ((status < STATUS_QUARANTINED)
                             & np.isfinite(obj) & ~conv & (refined > 0))
            status[refine_failed] = STATUS_REFINE_FAILED
            for j in np.where(refine_failed)[0]:
                rid = rids[j] if j < len(rids) else None
                obs_trace.instant("sweep.refine_failed", point=int(idxs[j]),
                                  request_id=rid)
                if obs_flight.enabled():
                    obs_flight.trigger(
                        "refine_failed", request_id=rid,
                        label="sweep." + opts.backend.lower(),
                        detail={"point": int(idxs[j]),
                                "obj": float(obj[j]),
                                "refined": int(refined[j])})
            _record_point_outcomes(status)
        if warm_seed:
            # solve order is distance-sorted for seeding, but the STORE
            # keeps the cold layout (ascending point order within the
            # chunk) so objectives()/training_data stay point-aligned
            back = np.argsort(idxs, kind="stable")
            idxs = idxs[back]
            obj, conv, iters = obj[back], conv[back], iters[back]
            status, retries, refined = (status[back], retries[back], refined[back])
            chunk_x, chunk_z = chunk_x[back], chunk_z[back]
        arrays = {
            "index": idxs.astype(np.int64),
            "obj": obj,
            "converged": conv,
            "iterations": iters,
            "status": status,
            "retries": retries,
            "refined": refined,
            "inputs": spec.inputs_for(idxs),
        }
        if warm_seed:
            # the next chunk's seed material (and the resume source):
            # scaled-space x / original-space z, the solver start
            # contract's spaces
            arrays["x"] = chunk_x
            arrays["z"] = chunk_z
        store.record_chunk(cid, arrays, time.perf_counter() - t0)
        if warm_seed:
            prev_sol = (arrays["inputs"], chunk_x, chunk_z)
        ran += 1
        if on_chunk is not None:
            on_chunk(cid, len(chunks))
    _ledger_record(store, opts, solve_chunk)
    return store


_STATUS_EVENT = {STATUS_OK: "ok", STATUS_RETRIED: "retried",
                 STATUS_QUARANTINED: "quarantined",
                 STATUS_REFINE_FAILED: "refine_failed"}


def _record_point_outcomes(status: np.ndarray) -> None:
    """Mirror one chunk's per-point outcomes into the process registry
    (``sweep.points`` counter, ``event=`` labels)."""
    ctr = obs_registry.counter(
        "sweep.points", "sweep point outcomes (event=ok|retried|"
        "quarantined|refine_failed)")
    for code, event in _STATUS_EVENT.items():
        k = int(np.count_nonzero(status == code))
        if k:
            ctr.inc(k, event=event)


def _ledger_record(store: ResultStore, opts: "SweepOptions",
                   solve_chunk) -> None:
    """Append this run's throughput/compile/memory record to the perf
    ledger — only when DISPATCHES_TPU_OBS_LEDGER_DIR is set (tier-1
    stays write-free), and never at the expense of the sweep itself.
    ``backend`` is the torch device type the chunks ran on."""
    try:
        from dispatches_tpu_torch.obs import ledger

        if not ledger.enabled():
            return
        s = store.summary()
        metrics: Dict = {}
        if s.get("solves_per_sec") is not None:
            metrics["solves_per_sec"] = s["solves_per_sec"]
        # gated iteration-count guardrail for the PDLP solver upgrades
        algorithm = None
        if str(opts.solver).lower() == "pdlp":
            if s.get("iterations_mean") is not None:
                metrics["pdhg_iters_mean"] = s["iterations_mean"]
            try:
                from dispatches_tpu_torch.solvers.pdlp import (
                    resolve_pdlp_algorithm,
                )

                algorithm = resolve_pdlp_algorithm(
                    (opts.solver_options or {}).get("algorithm"))
            except Exception:
                pass
        program = getattr(solve_chunk, "program", None)
        if program is not None:
            metrics["compile_count"] = int(program.compiles)
        try:
            from dispatches_tpu_torch.obs import profile

            cards = profile.cards_for("sweep.")
            peaks = [c["peak_bytes"] for c in cards if "peak_bytes" in c]
            if peaks:
                metrics["peak_bytes"] = max(peaks)
        except Exception:
            pass
        if not metrics:
            return
        ledger.append(ledger.make_record(
            "sweep", store.fingerprint[:12], metrics,
            backend=solve_chunk.device.type,
            extra={"dispatch": opts.backend,
                   "chunks_done": s.get("chunks_done"),
                   "algorithm": algorithm,
                   "precision": store.precision,
                   "refine_failed": s.get("refine_failed")}))
    except Exception:
        pass


def _direct_backend(nlp, opts: SweepOptions, defaults, warm_seed: bool, *,
                    plan=None, device=None, mesh=None):
    """``solve_chunk(values, n_live, point_ids=None, seeds=None) -> (obj,
    conv, iters, refined)`` through a plan program.

    ``point_ids`` (the chunk's global point indices) ride the plan
    dispatch as ``request_ids`` when tracing or faults are on, so the
    plan's spans name the points a batch carried."""
    from dispatches_tpu_torch.plan import ExecutionPlan, PlanOptions

    xplan = plan if plan is not None else ExecutionPlan(
        PlanOptions.from_env(device=device, mesh=mesh))
    base, _ = _resolve_solver(nlp, opts.solver, opts.solver_options, xplan.device)
    n_var, m_con = nlp.n, nlp.m_eq + nlp.m_ineq
    # the solver batches lanes itself; the plan program counts its
    # distinct argument signatures (one per lane width) and carries the
    # lane-axis description.  No donation: the chunk kernel takes one
    # params tree and updates nothing in place.
    program = xplan.program(base, label="sweep.direct",
                            vmap_axes=((0, 0) if warm_seed else (0,)),
                            donate_argnums=())

    def _stage_chunk(values, n_live, seeds):
        """Stage one (sub-)chunk from host rows; the restage path reuses
        this so plan retry/bisection re-stages from the caller-owned
        numpy rows."""
        width = xplan.lanes_for(n_live, opts.chunk_size)
        padded = _pad_rows(values, width)
        p = dict(defaults["p"])
        f = dict(defaults["fixed"])
        for k, v in padded.items():
            if k in p:
                p[k] = v
            else:
                f[k] = v
        # swept leaves carry the lane axis; defaults replicate (the plan
        # splits/replicates accordingly when it holds a mesh)
        batched = {grp: {k: k in values for k in defaults[grp]}
                   for grp in ("p", "fixed")}
        staged = xplan.stage({"p": p, "fixed": f}, lanes=width, donate=False,
                             batched=batched)
        if warm_seed:
            # every lane carries a (x0, z0, kind) start; seedless chunks
            # (the first, and all retries) pass zeros — bitwise the cold
            # init — through the same program
            if seeds is None:
                seeds = (np.zeros((n_live, n_var), np.float64),
                         np.zeros((n_live, m_con), np.float64),
                         np.zeros(n_live, np.int32))
            start = tuple(_pad_rows(
                {"x0": seeds[0], "z0": seeds[1], "kind": seeds[2]},
                width)[k] for k in ("x0", "z0", "kind"))
            start = xplan.stage(start, lanes=width, donate=False)
            return (staged, start), width
        return (staged,), width

    def solve_chunk(values, n_live, point_ids=None, seeds=None):
        args, width = _stage_chunk(values, n_live, seeds)

        def _restage(idxs):
            rows = list(idxs)
            sub = {k: np.asarray(v)[rows] for k, v in values.items()}
            sub_seeds = (None if seeds is None else
                         tuple(np.asarray(s)[rows] for s in seeds))
            sub_args, sub_width = _stage_chunk(sub, len(rows), sub_seeds)
            ids = [point_ids[i] for i in rows] if point_ids is not None else None
            return sub_args, sub_width, ids

        ticket = xplan.submit(
            program, args, n_live=n_live, lanes=width,
            request_ids=(point_ids if (obs_trace.enabled()
                                       or _faults.armed()) else None),
            restage=_restage)
        # collect() fences on the device before _extract, so the chunk
        # timer upstream measures device completion, not async dispatch
        res = xplan.collect(ticket)
        if warm_seed:
            # seed material for the next chunk (the engine records it)
            solve_chunk.last_x = _host(res.x)[:n_live]
            solve_chunk.last_z = _host(res.z)[:n_live]
        return _extract(res, n_live)

    solve_chunk.supports_seeds = warm_seed
    solve_chunk.seed_dims = (n_var, m_con)
    solve_chunk.program = program
    solve_chunk.device = xplan.device
    return solve_chunk


def _mesh_backend(nlp, opts: SweepOptions, names_p, names_f, *, mesh=None,
                  device=None):
    """``solve_chunk(values, n_live, point_ids=None)`` through
    ``parallel.scenario_sharded_solver`` over ``mesh`` (default: every
    visible device of ``device``'s kind)."""
    from dispatches_tpu_torch.parallel import scenario_mesh, scenario_sharded_solver

    if mesh is None:
        mesh = scenario_mesh(device=device)
    base, _ = _resolve_solver(nlp, opts.solver, opts.solver_options,
                              mesh.devices[0])
    sharded = scenario_sharded_solver(
        nlp, mesh, batched_keys=names_p, batched_fixed_keys=names_f,
        solver=base, full_result=True)

    def solve_chunk(values, n_live, point_ids=None):
        # the sharded solver pads to the mesh and strips internally, and
        # its collect() fences, so the chunk timer measures completion
        return _extract(sharded(values), n_live)

    solve_chunk.device = torch.device(mesh.devices[0])
    return solve_chunk


def _serve_backend(nlp, opts: SweepOptions, defaults, *, service=None, device=None):
    """``solve_chunk(values, n_live, point_ids=None)``: one request per
    point through a ``SolveService``."""
    if callable(opts.solver):
        raise ValueError(
            "the serve backend resolves its own kernels; pass "
            "solver='ipm'/'pdlp' (or use backend='direct')")
    from dispatches_tpu_torch.serve import RequestStatus, ServeOptions, SolveService

    if service is None:
        # private instance: no cross-request warm starts, so a resumed
        # sweep replays identically to an uninterrupted one
        service = SolveService(ServeOptions(
            max_batch=opts.chunk_size, max_wait_ms=1e12,
            max_queue=max(2 * opts.chunk_size, 2),
            warm_start=False), device=device)
    solver_kw = dict(solver=str(opts.solver),
                     options=dict(opts.solver_options or {}))

    def solve_chunk(values, n_live, point_ids=None):
        plist = []
        for i in range(n_live):
            p = dict(defaults["p"])
            f = dict(defaults["fixed"])
            for k, arr in values.items():
                if k in p:
                    p[k] = np.asarray(arr)[i]
                else:
                    f[k] = np.asarray(arr)[i]
            plist.append({"p": p, "fixed": f})
        handles = [service.submit(nlp, p, **solver_kw) for p in plist]
        service.flush_all()
        rs = [h.result() for h in handles]
        # the ids for the engine's retry/quarantine telemetry
        solve_chunk.last_request_ids = [h.request_id for h in handles]
        obj = np.full(n_live, np.nan)
        conv = np.zeros(n_live, dtype=bool)
        iters = np.zeros(n_live, dtype=np.int64)
        refined = np.zeros(n_live, dtype=np.int64)
        for i, r in enumerate(rs):
            if r.status != RequestStatus.DONE:
                continue
            o, c, it, rf = _extract(
                tree_map(lambda a: _host(a)[None], r.result), 1)
            obj[i], conv[i], iters[i] = o[0], c[0], it[0]
            refined[i] = rf[0]
        return obj, conv, iters, refined

    solve_chunk.device = service.plan.device
    return solve_chunk
