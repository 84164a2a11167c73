"""``ExecutionPlan``: the one dispatch path for every solve batch
(counterpart of ``dispatches_tpu/plan/execution.py``).

One plan = one placement policy plus one dispatch pipeline:

* **placement** — with no mesh every staged leaf lands on
  ``PlanOptions.device`` (``cuda`` unless the caller asks for the CPU).
  With a 1-D :class:`~dispatches_tpu_torch.parallel.sharding.Mesh`
  (``mesh``, or ``devices > 1`` through ``parallel.scenario_mesh``) a
  batch whose lane count divides the mesh is split into contiguous lane
  shards, one per mesh entry, each staged on its entry's device;
  replicated leaves go whole to every entry.  ``submit`` launches the
  program on every shard before any fence, and the fence waits for
  every shard's device and gathers the shards, in lane order, onto the
  plan's device (``PlanOptions.device``, else the mesh's first entry).
  Other lane counts are staged whole on the plan's device, and
  ``stage(slot=)`` pins a whole batch on one mesh device, round-robin.
  A mesh may name one device more than once; its shards then run one
  after another on that device's stream.
* **programs** — ``program(fn, ...)`` wraps a kernel that is already
  lane-batched (the port's solvers take a lane axis themselves, where
  the JAX package vmaps a per-scenario function).  ``vmap_axes`` is kept
  as the description of which arguments carry the lane axis (0) and
  which are shared (None).  ``PlanProgram.compiles`` counts the distinct
  argument signatures a program has run — what ``jax.jit`` would have
  compiled — so the serve layer's compile counts equal the JAX
  package's.
* **donation** — torch has none; ``donate`` stays an option with the
  JAX package's contract: ``stage(donate=True)`` copies a caller-owned
  tensor, so a program may update the staged buffers in place without
  touching anything the caller holds.
* **dispatch-ahead** — the number of dispatched-but-unfenced batches is
  bounded by ``PlanOptions.inflight``.  ``submit`` records a CUDA event
  after the program; ``collect``/``drain`` fence on it.  The port's
  solvers read an "any lane active" flag on the host once per check, so
  ``submit`` returns only when a solve is nearly done: dispatch-ahead
  overlaps host staging with the tail of the previous batch, no more.
* **scheduling** — ``"fifo"`` (oldest first) or ``"ready"``, which
  queries each ticket's event and fences whichever batch completed
  first, falling back to FIFO when nothing is ready or there is no
  probe (a CPU plan records no event).  Per-ticket results, recovery and
  the fence-time ``on_done`` contract (run exactly once, serialized,
  after the ticket completes) are the same in both modes.
  ``PlanOptions.inflight_max`` arms the AIMD depth controller
  (:mod:`dispatches_tpu_torch.plan.adaptive`), which moves the window
  between 1 and that bound from live stall attribution under a
  cost-card memory budget.
* **cost cards** — with ``DISPATCHES_TPU_OBS_PROFILE`` on when a program
  is built, the first call of each new argument signature records a
  card (:mod:`dispatches_tpu_torch.obs.profile`); with it off the
  program's call path is the plain one.

The fence path holds the window lock only to pop the chosen ticket: the
device wait, recovery and ``on_done`` run outside it, so a fence
serializes other fencers, never submitters, and an ``on_done`` that
re-submits cannot deadlock.

When tracing is on, the plan emits the batch lifecycle as retroactive
``plan.stage`` / ``plan.submit`` / ``plan.fence`` / ``plan.dispatch``
spans stamped with the plan id and the batch's sequence number.

The plan is also the batch **failure domain**: a dispatch or fence error
is wrapped into a :class:`PlanError` carried on the ticket.  With a
``restage`` callback the plan retries the whole batch with capped
exponential backoff, then lane-bisects until the guilty lanes are
isolated; innocents get real results, guilty lanes are NaN-filled and
named in ``PlanError.guilty``.  ``plan.retries`` counts every recovery
re-dispatch.  The fault sites (``plan.stage`` / ``plan.submit`` /
``plan.fence`` / ``solver``) sit behind one cached ``armed()`` branch.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dispatches_tpu_torch import resolve_device
from dispatches_tpu_torch.analysis.flags import flag_name
from dispatches_tpu_torch.analysis.runtime import ProgramCounter, sanitized_lock
from dispatches_tpu_torch.faults import inject as _faults
from dispatches_tpu_torch.obs import registry as obs_registry
from dispatches_tpu_torch.obs import trace as obs_trace
from dispatches_tpu_torch.utils.tree import tree_leaves, tree_map

__all__ = ["PlanOptions", "PlanProgram", "PlanTicket", "PlanError",
           "ExecutionPlan"]

#: exponential backoff between batch retries is capped here so a deep
#: retry budget cannot stall the fence for seconds
_BACKOFF_CAP_MS = 250.0

#: an injected ``hang_s`` wedge on a REAL clock sleeps at most this
#: long (virtual clocks advance the full duration instead)
_HANG_SLEEP_CAP_S = 2.0


@dataclass(frozen=True)
class PlanOptions:
    """Placement + pipeline knobs for one :class:`ExecutionPlan` (the
    JAX package's fields, plus ``device``)."""

    #: dispatch-ahead window: max batches dispatched but not yet fenced.
    inflight: int = 2
    #: build a ``parallel.scenario_mesh(devices)`` on ``device`` when no
    #: explicit mesh is given (None/1 = single-device placement).
    devices: Optional[int] = None
    #: explicit 1-D device mesh; wins over ``devices``.
    mesh: Optional[object] = None
    #: mesh axis the batch lane dimension splits over.
    axis: str = "scenario"
    #: default donation policy for ``program()``.
    donate: bool = True
    #: full-batch retry budget before lane bisection (needs ``restage``).
    max_retries: int = 2
    #: base backoff between batch retries in milliseconds, doubled per
    #: attempt and capped at :data:`_BACKOFF_CAP_MS`.
    retry_backoff_ms: float = 5.0
    #: fence order: ``"fifo"`` or ``"ready"``.
    schedule: str = "fifo"
    #: arms the adaptive in-flight depth controller: the window starts
    #: at ``inflight`` and AIMD moves it within [1, inflight_max] from
    #: live stall attribution.  None = fixed depth (the default).
    inflight_max: Optional[int] = None
    #: cost-card memory budget for the depth controller: growth stops
    #: when ``peak_bytes × depth`` would exceed it (None = no budget;
    #: needs ``obs.profile`` enabled to bind).
    mem_budget_bytes: Optional[int] = None
    #: fence watchdog: bound every blocking fence to this many ms of the
    #: plan's injectable clock (None = unbounded).
    fence_timeout_ms: Optional[float] = None
    #: where staged batches live and sharded results gather: ``cuda``
    #: unless given (the port's device rule, through ``resolve_device``);
    #: with a mesh and no device, the mesh's first entry.
    device: Optional[object] = None

    def __post_init__(self):
        if self.schedule not in ("fifo", "ready"):
            raise ValueError(
                f"PlanOptions.schedule must be 'fifo' or 'ready', "
                f"got {self.schedule!r}")

    @classmethod
    def from_env(cls, **overrides) -> "PlanOptions":
        """Defaults with ``DISPATCHES_TPU_PLAN_*`` env overrides applied
        (the JAX package's names)."""
        env = {}
        raw = os.environ.get(flag_name("PLAN_INFLIGHT"), "")
        if raw:
            env["inflight"] = int(raw)
        raw = os.environ.get(flag_name("PLAN_DEVICES"), "")
        if raw:
            env["devices"] = int(raw)
        raw = os.environ.get(flag_name("PLAN_MAX_RETRIES"), "")
        if raw:
            env["max_retries"] = int(raw)
        raw = os.environ.get(flag_name("PLAN_RETRY_BACKOFF_MS"), "")
        if raw:
            env["retry_backoff_ms"] = float(raw)
        raw = os.environ.get(flag_name("PLAN_SCHEDULE"), "")
        if raw:
            env["schedule"] = raw.strip().lower()
        raw = os.environ.get(flag_name("PLAN_INFLIGHT_MAX"), "")
        if raw:
            env["inflight_max"] = int(raw)
        raw = os.environ.get(flag_name("PLAN_FENCE_TIMEOUT_MS"), "")
        if raw:
            env["fence_timeout_ms"] = float(raw)
        env.update(overrides)
        return cls(**env)


class PlanError(RuntimeError):
    """A batch dispatch/fence failure wrapped with its blast radius.

    Carried on the ticket (``ticket.error``) rather than raised
    mid-pipeline.  ``guilty`` names the lane indices (positions within
    the live batch) whose isolated re-dispatch still failed — empty
    means the batch fully recovered on retry.  When no results could be
    produced at all, ``collect()`` raises this error.  ``kind`` is
    ``"error"`` or ``"hang"`` (the fence watchdog escaped a wedge)."""

    def __init__(self, label: str, seq: int, guilty: Sequence[int] = (),
                 attempts: int = 0, cause: Optional[BaseException] = None,
                 kind: str = "error"):
        self.label = label
        self.seq = seq
        self.guilty = tuple(guilty)
        self.attempts = attempts
        self.cause = cause
        self.kind = str(kind)
        msg = f"plan batch {label!r} seq {seq} failed"
        if self.kind != "error":
            msg += f" [{self.kind}]"
        if attempts:
            msg += f" after {attempts} retr{'y' if attempts == 1 else 'ies'}"
        if self.guilty:
            msg += f"; guilty lanes {list(self.guilty)}"
        if cause is not None:
            msg += f" (cause: {cause!r})"
        super().__init__(msg)


class _Sharded:
    """One staged tree split into contiguous lane shards: ``parts[i]``
    lives on ``devices[i]`` (the mesh's entries, in lane order)."""

    __slots__ = ("parts", "devices")

    def __init__(self, parts: List, devices: List):
        self.parts = parts
        self.devices = devices


def _unshard(tree):
    """``tree`` with each sharded value replaced by its list of shards."""
    if isinstance(tree, _Sharded):
        return list(tree.parts)
    if isinstance(tree, tuple):
        return tuple(_unshard(a) for a in tree)
    return tree


def _indexed(dev: torch.device) -> torch.device:
    """``dev`` with a CUDA index filled in (``cuda`` → ``cuda:<current>``),
    as tensors report their device."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _to_device(tree, dev):
    return tree_map(
        lambda a: a.to(dev) if isinstance(a, torch.Tensor) else a, tree)


def _signature(args) -> Tuple:
    """What a jit cache would key a call on: each leaf's shape and dtype
    (Python scalars by type).  A sharded argument keys on its shard
    count and its first shard — one program per lane count, as a mesh
    placement compiles once per lane count."""
    if any(isinstance(a, _Sharded) for a in args):
        k = next(len(a.parts) for a in args if isinstance(a, _Sharded))
        return ("shards", k, _signature(tuple(
            a.parts[0] if isinstance(a, _Sharded) else a for a in args)))
    sig = []
    for leaf in tree_leaves(args):
        if isinstance(leaf, torch.Tensor):
            sig.append((tuple(leaf.shape), str(leaf.dtype)))
        elif isinstance(leaf, np.ndarray):
            sig.append((leaf.shape, leaf.dtype.str))
        else:
            sig.append(type(leaf).__name__)
    return tuple(sig)


class PlanProgram:
    """One dispatch target: a lane-batched kernel, its signature counter
    and its donation contract.  Built via :meth:`ExecutionPlan.program`;
    called only through :meth:`ExecutionPlan.submit` (or, for head
    programs feeding a submit, :meth:`ExecutionPlan.run_inline`)."""

    __slots__ = ("plan", "label", "donate_argnums", "vmap_axes", "_fn",
                 "_counter", "_run")

    def __init__(self, plan: "ExecutionPlan", fn: Callable, *, label: str,
                 vmap_axes=None, donate_argnums: Sequence[int] = ()):
        from dispatches_tpu_torch.obs import profile

        self.plan = plan
        self.label = label
        self.donate_argnums = tuple(donate_argnums)
        self.vmap_axes = vmap_axes
        self._fn = fn
        self._counter = ProgramCounter(label)
        # resolved once, at build time: with profiling off the call path
        # is the plain one and carries no new host work
        self._run = self._run_profiled if profile.enabled() else self._run_plain

    def _call(self, *args):
        """The program on ``args``; a sharded call runs every shard,
        each on its own device, and returns the outputs still sharded."""
        if not any(isinstance(a, _Sharded) for a in args):
            return self._fn(*args)
        devices = next(a.devices for a in args if isinstance(a, _Sharded))
        outs = []
        for i, dev in enumerate(devices):
            shard_args = tuple(a.parts[i] if isinstance(a, _Sharded)
                               else _to_device(a, dev) for a in args)
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    outs.append(self._fn(*shard_args))
            else:
                outs.append(self._fn(*shard_args))
        return _Sharded(outs, list(devices))

    def _run_plain(self, *args):
        self._counter.observe(_signature(args))
        return self._call(*args)

    def _run_profiled(self, *args):
        if self._counter.observe(_signature(args)):
            from dispatches_tpu_torch.obs import profile

            return profile.profiled_call(self._call, self.label,
                                         self._counter.count, args,
                                         view=_unshard)
        return self._call(*args)

    @property
    def donates(self) -> bool:
        return bool(self.donate_argnums)

    @property
    def compiles(self) -> int:
        return self._counter.count


class PlanTicket:
    """One dispatched batch: a future fenced by ``collect``/``drain``.

    ``error`` is the :class:`PlanError` left by fence-time recovery
    (None on the happy path); a non-empty ``error.guilty`` names the
    lanes whose slots in ``result`` are NaN-filled."""

    __slots__ = ("label", "lanes", "n_live", "seq", "request_ids",
                 "result", "error", "_raw", "_exc", "_restage",
                 "_program", "_done", "_on_done", "_t_dispatch_us",
                 "_fencing", "_event", "_markers")

    def __init__(self, label: str, lanes: int, n_live: int, on_done,
                 seq: int = 0, request_ids: Optional[List[int]] = None):
        self.label = label
        self.lanes = lanes
        self.n_live = n_live
        self.seq = seq
        self.request_ids = request_ids
        self.result = None
        self.error = None
        self._raw = None
        self._exc = None
        self._restage = None
        self._program = None
        self._done = False
        self._on_done = on_done
        self._t_dispatch_us = 0.0
        # popped off the window by a fencer but not yet completed; a
        # concurrent collector parks on _event instead of re-fencing
        self._fencing = False
        self._event = threading.Event()
        # completion probes recorded after the program: one CUDA event per
        # device the batch ran on (empty on the CPU, whose programs have
        # finished when they return)
        self._markers = ()

    def done(self) -> bool:
        return self._done


def _stack_leaves(leaves: Sequence) -> Any:
    """Stack one leaf across lanes.  Host leaves (numpy / scalars) stack
    on the host — one memcpy and ONE host→device transfer at stage time;
    a leaf set holding tensors stacks on their device."""
    tensors = [leaf for leaf in leaves if isinstance(leaf, torch.Tensor)]
    if tensors:
        dev = tensors[0].device
        return torch.stack([torch.as_tensor(leaf, device=dev) for leaf in leaves])
    return np.stack([np.asarray(leaf) for leaf in leaves])


def _ticket_ready(ticket: PlanTicket) -> Optional[bool]:
    """Non-blocking readiness probe for one dispatched ticket: True when
    every marker reports complete (a dispatch-time exception also
    counts), False while a device still works, None when there is no
    probe — the scheduler treats None as "fall back to FIFO"."""
    if ticket._exc is not None:
        return True
    if not ticket._markers:
        return None
    try:
        return all(bool(m.query()) for m in ticket._markers)
    except Exception:  # noqa: BLE001 — the probe must never raise
        return None


def _nan_like_lane(lane) -> Any:
    """Filler for a guilty lane's slot in a recovered batch result: NaN
    for float leaves, zero/False otherwise, shaped from an innocent
    lane's slice."""

    def fill(a):
        a = torch.as_tensor(a)
        if a.is_floating_point():
            return torch.full_like(a, torch.nan)
        return torch.zeros_like(a)

    return tree_map(fill, lane)


# process-wide plan ids, stamped on the lifecycle spans
_plan_ids = itertools.count(1)


def _gather(sharded: _Sharded, device):
    """The shards' outputs joined in lane order on ``device`` (every leaf
    of a lane-batched program's output carries the lane axis)."""
    return tree_map(lambda *parts: torch.cat([t.to(device) for t in parts]),
                    *sharded.parts)


class ExecutionPlan:
    """Maps a stream of solve batches onto a mesh placement with a
    bounded dispatch-ahead pipeline (module docstring).

    Typical flow::

        plan = ExecutionPlan(PlanOptions.from_env(device="cuda"))
        prog = plan.program(kernel, label="serve.pdlp#0", vmap_axes=0)
        batched = plan.stage(plan.stack(per_lane_params, lanes=lanes),
                             lanes=lanes, donate=prog.donates)
        ticket = plan.submit(prog, (batched,), n_live=n, lanes=lanes)
        result = plan.collect(ticket)
    """

    def __init__(self, options: Optional[PlanOptions] = None, *,
                 clock: Callable[[], float] = time.monotonic):
        self.options = options if options is not None else PlanOptions.from_env()
        # the injectable clock bounds the fence watchdog
        self._clock = clock
        mesh = self.options.mesh
        if mesh is None and (self.options.devices or 0) > 1:
            # lazy import: parallel.sharding is a plan caller
            from dispatches_tpu_torch.parallel.sharding import scenario_mesh

            mesh = scenario_mesh(self.options.devices, axis=self.options.axis,
                                 device=self.options.device)
        self.mesh = mesh
        if mesh is not None and self.options.device is None:
            self.device = mesh.devices[0]
        else:
            self.device = resolve_device(self.options.device)
        self.plan_id = next(_plan_ids)
        self._seq = itertools.count(1)
        self._fence_seq = itertools.count(1)
        self._window: Deque[PlanTicket] = deque()
        # dispatch/fence window guard; the expensive parts (staging, the
        # device wait, recovery, on_done) all stay outside it
        self._lock = sanitized_lock("plan.window", reentrant=True)
        # fence order guard: one fence retires at a time.  Reentrant: an
        # on_done that re-submits may have to fence the overflow itself.
        self._fence_lock = sanitized_lock("plan.fence", reentrant=True)
        self._ctrl = None
        if self.options.inflight_max is not None:
            from dispatches_tpu_torch.plan.adaptive import InflightDepthController

            self._ctrl = InflightDepthController(
                base=max(int(self.options.inflight), 1),
                max_inflight=int(self.options.inflight_max),
                plan=self.plan_id,
                mem_budget_bytes=self.options.mem_budget_bytes,
                peak_bytes_fn=self._peak_bytes)
        self._labels: set = set()
        self._gauge = obs_registry.gauge(
            "plan.inflight",
            "execution-plan batches dispatched but not yet fenced")
        self._gauge.set(0.0)
        self._obs_batches = obs_registry.counter(
            "plan.batches", "batches dispatched through the execution "
            "plan (label = program)")
        self._obs_retries = obs_registry.counter(
            "plan.retries", "recovery re-dispatches after a batch "
            "dispatch/fence error — full-batch retries and bisection "
            "subsets alike (label = program)")

    # -- placement ---------------------------------------------------------

    @property
    def inflight(self) -> int:
        """Batches currently dispatched but not yet fenced."""
        return len(self._window)

    @property
    def controller(self):
        """The adaptive depth controller, or None (fixed window)."""
        return self._ctrl

    @property
    def inflight_limit(self) -> int:
        """The current dispatch-window bound (adaptive when the depth
        controller is armed, ``options.inflight`` otherwise)."""
        if self._ctrl is not None:
            return max(int(self._ctrl.depth), 1)
        return max(int(self.options.inflight), 1)

    def _peak_bytes(self) -> Optional[float]:
        """Largest cost-card peak_bytes across programs this plan has
        dispatched — the depth controller's per-slot memory model.  None
        when profiling is off or no card carries one."""
        from dispatches_tpu_torch.obs import profile

        if not profile.enabled():
            return None
        peaks = [c.get("peak_bytes") or 0 for label in tuple(self._labels)
                 for c in profile.cards_for(label)]
        return float(max(peaks)) if peaks else None

    def _axis_name(self) -> str:
        names = self.mesh.axis_names
        return self.options.axis if self.options.axis in names else names[0]

    def _mesh_dim(self) -> int:
        return int(self.mesh.shape[self._axis_name()])

    def sharding_for(self, lanes: int):
        """The mesh's devices, one lane shard each, when ``lanes``
        divides the mesh; None (single-device placement) otherwise —
        deterministic per lane count, so the one-program-per-(program,
        lane-count) accounting is unchanged."""
        if self.mesh is not None and lanes % self._mesh_dim() == 0:
            return list(self.mesh.devices.flat)
        return None

    def _slot_device(self, slot: int):
        """Round-robin mesh device for a ``stage(slot=...)`` batch."""
        devs = list(self.mesh.devices.flat)
        return devs[int(slot) % len(devs)]

    def lanes_for(self, n_live: int, max_batch: int) -> int:
        """Shape-stable lane count from the serve bucket menu."""
        from dispatches_tpu_torch.serve.bucket import pad_lanes

        return pad_lanes(n_live, max_batch)

    def _marker(self, device=None):
        """A completion probe for the work queued so far on ``device``
        (the plan's device by default): a CUDA event recorded on its
        current stream, or None on the CPU."""
        dev = self.device if device is None else device
        if dev.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        return event

    def _markers(self, value) -> Tuple:
        """Completion probes for a dispatched batch: the plan device's
        probe, or — for a sharded batch, or one pinned on another mesh
        device — one per CUDA device that holds a tensor of it."""
        if isinstance(value, _Sharded):
            leaves = [t for part in value.parts for t in tree_leaves(part)]
            devices = {d for d in value.devices if d.type == "cuda"}
        else:
            leaves = tree_leaves(value)
            devices = set()
        devices |= {t.device for t in leaves
                    if isinstance(t, torch.Tensor) and t.is_cuda}
        if not devices or devices == {_indexed(self.device)}:
            marker = self._marker()
            return () if marker is None else (marker,)
        return tuple(self._marker(d) for d in sorted(devices, key=lambda d: d.index or 0))

    # -- staging -----------------------------------------------------------

    def stack(self, trees: Sequence, *, lanes: Optional[int] = None):
        """Stack per-lane trees into one batched tree, padding to
        ``lanes`` by repeating the last entry (padded lanes replay a
        well-posed solve and are sliced off by the caller)."""
        trees = list(trees)
        if lanes is not None and lanes > len(trees):
            trees.extend([trees[-1]] * (lanes - len(trees)))
        return tree_map(lambda *ls: _stack_leaves(ls), *trees)

    def stage(self, tree, *, lanes: int, donate: bool = True, batched=True,
              slot: Optional[int] = None):
        """Place one batched tree for dispatch.

        ``batched`` is True (every leaf carries the lane axis), False
        (fully replicated), or a matching tree of bools for mixed trees
        (the sweep's swept-vs-default split); it decides which leaves a
        mesh placement splits into lane shards and which go whole to
        every shard.  Host leaves are copied to the device; with
        ``donate`` (the default) every staged leaf is plan-owned: a
        tensor the caller already holds on the device is cloned, so a
        program that updates its inputs in place can never touch a
        caller's buffer.

        ``slot`` (with a mesh) pins the whole batch on ONE mesh device,
        round-robin by slot index, instead of splitting lanes across the
        mesh."""
        tracing = obs_trace.enabled()
        stamp = tracing or self._ctrl is not None
        t0_us = obs_trace.now_us() if stamp else 0.0
        if _faults.armed():
            _faults.check("plan.stage")
        shards = None
        dev = self.device
        if self.mesh is not None:
            if slot is not None:
                dev = self._slot_device(slot)
            else:
                shards = self.sharding_for(lanes)

        def place(leaf, d):
            if isinstance(leaf, torch.Tensor):
                t = leaf.to(d)
                return t.clone() if donate and t is leaf else t
            return torch.tensor(np.asarray(leaf), device=d)

        def shard(leaf, is_batched, i):
            d = shards[i]
            if not is_batched:
                return place(leaf, d)
            c = lanes // len(shards)
            if isinstance(leaf, torch.Tensor):
                # a slice is a view of the caller's tensor: copy it when
                # it stays on the caller's device and is donated
                t = leaf[i * c:(i + 1) * c].to(d)
                return t.clone() if donate and t.device == leaf.device else t
            return torch.tensor(np.asarray(leaf)[i * c:(i + 1) * c], device=d)

        if shards is None:
            staged = tree_map(lambda leaf: place(leaf, dev), tree)
        elif batched is True or batched is False:
            staged = _Sharded(
                [tree_map(lambda leaf, _i=i: shard(leaf, batched, _i), tree)
                 for i in range(len(shards))], shards)
        else:
            staged = _Sharded(
                [tree_map(lambda leaf, b, _i=i: shard(leaf, bool(b), _i),
                          tree, batched) for i in range(len(shards))], shards)
        if stamp:
            # host staging is the wall time dispatch-ahead exists to hide
            end_us = obs_trace.now_us()
            if tracing:
                obs_trace.complete("plan.stage", t0_us, end_us - t0_us,
                                   plan=self.plan_id, lanes=lanes)
            if self._ctrl is not None:
                self._ctrl.ingest({
                    "name": "plan.stage", "ph": "X", "ts": t0_us,
                    "dur": end_us - t0_us,
                    "args": {"plan": self.plan_id, "lanes": lanes}})
        return staged

    # -- programs ----------------------------------------------------------

    def program(self, fn: Callable, *, label: str, vmap_axes=None,
                donate: Optional[bool] = None,
                donate_argnums: Optional[Sequence[int]] = None,
                n_args: int = 1) -> PlanProgram:
        """Build the dispatch target for one lane-batched kernel.

        ``vmap_axes`` records which arguments carry the lane axis (0)
        and which are shared (None).  Donation: explicit
        ``donate_argnums`` wins; otherwise ``donate`` (plan default)
        donates all ``n_args`` positional batch-state args."""
        if donate_argnums is None:
            donate = self.options.donate if donate is None else donate
            donate_argnums = tuple(range(n_args)) if donate else ()
        return PlanProgram(self, fn, label=label, vmap_axes=vmap_axes,
                           donate_argnums=donate_argnums)

    def run_inline(self, program: PlanProgram, args: Tuple):
        """Run one auxiliary program with NO window entry: no ticket, no
        fence bookkeeping, no in-flight slot.  For head programs whose
        outputs feed straight into a :meth:`submit` as that batch's
        staged inputs (serve's warm-start predictor): the outputs stay on
        the device, queued ahead of the batch that consumes them, whose
        fence covers both."""
        tracing = obs_trace.enabled()
        t0_us = obs_trace.now_us() if tracing else 0.0
        out = program._run(*args)
        if tracing:
            obs_trace.complete("plan.inline", t0_us,
                               obs_trace.now_us() - t0_us,
                               plan=self.plan_id, label=program.label)
        return out

    # -- dispatch pipeline -------------------------------------------------

    def submit(self, program: PlanProgram, args: Tuple, *,
               n_live: int, lanes: int,
               on_done: Optional[Callable[[PlanTicket], None]] = None,
               request_ids: Optional[List[int]] = None,
               restage: Optional[Callable] = None) -> PlanTicket:
        """Dispatch one staged batch.

        Returns a ticket; when the in-flight window is full the OLDEST
        batch is fenced first.  ``on_done`` runs at fence time with the
        completed ticket.  ``restage`` arms fence-time recovery: a
        callable mapping a tuple of live-lane indices to ``(args, lanes,
        request_ids)`` for that subset, re-staged from host data.
        Without it a failed batch carries a :class:`PlanError` covering
        every lane and ``collect()`` raises."""
        tracing = obs_trace.enabled()
        ctrl = self._ctrl
        stamp = tracing or ctrl is not None
        # the program runs OUTSIDE the window lock: a second submitter
        # (or a collector probing the window) must not wait on it.  A
        # sharded batch launches every shard here, before any fence.
        ticket = PlanTicket(program.label, lanes, n_live, on_done,
                            request_ids=request_ids)
        ticket._program = program
        ticket._restage = restage
        ticket._t_dispatch_us = obs_trace.now_us() if stamp else 0.0
        try:
            if _faults.armed():
                _faults.check("plan.submit", label=program.label,
                              request_ids=request_ids)
                _faults.check("solver", label=program.label,
                              request_ids=request_ids)
            ticket._raw = program._run(*args)
            ticket._markers = self._markers(ticket._raw)
        except Exception as exc:  # noqa: BLE001 — recovery at fence
            ticket._exc = exc
        end_us = obs_trace.now_us() if stamp else 0.0
        with self._lock:
            # seq is assigned with the append, under the same lock, so
            # window order IS seq order
            ticket.seq = next(self._seq)
            self._window.append(ticket)
            inflight = len(self._window)
        if stamp:
            args_kw = dict(plan=self.plan_id, seq=ticket.seq,
                           label=ticket.label, lanes=lanes,
                           live=n_live, inflight=inflight)
            if request_ids is not None:
                args_kw["request_ids"] = list(request_ids)
            if tracing:
                obs_trace.complete("plan.submit", ticket._t_dispatch_us,
                                   end_us - ticket._t_dispatch_us, **args_kw)
            if ctrl is not None:
                ctrl.ingest({
                    "name": "plan.submit", "ph": "X",
                    "ts": ticket._t_dispatch_us,
                    "dur": end_us - ticket._t_dispatch_us,
                    "args": args_kw})
        self._obs_batches.inc(label=program.label)
        self._labels.add(program.label)
        self._gauge.set(float(inflight))
        # fence window overflow OUTSIDE the dispatch lock
        self._trim_window()
        return ticket

    def collect(self, ticket: PlanTicket):
        """Fence batches until this ticket completes; returns its result.

        A batch that produced no results at all raises its
        :class:`PlanError` here; a partially recovered batch returns a
        result whose guilty lanes (``ticket.error.guilty``) are
        NaN-filled."""
        while not ticket._done:
            with self._lock:
                if ticket._done:  # fenced by a concurrent collector
                    break
                pending = ticket in self._window
                if not pending and not ticket._fencing:
                    raise RuntimeError(
                        f"ticket for {ticket.label!r} is neither in "
                        "flight nor complete — was it submitted "
                        "through this plan?")
            if pending:
                self._fence_next(prefer=ticket)
            else:
                # popped by a concurrent fencer mid-completion
                ticket._event.wait()
        if ticket.result is None and ticket.error is not None:
            raise ticket.error
        return ticket.result

    def drain(self) -> int:
        """Fence every in-flight batch; returns how many this caller
        fenced."""
        n = 0
        while self._fence_next() is not None:
            n += 1
        return n

    # -- fencing -----------------------------------------------------------

    def _select_index(self, prefer: Optional[PlanTicket]) -> int:
        """Window index of the next ticket to fence (caller holds the
        window lock): FIFO takes the oldest; ``"ready"`` the oldest
        completed batch, then the preferred ticket, then the oldest."""
        if self.options.schedule != "ready" or len(self._window) <= 1:
            return 0
        for i, t in enumerate(self._window):
            if _ticket_ready(t):
                return i
        if prefer is not None:
            for i, t in enumerate(self._window):
                if t is prefer:
                    return i
        return 0

    def _trim_window(self) -> None:
        while True:
            with self._lock:
                if len(self._window) <= self.inflight_limit:
                    return
            if self._fence_next() is None:
                return

    def _fence_next(self,
                    prefer: Optional[PlanTicket] = None
                    ) -> Optional[PlanTicket]:
        """Retire one dispatched batch (schedule picks which); None when
        the window is empty."""
        # the fence lock holds across the device wait + on_done BY
        # DESIGN: only fencers contend on it
        with self._fence_lock:  # lockcheck: intentional
            with self._lock:
                if not self._window:
                    return None
                idx = self._select_index(prefer)
                if idx:
                    chosen = self._window[idx]
                    del self._window[idx]
                    self._window.appendleft(chosen)
            return self._complete_oldest()

    def _complete_oldest(self) -> PlanTicket:
        # the window lock is held ONLY for the pop
        with self._lock:
            ticket = self._window.popleft()
            ticket._fencing = True
            inflight_after = len(self._window)
            self._gauge.set(float(inflight_after))
        tracing = obs_trace.enabled()
        ctrl = self._ctrl
        stamp = tracing or ctrl is not None
        t_fence_us = obs_trace.now_us() if stamp else 0.0
        try:
            try:
                if ticket._exc is not None:
                    exc, ticket._exc = ticket._exc, None
                    raise exc
                if _faults.armed():
                    _faults.check("plan.fence", label=ticket.label,
                                  request_ids=ticket.request_ids)
                ticket.result = self._fence(ticket)
            except Exception as exc:  # noqa: BLE001 — the failure domain
                self._recover(ticket, exc)
            ticket._raw = None
            ticket._markers = ()
            ticket._done = True
            if stamp:
                end_us = obs_trace.now_us()
                order = next(self._fence_seq)
                # ``order`` is the retirement rank — diffing it against
                # ``seq`` shows out-of-order fences
                fence_kw = dict(plan=self.plan_id, seq=ticket.seq,
                                label=ticket.label, lanes=ticket.lanes,
                                inflight=inflight_after, order=order)
                if tracing:
                    obs_trace.complete("plan.fence", t_fence_us,
                                       end_us - t_fence_us, **fence_kw)
                    args_kw = dict(plan=self.plan_id, seq=ticket.seq,
                                   label=ticket.label, lanes=ticket.lanes,
                                   live=ticket.n_live, inflight=inflight_after)
                    if ticket.request_ids is not None:
                        args_kw["request_ids"] = list(ticket.request_ids)
                    obs_trace.complete("plan.dispatch", ticket._t_dispatch_us,
                                       end_us - ticket._t_dispatch_us, **args_kw)
                if ctrl is not None:
                    ctrl.ingest({
                        "name": "plan.fence", "ph": "X",
                        "ts": t_fence_us, "dur": end_us - t_fence_us,
                        "args": fence_kw})
            if ticket._on_done is not None:
                ticket._on_done(ticket)
        finally:
            # always release waiters, even when on_done raised
            ticket._event.set()
        return ticket

    # -- fence watchdog ----------------------------------------------------

    def _fence(self, ticket: PlanTicket):
        """The blocking device wait, bounded by the fence watchdog when
        ``fence_timeout_ms`` is set (an injected ``hang_s`` consumes the
        plan clock first; a real wedge is bounded by polling the
        ticket's marker).  A fence past its budget raises
        ``PlanError(kind="hang")`` into :meth:`_recover`."""
        timeout_ms = self.options.fence_timeout_ms
        timeout_s = None if timeout_ms is None else max(
            float(timeout_ms), 0.0) / 1e3
        if _faults.armed():
            hang_s = _faults.hang_for("plan.fence", label=ticket.label,
                                      request_ids=ticket.request_ids)
            if hang_s > 0.0:
                waited = hang_s if timeout_s is None else min(hang_s, timeout_s)
                self._advance_clock(waited)
                if timeout_s is not None and hang_s > timeout_s:
                    self._hang_escape(ticket)
        if timeout_s is not None:
            self._watch_fence(ticket, timeout_s)
        for marker in ticket._markers:  # every shard's device
            marker.synchronize()
        raw = ticket._raw
        return _gather(raw, self.device) if isinstance(raw, _Sharded) else raw

    def _advance_clock(self, seconds: float) -> None:
        """Consume ``seconds`` from the injectable clock: virtual clocks
        (anything with ``.advance``) jump; real clocks sleep, capped."""
        adv = getattr(self._clock, "advance", None)
        if adv is not None:
            adv(seconds)
        else:
            time.sleep(min(seconds, _HANG_SLEEP_CAP_S))

    def _watch_fence(self, ticket: PlanTicket, timeout_s: float) -> None:
        """Poll ticket readiness until complete or the budget expires,
        on both the injectable clock and wall time.  Without a probe the
        watchdog cannot observe progress and falls through to the plain
        blocking fence."""
        t0 = self._clock()
        wall0 = time.monotonic()
        while True:
            ready = _ticket_ready(ticket)
            if ready is None or ready:
                return
            if (self._clock() - t0 >= timeout_s
                    or time.monotonic() - wall0 >= timeout_s):
                self._hang_escape(ticket)
            time.sleep(min(timeout_s / 20.0, 0.001))

    def _hang_escape(self, ticket: PlanTicket) -> None:
        """A fence exceeded its budget: flight-record the wedge, shrink
        the dispatch window now (a hang is maximal congestion) and raise
        the hang into the failure domain."""
        if self._ctrl is not None:
            self._ctrl.on_backoff()
        from dispatches_tpu_torch.obs import flight as obs_flight

        if obs_flight.enabled():
            obs_flight.trigger(
                "plan_hang", label=ticket.label,
                detail={"plan": self.plan_id, "seq": ticket.seq,
                        "lanes": ticket.lanes, "n_live": ticket.n_live,
                        "fence_timeout_ms": float(self.options.fence_timeout_ms),
                        "request_ids": list(ticket.request_ids or ())})
        raise PlanError(ticket.label, ticket.seq, kind="hang",
                        guilty=(), attempts=0)

    # -- failure domain ----------------------------------------------------

    def _redispatch(self, ticket: PlanTicket, idxs: Sequence[int]):
        """Synchronously re-stage and re-run a subset of a failed batch;
        the fault sites are re-checked so persistent (poison) rules keep
        failing until bisection has isolated their lanes."""
        self._obs_retries.inc(label=ticket.label)
        args, lanes, req_ids = ticket._restage(tuple(idxs))
        if _faults.armed():
            for site in ("plan.submit", "solver", "plan.fence"):
                _faults.check(site, label=ticket.label, request_ids=req_ids)
        out = ticket._program._run(*args)
        for marker in self._markers(out):
            marker.synchronize()
        return _gather(out, self.device) if isinstance(out, _Sharded) else out

    def _recover(self, ticket: PlanTicket, exc: BaseException) -> None:
        """Contain one failed batch: full retries with capped exponential
        backoff, then lane bisection to isolate guilty lanes.  Leaves
        ``ticket.error`` (always) and ``ticket.result`` (unless no lane
        could produce one)."""
        label = ticket.label
        kind = getattr(exc, "kind", "error")
        if ticket._restage is None or ticket._program is None:
            ticket.error = PlanError(
                label, ticket.seq, guilty=tuple(range(ticket.n_live)),
                attempts=0, cause=exc, kind=kind)
            return
        _faults.note_recovered(exc)
        if self._ctrl is not None:
            # recovery backoff is congestion: shrink the window now
            self._ctrl.on_backoff()
        indices = list(range(ticket.n_live))
        backoff_ms = max(float(self.options.retry_backoff_ms), 0.0)
        attempts = 0
        for attempt in range(1, max(int(self.options.max_retries), 0) + 1):
            attempts = attempt
            if backoff_ms > 0.0:
                time.sleep(min(backoff_ms * 2.0 ** (attempt - 1),
                               _BACKOFF_CAP_MS) / 1e3)
            try:
                res = self._redispatch(ticket, indices)
            except Exception as exc2:  # noqa: BLE001
                _faults.note_recovered(exc2)
                continue
            ticket.result = res
            ticket.error = PlanError(label, ticket.seq, guilty=(),
                                     attempts=attempts, cause=exc, kind=kind)
            return
        # retries exhausted: bisect so every innocent lane still
        # completes and only the guilty ones fail
        results: Dict[int, Any] = {}
        guilty: List[int] = []
        stack = [indices]
        while stack:
            idxs = stack.pop()
            try:
                res = self._redispatch(ticket, idxs)
            except Exception as exc2:  # noqa: BLE001
                _faults.note_recovered(exc2)
                if len(idxs) == 1:
                    guilty.append(idxs[0])
                else:
                    mid = len(idxs) // 2
                    stack.append(idxs[mid:])
                    stack.append(idxs[:mid])
                continue
            for j, i in enumerate(idxs):
                results[i] = tree_map(lambda a, _j=j: a[_j], res)
        guilty.sort()
        if results:
            filler = _nan_like_lane(next(iter(results.values())))
            lanes_out = [results.get(i, filler) for i in indices]
            ticket.result = tree_map(
                lambda *ls: torch.stack([torch.as_tensor(v) for v in ls]), *lanes_out)
        ticket.error = PlanError(label, ticket.seq, guilty=tuple(guilty),
                                 attempts=attempts, cause=exc, kind=kind)
