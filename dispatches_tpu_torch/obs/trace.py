"""Contextvar span tracer with device fencing and Chrome-trace export
(counterpart of ``dispatches_tpu/obs/trace.py``).

PyTorch's CUDA work is asynchronous, so a ``perf_counter`` stop right
after a call measures the enqueue, not the solve.  A span covering
device work calls ``sp.fence(result)``, which ALWAYS synchronises the
CUDA streams that the result's tensors live on (on CPU tensors it does
nothing) — fencing is a timing-correctness operation, not telemetry, so
it blocks whether or not tracing is enabled.

Spans nest through a ``contextvars.ContextVar`` (each completed span
records its parent), land in a bounded ring buffer (oldest dropped),
and export as Chrome trace-event JSON (Perfetto, ``chrome://tracing``).

Disabled-by-default fast path: unless ``DISPATCHES_TPU_OBS`` is set (or
:func:`enable` was called), ``span()`` returns a shared no-op span and
``instant()`` returns immediately — one cached boolean check per call
site, no allocation, no locking.
"""

from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

from dispatches_tpu_torch.analysis.flags import flag_enabled, flag_name

__all__ = [
    "enabled",
    "enable",
    "span",
    "current_span",
    "instant",
    "complete",
    "now_us",
    "events",
    "dropped",
    "reset",
    "add_sink",
    "remove_sink",
    "set_memory_sampler",
    "export_chrome_trace",
    "fence",
    "to_chrome_events",
]

DEFAULT_BUFFER = 65536

_lock = threading.Lock()
_ENABLED: Optional[bool] = None     # lazily resolved from the env flag
_BUFFER: Optional[Deque[Dict]] = None
_DROPPED = 0

# name stack of the spans currently open in this context (tuple of
# span names; immutable so concurrent contexts never share state)
_STACK: contextvars.ContextVar = contextvars.ContextVar(
    "dispatches_tpu_torch_obs_span_stack", default=()
)

# span-boundary hook (obs.profile installs its memory sampler here);
# module-global so the Span hot path pays one attribute read when unset
_SPAN_HOOK = None

# streaming event sinks (obs.online's incremental timeline accumulator
# subscribes here): each completed event is handed to every sink as it
# is recorded, so consumers see spans the moment they retire instead of
# re-scanning the ring.  Empty-list check on the hot path; sink
# exceptions are swallowed (telemetry never breaks the traced op).
_SINKS: List = []


def add_sink(fn) -> None:
    """Register ``fn(event_dict)`` to observe every recorded event."""
    with _lock:
        if fn not in _SINKS:
            _SINKS.append(fn)


def remove_sink(fn) -> None:
    """Unregister a sink installed with :func:`add_sink` (idempotent)."""
    with _lock:
        try:
            _SINKS.remove(fn)
        except ValueError:
            pass


def set_memory_sampler(fn) -> None:
    """Install ``fn`` to run at every span exit (None uninstalls).
    Exceptions from the sampler are swallowed — telemetry never breaks
    the traced operation."""
    global _SPAN_HOOK
    _SPAN_HOOK = fn


def enabled() -> bool:
    """Whether spans/instants are recorded (``DISPATCHES_TPU_OBS``).

    The env flag is read once, lazily; :func:`enable` overrides it for
    the rest of the process (tests, embedding drivers)."""
    global _ENABLED
    if _ENABLED is None:
        _ENABLED = flag_enabled("OBS")
    return _ENABLED


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = bool(on)


def _buffer_size() -> int:
    raw = os.environ.get(flag_name("OBS_BUFFER"), "")
    return int(raw) if raw else DEFAULT_BUFFER


def _buffer() -> Deque[Dict]:
    global _BUFFER
    if _BUFFER is None:
        with _lock:
            if _BUFFER is None:
                _BUFFER = deque(maxlen=_buffer_size())
    return _BUFFER


def _record(event: Dict) -> None:
    global _DROPPED
    buf = _buffer()
    with _lock:
        if len(buf) == buf.maxlen:
            _DROPPED += 1
        buf.append(event)
        sinks = list(_SINKS) if _SINKS else None
    if sinks is not None:  # outside the lock: sinks may touch telemetry
        for fn in sinks:
            try:
                fn(event)
            except Exception:
                pass


def _tensors(value):
    if isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)
    elif hasattr(value, "is_cuda"):
        yield value


def fence(value):
    """Synchronise the current CUDA stream of every device that holds a
    tensor of ``value``, then return ``value``.  Tensors on the CPU need
    no fence."""
    devices = {t.device for t in _tensors(value) if t is not None and t.is_cuda}
    if devices:
        import torch

        for dev in devices:
            torch.cuda.current_stream(dev).synchronize()
    return value


def _now_us() -> float:
    return time.perf_counter_ns() / 1e3


def now_us() -> float:
    """The tracer's clock (µs, ``perf_counter`` epoch) — callers that
    emit retroactive :func:`complete` events capture their own
    timestamps with this so they land on the same axis as live spans."""
    return _now_us()


class Span:
    """One live span; use via ``with span("name", key=val) as sp:``."""

    __slots__ = ("name", "args", "_t0", "_token")

    def __init__(self, name: str, args: Dict):
        self.name = name
        self.args = args
        self._t0 = 0.0
        self._token = None

    def fence(self, value):
        """Block until the device work producing ``value`` (tensors in
        any nest of tuples, lists and dicts) has completed, then return
        it.  The fence runs unconditionally — see the module docstring."""
        return fence(value)

    def __enter__(self) -> "Span":
        stack = _STACK.get()
        self._token = _STACK.set(stack + (self.name,))
        self._t0 = _now_us()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        end = _now_us()
        stack = _STACK.get()
        parent = stack[-2] if len(stack) >= 2 else None
        _STACK.reset(self._token)
        args = dict(self.args)
        if parent is not None:
            args["parent"] = parent
        if exc_type is not None:
            # failed spans must be distinguishable in the export; the
            # exception itself keeps propagating (return False below)
            args["error"] = exc_type.__name__
        _record({
            "name": self.name,
            "ph": "X",
            "ts": self._t0,
            "dur": end - self._t0,
            "tid": threading.get_ident(),
            "args": args,
        })
        hook = _SPAN_HOOK
        if hook is not None:
            try:
                hook()
            except Exception:
                pass
        return False


class _NullSpan:
    """Shared no-op span returned when tracing is disabled.  ``fence``
    still blocks (timing correctness is not telemetry)."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    @staticmethod
    def fence(value):
        return fence(value)


_NULL_SPAN = _NullSpan()


def span(name: str, **args):
    """Context manager timing one operation; near-zero cost when
    tracing is disabled."""
    if not enabled():
        return _NULL_SPAN
    return Span(name, args)


def current_span() -> Optional[str]:
    """Name of the innermost span open in this context, or None."""
    stack = _STACK.get()
    return stack[-1] if stack else None


def instant(name: str, **args) -> None:
    """Point event (e.g. a ``graft_jit`` compile)."""
    if not enabled():
        return
    _record({
        "name": name,
        "ph": "i",
        "ts": _now_us(),
        "s": "t",
        "tid": threading.get_ident(),
        "args": args,
    })


def complete(name: str, ts_us: float, dur_us: float, **args) -> None:
    """Retroactive complete (``ph:X``) event with explicit timestamps.

    The serve layer uses this for per-request journey spans
    (``serve.request`` / ``serve.queue_wait`` / ``serve.dispatch``):
    a request's begin time is only known to be interesting once the
    request completes, so the span is recorded after the fact from
    timestamps captured with :func:`now_us`."""
    if not enabled():
        return
    _record({
        "name": name,
        "ph": "X",
        "ts": float(ts_us),
        "dur": max(float(dur_us), 0.0),
        "tid": threading.get_ident(),
        "args": args,
    })


def events() -> List[Dict]:
    """Snapshot of the ring buffer (oldest first)."""
    if _BUFFER is None:
        return []
    with _lock:
        return list(_BUFFER)


def dropped() -> int:
    """Events evicted from the ring buffer so far."""
    return _DROPPED


def reset() -> None:
    """Clear the buffer and re-resolve its size from the environment."""
    global _BUFFER, _DROPPED
    with _lock:
        _BUFFER = None
        _DROPPED = 0


def to_chrome_events(evts: Optional[List[Dict]] = None) -> List[Dict]:
    """Chrome trace-event dicts (``ph:X`` complete spans, ``ph:i``
    instants) for ``evts`` (default: the live buffer)."""
    pid = os.getpid()
    out = []
    for e in (events() if evts is None else evts):
        ce = dict(e)
        ce["pid"] = pid
        ce["cat"] = "dispatches_tpu"  # the JAX package's category, so traces merge
        out.append(ce)
    # ring order is completion order (a parent span lands after its
    # children, retroactive request spans after the batch) — sort per
    # (tid, ts) so Perfetto sees monotone timestamps on every track
    out.sort(key=lambda e: (e.get("tid", 0), e.get("ts", 0.0)))
    return out


def export_chrome_trace(path, evts: Optional[List[Dict]] = None) -> int:
    """Write the buffered events as Chrome trace-event JSON (Perfetto /
    ``chrome://tracing`` compatible); returns the event count."""
    chrome = to_chrome_events(evts)
    payload = {
        "traceEvents": chrome,
        "displayTimeUnit": "ms",
        # drops are part of the artifact: a truncated Perfetto view
        # should say so instead of silently looking complete
        "otherData": {"events_dropped": dropped()},
    }
    with open(path, "w") as f:
        json.dump(payload, f)
    return len(chrome)
