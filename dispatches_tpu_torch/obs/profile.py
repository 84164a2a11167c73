"""Cost/memory accounting: per-program **cost cards** and span-boundary
memory gauges (counterpart of ``dispatches_tpu/obs/profile.py``).

The JAX package takes a card from XLA's AOT artifact at each compile.
The port compiles nothing per input shape: its "compile" is the first
call of a new argument signature of a plan program
(``PlanProgram.compiles``, :class:`analysis.runtime.ProgramCounter`).
So the card is taken around that first call:

* ``label``, ``count``, ``backend`` (``"gpu"`` for a CUDA device,
  ``"cpu"``) and ``shapes`` (the argument description) — the JAX keys;
* ``argument_bytes`` / ``output_bytes`` — the summed ``nbytes`` of the
  call's tensor arguments and results;
* ``peak_bytes`` (CUDA only) — the allocator's high-water mark during
  the call above what was allocated before it
  (``torch.cuda.max_memory_allocated``), plus ``argument_bytes``: the
  device memory one batch in flight holds;
* ``flops`` — the floating-point operations that
  ``torch.utils.flop_counter.FlopCounterMode`` counts over the call: the
  matmul-family ATen ops.  Elementwise work and hand-written kernels
  launched outside the ATen dispatcher are not counted, so it is a lower
  bound, and a card whose count is 0 leaves the key out;
* ``first_call_ms`` — the first call's wall time (the counterpart of
  the JAX package's ``compile_ms``, which is an AOT compile's time).

XLA's ``bytes_accessed`` has no honest counterpart and is left out;
so are ``temp_bytes`` and ``generated_code_bytes``.

Everything is opt-in behind ``DISPATCHES_TPU_OBS_PROFILE`` (or
:func:`enable`), resolved when a plan program is built: with the flag
off, the program's call path is the plain one and the serve/sweep hot
paths carry no new host work.  While profiling is enabled a sampler runs
at every span exit and sets ``profile.device_memory_bytes``
(``torch.cuda.memory_allocated``, absent on a CPU-only process).

Cost accounting never breaks a solve: every recording path is wrapped,
and a failure simply yields no card.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from dispatches_tpu_torch.analysis.flags import flag_enabled
from dispatches_tpu_torch.obs import registry, trace
from dispatches_tpu_torch.utils.tree import tree_leaves

__all__ = [
    "enabled",
    "enable",
    "profiled_call",
    "cost_cards",
    "cards_for",
    "sample_memory",
    "reset",
]

#: bounded card history — a long-running service builds a handful of
#: programs per bucket, so 1024 covers any realistic process lifetime
MAX_CARDS = 1024

_lock = threading.Lock()
_ENABLED: Optional[bool] = None     # lazily resolved from the env flag
_CARDS: "deque[Dict]" = deque(maxlen=MAX_CARDS)
_tls = threading.local()


def _install_sampler(on: bool) -> None:
    trace.set_memory_sampler(sample_memory if on else None)


def enabled() -> bool:
    """Whether cost cards are recorded (``DISPATCHES_TPU_OBS_PROFILE``).

    Read once, lazily; :func:`enable` overrides it for the rest of the
    process.  A plan program consults this when it is built — flipping
    the flag later does not retrofit accounting onto programs already
    built."""
    global _ENABLED
    if _ENABLED is None:
        _ENABLED = flag_enabled("OBS_PROFILE")
        if _ENABLED:
            _install_sampler(True)
    return _ENABLED


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = bool(on)
    _install_sampler(_ENABLED)


def _tensors(tree):
    import torch

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(int(t.numel()) * int(t.element_size()) for t in _tensors(tree))


def _describe_arg(a) -> str:
    """Short shape summary for one call argument (card metadata)."""
    try:
        leaves = tree_leaves(a)
        if len(leaves) == 1 and hasattr(leaves[0], "shape"):
            leaf = leaves[0]
            dtype = str(getattr(leaf, "dtype", "?")).replace("torch.", "")
            return f"{dtype}{list(leaf.shape)}"
        return f"pytree[{len(leaves)} leaves]"
    except Exception:
        return type(a).__name__


def _cuda_device(args):
    """The CUDA device of the call's first CUDA tensor argument, or None."""
    for t in _tensors(args):
        if t.is_cuda:
            return t.device
    return None


def profiled_call(fn, label: str, count: int, args, view=None):
    """Run ``fn(*args)`` — the first call of a new signature of program
    ``label`` — and record its cost card.  Returns ``fn``'s result; the
    card is recorded only when the call succeeds, and any failure of the
    accounting itself leaves the result untouched and yields no card.
    ``view`` maps the arguments and the result to plain trees of tensors
    for the card (the plan unwraps its lane shards with it)."""
    view = view if view is not None else (lambda tree: tree)
    if getattr(_tls, "busy", False):  # a program called inside a program
        return fn(*args)
    _tls.busy = True
    try:
        dev = base = flops_mode = None
        try:
            import torch
            from torch.utils.flop_counter import FlopCounterMode

            dev = _cuda_device(view(args))
            if dev is not None:
                torch.cuda.synchronize(dev)
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            flops_mode = FlopCounterMode(display=False)
        except Exception:
            flops_mode = None
        t0 = time.perf_counter()
        if flops_mode is not None:
            with flops_mode:
                out = fn(*args)
        else:
            out = fn(*args)
        try:
            _record(label, count, view(args), view(out), dev, base,
                    flops_mode, t0)
        except Exception:
            pass
        return out
    finally:
        _tls.busy = False


def _record(label, count, args, out, dev, base, flops_mode, t0) -> None:
    import torch

    peak = None
    if dev is not None:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
    first_call_ms = (time.perf_counter() - t0) * 1e3
    card = {
        "label": label,
        "count": int(count),
        "backend": "gpu" if dev is not None else "cpu",
        "argument_bytes": _nbytes(args),
        "output_bytes": _nbytes(out),
        "first_call_ms": round(first_call_ms, 3),
        "shapes": [_describe_arg(a) for a in args[:8]],
    }
    flops = int(flops_mode.get_total_flops()) if flops_mode is not None else 0
    if flops > 0:
        card["flops"] = float(flops)
    if peak is not None:
        card["peak_bytes"] = int(max(peak, 0) + card["argument_bytes"])
    with _lock:
        _CARDS.append(card)
    trace.instant("compile.cost", **card)
    if "flops" in card:
        registry.gauge(
            "profile.flops", "matmul-family flops of the latest first call"
        ).set(card["flops"], label=label)
    if "peak_bytes" in card:
        registry.gauge(
            "profile.peak_bytes", "device bytes one call of the program "
            "holds (allocator peak above the call's start + arguments)"
        ).set(card["peak_bytes"], label=label)
    registry.counter(
        "profile.cost_cards", "cost cards recorded").inc(label=label)
    registry.histogram(
        "profile.first_call_ms", "wall time of a signature's first call"
    ).observe(card["first_call_ms"])


def cost_cards() -> List[Dict]:
    """Snapshot of every recorded card, oldest first."""
    with _lock:
        return list(_CARDS)


def cards_for(prefix: str) -> List[Dict]:
    """Cards whose label starts with ``prefix`` (e.g. ``serve.pdlp#0``
    for one bucket, ``sweep.`` for every sweep program)."""
    return [c for c in cost_cards() if c["label"].startswith(prefix)]


def sample_memory() -> Dict[str, int]:
    """Update the memory gauge and return it; installed as the tracer's
    span-boundary sampler while profiling is enabled.  Empty in a
    process that has not initialised CUDA."""
    import torch

    out: Dict[str, int] = {}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        out["device_memory_bytes"] = int(torch.cuda.memory_allocated())
        registry.gauge(
            "profile.device_memory_bytes", "device allocator bytes in use"
        ).set(out["device_memory_bytes"])
    return out


def reset() -> None:
    """Drop every recorded card (tests)."""
    with _lock:
        _CARDS.clear()
