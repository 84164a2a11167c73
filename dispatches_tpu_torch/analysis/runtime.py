"""Runtime sanitizers: opt-in NaN/Inf guards on solver iterates, the
program-build accounting of the execution plan and the solvers, and the
lock-order sanitizer of the concurrent layers.

Counterpart of ``dispatches_tpu/analysis/runtime.py``:

* ``nan_guard``: PyTorch runs eagerly, so where the JAX guard inserts a
  host callback into the trace, this one checks the tensors directly — a
  device sync per guard, paid only when ``DISPATCHES_TPU_SANITIZE`` is
  set.
* :class:`ProgramCounter` takes the place of ``graft_jit``'s compile
  counter.  torch compiles nothing per input shape, so it counts what a
  jit cache would key on: the distinct argument signatures (shapes and
  dtypes) a program has run.  That is the quantity behind the serve
  layer's "compiled programs" and a bucket's compiles, so both packages
  report the same numbers.  Every counter registers itself, so
  ``recompile_counts()``, ``reset_recompile_counts()`` and
  ``assert_no_recompiles()`` keep the JAX package's steady-state
  contract, and ``DISPATCHES_TPU_WARN_RECOMPILE`` warns
  (:class:`RecompileWarning`) on every signature after a program's
  first.
* :class:`CountedProgram` wraps a solver callable with such a counter,
  where the JAX package wraps it in ``graft_jit``.
* ``checkified``: the counterpart of checkify's ``nan_checks``, a
  dispatch mode that checks every aten op's floating outputs (a
  debugging tool, off every main path).
* ``sanitized_lock``: a copy of the JAX package's (pure Python).
"""

from __future__ import annotations

import contextlib
import functools
import sys
import threading
import time
import warnings
from typing import Callable, Dict, Hashable, List, Tuple

import torch

from dispatches_tpu_torch.analysis.flags import flag_enabled

__all__ = [
    "CountedProgram",
    "LockOrderError",
    "ProgramCounter",
    "RecompileWarning",
    "SanitizeWarning",
    "SanitizedLock",
    "assert_no_recompiles",
    "checkified",
    "drain_sanitize_events",
    "lock_order_report",
    "nan_guard",
    "recompile_counts",
    "reset_lock_order",
    "reset_recompile_counts",
    "sanitize_enabled",
    "sanitized_lock",
]


class RecompileWarning(UserWarning):
    """A counted program ran a new argument signature after its first."""


class SanitizeWarning(UserWarning):
    """A nan_guard found a non-finite value."""


_lock = threading.Lock()
_EVENTS: List[str] = []


def sanitize_enabled() -> bool:
    """Whether nan_guard checks its tensors (DISPATCHES_TPU_SANITIZE)."""
    return flag_enabled("SANITIZE")


def _unwrapped(t: torch.Tensor) -> torch.Tensor:
    # inside torch.func.vmap/grad a tensor is a functorch wrapper, and
    # bool() on it would be data-dependent control flow; check the
    # underlying tensor (all lanes at once) instead
    while torch._C._functorch.is_functorch_wrapped_tensor(t):
        t = torch._C._functorch.get_unwrapped(t)
    return t


def nan_guard(label: str, *tensors) -> None:
    """Opt-in non-finite check on intermediate iterates.

    No-op unless DISPATCHES_TPU_SANITIZE is set.  When set, records
    ``label`` for ``drain_sanitize_events``, warns and triggers a
    ``nan_guard`` flight bundle (when the recorder is armed) if any
    tensor holds a NaN or Inf.  Safe inside ``torch.func`` transforms."""
    if not sanitize_enabled():
        return
    flat = [_unwrapped(t) for t in tensors if t is not None]
    if not flat or all(bool(torch.isfinite(t).all()) for t in flat):
        return
    with _lock:
        _EVENTS.append(label)
    warnings.warn(
        f"sanitize: non-finite value in '{label}'",
        SanitizeWarning,
        stacklevel=2,
    )
    try:  # lazy: the analysis layer imports nothing of obs at load
        from dispatches_tpu_torch.obs import flight

        if flight.enabled():
            flight.trigger("nan_guard", label=label, detail={"guard": label})
    except Exception:
        pass


def drain_sanitize_events() -> List[str]:
    """Return and clear the labels recorded by nan_guard."""
    with _lock:
        out = list(_EVENTS)
        _EVENTS.clear()
    return out


def checkified(fun: Callable) -> Callable:
    """Wrap ``fun`` so that the first aten operation that writes a NaN
    into a floating output raises ``FloatingPointError`` (message: "nan
    generated by ...") instead of propagating it: the counterpart of
    ``jax.experimental.checkify`` with ``nan_checks``.

    Every operation inside ``fun`` runs under a
    ``TorchDispatchMode`` that reads its outputs back (a device sync per
    operation on the card, and noise from benign ±inf arithmetic) — a
    tool for debugging one function, not for wiring into hot paths."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class _NanChecks(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and bool(torch.isnan(t).any())):
                    raise FloatingPointError(
                        f"nan generated by primitive {func} "
                        f"(output of shape {tuple(t.shape)})")
            return out

    @functools.wraps(fun)
    def run(*args, **kwargs):
        with _NanChecks():
            return fun(*args, **kwargs)

    return run


# ---------------------------------------------------------------------------
# program-build accounting (the port's graft_jit compile counter)
# ---------------------------------------------------------------------------


_COUNTERS: List["ProgramCounter"] = []


class ProgramCounter:
    """Distinct argument signatures one program has run.

    ``observe(signature)`` returns True (and counts, and tells the obs
    layer) the first time a signature is seen — where ``jax.jit`` would
    trace and compile.  Counts are per program instance, as the JAX
    package's compile counters are per wrapper: two trackers each own a
    program, and each is expected to build once.  Every counter
    registers itself for ``recompile_counts()``."""

    __slots__ = ("label", "count", "_seen")

    def __init__(self, label: str):
        self.label = label
        self.count = 0
        self._seen: set = set()
        with _lock:
            _COUNTERS.append(self)

    def observe(self, signature: Hashable) -> bool:
        with _lock:
            if signature in self._seen:
                return False
            self._seen.add(signature)
            self.count += 1
            count = self.count
        if count > 1 and flag_enabled("WARN_RECOMPILE"):
            warnings.warn(
                f"'{self.label}' ran a new argument signature (build "
                f"#{count}) after warm-up; check for shape/dtype churn",
                RecompileWarning,
                stacklevel=3,
            )
        try:  # telemetry never breaks the dispatch it describes
            from dispatches_tpu_torch.obs import registry, trace

            trace.instant("compile", label=self.label, count=count)
            registry.counter(
                "program.builds", "distinct program signatures run "
                "(the jit cache misses of the JAX package)").inc(label=self.label)
        except Exception:
            pass
        return True


class CountedProgram:
    """A solver callable with the JAX package's ``graft_jit`` compile
    count: ``_graft_counter`` (a :class:`ProgramCounter` labelled
    ``label``) counts the distinct params signatures it has run."""

    __slots__ = ("_fn", "_graft_counter", "_profile")

    def __init__(self, fn, label: str):
        from dispatches_tpu_torch.obs import profile

        self._fn = fn
        self._graft_counter = ProgramCounter(label)
        # resolved at wrap time, as graft_jit resolves OBS_PROFILE
        self._profile = profile.enabled()

    def __call__(self, params, *args, **kwargs):
        from dispatches_tpu_torch.plan.execution import _signature

        c = self._graft_counter
        if c.observe(_signature((params,) + args)) and self._profile:
            from dispatches_tpu_torch.obs import profile

            return profile.profiled_call(
                lambda *a: self._fn(*a, **kwargs), c.label, c.count,
                (params,) + args)
        return self._fn(params, *args, **kwargs)


def recompile_counts() -> Dict[str, int]:
    """Signature counts per program, keyed ``label`` (``label#k`` on
    label collisions, in registration order)."""
    with _lock:
        counters = list(_COUNTERS)
    out: Dict[str, int] = {}
    seen: Dict[str, int] = {}
    for c in counters:
        k = seen.get(c.label, 0)
        seen[c.label] = k + 1
        out[c.label if k == 0 else f"{c.label}#{k}"] = c.count
    return out


def reset_recompile_counts() -> None:
    """Zero every counter and forget the programs registered so far.

    Counters stay attached to their (still live) programs and keep the
    signatures they have seen, as a jit cache stays warm: a later new
    signature of an old program is still observable through its
    counter; the global report simply starts fresh.
    """
    with _lock:
        for c in _COUNTERS:
            c.count = 0
        _COUNTERS.clear()


@contextlib.contextmanager
def assert_no_recompiles(allow: Tuple[str, ...] = ()):
    """Assert that no counted program runs a new signature inside the
    block.

    Steady-state contract: after warm-up, a double-loop day must reuse
    every solver program it built — zero new signatures, including the
    first signatures of programs created inside the block (a new
    program in steady state IS a build the warm-up failed to amortize).
    ``allow`` exempts labels that legitimately build (e.g. a solver for
    a new horizon requested mid-run).
    """
    with _lock:
        before = {id(c): c.count for c in _COUNTERS}
    yield
    with _lock:
        offending = [
            (c.label, c.count - before.get(id(c), 0))
            for c in _COUNTERS
            if c.count > before.get(id(c), 0) and c.label not in allow
        ]
    if offending:
        detail = ", ".join(f"{lbl}: +{n}" for lbl, n in offending)
        raise AssertionError(
            f"recompiles detected in steady state: {detail} "
            "(every call should reuse a program built in warm-up)"
        )


class LockOrderError(RuntimeError):
    """A SanitizedLock observed a lock-order inversion (or a
    non-reentrant self re-acquire) at runtime."""


# ---------------------------------------------------------------------------
# lock-order sanitizer (DISPATCHES_TPU_SANITIZE)
# ---------------------------------------------------------------------------
#
# The runtime half of the GL011 static rule: the linter proves the
# acquisition-order graph of *lexically visible* acquisitions is
# acyclic, this sanitizer watches the orders that actually happen —
# including ones threaded through callbacks and dynamic dispatch the
# one-level summaries cannot see.  ``sanitized_lock(name)`` is the
# factory the concurrent layers use for their guards:
#
#   - disarmed (flag unset at CONSTRUCTION time): returns a genuine
#     ``threading.Lock``/``RLock`` — not a wrapper, the exact object
#     type, so the hot path pays literally zero (spy-pinned in tests
#     by type identity);
#   - armed: returns a wrapper that records per-thread acquisition
#     stacks and per-site hold durations, registers every observed
#     held->acquired edge in a process-wide order graph, and raises
#     :class:`LockOrderError` the moment an acquisition inverts an
#     edge already observed in the other direction (or a thread
#     re-enters a non-reentrant lock).
#
# ``lock_order_report()`` feeds the ``sanitize.lock_order`` dump the CI
# smoke asserts empty on the clean tree.

_ORDER_LOCK = threading.Lock()  # guards the three dicts below
_ORDER_EDGES: Dict[Tuple[str, str], str] = {}   # (held, acquired) -> site
_ORDER_INVERSIONS: List[Dict[str, str]] = []
_HOLD_SITES: Dict[str, Dict[str, float]] = {}   # "name@file:line" -> stats
_HELD = threading.local()  # per-thread stack of live _Acquisition


class _Acquisition:
    __slots__ = ("name", "site", "t0")

    def __init__(self, name: str, site: str, t0: float):
        self.name = name
        self.site = site
        self.t0 = t0


def _held_stack() -> List["_Acquisition"]:
    stack = getattr(_HELD, "stack", None)
    if stack is None:
        stack = _HELD.stack = []
    return stack


def _call_site(depth: int) -> str:
    frame = sys._getframe(depth)
    return f"{frame.f_code.co_filename.rsplit('/', 1)[-1]}:{frame.f_lineno}"


class _SanitizedLock:
    """The armed wrapper: a context-manager lock with order tracking.

    Not a drop-in for every ``threading`` API (no ``Condition``
    integration) — it covers ``with``/``acquire``/``release``/
    ``locked``, which is all the concurrent layers use.
    """

    __slots__ = ("name", "reentrant", "_inner")

    def __init__(self, name: str, reentrant: bool):
        self.name = name
        self.reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()

    # -- order bookkeeping -------------------------------------------------

    def _before_acquire(self, site: str) -> None:
        stack = _held_stack()
        held_names = []
        for acq in stack:
            if acq.name == self.name:
                if not self.reentrant:
                    with _ORDER_LOCK:
                        _ORDER_INVERSIONS.append({
                            "kind": "self-deadlock", "lock": self.name,
                            "site": site, "prior_site": acq.site})
                    raise LockOrderError(
                        f"non-reentrant lock '{self.name}' re-acquired "
                        f"at {site} while held (acquired at "
                        f"{acq.site}) — this thread would deadlock")
                return  # re-entering: no new order edges
            if acq.name not in held_names:
                held_names.append(acq.name)
        if not held_names:
            return
        with _ORDER_LOCK:
            for held in held_names:
                reverse = _ORDER_EDGES.get((self.name, held))
                if reverse is not None:
                    _ORDER_INVERSIONS.append({
                        "kind": "inversion", "first": held,
                        "second": self.name, "site": site,
                        "reverse_site": reverse})
                    raise LockOrderError(
                        f"lock-order inversion: '{held}' -> "
                        f"'{self.name}' at {site}, but "
                        f"'{self.name}' -> '{held}' was observed at "
                        f"{reverse} — two threads taking the pair in "
                        "opposite orders deadlock")
                _ORDER_EDGES.setdefault((held, self.name), site)

    def _after_acquire(self, site: str) -> None:
        _held_stack().append(_Acquisition(self.name, site,
                                          time.perf_counter()))

    def _on_release(self) -> None:
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i].name == self.name:
                acq = stack.pop(i)
                held_s = time.perf_counter() - acq.t0
                key = f"{self.name}@{acq.site}"
                with _ORDER_LOCK:
                    stats = _HOLD_SITES.setdefault(
                        key, {"count": 0, "total_s": 0.0, "max_s": 0.0})
                    stats["count"] += 1
                    stats["total_s"] += held_s
                    stats["max_s"] = max(stats["max_s"], held_s)
                return

    # -- lock API ----------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        site = _call_site(2)
        self._before_acquire(site)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._after_acquire(site)
        return got

    def release(self) -> None:
        self._on_release()
        self._inner.release()

    def __enter__(self) -> "_SanitizedLock":
        site = _call_site(2)
        self._before_acquire(site)
        self._inner.acquire()
        self._after_acquire(site)
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        inner = self._inner
        return inner.locked() if hasattr(inner, "locked") else False

    def __repr__(self) -> str:
        return (f"<SanitizedLock {self.name!r} "
                f"{'reentrant' if self.reentrant else 'plain'}>")


#: public alias for isinstance checks / docs
SanitizedLock = _SanitizedLock


def sanitized_lock(name: str, *, reentrant: bool = True):
    """A lock for the concurrent layers' guards: the plain
    ``threading`` lock when ``DISPATCHES_TPU_SANITIZE`` is unset (zero
    overhead, by type identity), the order-tracking
    :class:`SanitizedLock` when armed.

    The flag is read at CONSTRUCTION time — like ``nan_guard``'s
    trace-time rule: arm the sanitizer before building the service or
    plan whose locks you want watched.
    """
    if not flag_enabled("SANITIZE"):
        return threading.RLock() if reentrant else threading.Lock()
    return _SanitizedLock(name, reentrant)


def lock_order_report() -> Dict[str, object]:
    """The ``sanitize.lock_order`` report: every acquisition-order edge
    observed, every inversion raised, and per-site hold durations."""
    with _ORDER_LOCK:
        return {
            "edges": {f"{a} -> {b}": site
                      for (a, b), site in sorted(_ORDER_EDGES.items())},
            "inversions": [dict(i) for i in _ORDER_INVERSIONS],
            "holds": {k: dict(v) for k, v in sorted(_HOLD_SITES.items())},
        }


def reset_lock_order() -> None:
    """Clear the process-wide order graph, inversion log, and hold
    stats (per-thread held stacks clear themselves on release)."""
    with _ORDER_LOCK:
        _ORDER_EDGES.clear()
        _ORDER_INVERSIONS.clear()
        _HOLD_SITES.clear()
