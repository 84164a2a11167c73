"""Process-wide metrics registry: labeled counters, gauges, and
sliding-window histograms with snapshot/diff (a copy of
``dispatches_tpu/obs/registry.py``; it is pure Python).

Every layer of the port that counts something — ``serve`` requests and
batches, ``plan`` dispatches and retries, injected faults — feeds the
same registry.

Design notes
------------
* **Instruments are usable standalone.**  ``Counter``/``Gauge``/
  ``Histogram`` constructed directly are instance-scoped (the serve
  layer keeps per-service instruments this way so two services never
  blend their ``--stats``); instruments obtained through a
  :class:`MetricsRegistry` (or the module-level :func:`counter`/
  :func:`gauge`/:func:`histogram` helpers) are get-or-create shared
  families — the process-wide aggregate.
* **Labels** are passed as keyword arguments at record time
  (``ctr.inc(bucket="pdlp#0")``); each distinct label set gets its own
  series.  The empty label set is just another series.
* **Histograms are sliding windows** with exact small-sample quantiles
  — the semantics ``serve.metrics.LatencyWindow`` relies on (it is a
  subclass), not fixed buckets.
* stdlib-only and thread-safe.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "counter",
    "gauge",
    "histogram",
    "default_registry",
    "diff_snapshots",
]

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def label_text(key: LabelKey) -> str:
    """``a=1,b=2`` rendering used in snapshots and reports ('' = no
    labels)."""
    return ",".join(f"{k}={v}" for k, v in key)


class _Instrument:
    """Shared plumbing: a name, a help string, and a lock."""

    kind = "instrument"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()

    def series(self) -> List[LabelKey]:
        with self._lock:
            return list(self._series_keys())

    def _series_keys(self) -> Iterable[LabelKey]:
        return ()  # subclasses expose their label sets


class _BoundCounter:
    """Hot-path handle for one pre-resolved label set: ``inc`` skips
    the per-call label formatting (~1 µs) that :meth:`Counter.inc`
    pays, which matters at per-request rates in the serve dispatch
    loop."""

    __slots__ = ("_counter", "_key")

    def __init__(self, counter: "Counter", key: LabelKey):
        self._counter = counter
        self._key = key

    def inc(self, amount: float = 1) -> None:
        c = self._counter
        with c._lock:
            c._values[self._key] = c._values.get(self._key, 0) + amount

    def value(self) -> float:
        c = self._counter
        with c._lock:
            return c._values.get(self._key, 0)


class Counter(_Instrument):
    """Monotonically increasing count per label set."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def labeled(self, **labels) -> _BoundCounter:
        return _BoundCounter(self, _label_key(labels))

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0)

    def total(self) -> float:
        """Sum over every label set."""
        with self._lock:
            return sum(self._values.values())

    def _series_keys(self):
        return self._values.keys()

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {label_text(k): v for k, v in self._values.items()}


class Gauge(_Instrument):
    """Last-set value per label set (queue depths, cache sizes)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = value

    def inc(self, amount: float = 1, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def value(self, **labels) -> Optional[float]:
        with self._lock:
            return self._values.get(_label_key(labels))

    def _series_keys(self):
        return self._values.keys()

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {label_text(k): v for k, v in self._values.items()}


class _Window:
    """One label set's sliding window (the LatencyWindow algorithm)."""

    __slots__ = ("items", "count", "total")

    def __init__(self, maxlen: int):
        self.items: deque = deque(maxlen=maxlen)
        self.count = 0
        self.total = 0.0

    def observe(self, value: float) -> None:
        self.items.append(float(value))
        self.count += 1
        self.total += float(value)

    def quantile(self, q: float) -> Optional[float]:
        if not self.items:
            return None
        xs = sorted(self.items)
        idx = min(int(q * len(xs)), len(xs) - 1)
        return xs[idx]

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {"count": self.count}
        if self.items:
            out["mean"] = round(self.total / max(self.count, 1), 3)
            out["p50"] = round(self.quantile(0.50), 3)
            out["p95"] = round(self.quantile(0.95), 3)
            out["p99"] = round(self.quantile(0.99), 3)
        return out


class _BoundWindow:
    """Hot-path handle for one pre-resolved histogram series — the
    :class:`_BoundCounter` pattern for observations (the serve layer's
    per-request queue-wait recording uses it)."""

    __slots__ = ("_hist", "_key")

    def __init__(self, hist: "Histogram", key: LabelKey):
        self._hist = hist
        self._key = key

    def observe(self, value: float) -> None:
        h = self._hist
        with h._lock:
            w = h._windows.get(self._key)
            if w is None:
                w = h._windows[self._key] = _Window(h.window_size)
            w.observe(float(value))


class Histogram(_Instrument):
    """Sliding-window value distribution with cheap exact quantiles."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", window: int = 4096):
        super().__init__(name, help)
        self.window_size = window
        self._windows: Dict[LabelKey, _Window] = {}

    def _window(self, labels: Dict) -> _Window:
        key = _label_key(labels)
        w = self._windows.get(key)
        if w is None:
            w = self._windows[key] = _Window(self.window_size)
        return w

    def observe(self, value: float, **labels) -> None:
        with self._lock:
            self._window(labels).observe(value)

    def labeled(self, **labels) -> _BoundWindow:
        return _BoundWindow(self, _label_key(labels))

    def count(self, **labels) -> int:
        with self._lock:
            return self._window(labels).count

    def total(self, **labels) -> float:
        with self._lock:
            return self._window(labels).total

    def quantile(self, q: float, **labels) -> Optional[float]:
        with self._lock:
            return self._window(labels).quantile(q)

    def summary(self, **labels) -> Dict[str, float]:
        with self._lock:
            return self._window(labels).summary()

    def _series_keys(self):
        return self._windows.keys()

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {label_text(k): w.summary()
                    for k, w in self._windows.items()}


class MetricsRegistry:
    """Named collection of instruments with get-or-create semantics.

    ``counter(name)`` returns THE counter for ``name`` — callers in
    different modules incrementing the same family accumulate into one
    series, which is the point of a process-wide registry.  Asking for
    an existing name with a different instrument kind raises.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Instrument] = {}

    def _get_or_create(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"not {cls.kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  window: int = 4096) -> Histogram:
        return self._get_or_create(Histogram, name, help, window=window)

    def metrics(self) -> List[_Instrument]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def snapshot(self) -> Dict[str, Dict]:
        """Plain-dict view of every instrument: ``{name: {"kind": ...,
        "values": {label_text: value-or-summary}}}``."""
        out: Dict[str, Dict] = {}
        for m in self.metrics():
            out[m.name] = {"kind": m.kind, "values": m.snapshot()}
        return out

    def reset(self) -> None:
        """Drop every instrument (tests; live handles callers still
        hold keep working but are no longer reachable here)."""
        with self._lock:
            self._metrics.clear()


def diff_snapshots(before: Dict[str, Dict],
                   after: Dict[str, Dict]) -> Dict[str, Dict]:
    """What changed between two :meth:`MetricsRegistry.snapshot` calls.

    Counters/gauges report numeric deltas; histograms report the count
    delta per series.  Series absent from ``before`` diff against
    zero/empty; unchanged series are omitted.
    """
    out: Dict[str, Dict] = {}
    for name, entry in after.items():
        kind = entry["kind"]
        prev = before.get(name, {"values": {}})["values"]
        changed = {}
        for label, val in entry["values"].items():
            if kind == "histogram":
                d = val.get("count", 0) - prev.get(label, {}).get("count", 0)
            else:
                d = val - prev.get(label, 0)
            if d:
                changed[label] = d
        if changed:
            out[name] = {"kind": kind, "delta": changed}
    return out


_default_lock = threading.Lock()
_default: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    """The process-wide registry every layer feeds by default."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry()
        return _default


def counter(name: str, help: str = "") -> Counter:
    return default_registry().counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return default_registry().gauge(name, help)


def histogram(name: str, help: str = "", window: int = 4096) -> Histogram:
    return default_registry().histogram(name, help, window=window)
