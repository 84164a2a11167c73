"""Seeded open-loop traffic generation (counterpart of
``dispatches_tpu/serve/traffic.py``; numpy only, and the same draws, so
a spec yields byte-identical request streams in both packages).

Production traffic against a solve service is a *stream*: a long,
correlated sequence of perturbed problem instances arriving on their own
schedule.  This module generates that stream deterministically:

* **arrival processes** (open-loop: arrival times never depend on
  service latency, so an overloaded service builds queue instead of
  silently throttling the load):

  - ``poisson`` — homogeneous Poisson at ``rate_rps``;
  - ``bursty`` — a two-state Markov-modulated Poisson process (MMPP):
    baseline ``rate_rps`` with exponentially-dwelling bursts at
    ``rate_rps * burst_factor`` (mean dwells ``dwell_off_s`` /
    ``dwell_on_s``);
  - ``diurnal`` — an inhomogeneous Poisson ramp
    ``rate(t) = rate_rps * (1 + amplitude * sin(2*pi*t/period_s))``
    by Lewis-Shedler thinning.

* **request streams** as correlated perturbations of a base parameter
  point: each perturbed leaf follows a stationary AR(1) multiplier
  ``x_{k+1} = rho * x_k + sigma * sqrt(1-rho^2) * eps`` around the base
  value.

Everything is driven by ``numpy.random.default_rng(seed)``, and the
generator emits *schedule* timestamps, not sleeps: a replay loop walks
them on the service's injectable clock.  Base params may hold tensors:
a perturbed leaf is computed from its host copy.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, replace
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

__all__ = [
    "TrafficSpec",
    "Request",
    "spec_from_dict",
    "arrival_times",
    "perturbed_params",
    "generate",
]

PROCESSES = ("poisson", "bursty", "diurnal")


@dataclass(frozen=True)
class TrafficSpec:
    """One deterministic traffic segment (see the module docstring)."""

    process: str = "poisson"
    rate_rps: float = 50.0       # baseline arrival rate
    duration_s: float = 60.0     # segment length (virtual seconds)
    seed: int = 0
    # bursty (MMPP-2) knobs
    burst_factor: float = 8.0    # on-state rate multiplier
    dwell_off_s: float = 8.0     # mean dwell at baseline
    dwell_on_s: float = 2.0      # mean dwell in the burst
    # diurnal knobs
    period_s: float = 3600.0     # one "day" (virtual)
    amplitude: float = 0.5       # peak-to-mean ratio - 1 (must be < 1)
    # parameter-stream knobs: AR(1) multiplicative perturbation of the
    # named leaves of base_params["p"]
    perturb: Tuple[str, ...] = ()
    rho: float = 0.9             # lag-1 autocorrelation of the stream
    sigma: float = 0.05          # stationary relative std of each leaf
    # per-request deadline handed to SolveService.submit (None = none)
    deadline_ms: Optional[float] = None

    def __post_init__(self):
        if self.process not in PROCESSES:
            raise ValueError(
                f"unknown arrival process {self.process!r}; "
                f"expected one of {PROCESSES}")
        if self.rate_rps <= 0:
            raise ValueError("rate_rps must be positive")
        if self.duration_s <= 0:
            raise ValueError("duration_s must be positive")
        if not 0.0 <= self.rho < 1.0:
            raise ValueError("rho must be in [0, 1)")
        if abs(self.amplitude) >= 1.0:
            raise ValueError("amplitude must satisfy |amplitude| < 1")

    def to_dict(self) -> Dict:
        d = {f.name: getattr(self, f.name) for f in fields(self)}
        d["perturb"] = list(self.perturb)
        return d


def spec_from_dict(d: Dict) -> TrafficSpec:
    """Build a spec from a JSON-shaped dict (unknown keys rejected, so
    a typo in a soak spec file fails loudly instead of silently running
    the default)."""
    known = {f.name for f in fields(TrafficSpec)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"unknown TrafficSpec keys: {unknown}")
    d = dict(d)
    if "perturb" in d:
        d["perturb"] = tuple(d["perturb"])
    return TrafficSpec(**d)


class Request(NamedTuple):
    """One scheduled request: arrival time (seconds from segment start
    on the replay clock), the perturbed params pytree, and the deadline
    to hand to ``SolveService.submit``."""

    t: float
    params: Dict
    deadline_ms: Optional[float]


# ---------------------------------------------------------------------------
# arrival processes
# ---------------------------------------------------------------------------


def arrival_times(spec: TrafficSpec) -> np.ndarray:
    """Sorted arrival offsets in ``[0, duration_s)`` (seconds)."""
    rng = np.random.default_rng(spec.seed)
    if spec.process == "poisson":
        return _poisson(rng, spec.rate_rps, spec.duration_s)
    if spec.process == "bursty":
        return _bursty(rng, spec)
    return _diurnal(rng, spec)


def _poisson(rng, rate: float, duration: float,
             t0: float = 0.0) -> np.ndarray:
    out: List[float] = []
    t = t0
    while True:
        t += rng.exponential(1.0 / rate)
        if t >= t0 + duration:
            break
        out.append(t)
    return np.asarray(out, dtype=float)


def _bursty(rng, spec: TrafficSpec) -> np.ndarray:
    """MMPP-2: alternate exponential dwells between the baseline and
    burst states, generating a homogeneous Poisson stream within each
    dwell at that state's rate."""
    out: List[float] = []
    t = 0.0
    on = False  # start at baseline
    while t < spec.duration_s:
        dwell = rng.exponential(spec.dwell_on_s if on else spec.dwell_off_s)
        end = min(t + dwell, spec.duration_s)
        rate = spec.rate_rps * (spec.burst_factor if on else 1.0)
        out.extend(_poisson(rng, rate, end - t, t0=t).tolist())
        t = end
        on = not on
    return np.asarray(out, dtype=float)


def _diurnal(rng, spec: TrafficSpec) -> np.ndarray:
    """Lewis-Shedler thinning against the peak rate."""
    peak = spec.rate_rps * (1.0 + abs(spec.amplitude))
    candidates = _poisson(rng, peak, spec.duration_s)
    rate = spec.rate_rps * (
        1.0 + spec.amplitude * np.sin(2.0 * np.pi * candidates / spec.period_s)
    )
    keep = rng.random(candidates.shape) * peak < rate
    return candidates[keep]


# ---------------------------------------------------------------------------
# correlated parameter streams
# ---------------------------------------------------------------------------


def _host(leaf):
    """A leaf as host data (tensors are copied to the CPU)."""
    return leaf.detach().cpu().numpy() if hasattr(leaf, "detach") else leaf


def perturbed_params(spec: TrafficSpec, base_params: Dict,
                     n: int) -> List[Dict]:
    """``n`` params dicts shaped like ``base_params``: each leaf named
    in ``spec.perturb`` is the base value times ``1 + x_k`` where
    ``x_k`` is a stationary AR(1) sequence (std ``sigma``, lag-1
    correlation ``rho``), independently per leaf element.  Leaves not
    named pass through by reference."""
    base_p = base_params.get("p", {})
    for key in spec.perturb:
        if key not in base_p:
            raise KeyError(
                f"perturb leaf {key!r} not in base params "
                f"(have {sorted(base_p)})")
    rng = np.random.default_rng(spec.seed + 0x5EED)
    innov = float(np.sqrt(max(1.0 - spec.rho * spec.rho, 0.0)))
    states = {k: None for k in spec.perturb}
    out: List[Dict] = []
    for _ in range(n):
        p = dict(base_p)
        for key in spec.perturb:
            base = np.asarray(_host(base_p[key]), dtype=float)
            eps = rng.standard_normal(base.shape)
            x = states[key]
            # first draw comes from the stationary distribution, so the
            # stream has no warm-up transient
            x = spec.sigma * eps if x is None else (
                spec.rho * x + spec.sigma * innov * eps)
            states[key] = x
            p[key] = base * (1.0 + x)
        out.append({"p": p, "fixed": dict(base_params.get("fixed", {}))})
    return out


def generate(spec: TrafficSpec, base_params: Dict) -> List[Request]:
    """The full deterministic request stream for one segment."""
    times = arrival_times(spec)
    params = perturbed_params(spec, base_params, len(times))
    return [Request(float(t), p, spec.deadline_ms)
            for t, p in zip(times, params)]
