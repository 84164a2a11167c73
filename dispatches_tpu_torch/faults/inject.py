"""Deterministic, seeded fault injection for the dispatch stack (a copy
of ``dispatches_tpu/faults/inject.py``: same grammar, same site names,
so one ``DISPATCHES_TPU_FAULTS`` scenario arms both packages alike; the
port fires ``plan.*``, ``solver``, ``serve.stage`` and ``service.clock``,
and keeps the fleet and net sites only so their rules parse).

The serve/plan/sweep layers were built for throughput; this module
exists so their *failure domains* can be tested on purpose.  A small
set of named **injection sites** is threaded through the hot paths:

======================  ====================================================
site                    where it fires
======================  ====================================================
``plan.stage``          :meth:`ExecutionPlan.stage` — host→device staging
``plan.submit``         :meth:`ExecutionPlan.submit` — program dispatch
``plan.fence``          :meth:`ExecutionPlan._complete_oldest` — the
                        ``block_until_ready`` fence (and every bisection
                        re-dispatch, so persistent rules re-fire there)
``solver``              checked alongside ``plan.submit`` but matched on
                        the program label, for targeting one solver kind
``serve.stage``         :meth:`SolveService._dispatch_bucket` — host-side
                        batch staging before the plan is involved
``service.clock``       non-raising: skews the service's view of "now"
                        (deadline triage, queue-wait) by ``skew_s``
``replica.heartbeat``   :meth:`fleet.ReplicaHandle.heartbeat` — the beat
                        is silently lost (contained), so a persistent
                        rule drives heartbeat-timeout failover of a
                        live replica (label = replica name)
``router.submit``       :meth:`fleet.FleetRouter.submit` — the request
                        is refused at the fleet façade and completes
                        as ``SHED`` (contained)
``net.connect``         :class:`net.rpc.RpcClient` connection dial —
                        the dial fails (label = ``host:port`` peer, so
                        ``match`` partitions one peer away; a
                        persistent rule is a network partition)
``net.send``            request framing onto a connected socket — the
                        write fails and the connection is torn down
                        (label = ``peer/method``; retry/backoff
                        contains it, ``hang_s`` models added latency
                        consumed against the call's deadline clock)
``net.recv``            response framing off the socket — the read
                        fails after the request may already have been
                        delivered (label = ``peer/method``; same
                        containment and ``hang_s`` semantics as
                        ``net.send``)
======================  ====================================================

A **scenario** is a list of rules.  The string grammar (also accepted
from the ``DISPATCHES_TPU_FAULTS`` environment flag and soak specs) is
semicolon-separated rules of comma-separated ``key=value`` fields; the
first bare field may be the site::

    plan.fence,p=0.5,times=3,seed=7;plan.fence,poison_mod=37

Rule fields:

``site``        required — one of :data:`SITES`.
``p``           fire probability per eligible call (default 1.0),
                drawn from a per-rule ``random.Random(seed)`` so a
                scenario replays identically run to run.
``times``       total fire budget (default 1; ``times=0`` or
                ``times=-1`` means unlimited).  Poison rules default
                to unlimited — a poisoned lane stays poisoned.
``after``       skip the first N eligible calls (default 0).
``every``       fire on every Nth eligible call after ``after``
                (default 1).
``seed``        RNG seed for ``p`` draws (default 0).
``match``       substring that must occur in the call's label
                (program / bucket label) for the rule to apply.
``poison_ids``  ``|``-separated request ids; the rule applies only to
                calls whose ``request_ids`` include one of them.
``poison_mod``  the rule applies when any riding request id satisfies
                ``id % poison_mod == 0`` — a spec-friendly way to
                poison a deterministic subset of soak traffic.
``skew_s``      ``service.clock`` only: seconds added to the service's
                clock reads while the rule has fire budget.
``hang_s``      plan and ``net.*`` sites: the fence (or RPC) *wedges*
                for this many seconds instead of raising — the plan
                consumes the duration via its injectable clock (the
                RPC client charges it against the call's deadline
                budget), so a fence watchdog
                (``PlanOptions.fence_timeout_ms``) can be proven to
                escape a hang rather than wait it out.  Non-raising
                like ``skew_s``: hang firings count in ``faults.hung``,
                not ``faults.injected`` (recovery-rate accounting is
                for raised faults).

Raising sites raise :class:`InjectedFault` (a ``RuntimeError``) and
increment the ``faults.injected`` counter (labeled by site); recovery
code that *catches* one calls :func:`note_recovered` so the soak /
bench ``fault_recovery_rate`` (recovered ÷ injected) lands at exactly
1.0 when every injected fault was contained.

Arming is process-global and cheap to test: :func:`armed` is a single
cached-environment check (``DISPATCHES_TPU_FAULTS``) plus a module
global, so disarmed hot paths pay one predictable branch — the
spy-pinned zero-overhead tests monkeypatch :func:`check` to raise and
assert the serve/plan fast paths never reach it.  Tests and the soak
harness arm programmatically via :func:`arm`, which returns the
previous scenario so it can be restored.

Host-side and stdlib-only (plus the metrics registry).
"""
from __future__ import annotations

import os
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from dispatches_tpu_torch.analysis.flags import flag_name
from dispatches_tpu_torch.obs import registry as _registry

__all__ = [
    "SITES",
    "InjectedFault",
    "FaultRule",
    "FaultScenario",
    "parse_scenario",
    "armed",
    "arm",
    "disarm",
    "reset",
    "check",
    "clock_skew",
    "hang_for",
    "hung_total",
    "note_recovered",
    "injected_total",
    "recovered_total",
]

SITES = (
    "plan.stage",
    "plan.submit",
    "plan.fence",
    "solver",
    "serve.stage",
    "service.clock",
    "replica.heartbeat",
    "router.submit",
    "net.connect",
    "net.send",
    "net.recv",
)

_UNLIMITED = None  # sentinel for "no fire budget"

_injected = _registry.counter(
    "faults.injected",
    "faults raised by the injection layer (site=<injection site>)")
_recovered = _registry.counter(
    "faults.recovered",
    "injected faults caught and contained by a failure domain "
    "(site=<injection site>)")
_skewed = _registry.counter(
    "faults.skewed",
    "service clock reads skewed by a service.clock rule")
_hung = _registry.counter(
    "faults.hung",
    "fences wedged by a hang_s rule (site=<injection site>)")


class InjectedFault(RuntimeError):
    """Raised by :func:`check` when an armed rule fires at a site."""

    def __init__(self, site: str, detail: str = ""):
        self.site = site
        msg = f"injected fault at {site}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


@dataclass
class FaultRule:
    """One armed rule; mutable counters make firing deterministic."""

    site: str
    p: float = 1.0
    times: Optional[int] = 1
    after: int = 0
    every: int = 1
    seed: int = 0
    match: Optional[str] = None
    poison_ids: Tuple[int, ...] = ()
    poison_mod: Optional[int] = None
    skew_s: float = 0.0
    hang_s: float = 0.0
    calls: int = 0
    fires: int = 0
    _rng: random.Random = field(default=None, repr=False)  # type: ignore

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; expected one of {SITES}")
        if self._rng is None:
            self._rng = random.Random(self.seed)
        if self.poison_ids or self.poison_mod:
            # poison rules default to a persistent fault: the whole
            # point is that retries keep failing until bisection
            # isolates the lane
            if self.times == 1:
                self.times = _UNLIMITED

    def _applies(self, label: Optional[str],
                 request_ids: Optional[Sequence[int]]) -> bool:
        if self.match is not None and (
                label is None or self.match not in label):
            return False
        if self.poison_ids or self.poison_mod:
            if not request_ids:
                return False
            ids = set(int(i) for i in request_ids)
            if self.poison_ids and not ids.intersection(self.poison_ids):
                return False
            if self.poison_mod and not any(
                    i % self.poison_mod == 0 for i in ids):
                return False
        return True

    def should_fire(self, label: Optional[str],
                    request_ids: Optional[Sequence[int]]) -> bool:
        if not self._applies(label, request_ids):
            return False
        self.calls += 1
        if self.calls <= self.after:
            return False
        if (self.calls - self.after - 1) % max(self.every, 1) != 0:
            return False
        if self.times is not _UNLIMITED and self.fires >= self.times:
            return False
        if self.p < 1.0 and self._rng.random() >= self.p:
            return False
        self.fires += 1
        return True


class FaultScenario:
    """An armed list of :class:`FaultRule`."""

    def __init__(self, rules: Sequence[FaultRule]):
        self.rules: List[FaultRule] = list(rules)

    def check(self, site: str, label: Optional[str] = None,
              request_ids: Optional[Sequence[int]] = None) -> None:
        for rule in self.rules:
            if rule.site != site or rule.site == "service.clock":
                continue
            if rule.hang_s > 0.0:
                continue  # hang rules are consumed via hang_for()
            if rule.should_fire(label, request_ids):
                _injected.inc(site=site)
                detail = rule.match or (
                    f"poison {sorted(rule.poison_ids) or rule.poison_mod}"
                    if (rule.poison_ids or rule.poison_mod) else
                    f"fire {rule.fires}/{rule.times or 'inf'}")
                raise InjectedFault(site, detail)

    def clock_skew(self) -> float:
        skew = 0.0
        for rule in self.rules:
            if rule.site != "service.clock":
                continue
            if rule.should_fire(None, None):
                _skewed.inc()
                skew += rule.skew_s
        return skew

    def hang_for(self, site: str, label: Optional[str] = None,
                 request_ids: Optional[Sequence[int]] = None) -> float:
        """Total seconds the fence at ``site`` should wedge (0.0 when
        no hang rule fires).  Non-raising, like :meth:`clock_skew`."""
        hang = 0.0
        for rule in self.rules:
            if rule.site != site or rule.hang_s <= 0.0:
                continue
            if rule.should_fire(label, request_ids):
                _hung.inc(site=site)
                hang += rule.hang_s
        return hang

    def __repr__(self):
        return f"FaultScenario({self.rules!r})"


_RuleSpec = Union[str, Dict, FaultRule]
_ScenarioSpec = Union[str, Dict, Sequence[_RuleSpec], FaultScenario, None]

_INT_FIELDS = ("times", "after", "every", "seed", "poison_mod")
_FLOAT_FIELDS = ("p", "skew_s", "hang_s")


def _parse_rule(spec: _RuleSpec) -> FaultRule:
    if isinstance(spec, FaultRule):
        return spec
    if isinstance(spec, str):
        fields: Dict[str, object] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                if "site" in fields:
                    raise ValueError(
                        f"bare field {part!r} but site already set "
                        f"in rule {spec!r}")
                fields["site"] = part
                continue
            key, _, value = part.partition("=")
            fields[key.strip()] = value.strip()
        spec = fields
    if not isinstance(spec, dict):
        raise TypeError(f"cannot parse fault rule from {type(spec)!r}")
    kw: Dict[str, object] = {}
    for key, value in spec.items():
        if value is None:
            if key != "times":
                raise ValueError(f"fault rule field {key!r} is null")
            kw[key] = _UNLIMITED  # JSON null = unlimited fire budget
        elif key in _INT_FIELDS:
            kw[key] = int(value)
        elif key in _FLOAT_FIELDS:
            kw[key] = float(value)
        elif key == "poison_ids":
            if isinstance(value, str):
                value = [v for v in value.split("|") if v]
            kw[key] = tuple(int(v) for v in value)  # type: ignore
        elif key in ("site", "match"):
            kw[key] = str(value)
        else:
            raise ValueError(f"unknown fault rule field {key!r}")
    if "site" not in kw:
        raise ValueError(f"fault rule missing site: {spec!r}")
    if kw.get("times") in (0, -1):
        kw["times"] = _UNLIMITED
    return FaultRule(**kw)  # type: ignore[arg-type]


def parse_scenario(spec: _ScenarioSpec) -> Optional[FaultScenario]:
    """Build a :class:`FaultScenario` from a string / dict / list spec.

    Accepts the ``;``-separated string grammar, a single rule dict, a
    list of rule specs, or a ``{"rules": [...]}`` wrapper (the soak
    spec JSON shape).  ``None`` / empty specs return ``None``.
    """
    if spec is None or isinstance(spec, FaultScenario):
        return spec or None
    if isinstance(spec, dict) and "rules" in spec:
        spec = spec["rules"]  # type: ignore[assignment]
    if isinstance(spec, str):
        rules = [r for r in (s.strip() for s in spec.split(";")) if r]
    elif isinstance(spec, dict):
        rules = [spec]  # type: ignore[list-item]
    else:
        rules = list(spec)  # type: ignore[arg-type]
    parsed = [_parse_rule(r) for r in rules]
    return FaultScenario(parsed) if parsed else None


# ---------------------------------------------------------------------------
# process-global arming

_SCENARIO: Optional[FaultScenario] = None
_ENV_CHECKED = False


def armed() -> bool:
    """True when a fault scenario is armed (one branch when cold)."""
    global _ENV_CHECKED, _SCENARIO
    if not _ENV_CHECKED:
        _ENV_CHECKED = True
        raw = os.environ.get(flag_name("FAULTS"), "")
        if raw:
            _SCENARIO = parse_scenario(raw)
    return _SCENARIO is not None


def arm(spec: _ScenarioSpec) -> Optional[FaultScenario]:
    """Arm ``spec`` (parsed via :func:`parse_scenario`); returns the
    previously armed scenario so callers can restore it."""
    global _SCENARIO, _ENV_CHECKED
    armed()  # fold in any pending env spec so we return/restore it
    previous = _SCENARIO
    _SCENARIO = parse_scenario(spec)
    _ENV_CHECKED = True
    return previous


def disarm() -> Optional[FaultScenario]:
    """Disarm; returns the previously armed scenario."""
    return arm(None)


def reset() -> None:
    """Forget both the armed scenario and the cached env check (tests)."""
    global _SCENARIO, _ENV_CHECKED
    _SCENARIO = None
    _ENV_CHECKED = False


def check(site: str, label: Optional[str] = None,
          request_ids: Optional[Sequence[int]] = None) -> None:
    """Raise :class:`InjectedFault` if an armed rule fires at ``site``.

    Callers guard with ``if faults.armed(): faults.check(...)`` so the
    disarmed path never reaches this function.
    """
    if _SCENARIO is not None:
        _SCENARIO.check(site, label=label, request_ids=request_ids)


def clock_skew() -> float:
    """Accumulated ``service.clock`` skew for this call, in seconds."""
    if _SCENARIO is None:
        return 0.0
    return _SCENARIO.clock_skew()


def hang_for(site: str, label: Optional[str] = None,
             request_ids: Optional[Sequence[int]] = None) -> float:
    """Seconds a ``hang_s`` rule wedges the fence at ``site`` (0.0
    when disarmed or no rule fires)."""
    if _SCENARIO is None:
        return 0.0
    return _SCENARIO.hang_for(site, label=label, request_ids=request_ids)


def hung_total() -> float:
    """Total hang_s firings so far (all sites; process-global)."""
    return _hung.total()


def note_recovered(exc: BaseException) -> None:
    """Record that a caught exception was a contained injected fault."""
    if isinstance(exc, InjectedFault):
        _recovered.inc(site=exc.site)


def injected_total() -> float:
    """Total injected faults so far (all sites; process-global)."""
    return _injected.total()


def recovered_total() -> float:
    """Total recovered injected faults so far (all sites)."""
    return _recovered.total()
