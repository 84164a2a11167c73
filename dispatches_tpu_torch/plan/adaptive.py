"""Adaptive in-flight depth: AIMD on the live stall attribution
(counterpart of ``dispatches_tpu/plan/adaptive.py``, the same controller).

:class:`InflightDepthController` owns a private
:class:`~dispatches_tpu_torch.obs.online.TimelineAccumulator` fed with the
same three lifecycle spans the plan emits when tracing (the plan feeds
the controller directly, so the loop works with tracing off).  Every
``decide_every`` fences it compares the stall-attribution *deltas*
since its previous decision — the ``fence_bound`` / ``host_stage_bound``
split of the live ``plan.online.stall_us`` gauges — and applies AIMD:

* ``fence_bound`` dominated the interval → the host sat in the fence
  while the window was full: **grow additively** (+1), gated by the
  cost-card memory model — the deeper window must keep
  ``peak_bytes × depth`` under ``mem_budget_bytes`` (either side
  unknown → unconstrained; peak bytes come from
  :func:`dispatches_tpu_torch.obs.profile.cards_for` via the plan).
* ``host_stage_bound`` dominated → the device waited on the host, so a
  deeper window cannot help: **shrink multiplicatively** (halve).
* a fence-time recovery backoff (:meth:`on_backoff`) is congestion:
  immediate multiplicative shrink.

Depth is clamped to ``[1, max_inflight]`` (``PLAN_INFLIGHT_MAX``).
Decisions depend only on the ingested event stream and the fence count
— never on a wall-clock read of the controller's own — so a recorded
or virtual-clock span stream replays to the exact same depth trajectory.

Gauges: ``plan.adaptive.inflight`` (current depth) and the
``plan.adaptive.decisions`` counter (``direction=grow|shrink|hold``),
labeled by plan id.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from dispatches_tpu_torch.obs.online import TimelineAccumulator

__all__ = ["InflightDepthController"]


class InflightDepthController:
    """One plan's dispatch-window depth, driven by stall attribution.

    The owning :class:`~dispatches_tpu_torch.plan.ExecutionPlan` feeds every
    lifecycle span through :meth:`ingest` and reads :attr:`depth` as
    its window bound on each submit; everything else is internal.
    """

    def __init__(self, *, base: int = 2, max_inflight: int = 8,
                 plan: Optional[int] = None, decide_every: int = 2,
                 dominance: float = 2.0,
                 mem_budget_bytes: Optional[int] = None,
                 peak_bytes_fn: Optional[Callable[[], Optional[float]]] = None,
                 gauges: bool = True, registry=None):
        self.max_inflight = max(int(max_inflight), 1)
        self.depth = min(max(int(base), 1), self.max_inflight)
        self.decide_every = max(int(decide_every), 1)
        self.dominance = float(dominance)
        self.mem_budget_bytes = mem_budget_bytes
        self._peak_bytes_fn = peak_bytes_fn
        self.acc = TimelineAccumulator(plan=plan, gauges=False)
        self._fences = 0
        self._fences_at_decision = 0
        self._prev: Dict[str, float] = {"fence_bound_us": 0.0,
                                        "host_stage_bound_us": 0.0,
                                        "queue_empty_us": 0.0}
        self.decisions: Dict[str, int] = {"grow": 0, "shrink": 0, "hold": 0}
        self._gauges = gauges
        self._registry = registry
        self._cells = None

    # -- inputs ------------------------------------------------------------

    def ingest(self, event: Dict) -> None:
        """Consume one plan lifecycle span (Chrome-shaped dict); a
        ``plan.fence`` span advances the decision clock."""
        self.acc.ingest(event)
        if event.get("name") != "plan.fence":
            return
        self._fences += 1
        if self._fences - self._fences_at_decision >= self.decide_every:
            self._decide()

    def on_backoff(self) -> None:
        """A batch hit fence-time recovery backoff — treat it like
        congestion and shrink immediately (multiplicative decrease)."""
        self._fences_at_decision = self._fences
        self._prev = dict(self.acc.stalls())
        self._apply("shrink" if self.depth > 1 else "hold")

    # -- decision ----------------------------------------------------------

    def _decide(self) -> None:
        self._fences_at_decision = self._fences
        cur = self.acc.stalls()
        fence_d = cur["fence_bound_us"] - self._prev["fence_bound_us"]
        host_d = (cur["host_stage_bound_us"]
                  - self._prev["host_stage_bound_us"])
        self._prev = dict(cur)
        if (fence_d > self.dominance * max(host_d, 1.0)
                and self.depth < self.max_inflight
                and self._mem_allows(self.depth + 1)):
            self._apply("grow")
        elif host_d > self.dominance * max(fence_d, 1.0) and self.depth > 1:
            self._apply("shrink")
        else:
            self._apply("hold")

    def _mem_allows(self, depth: int) -> bool:
        if self.mem_budget_bytes is None or self._peak_bytes_fn is None:
            return True
        peak = self._peak_bytes_fn()
        if not peak:
            return True
        return float(peak) * depth <= float(self.mem_budget_bytes)

    def _apply(self, direction: str) -> None:
        if direction == "grow":
            self.depth = min(self.depth + 1, self.max_inflight)
        elif direction == "shrink":
            self.depth = max(self.depth // 2, 1)
        self.decisions[direction] += 1
        if self._gauges:
            self._publish(direction)

    # -- gauges ------------------------------------------------------------

    def _publish(self, direction: str) -> None:
        if self._cells is None:
            if self._registry is None:
                from dispatches_tpu_torch.obs import registry as _registry

                self._registry = _registry.default_registry()
            reg = self._registry
            self._cells = {
                "depth": reg.gauge(
                    "plan.adaptive.inflight",
                    "adaptive dispatch-window depth (AIMD on stall "
                    "attribution)"),
                "decisions": reg.counter(
                    "plan.adaptive.decisions",
                    "depth-controller decisions by direction"),
            }
        labels = {"plan": str(self.acc.plan)}
        self._cells["depth"].set(float(self.depth), **labels)
        self._cells["decisions"].inc(direction=direction, **labels)
