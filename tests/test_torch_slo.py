"""The PyTorch port's SLO grading (``dispatches_tpu_torch.obs.slo``) held to
the JAX package's ``obs.slo``, bitwise: the built-in spec, the committed
example spec and ``DISPATCHES_TPU_OBS_SLO``, the validation errors, and
``evaluate`` / ``violations`` / ``format_results`` on snapshots that a
port registry and a JAX registry fill with the same seeded observations
(quantile objectives grouped per bucket, pinned to a label set and
ungrouped; ratio objectives; objectives with no data)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu.obs import registry as jreg  # noqa: E402
from dispatches_tpu.obs import slo as jslo  # noqa: E402

from dispatches_tpu_torch.obs import registry as treg  # noqa: E402
from dispatches_tpu_torch.obs import slo as tslo  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

EXAMPLE_SPEC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "examples", "slo_spec.json")

SPEC = {"name": "t", "objectives": [
    {"name": "lat", "kind": "quantile", "metric": "serve.latency_ms", "p": "p99",
     "target": 40.0, "group_by": "bucket"},
    {"name": "lat_a", "kind": "quantile", "metric": "serve.latency_ms", "p": "p95",
     "target": 30.0, "labels": {"bucket": "a#0"}},
    {"name": "qw_all", "kind": "quantile", "metric": "serve.queue_wait_ms", "p": "mean",
     "target": 5.0},
    {"name": "ghost", "kind": "quantile", "metric": "absent", "target": 1.0},
    {"name": "miss", "kind": "ratio", "target": 0.05,
     "num": {"metric": "serve.deadline", "labels": {"event": "missed"}},
     "den": {"metric": "serve.requests", "labels": {"event": "submitted"}}},
    {"name": "quarantine", "kind": "ratio", "target": 0.05,
     "num": {"metric": "sweep.points", "labels": {"event": "quarantined"}},
     "den": {"metric": "sweep.points"}},
    {"name": "empty_den", "kind": "ratio", "target": 0.1,
     "num": {"metric": "serve.deadline"}, "den": {"metric": "nothing"}},
]}


def _fill(reg, seed):
    rng = np.random.default_rng(seed)
    for b, scale in (("a#0", 2.5), ("b#1", 3.5)):
        for v in rng.lognormal(scale, 0.4, 200):
            reg.histogram("serve.latency_ms").observe(float(v), bucket=b)
    for v in rng.exponential(4.0, 300):
        reg.histogram("serve.queue_wait_ms").observe(float(v))
    reg.counter("serve.requests").inc(400, event="submitted")
    reg.counter("serve.deadline").inc(int(rng.integers(5, 40)), event="missed")
    reg.counter("serve.deadline").inc(300, event="met")
    reg.counter("sweep.points").inc(360, event="ok")
    reg.counter("sweep.points").inc(int(rng.integers(0, 30)), event="quarantined")
    return reg.snapshot()


def test_api_and_builtin_spec_match_jax(monkeypatch):
    assert tslo.__all__ == jslo.__all__
    assert tslo.builtin_spec() == tslo.spec_from_dict({
        "name": "builtin",
        "objectives": [o.__dict__ for o in jslo.builtin_spec().objectives]})
    assert tslo.load_spec(EXAMPLE_SPEC) == tslo.spec_from_dict({
        "name": jslo.load_spec(EXAMPLE_SPEC).name,
        "objectives": [o.__dict__ for o in jslo.load_spec(EXAMPLE_SPEC).objectives]})
    monkeypatch.setenv("DISPATCHES_TPU_OBS_SLO", EXAMPLE_SPEC)
    assert tslo.load_spec().name == jslo.load_spec().name == "example"
    monkeypatch.delenv("DISPATCHES_TPU_OBS_SLO")
    assert tslo.load_spec().name == "builtin"


@pytest.mark.parametrize("bad", [
    dict(name="x", kind="median", target=1.0),
    dict(name="x", kind="quantile", target=1.0),
    dict(name="x", kind="quantile", target=1.0, metric="m", p="p42"),
    dict(name="x", kind="ratio", target=1.0),
    dict(name="x", kind="ratio", target=1.0, num={"metric": "a"}),
])
def test_validation_errors_match_jax(bad):
    with pytest.raises(ValueError) as j_err:
        jslo.SLOObjective(**bad)
    with pytest.raises(ValueError) as t_err:
        tslo.SLOObjective(**bad)
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("seed", [0, 3])
def test_evaluate_equal_jax_on_filled_registries(seed):
    t_snap, j_snap = _fill(treg.MetricsRegistry(), seed), _fill(jreg.MetricsRegistry(), seed)
    assert t_snap == j_snap
    t_spec, j_spec = tslo.spec_from_dict(SPEC), jslo.spec_from_dict(SPEC)
    rows = tslo.evaluate(t_spec, t_snap)
    assert rows == jslo.evaluate(j_spec, j_snap)
    assert len(rows) == 8 and any(r["no_data"] for r in rows)
    assert tslo.violations(rows) == jslo.violations(rows)
    assert tslo.format_results(t_spec, rows) == jslo.format_results(j_spec, rows)
    # the built-in objectives on the same snapshot (sweep ratios graded)
    assert tslo.evaluate(tslo.builtin_spec(), t_snap) == jslo.evaluate(jslo.builtin_spec(),
                                                                       j_snap)


def test_evaluate_reads_the_port_default_registry(monkeypatch):
    fresh = treg.MetricsRegistry()
    monkeypatch.setattr(treg, "default_registry", lambda: fresh)
    _fill(fresh, 1)
    rows = tslo.evaluate(tslo.spec_from_dict(SPEC))
    assert rows == jslo.evaluate(jslo.spec_from_dict(SPEC), _fill(jreg.MetricsRegistry(), 1))
