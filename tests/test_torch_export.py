"""The PyTorch port's continuous export (``dispatches_tpu_torch.obs.export``)
held to the JAX package's ``obs.export``:

- ``render_prometheus`` byte-equal between the packages on registries
  filled with the same seeded observations, label escaping and name
  sanitizing included, and equal to the JAX package's golden file;
  ``render_prometheus_snapshots`` byte-equal on per-process snapshots;
- ``ContinuousExporter`` on the same ``FakeClock`` ticks: the same JSONL
  records byte for byte, the same rotation, and the same ``metrics.prom``
  apart from process identity (the start-stamp value of
  ``dispatches_tpu_process_start_us``); the restart generation label;
  ``ExportOptions.from_env``;
- ``SolveService`` arming: with ``DISPATCHES_TPU_OBS_EXPORT_DIR`` set a
  service on a fake clock writes a parseable ``metrics.prom`` and two
  interval records; disarmed it never reaches the exporter module.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu.obs import export as jexp  # noqa: E402
from dispatches_tpu.obs import registry as jreg  # noqa: E402
from dispatches_tpu.obs.soak import FakeClock as JFakeClock  # noqa: E402

from dispatches_tpu_torch.obs import export as texp  # noqa: E402
from dispatches_tpu_torch.obs import registry as treg  # noqa: E402
from dispatches_tpu_torch.obs.soak import FakeClock, StubNLP, make_stub_solver  # noqa: E402
from dispatches_tpu_torch.serve import ServeOptions, SolveService  # noqa: E402
from torch_isolation import isolated_obs_state  # noqa: E402,F401
from torch_threads import one_torch_thread  # noqa: E402,F401

PROM_GOLDEN = os.path.join(os.path.dirname(__file__), "data", "prometheus_golden.prom")


def _sample(reg):
    """tests/test_timeline_export.py's golden registry."""
    c = reg.counter("serve.requests", "request events")
    c.inc(3, event="ok")
    c.inc(1, event="err")
    reg.gauge("plan.inflight", "in-flight batches").set(2)
    h = reg.histogram("serve.latency_ms", "per-request latency", window=8)
    for v in (1.0, 2.0, 3.0, 4.0):
        h.observe(v, bucket="pdlp#0")
    return reg


def _seeded(reg, seed):
    rng = np.random.default_rng(seed)
    for b in ("pdlp#0", "pdlp#1.f32", 'odd"b\\x\ny'):
        for v in rng.lognormal(2.0, 0.7, 300):
            reg.histogram("serve.latency_ms", "latency\nms").observe(float(v), bucket=b)
        reg.counter("serve.requests").inc(int(rng.integers(1, 50)), event="submitted", bucket=b)
    reg.gauge("odd.name-x", "help with\nnewline and \\ slash").set(
        float(rng.normal()), path='a\\b"c\nd')
    reg.gauge("plan.inflight").set(3)
    reg.counter("flight.errors").inc(0)
    return reg


def test_api_matches_jax():
    assert texp.__all__ == jexp.__all__
    assert (texp.SCHEMA_VERSION, texp.PROM_FILE) == (jexp.SCHEMA_VERSION, jexp.PROM_FILE)
    assert texp.ExportOptions() == texp.ExportOptions(**jexp.ExportOptions().__dict__)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_prometheus_byte_equal_jax(seed):
    t_text = texp.render_prometheus(_seeded(treg.MetricsRegistry(), seed))
    assert t_text == jexp.render_prometheus(_seeded(jreg.MetricsRegistry(), seed))
    assert t_text == texp.render_prometheus(_seeded(treg.MetricsRegistry(), seed))
    golden = texp.render_prometheus(_sample(treg.MetricsRegistry()))
    with open(PROM_GOLDEN, "rb") as f:
        assert golden.encode() == f.read()
    assert texp.render_prometheus(treg.MetricsRegistry()) == ""


def test_render_snapshots_byte_equal_jax():
    per = {"worker-1": _seeded(treg.MetricsRegistry(), 3).snapshot(),
           "router": _sample(treg.MetricsRegistry()).snapshot(), "dead": None}
    text = texp.render_prometheus_snapshots(per)
    assert text == jexp.render_prometheus_snapshots(per) and 'process="worker-1"' in text


def _drive(exp_mod, reg_mod, clock, tmp, **opts):
    reg = reg_mod.MetricsRegistry()
    exp = exp_mod.ContinuousExporter(exp_mod.ExportOptions(directory=str(tmp), **opts),
                                     clock=clock, registry=reg)
    rng = np.random.default_rng(9)
    written = []
    for step in range(9):
        reg.counter("ticks").inc(int(rng.integers(1, 5)))
        reg.gauge("depth").set(float(rng.integers(0, 9)), bucket="b#0")
        reg.histogram("lat").observe(float(rng.lognormal()), bucket="b#0")
        written.append(exp.maybe_export())
        clock.advance(float(rng.choice([1.0, 4.0, 6.0])))
    exp.export()
    return written


def test_exporter_records_equal_jax_on_fake_clock_ticks(tmp_path):
    for opts in ({"interval_s": 5.0}, {"interval_s": 1.0, "max_records": 2, "max_files": 2}):
        t_dir, j_dir = tmp_path / "t", tmp_path / "j"
        t_w = _drive(texp, treg, FakeClock(), t_dir, **opts)
        j_w = _drive(jexp, jreg, JFakeClock(), j_dir, **opts)
        assert [p and os.path.basename(p) for p in t_w] == \
            [p and os.path.basename(p) for p in j_w]
        names = sorted(os.listdir(t_dir))
        assert names == sorted(os.listdir(j_dir))
        for n in names:
            t_b, j_b = (t_dir / n).read_bytes(), (j_dir / n).read_bytes()
            if n == texp.PROM_FILE:
                # the process start stamp differs between the two
                # exporters' modules, nothing else
                t_b, j_b = (b.rsplit(b" ", 1)[0] for b in (t_b, j_b))
            assert t_b == j_b, n
        for d in (t_dir, j_dir):
            for n in names:
                os.remove(d / n)


def test_restart_generation_and_options_from_env(tmp_path, monkeypatch):
    prev = texp.set_restart_generation(7)
    try:
        exp = texp.ContinuousExporter(texp.ExportOptions(directory=str(tmp_path)),
                                      clock=FakeClock())
        exp.export()
        text = (tmp_path / texp.PROM_FILE).read_text()
        assert f'dispatches_tpu_process_start_us{{generation="7"}} ' \
               f'{texp._fmt(texp.process_start_us())}\n' in text
    finally:
        texp.set_restart_generation(prev)
    with pytest.raises(ValueError):
        texp.ContinuousExporter(texp.ExportOptions())
    monkeypatch.setenv("DISPATCHES_TPU_OBS_EXPORT_DIR", str(tmp_path))
    monkeypatch.setenv("DISPATCHES_TPU_OBS_EXPORT_INTERVAL_S", "2.5")
    monkeypatch.setenv("DISPATCHES_TPU_OBS_EXPORT_MAX_FILES", "3")
    monkeypatch.setenv("DISPATCHES_TPU_OBS_EXPORT_MAX_RECORDS", "17")
    assert texp.ExportOptions.from_env() == texp.ExportOptions(
        **jexp.ExportOptions.from_env().__dict__)
    assert texp.enabled()
    monkeypatch.delenv("DISPATCHES_TPU_OBS_EXPORT_DIR")
    assert not texp.enabled()


def test_armed_service_writes_prom_and_two_records(monkeypatch, tmp_path):
    monkeypatch.setenv("DISPATCHES_TPU_OBS_EXPORT_DIR", str(tmp_path))
    monkeypatch.setenv("DISPATCHES_TPU_OBS_EXPORT_INTERVAL_S", "5")
    clock = FakeClock()
    service = SolveService(ServeOptions(max_batch=2, max_wait_ms=1e9), clock=clock,
                           device="cpu")
    assert service._exporter is not None
    nlp, solver = StubNLP(), make_stub_solver()
    hs = [service.submit(nlp, solver="pdlp", base_solver=solver) for _ in range(2)]
    assert all(h.result().status == "DONE" for h in hs)
    clock.advance(5.0)
    service.poll()
    jsonl = [n for n in os.listdir(tmp_path) if n.endswith(".jsonl")]
    assert len(jsonl) == 1
    recs = [json.loads(line) for line in open(tmp_path / jsonl[0])]
    assert len(recs) >= 2 and recs[0]["schema"] == texp.SCHEMA_VERSION
    assert recs[1]["t"] == 5.0
    prom = (tmp_path / texp.PROM_FILE).read_text()
    assert "# TYPE dispatches_tpu_serve_requests counter" in prom
    for line in prom.splitlines():
        if line.startswith("#"):
            continue
        name_part, value = line.rsplit(" ", 1)
        float(value)
        assert name_part.startswith("dispatches_tpu_")


def test_disarmed_service_never_reaches_the_exporter(monkeypatch):
    monkeypatch.delenv("DISPATCHES_TPU_OBS_EXPORT_DIR", raising=False)
    monkeypatch.setattr(texp, "ContinuousExporter",
                        lambda *a, **k: (_ for _ in ()).throw(AssertionError("armed")))
    service = SolveService(ServeOptions(max_batch=2, max_wait_ms=1e9), device="cpu")
    assert service._exporter is None
    service.submit(StubNLP(), solver="pdlp", base_solver=make_stub_solver())
    service.flush_all()
    service.poll()
