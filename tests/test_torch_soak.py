"""The PyTorch port's soak harness (``dispatches_tpu_torch.obs.soak``) held to
the JAX package's ``obs.soak`` on the CPU.

The virtual soak runs on a ``FakeClock`` with numpy generators and the
service-time model, so every report field that is a function of virtual
time and the seed must equal the JAX package's report on the same spec:
request counts, the streaming and post-hoc latency and queue-wait
quantiles, SLO monitor states, alerts and burn peaks, drift results, the
service's metrics (batches, lane counts, warm starts, compile counts),
the fault and restart blocks and the headline numbers.  Floats are held
to 1e-12 relative, everything else is equal.  The specs: the default
spec (~1.2k requests), the spike spec of ``tests/test_soak.py`` with the
recorder armed (one coalesced ``burn_rate`` bundle), its chaos-window spec
and the crash-restart spec of ``tests/test_durability.py``.

Exempt, because they are wall-clock or file-system facts of one run, not
functions of virtual time: ``timeline``'s times (the plan spans carry the
tracer's wall-clock stamps; its key set and ``n_batches`` are compared),
the rebuild's ``restart_recovery_ms`` / ``recovery_ms``, the bundle
paths (their names carry ``time_ns``; their count and kinds are
compared) and ``report_path`` (each side writes under its own
``out_dir``).

JAX's four reports (with those fields taken out) are recorded in
``tests/data/soak_reports_jax.json`` (``tests/torch_records.py``), which
``test_soak_jax_record_is_current`` (slow) holds to a fresh JAX run
bitwise; tier 1 holds the port's reports to the record.

The fleet section (``enabled`` true, or ``n_replicas`` > 1) replays a
short spec equal to JAX's in every virtual-time field, and raises JAX's
``ValueError`` on the real clock and beside the restart section; the
chaos-kill spec of ``tests/test_fleet.py`` is held in
``tests/test_torch_fleet.py``.
"""

import json
import os
import tempfile

import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu.faults import inject as jfaults  # noqa: E402
from dispatches_tpu.obs import flight as jfl  # noqa: E402
from dispatches_tpu.obs import soak as jsoak  # noqa: E402
from dispatches_tpu.obs import trace as jtrace  # noqa: E402

from dispatches_tpu_torch.faults import inject as tfaults  # noqa: E402
from dispatches_tpu_torch.obs import flight as tfl  # noqa: E402
from dispatches_tpu_torch.obs import soak as tsoak  # noqa: E402
from dispatches_tpu_torch.obs import trace as ttrace  # noqa: E402
import torch_records  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

RTOL = 1e-12
SPIKE = {"traffic": {"duration_s": 6.0, "rate_rps": 150.0},
         "service_time": {"spikes": [[2.0, 6.0, 100.0]]}}
CHAOS = {"traffic": {"duration_s": 2.0, "rate_rps": 150.0},
         "faults": {"scenario": ("plan.fence,p=0.25,times=6,seed=7;"
                                 "plan.fence,poison_mod=37"),
                    "start_s": 0.25, "stop_s": 1.75}}
RESTART = {"traffic": {"duration_s": 1.0, "rate_rps": 60.0, "seed": 23},
           "restart": {"enabled": True, "crash_at_s": 0.5, "snapshot_interval_s": 0.25}}
#: name -> (spec, run_soak keywords for a scratch directory)
CASES = {"default": (None, lambda d: {}),
         "spike": (SPIKE, lambda d: {"flight_dir": os.path.join(d, "flight")}),
         "chaos": (CHAOS, lambda d: {}),
         "restart": (RESTART, lambda d: {"out_dir": os.path.join(d, "out")})}
#: wall-clock and file-system fields, by path from the report root
EXEMPT = (("restart", "restart_recovery_ms"), ("restart_recovery_ms",),
          ("service", "durability", "recovery", "recovery_ms"),
          ("slo", "bundle_paths"), ("report_path",))
SOAK_RECORD = "soak_reports_jax"


def _virtual_fields(report):
    """The report as its JSON file holds it, without the exempt fields; the
    timeline reduced to its keys and batch count."""
    out = json.loads(json.dumps(report, default=str))
    for path in EXEMPT:
        node = out
        for k in path[:-1]:
            node = node.get(k) if isinstance(node, dict) else None
        if isinstance(node, dict):
            node.pop(path[-1], None)
    tl = out["timeline"]
    out["timeline"] = None if tl is None else {"keys": sorted(tl), "n_batches": tl["n_batches"]}
    return out


def _reset():
    for mod in (tfl, jfl, tfaults, jfaults):
        mod.reset()
    for tr in (ttrace, jtrace):
        tr.enable(False)
        tr.reset()


def jax_record():
    """JAX's reports on the four specs, virtual-time fields only."""
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for name, (spec, kw) in CASES.items():
            _reset()
            out[name] = _virtual_fields(jsoak.run_soak(json.loads(json.dumps(spec)), **kw(d)))
    _reset()
    return out


@pytest.fixture(autouse=True)
def _clean():
    _reset()
    yield
    _reset()


def _equal(got, want, path=()):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _equal(got[k], want[k], path + (k,))
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, path + (i,))
    elif isinstance(want, float):
        assert isinstance(got, float), path
        assert got == pytest.approx(want, rel=RTOL, abs=0.0), path
    else:
        assert got == want and type(got) is type(want), path


def _port(name, tmp_path):
    spec, kw = CASES[name]
    report = tsoak.run_soak(json.loads(json.dumps(spec)), device="cpu", **kw(str(tmp_path)))
    _equal(_virtual_fields(report), torch_records.read(SOAK_RECORD)[name])
    return report


@pytest.mark.slow
def test_soak_jax_record_is_current():
    assert torch_records.matches(SOAK_RECORD, jax_record())


def test_constants_match_jax():
    assert tsoak.SOAK_SCHEMA == jsoak.SOAK_SCHEMA == 1
    assert tsoak.DEFAULT_SPEC == jsoak.DEFAULT_SPEC
    assert tsoak.__all__ == jsoak.__all__
    assert tsoak.load_soak_spec(overrides=CHAOS) == jsoak.load_soak_spec(overrides=CHAOS)
    with pytest.raises(ValueError, match="unknown soak spec sections"):
        tsoak.run_soak({"trafic": {}}, device="cpu")


def test_default_spec_equals_jax(tmp_path):
    t = _port("default", tmp_path)
    c = t["requests"]
    assert c["scheduled"] >= 1000 and c["submitted"] == c["done"] == c["scheduled"]
    assert t["slo"]["alerts_total"] == 0 and 0.0 < t["slo_burn_max"] < 1.0
    assert t["latency_ms"]["streaming"]["p99"] == pytest.approx(
        t["latency_ms"]["posthoc"]["p99"], rel=0.10)


def test_spike_spec_equals_jax_with_one_coalesced_bundle(tmp_path):
    t = _port("spike", tmp_path)
    assert t["slo_burn_max"] > 1.2 and t["slo"]["flight_bundles"] == 1
    assert [b["kind"] for b in tfl.bundles(str(tmp_path / "flight"))] == ["burn_rate"]
    b = tfl.load_bundle(t["slo"]["bundle_paths"][0])
    assert b["trigger"]["label"].startswith("soak_")
    assert b["trigger"]["detail"]["burn_fast"] > b["trigger"]["detail"]["threshold"]
    assert b["plan"]["timeline_tail"]  # the soak traces the plan lifecycle


def test_chaos_spec_equals_jax(tmp_path):
    t = _port("chaos", tmp_path)
    c, fl = t["requests"], t["faults"]
    assert c["hung"] == 0 and c["error"] > 0
    assert fl["armed"] is True and fl["recovered"] == fl["injected"] > 0
    assert t["fault_recovery_rate"] == 1.0 and not tfaults.armed()


def test_restart_spec_equals_jax(tmp_path):
    t = _port("restart", tmp_path)
    rs = t["restart"]
    assert t["requests"]["hung"] == 0 and rs["lost"] == 0 and t["lost_request_rate"] == 0.0
    assert rs["recovered"] == rs["open_at_crash"] > 0 and rs["generation"] == 2
    assert t["restart_recovery_ms"] > 0.0
    on_disk = json.loads((tmp_path / "out" / "soak_report.json").read_text())
    assert set(on_disk) == set(t) - {"report_path"}
    assert os.path.exists(tmp_path / "out" / "metrics.prom")
    assert not ttrace._SINKS


@pytest.mark.parametrize("fleet", [{"enabled": True}, {"n_replicas": 3}])
def test_fleet_section_raises(fleet):
    """The armed section: a short replay through the router equals JAX's
    in every virtual-time field; it raises JAX's ``ValueError`` on the
    real clock and beside the restart section."""
    spec = {"traffic": {"duration_s": 0.5}, "fleet": fleet}
    t = tsoak.run_soak(json.loads(json.dumps(spec)), device="cpu")
    _reset()
    j = jsoak.run_soak(json.loads(json.dumps(spec)))
    _equal(_virtual_fields(t), _virtual_fields(j))
    ft = t["fleet"]
    assert ft["enabled"] and ft["n_replicas"] == fleet.get("n_replicas", 1)
    assert ft["alive"] == ft["n_replicas"] and ft["failovers"] == 0
    assert t["requests"]["hung"] == 0 and t["replica_lost_request_rate"] == 0.0
    assert t["requests"]["done"] == t["requests"]["submitted"] > 0
    with pytest.raises(ValueError, match="virtual"):
        tsoak.run_soak(json.loads(json.dumps(spec)), virtual=False, device="cpu")
    with pytest.raises(ValueError, match="mutually"):
        tsoak.run_soak({**spec, "restart": {"enabled": True, "crash_at_s": 0.05}},
                       device="cpu")


def test_stub_solver_iters_match_jax_stub():
    import jax.numpy as jnp
    import numpy as np

    price = np.random.default_rng(4).uniform(1.0, 2.0, (5, 8))
    got = tsoak.make_stub_solver()({"p": {"price": torch.as_tensor(price)}, "fixed": {}})
    j = jsoak.make_stub_solver()
    want = [j({"p": {"price": jnp.asarray(p)}, "fixed": {}}) for p in price]
    assert got.iters.dtype == torch.float32
    np.testing.assert_array_equal(got.iters.numpy(), [np.asarray(w.iters) for w in want])
    # the objective is a sum of 8 prices, whose order differs by a last bit
    np.testing.assert_allclose(got.obj.numpy(), [float(w.obj) for w in want], rtol=1e-15)
    kind = np.array([0, 1, 2, 0, 3], np.int32)
    x0, z0 = np.zeros((5, 8)), np.zeros((5, 1))
    gw = tsoak.make_stub_solver(warm=True)(
        {"p": {"price": torch.as_tensor(price)}, "fixed": {}},
        (torch.as_tensor(x0), torch.as_tensor(z0), torch.as_tensor(kind)))
    jw = jsoak.make_stub_solver(warm=True)
    for i in range(5):
        w = jw({"p": {"price": jnp.asarray(price[i])}, "fixed": {}},
               (jnp.asarray(x0[i]), jnp.asarray(z0[i]), jnp.asarray(kind[i])))
        for f in ("x", "z", "iters", "start_kind"):
            np.testing.assert_allclose(getattr(gw, f)[i].numpy(), np.asarray(getattr(w, f)),
                                       rtol=1e-15 if f == "z" else 0.0)
