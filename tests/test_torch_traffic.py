"""The port's traffic generator (``serve/traffic.py``) held to the JAX
package's on the CPU.

* The traffic cases of tests/test_soak.py run on the port: deterministic
  streams, sorted and bounded arrivals for every process, the Poisson
  rate, bursts above the baseline, the diurnal ramp, the spec round trip
  and its errors, and the AR(1) parameter stream.
* ``generate`` is byte-identical to JAX's for ``poisson``, ``bursty`` and
  ``diurnal`` specs: every arrival time and every perturbed leaf equal
  bitwise, untouched leaves passed through by reference; base params
  holding tensors give the streams their numpy copies give.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu.serve import traffic as jtraffic  # noqa: E402

from dispatches_tpu_torch.serve import traffic  # noqa: E402
from test_torch_stacked import one_torch_thread  # noqa: E402,F401


def test_traffic_streams_are_deterministic():
    spec = traffic.TrafficSpec(rate_rps=100.0, duration_s=3.0, seed=3, perturb=("price",))
    base = {"p": {"price": np.linspace(1.0, 2.0, 4)}, "fixed": {}}
    a = traffic.generate(spec, base)
    b = traffic.generate(spec, base)
    assert len(a) == len(b) > 0
    for ra, rb in zip(a, b):
        assert ra.t == rb.t
        np.testing.assert_array_equal(ra.params["p"]["price"], rb.params["p"]["price"])


@pytest.mark.parametrize("process", traffic.PROCESSES)
def test_arrival_processes_are_sorted_and_bounded(process):
    spec = traffic.TrafficSpec(process=process, rate_rps=200.0, duration_s=10.0, seed=1,
                               dwell_off_s=1.0, dwell_on_s=0.5, period_s=10.0)
    ts = traffic.arrival_times(spec)
    assert len(ts) > 0
    assert np.all(np.diff(ts) >= 0)
    assert ts[0] >= 0.0 and ts[-1] < spec.duration_s


def test_poisson_rate_is_calibrated():
    spec = traffic.TrafficSpec(rate_rps=500.0, duration_s=20.0, seed=0)
    n = len(traffic.arrival_times(spec))
    assert 9_500 < n < 10_500  # mean 10,000, std ~100: +-5 sigma


def test_bursty_exceeds_baseline_count():
    base = traffic.TrafficSpec(rate_rps=50.0, duration_s=30.0, seed=2)
    burst = traffic.TrafficSpec(process="bursty", rate_rps=50.0, duration_s=30.0, seed=2,
                                burst_factor=8.0, dwell_off_s=4.0, dwell_on_s=2.0)
    assert len(traffic.arrival_times(burst)) > 1.3 * len(traffic.arrival_times(base))


def test_diurnal_density_follows_the_ramp():
    spec = traffic.TrafficSpec(process="diurnal", rate_rps=200.0, duration_s=100.0, seed=4,
                               period_s=100.0, amplitude=0.9)
    ts = traffic.arrival_times(spec)
    first = np.sum(ts < 50.0)
    assert first > 1.5 * (len(ts) - first)


def test_spec_round_trip_and_unknown_keys():
    spec = traffic.TrafficSpec(process="bursty", rate_rps=10.0, duration_s=5.0,
                               perturb=("price",), deadline_ms=100.0)
    assert traffic.spec_from_dict(spec.to_dict()) == spec
    # the spec dicts are the JAX package's: each reads the other's
    assert spec.to_dict() == jtraffic.TrafficSpec(**{
        **spec.to_dict(), "perturb": spec.perturb}).to_dict()
    assert jtraffic.spec_from_dict(spec.to_dict()).to_dict() == spec.to_dict()
    with pytest.raises(ValueError, match="unknown TrafficSpec keys"):
        traffic.spec_from_dict({"rate_hz": 10.0})
    with pytest.raises(ValueError, match="process"):
        traffic.TrafficSpec(process="steady")
    with pytest.raises(ValueError, match="rho"):
        traffic.TrafficSpec(rho=1.0)


def test_perturbed_params_ar1_stream():
    spec = traffic.TrafficSpec(rate_rps=1.0, duration_s=1.0, seed=7, perturb=("price",),
                               rho=0.95, sigma=0.1)
    base = {"p": {"price": np.full(8, 10.0), "other": np.ones(3)}, "fixed": {"cap": 1.0}}
    n = 4000
    stream = traffic.perturbed_params(spec, base, n)
    assert len(stream) == n
    assert stream[0]["p"]["other"] is base["p"]["other"]
    xs = np.array([s["p"]["price"][0] / 10.0 - 1.0 for s in stream])
    assert 0.05 < np.std(xs[: n // 2]) < 0.2
    assert np.corrcoef(xs[:-1], xs[1:])[0, 1] > 0.8
    with pytest.raises(KeyError, match="missing"):
        traffic.perturbed_params(traffic.TrafficSpec(perturb=("missing",)), base, 1)


_SPECS = {
    "poisson": dict(process="poisson", rate_rps=300.0, duration_s=4.0, seed=11),
    "bursty": dict(process="bursty", rate_rps=60.0, duration_s=8.0, seed=5, burst_factor=6.0,
                   dwell_off_s=1.5, dwell_on_s=0.7, deadline_ms=250.0),
    "diurnal": dict(process="diurnal", rate_rps=150.0, duration_s=12.0, seed=9,
                    period_s=6.0, amplitude=0.7),
}


@pytest.mark.parametrize("process", sorted(_SPECS))
def test_generate_is_byte_identical_to_jax(process):
    kw = dict(_SPECS[process], perturb=("price", "cf"), rho=0.8, sigma=0.07)
    rng = np.random.default_rng(1)
    base = {"p": {"price": 30.0 + 10.0 * rng.standard_normal(24),
                  "cf": rng.random((24,)), "other": np.ones(3)},
            "fixed": {"cap": np.array(25.0)}}
    want = jtraffic.generate(jtraffic.TrafficSpec(**kw), base)
    got = traffic.generate(traffic.TrafficSpec(**kw), base)
    # tensor leaves in the base give the streams of their numpy copies
    t_base = {"p": {k: torch.as_tensor(v) for k, v in base["p"].items()},
              "fixed": base["fixed"]}
    got_t = traffic.generate(traffic.TrafficSpec(**kw), t_base)
    assert len(got) == len(got_t) == len(want) > 50
    for g, gt, w in zip(got, got_t, want):
        assert np.float64(g.t).tobytes() == np.float64(w.t).tobytes() == np.float64(gt.t).tobytes()
        assert g.deadline_ms == w.deadline_ms == kw.get("deadline_ms")
        for key in ("price", "cf"):
            assert g.params["p"][key].tobytes() == w.params["p"][key].tobytes(), key
            assert gt.params["p"][key].tobytes() == w.params["p"][key].tobytes(), key
        assert g.params["p"]["other"] is base["p"]["other"]
        assert g.params["fixed"]["cap"] is base["fixed"]["cap"]
    assert traffic.arrival_times(traffic.TrafficSpec(**kw)).tobytes() == \
        jtraffic.arrival_times(jtraffic.TrafficSpec(**kw)).tobytes()
