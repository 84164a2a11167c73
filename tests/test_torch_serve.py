"""The port's SolveService held to the JAX package's on the CPU.

The same request streams go to both services (fake clocks, so the
policy and the latency telemetry are deterministic):

* the warm-start ladder on the battery-arbitrage LP (cold, exact,
  neighbour): per request equal status, objective (f64, rtol 1e-9),
  ``start_kind`` and iterations; equal ``metrics()`` and ``format_stats()``;
* the ``--stats`` golden (tests/data/serve_stats_golden.txt) byte for
  byte under tests/test_obs.py's recipe;
* the toy-solver policy cases of tests/test_serve.py (deadline timeout,
  max-wait flush on poll, backpressure oldest-first, ``solve_many``
  order, shedding, ``adaptive_wait``) with equal outcomes;
* an IPM bucket on the T = 12 LP (statuses equal, objectives within 1e-7,
  the x0 warm-start LRU alike);
* port only: the predictor rung (the head runs through
  ``ExecutionPlan.run_inline``) degrading one rung at a time, the
  predictor kill switch bitwise equal to retrieval only, poisoned-lane
  isolation, ``SolverFactory("serve", device="cpu")``, the CLI with
  ``--device cpu``, the device rule, the durability options accepted,
  and the export and flight flags arming the exporter and the
  recorder."""

import os
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dispatches_tpu.serve import ServeOptions as JServeOptions  # noqa: E402
from dispatches_tpu.serve import SolveService as JSolveService  # noqa: E402
from dispatches_tpu.serve.__main__ import _arbitrage_nlp as j_arbitrage_nlp  # noqa: E402

from dispatches_tpu_torch.analysis import assert_no_recompiles  # noqa: E402
from dispatches_tpu_torch.faults import inject as t_faults  # noqa: E402
from dispatches_tpu_torch.serve import (  # noqa: E402
    RequestStatus,
    ServeOptions,
    SolveService,
    set_default_service,
)
from dispatches_tpu_torch.serve import service as service_mod  # noqa: E402
from dispatches_tpu_torch.serve.__main__ import _arbitrage_nlp  # noqa: E402
from dispatches_tpu_torch.solvers import (  # noqa: E402
    IPMOptions,
    PDLPOptions,
    make_ipm_solver,
    make_pdlp_solver,
)
from test_torch_stacked import one_torch_thread  # noqa: E402,F401

CPU = "cpu"
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "serve_stats_golden.txt")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, seconds):
        self.t += seconds


def _pair_service(opts, clock_j=None, clock_t=None):
    return (JSolveService(JServeOptions(**opts), clock=clock_j or FakeClock()),
            SolveService(ServeOptions(**opts), clock=clock_t or FakeClock(), device=CPU))


@pytest.fixture(scope="module")
def nlps():
    return {T: (j_arbitrage_nlp(T), _arbitrage_nlp(T)) for T in (8, 12)}


def _prices(T, n, seed):
    rng = np.random.default_rng(seed)
    return [30.0 + 10.0 * rng.standard_normal(T) for _ in range(n)]


def _params(nlp, price):
    d = nlp.default_params()
    return {"p": {**d["p"], "price": price}, "fixed": d["fixed"]}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("WARMSTART", "WARMSTART_PREDICT", "PDLP_PRECISION", "PDLP_ALGO", "FAULTS",
                "SERVE_JOURNAL_DIR", "OBS_EXPORT_DIR", "OBS_FLIGHT_DIR", "OBS_PROFILE"):
        monkeypatch.delenv(f"DISPATCHES_TPU_{var}", raising=False)
    t_faults.reset()
    yield
    t_faults.reset()


def test_warm_ladder_stream_matches_jax(nlps):
    """Cold, then exact (identical round), then neighbour (0.1% drift)
    starts, max_batch 4 over 6 requests a round: the service's default
    float64 PDLP at tol 1e-8, warm starts and the predictor rung on."""
    jn, tn = nlps[8]
    jsvc, tsvc = _pair_service({"max_batch": 4, "max_wait_ms": 1e9})
    prices = _prices(8, 6, seed=3)
    rounds = [prices, prices, [p * 1.001 for p in prices]]
    got, want = [], []
    for plist in rounds:
        want += jsvc.solve_many(jn, [_params(jn, p) for p in plist], solver="pdlp")
        got += tsvc.solve_many(tn, [_params(tn, p) for p in plist], solver="pdlp")
    kinds = []
    for w, g in zip(want, got):
        assert g.status == w.status == RequestStatus.DONE
        assert g.obj == pytest.approx(w.obj, rel=1e-9)
        assert int(g.result.start_kind) == int(w.result.start_kind)
        assert int(g.result.iters) == int(w.result.iters)
        assert g.latency_ms == w.latency_ms
        kinds.append(int(g.result.start_kind))
    assert set(kinds) == {0, 1, 2}  # every rung below the predictor ran
    assert tsvc.metrics() == jsvc.metrics()
    assert tsvc.format_stats() == jsvc.format_stats()


def test_stats_golden_byte_identical():
    ticks = {"t": 0.0}

    def clock():
        ticks["t"] += 0.25e-3
        return ticks["t"]

    service = SolveService(ServeOptions(max_batch=4, max_wait_ms=1e9), clock=clock, device=CPU)
    nlp = _arbitrage_nlp(6)
    rng = np.random.default_rng(0)
    handles = [service.submit(nlp, _params(nlp, 30.0 + 10.0 * rng.standard_normal(6)),
                              solver="pdlp") for _ in range(6)]
    service.flush_all()
    assert all(h.result().status == "DONE" for h in handles)
    with open(GOLDEN, "rb") as f:
        assert (service.format_stats() + "\n").encode() == f.read()


# ---------------------------------------------------------------------------
# dispatch policy on toy solvers, both packages
# ---------------------------------------------------------------------------


class ToyResult(NamedTuple):
    obj: object
    x: object


def _j_toy(params, x0):
    return ToyResult(obj=jnp.sum(params["p"]["price"]), x=x0)


def _t_toy(params, x0):
    """The port's toy solver is lane-batched, as every serve program is."""
    return ToyResult(obj=params["p"]["price"].sum(-1), x=x0)


def _policy_case(case, svc, nlp8, nlp12, toy, clock):
    """Drive one policy case of tests/test_serve.py; returns what the
    two packages must agree on."""
    rng = np.random.default_rng(4)

    def sub(nlp, T, **kw):
        return svc.submit(nlp, _params(nlp, 30.0 + 10.0 * rng.standard_normal(T)),
                          solver="ipm", base_solver=toy, **kw)

    out = []
    if case == "deadline":
        doomed = sub(nlp8, 8, deadline_ms=5.0)
        live = [sub(nlp8, 8) for _ in range(2)]
        clock.advance(0.010)
        svc.flush_all()
        out = [h.result().status for h in [doomed] + live]
        out += [round(float(h.result().obj), 9) for h in live]
    elif case == "max_wait":
        hs = [sub(nlp8, 8) for _ in range(2)]
        out.append(svc.poll())
        clock.advance(0.006)
        out.append(svc.poll())
        out += [h.result().status for h in hs]
    elif case == "backpressure":
        oldest = sub(nlp8, 8)
        clock.advance(1e-3)
        newer = [sub(nlp12, 12) for _ in range(2)]
        clock.advance(1e-3)
        last = sub(nlp12, 12)
        out = [oldest.done(), last.done(), [h.done() for h in newer]]
    elif case == "solve_many":
        plist = [_params(nlp8, 30.0 + 10.0 * rng.standard_normal(8)) for _ in range(6)]
        rs = svc.solve_many(nlp8, plist, solver="ipm", base_solver=toy)
        out = [(r.status, round(float(r.obj), 9)) for r in rs]
    elif case == "shed":
        hs = [sub(nlp8, 8) for _ in range(4)]
        svc.shed_signal = lambda: True
        hs.append(sub(nlp8, 8))
        svc.shed_signal = None
        svc.flush_all()
        out = [h.result().status for h in hs]
    elif case == "adaptive_close_early":
        h = sub(nlp8, 8, deadline_ms=50.0)
        for _ in range(8):
            h._bucket.est.observe_ms(30.0)
        out = [svc._close_due_at(h._bucket, clock.t), svc.poll()]
        clock.advance(0.013)
        out += [svc.poll(), h.result().status]
    elif case == "adaptive_hold":
        sub(nlp8, 8)
        clock.advance(0.004)
        sub(nlp8, 8)
        clock.advance(0.008)
        out.append(svc.poll())
        clock.advance(0.029)
        out.append(svc.poll())
    m = svc.metrics()
    out.append({k: m[k] for k in ("submitted", "solved", "timeouts", "shed", "queue_depth",
                                  "batches", "flushes", "programs", "compile_count")})
    out.append({b: (d["lane_counts"], d["submitted"], d["timeouts"])
                for b, d in m["buckets"].items()})
    return out


_POLICY = {
    "deadline": {"max_batch": 8, "max_wait_ms": 1e9},
    "max_wait": {"max_batch": 8, "max_wait_ms": 5.0},
    "backpressure": {"max_batch": 8, "max_wait_ms": 1e9, "max_queue": 3},
    "solve_many": {"max_batch": 4, "max_wait_ms": 1e9},
    "shed": {"max_batch": 8, "max_wait_ms": 1e9, "shed_queue_depth": 3},
    "adaptive_close_early": {"max_batch": 8, "max_wait_ms": 1000.0, "adaptive_wait": True},
    "adaptive_hold": {"max_batch": 8, "max_wait_ms": 10.0, "adaptive_wait": True},
}


@pytest.mark.parametrize("case", sorted(_POLICY))
def test_policy_outcomes_equal_jax(case, nlps):
    opts = dict(_POLICY[case], warm_start=False)
    cj, ct = FakeClock(), FakeClock()
    jsvc, tsvc = _pair_service(opts, cj, ct)
    want = _policy_case(case, jsvc, nlps[8][0], nlps[12][0], _j_toy, cj)
    got = _policy_case(case, tsvc, nlps[8][1], nlps[12][1], _t_toy, ct)
    assert got == want


def test_ipm_bucket_matches_jax(nlps):
    """An IPM bucket (lane-batched ``make_ipm_solver``) on the T = 12 LP:
    statuses equal, objectives within 1e-7; the second round warm-starts
    from the x0 LRU in both packages."""
    jn, tn = nlps[12]
    jsvc, tsvc = _pair_service({"max_batch": 4, "max_wait_ms": 1e9})
    plist = _prices(12, 4, seed=6)
    opts = {"max_iter": 200}
    for _ in range(2):
        want = jsvc.solve_many(jn, [_params(jn, p) for p in plist], solver="ipm", options=opts)
        got = tsvc.solve_many(tn, [_params(tn, p) for p in plist], solver="ipm", options=opts)
        for w, g in zip(want, got):
            assert g.status == w.status == RequestStatus.DONE
            assert int(g.result.status) == int(w.result.status)
            assert g.obj == pytest.approx(w.obj, rel=1e-7, abs=1e-7)
    jm, tm = jsvc.metrics(), tsvc.metrics()
    assert tm["warm_start"] == jm["warm_start"]
    assert tm["buckets"]["ipm#0"]["lane_counts"] == jm["buckets"]["ipm#0"]["lane_counts"] == [4]
    assert tm["compile_count"] == jm["compile_count"] == 1


# ---------------------------------------------------------------------------
# port-only contracts
# ---------------------------------------------------------------------------


def test_steady_state_compile_count_and_no_recompiles(nlps):
    """tests/test_serve.py's steady-state acceptance on the port: two
    waves of (8 PDLP at T = 8, 8 IPM at T = 12) a round fill one 16-lane
    program per bucket; the PDLP objectives equal a direct lane-axis
    solve's within 1e-6; the compile count equals the programs (2), and
    an identical second round builds nothing."""
    clock = FakeClock()
    svc = SolveService(ServeOptions(max_batch=16, max_wait_ms=1e9, warm_start=False),
                       clock=clock, device=CPU)
    nlp8, nlp12 = nlps[8][1], nlps[12][1]
    prices8, prices12 = _prices(8, 16, seed=11), _prices(12, 16, seed=12)
    reqs = []
    for w in range(2):
        reqs += [("pdlp", nlp8, _params(nlp8, p)) for p in prices8[8 * w:8 * w + 8]]
        reqs += [("ipm", nlp12, _params(nlp12, p)) for p in prices12[8 * w:8 * w + 8]]

    def run_round():
        handles = []
        for kind, nlp, params in reqs:
            clock.advance(1e-4)
            handles.append(svc.submit(nlp, params, solver=kind, options=(
                {"tol": 1e-9} if kind == "pdlp" else {"max_iter": 200})))
        svc.flush_all()
        return [h.result() for h in handles]

    round1 = run_round()
    assert all(r.status == RequestStatus.DONE for r in round1)
    # the direct solves with the buckets' options, all lanes at once
    direct = {
        "pdlp": make_pdlp_solver(nlp8, PDLPOptions(tol=1e-9, dtype="float64"), device=CPU)(
            _params(nlp8, np.stack(prices8))),
        "ipm": make_ipm_solver(nlp12, IPMOptions(max_iter=200), device=CPU)(
            _params(nlp12, np.stack(prices12)))}
    for kind in ("pdlp", "ipm"):
        got = [r.obj for (k, _, _), r in zip(reqs, round1) if k == kind]
        assert got == pytest.approx([float(v) for v in direct[kind].obj], abs=1e-6), kind
    m = svc.metrics()
    assert m["buckets"]["pdlp#0"]["lane_counts"] == [16]
    assert m["buckets"]["ipm#1"]["lane_counts"] == [16]
    assert m["programs"] == m["compile_count"] == 2
    assert m["solved"] == 32 and m["timeouts"] == 0
    with assert_no_recompiles():
        round2 = run_round()
    assert all(r.status == RequestStatus.DONE for r in round2)
    m2 = svc.metrics()
    assert m2["compile_count"] == 2 and m2["solved"] == 64
    assert m2["occupancy_mean"] == pytest.approx(1.0)


def test_predictor_ladder_degrades_one_rung_at_a_time(nlps):
    from dispatches_tpu_torch.interop import predictor_from_numpy
    from dispatches_tpu_torch.learn import fit

    _, tn = nlps[8]
    svc = SolveService(ServeOptions(max_batch=1, max_wait_ms=1e9, degrade_mispredicts=2),
                       clock=FakeClock(), device=CPU)
    p0 = _params(tn, _prices(8, 1, seed=11)[0])
    opts = {"tol": 1e-7, "dtype": "float64"}
    assert int(svc.solve(tn, p0, solver="pdlp", options=opts).start_kind) == 0
    bucket = next(iter(svc._buckets.values()))
    trainer = bucket.predict_trainer
    assert trainer is not None and not trainer.ready()
    vecs, xs, zs = bucket.warm_index.export_pairs()
    pred = fit(np.stack(vecs).astype(np.float32), np.stack(xs), np.stack(zs),
               hidden=4, epochs=10, device=CPU)
    trainer.adopt(pred, trained_samples=len(vecs))
    bucket.predict_weights = predictor_from_numpy(pred.params, CPU)
    bucket.warm_guard.cold_iters_ema = 0.5  # every warm start mispredicts
    kinds = []
    for i in range(5):
        p = _params(tn, p0["p"]["price"] * (1.0 + 1e-3 * (i + 1)))
        r = svc.solve(tn, p, solver="pdlp", options=opts)
        assert np.isfinite(float(r.obj))
        kinds.append(int(r.start_kind))
    assert kinds == [3, 3, 2, 2, 0]  # predictor, k-NN, cold
    assert bucket.predict_fallback and bucket.warm_fallback
    ws = svc.metrics()["warm_start"]
    assert ws["predicted"] == 2 and ws["neighbor_hits"] == 2
    assert bucket.predict_program.compiles == 1  # the head: one signature


def test_predict_kill_switch_bitwise_retrieval_only(nlps, monkeypatch):
    _, tn = nlps[8]

    def _run():
        svc = SolveService(ServeOptions(max_batch=4, max_wait_ms=1e9), clock=FakeClock(),
                           device=CPU)
        plist = [_params(tn, p) for p in _prices(8, 4, seed=13)]
        opts = {"tol": 1e-7, "dtype": "float64"}
        out = list(svc.solve_many(tn, plist, solver="pdlp", options=opts))
        out += svc.solve_many(tn, plist, solver="pdlp", options=opts)
        plist3 = [_params(tn, p["p"]["price"] * 1.001) for p in plist]
        out += svc.solve_many(tn, plist3, solver="pdlp", options=opts)
        return out, svc.metrics()["warm_start"]

    r_on, ws_on = _run()

    def _boom(*a, **k):
        raise AssertionError("predictor machinery touched with WARMSTART_PREDICT=0")

    monkeypatch.setenv("DISPATCHES_TPU_WARMSTART_PREDICT", "0")
    monkeypatch.setattr(service_mod.learn_train, "OnlineTrainer", _boom)
    monkeypatch.setattr(service_mod, "_predict_head_fn", _boom)
    r_off, ws_off = _run()
    for a, b in zip(r_on, r_off):
        for f in ("x", "z", "iters", "start_kind"):
            assert torch.equal(getattr(a.result, f), getattr(b.result, f)), f
        assert a.obj == b.obj
    assert ws_on["predicted"] == ws_off["predicted"] == 0
    assert ws_off["hits"] == 4 and ws_off["neighbor_hits"] == 4


def test_poisoned_lane_fails_alone_bitwise_batchmates(nlps):
    _, tn = nlps[8]
    plist = [_params(tn, p) for p in _prices(8, 4, seed=14)]

    def run(scenario):
        svc = SolveService(ServeOptions(max_batch=4, max_wait_ms=1e9, warm_start=False),
                           clock=FakeClock(), device=CPU)
        t_faults.arm(scenario)
        try:
            return svc.solve_many(tn, plist, solver="pdlp") if scenario is None else \
                [h.result() for h in [svc.submit(tn, p, solver="pdlp") for p in plist]]
        finally:
            t_faults.reset()

    clean = run(None)
    faulted = run("solver,poison_ids=3")
    assert [r.status for r in faulted] == ["DONE", "DONE", "ERROR", "DONE"]
    for c, f in zip(clean, faulted):
        if f.status == "DONE":
            assert f.obj == c.obj  # bisection re-solves innocents bitwise


def test_solver_factory_serve_entry(nlps):
    from dispatches_tpu_torch.solvers import SolverFactory

    _, tn = nlps[8]
    prev = set_default_service(None)
    try:
        factory = SolverFactory("serve", solver="pdlp", device=CPU, tol=1e-9)
        params = _params(tn, _prices(8, 1, seed=7)[0])
        res = factory.solve(tn, params, tee=True)
        direct = make_pdlp_solver(tn, PDLPOptions(tol=1e-9, dtype="float64"), device=CPU)
        assert float(res.obj) == pytest.approx(float(direct(params).obj), abs=1e-6)
        assert factory.service.metrics()["submitted"] == 1
        assert factory.service.plan.device == torch.device("cpu")
        with pytest.raises(ValueError, match="default service runs on cpu"):
            SolverFactory("serve", device="meta")
    finally:
        set_default_service(prev)


def test_cli_stats_on_cpu(capsys):
    from dispatches_tpu_torch.serve.__main__ import main

    assert main(["--stats", "--device", "cpu", "--n", "2", "--max-batch", "2",
                 "--horizons", "8"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("== dispatches_tpu.serve stats ==")
    assert "requests: 2 submitted / 2 solved" in out and "compiled programs" in out


def test_device_rule_and_deferred_options_raise(monkeypatch, tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SolveService()
    # the durability options are ported (tests/test_torch_durability.py)
    for kw in ({"journal_dir": str(tmp_path / "j")}, {"recover_dir": str(tmp_path / "r")},
               {"snapshot_interval_s": 1.0}):
        svc = SolveService(device=CPU, **kw)
        assert svc.metrics()["durability"]["journaled"] == ("snapshot_interval_s" not in kw)
    monkeypatch.setenv("DISPATCHES_TPU_SERVE_JOURNAL_DIR", str(tmp_path / "env"))
    assert SolveService(device=CPU).metrics()["durability"]["journaled"]
    monkeypatch.delenv("DISPATCHES_TPU_SERVE_JOURNAL_DIR")
    # ServeOptions.mesh goes to the plan
    from dispatches_tpu_torch.obs import profile, trace
    from dispatches_tpu_torch.parallel import scenario_mesh

    meshed = SolveService(ServeOptions(mesh=scenario_mesh(2, device=CPU)), device=CPU)
    assert meshed.plan.mesh.shape == {"scenario": 2}
    # the export and flight flags arm the exporter and the recorder
    from dispatches_tpu_torch.obs import export as obs_export
    from dispatches_tpu_torch.obs import flight as obs_flight

    assert SolveService(device=CPU)._exporter is None and not obs_flight.enabled()
    monkeypatch.setenv("DISPATCHES_TPU_OBS_EXPORT_DIR", str(tmp_path / "export"))
    assert isinstance(SolveService(device=CPU)._exporter, obs_export.ContinuousExporter)
    monkeypatch.delenv("DISPATCHES_TPU_OBS_EXPORT_DIR")
    monkeypatch.setenv("DISPATCHES_TPU_OBS_FLIGHT_DIR", str(tmp_path / "flight"))
    svc = SolveService(device=CPU)
    assert obs_flight.enabled() and svc._exporter is None
    monkeypatch.delenv("DISPATCHES_TPU_OBS_FLIGHT_DIR")
    # cost cards are ported: the flag no longer stops the service (the
    # flag is read once per process, so its resolution is restored after)
    monkeypatch.setattr(profile, "_ENABLED", None)
    monkeypatch.setattr(trace, "_SPAN_HOOK", None)
    monkeypatch.setenv("DISPATCHES_TPU_OBS_PROFILE", "1")
    assert SolveService(device=CPU).plan.device == torch.device("cpu")
    assert profile.enabled()
    monkeypatch.delenv("DISPATCHES_TPU_OBS_PROFILE")
    svc = SolveService(device=CPU)
    assert svc.plan.device == torch.device("cpu")
    assert svc.metrics()["durability"] == {"journaled": False, "snapshot_writes": 0,
                                           "generation": 1, "recovery": None}


def test_concurrent_first_submits_build_buckets_one_at_a_time():
    """Six threads submit the first requests of one bucket at once (a net
    worker's RPC threads do this): building a bucket differentiates the
    model with ``torch.func.jacfwd``, whose forward-AD levels are
    process-wide in torch, so unserialized builds raised "Trying to create
    a dual Tensor for forward AD but no level exists".  Every submit now
    lands, in one bucket, and every request solves."""
    import sys
    import threading

    for _ in range(3):
        nlp = _arbitrage_nlp(12)
        svc = SolveService(ServeOptions(max_batch=64, max_wait_ms=1e9), device=CPU)
        barrier = threading.Barrier(6)
        handles, errors = [], []

        def submit(k):
            barrier.wait()
            try:
                d = nlp.default_params()
                handles.append(svc.submit(nlp, {"p": {**d["p"], "price": np.full(12, 30.0 + k)},
                                                "fixed": d["fixed"]}))
            except Exception as exc:
                errors.append(exc)

        threads = [threading.Thread(target=submit, args=(k,)) for k in range(6)]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)  # switch threads often: races show
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        assert errors == [] and len(handles) == 6
        assert len(svc._buckets) == 1
        svc.flush_all()
        assert [h.result().status for h in handles] == ["DONE"] * 6
