"""The PyTorch port's sweep engine (``dispatches_tpu_torch.sweep``) held to
the JAX package on the CPU, on the T = 6 storage LP of
tests/test_sweep.py built in both packages.

- specs: grid and LHS specs have the JAX package's points, inputs and
  fingerprints;
- the direct backend: per-point iterations equal to JAX's direct sweep
  and objectives within 1e-9 relative (the lane-axis PDLP parity);
- the store format: the JAX ``ResultStore`` opens the port's store (its
  manifest is byte-equal) and a store the JAX engine started is resumed
  by the port;
- the cases of tests/test_sweep.py on the port: bitwise resume, partial
  runs, warm sweeps, quarantine, refine-failed, the refusals, the env
  options, the chunk timer, direct against serve, ``--report`` and the
  surrogate handoff;
- the guards: the mesh backend (item 7) and the observability flags
  (item 12) raise, and the default device is the card.

One JAX store and one port store of the canonical 12-point spec are
built once for the module.
"""

import hashlib
import json
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dispatches_tpu import Flowsheet as JFlowsheet  # noqa: E402
from dispatches_tpu import sweep as jsw  # noqa: E402
from dispatches_tpu.core.graph import tshift as j_tshift  # noqa: E402

from dispatches_tpu_torch import sweep as tsw  # noqa: E402
from dispatches_tpu_torch.core.graph import Flowsheet as TFlowsheet  # noqa: E402
from dispatches_tpu_torch.core.graph import tshift as t_tshift  # noqa: E402
from dispatches_tpu_torch.sweep import engine as engine_mod  # noqa: E402
from test_torch_stacked import one_torch_thread  # noqa: E402,F401

T = 6
_PDLP = {"tol": 1e-7, "dtype": "float64"}
CPU = "cpu"
OBJ_RTOL = 1e-9


def _storage_nlp(Flowsheet, tshift, xp):
    fs = Flowsheet(horizon=T)
    fs.add_var("charge", lb=0, ub=1)
    fs.add_var("discharge", lb=0, ub=1)
    fs.add_var("soc", lb=0, ub=3)
    fs.add_var("soc0", shape=(), lb=0)
    fs.fix("soc0", 0.0)
    fs.add_param("price", np.ones(T))
    fs.add_eq("soc", lambda v, p: v["soc"] - tshift(v["soc"], v["soc0"])
              - v["charge"] + v["discharge"])
    return fs.compile(
        objective=lambda v, p: xp.sum(p["price"] * (v["discharge"] - v["charge"])),
        sense="max")


@pytest.fixture(scope="module")
def nlps():
    return (_storage_nlp(JFlowsheet, j_tshift, jnp),
            _storage_nlp(TFlowsheet, t_tshift, torch))


def _spec(pkg, n_profiles=4, n_lhs=3):
    rng = np.random.default_rng(0)
    return pkg.SweepSpec((
        pkg.grid("price", rng.uniform(1.0, 10.0, (n_profiles, T))),
        pkg.lhs({"soc0": (0.0, 1.0)}, n_lhs, seed=1),
    ))


def _opts(pkg=tsw, **kw):
    kw.setdefault("chunk_size", 4)
    kw.setdefault("solver", "pdlp")
    kw.setdefault("solver_options", _PDLP)
    return pkg.SweepOptions(**kw)


def _run(nlps, store_dir, spec=None, **kw):
    """The port's sweep on the CPU."""
    options = kw.pop("options", None) or _opts()
    return tsw.run_sweep(nlps[1], spec if spec is not None else _spec(tsw),
                         store_dir=store_dir, options=options, device=CPU, **kw)


@pytest.fixture(scope="module")
def j_store(nlps, tmp_path_factory):
    d = tmp_path_factory.mktemp("jsweep") / "ref"
    return jsw.run_sweep(nlps[0], _spec(jsw), store_dir=d, options=_opts(jsw))


@pytest.fixture(scope="module")
def ref_store(nlps, tmp_path_factory):
    """The canonical completed direct-backend run on the port, shared by
    every read-only consumer."""
    return _run(nlps, tmp_path_factory.mktemp("tsweep") / "ref")


def _identity_hashes(root):
    """Hashes of every file that is part of the store's identity (the
    manifest + chunk arrays; progress.json is run telemetry)."""
    out = {}
    for f in sorted(Path(root).rglob("*")):
        if f.is_file() and f.name != "progress.json":
            out[str(f.relative_to(root))] = hashlib.blake2b(f.read_bytes()).hexdigest()
    return out


# -- spec -------------------------------------------------------------


def _lhs_only(pkg, seed):
    return pkg.SweepSpec((pkg.lhs({"soc0": (0.0, 1.0), "x": (-2.0, 5.0)}, 5, seed=seed),))


@pytest.mark.parametrize("make", [lambda p: _spec(p), lambda p: _spec(p, 5, 2),
                                  lambda p: _lhs_only(p, 7),
                                  lambda p: p.SweepSpec((p.grid("soc0", np.linspace(0, 1, 4)),))],
                         ids=["grid_x_lhs", "grid5_x_lhs2", "lhs", "scalar_grid"])
def test_spec_matches_jax(make):
    a, b = make(jsw), make(tsw)
    assert (b.n_points, b.shape, b.swept_names, b.input_names) == \
        (a.n_points, a.shape, a.swept_names, a.input_names)
    idx = np.arange(a.n_points)
    np.testing.assert_array_equal(b.inputs_for(idx), a.inputs_for(idx))
    va, vb = a.values_for(idx[::2]), b.values_for(idx[::2])
    assert va.keys() == vb.keys()
    for k in va:
        np.testing.assert_array_equal(va[k], vb[k])
    assert b.describe() == a.describe()
    assert b.fingerprint() == a.fingerprint()


def test_spec_guards_and_synhist_axis():
    with pytest.raises(ValueError, match="two axes"):
        tsw.SweepSpec((tsw.grid("price", np.ones((2, T))), tsw.grid("price", np.ones((3, T)))))
    assert _spec(tsw).fingerprint() != _spec(tsw, n_profiles=5).fingerprint()
    from dispatches_tpu_torch.utils.synhist import ARMAModel

    model = ARMAModel(phi=[0.5], theta=[], sigma=1.0,
                      seasonal_mean=[30.0, 35.0, 40.0, 38.0, 33.0, 31.0])
    ax = tsw.synhist("price", model, n=5, n_steps=T, seed=3)
    assert ax.kind == "synhist" and ax.values[0].shape == (5, T)
    assert ax.values[0].dtype == np.float64
    ax2 = tsw.synhist("price", model, n=5, n_steps=T, seed=3)
    np.testing.assert_array_equal(ax.values[0], ax2.values[0])
    assert tsw.SweepSpec((ax,)).fingerprint() == tsw.SweepSpec((ax2,)).fingerprint()


class _Pair(NamedTuple):
    lo: float
    hi: dict


_TREES = {
    "dict": {"fixed": {}, "p": {"price": np.ones(T), "soc0": np.float64(0.0)}},
    "list_tuple_none": [np.ones(2), (np.zeros(3),), None, ()],
    "namedtuple": {"b": _Pair(1.0, {"z": np.ones(2), "a": None}), "a": [_Pair(2.0, {})]},
}


@pytest.mark.parametrize("name", sorted(_TREES))
def test_request_fingerprint_matches_jax(name):
    """The store's params fingerprint hashes the tree as JAX's
    ``repr(treedef)`` text, NamedTuples included."""
    import jax

    from dispatches_tpu.serve.bucket import request_fingerprint as j_fingerprint
    from dispatches_tpu_torch.serve.bucket import request_fingerprint
    from dispatches_tpu_torch.utils.tree import treedef_repr

    tree = _TREES[name]
    assert treedef_repr(tree) == repr(jax.tree_util.tree_structure(tree))
    assert request_fingerprint(tree) == j_fingerprint(tree)
    if name == "namedtuple":
        pair = _Pair(1.0, {})
        assert request_fingerprint(pair) != request_fingerprint(tuple(pair))


# -- the direct backend against JAX's ----------------------------------


def test_direct_backend_matches_jax(ref_store, j_store):
    a, b = j_store.arrays(), ref_store.arrays()
    assert a.keys() == b.keys()
    for k in ("index", "status", "retries", "refined", "converged", "iterations", "inputs"):
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        assert b[k].dtype == a[k].dtype, k
    assert np.all(b["status"] == tsw.STATUS_OK) and np.all(b["converged"])
    np.testing.assert_allclose(b["obj"], a["obj"], rtol=OBJ_RTOL, atol=0)


def test_jax_store_opens_the_ports_store(ref_store, j_store):
    """Same manifest bytes; the JAX package reads the port's store and
    reports the same summary but for the run's timings."""
    assert (ref_store.path / "manifest.json").read_bytes() == \
        (j_store.path / "manifest.json").read_bytes()
    opened = jsw.ResultStore(ref_store.path)
    run_keys = {"path", "wall_s", "solves_per_sec", "solves_per_sec_steady"}
    sa = {k: v for k, v in opened.summary().items() if k not in run_keys}
    sb = {k: v for k, v in j_store.summary().items() if k not in run_keys}
    assert sa == sb
    np.testing.assert_allclose(opened.objectives(), j_store.objectives(), rtol=OBJ_RTOL)
    assert opened.summary().keys() == ref_store.summary().keys()


def test_port_resumes_a_store_the_jax_engine_started(nlps, j_store, tmp_path):
    d = tmp_path / "mixed"
    jsw.run_sweep(nlps[0], _spec(jsw), store_dir=d, options=_opts(jsw, max_chunks=1))
    assert jsw.ResultStore(d).completed == {0}
    ran = []
    st = _run(nlps, d, resume=True, on_chunk=lambda cid, n: ran.append(cid))
    assert ran == [1, 2] and st.is_complete
    np.testing.assert_array_equal(st.arrays()["iterations"], j_store.arrays()["iterations"])
    np.testing.assert_allclose(st.objectives(), j_store.objectives(), rtol=OBJ_RTOL)


# -- refusals, options, guards -----------------------------------------


def test_refusals(nlps, ref_store, tmp_path):
    with pytest.raises(FileExistsError):
        _run(nlps, ref_store.path)
    # resume of a COMPLETE store is a no-op returning the same results
    assert _run(nlps, ref_store.path, resume=True).is_complete
    with pytest.raises(ValueError, match="fingerprint"):
        _run(nlps, ref_store.path, spec=_spec(tsw, n_profiles=5), resume=True)
    with pytest.raises(KeyError, match="not_a_param"):
        _run(nlps, tmp_path / "s", spec=tsw.SweepSpec((tsw.grid("not_a_param", np.ones(3)),)))
    with pytest.raises(ValueError, match="chunk_size"):
        _run(nlps, tmp_path / "c", options=_opts(chunk_size=0))
    with pytest.raises(ValueError, match="backend"):
        _run(nlps, tmp_path / "b", options=_opts(backend="nope"))


def test_sweep_options_from_env(monkeypatch):
    monkeypatch.setenv("DISPATCHES_TPU_SWEEP_CHUNK", "16")
    monkeypatch.setenv("DISPATCHES_TPU_SWEEP_MAX_RETRIES", "3")
    monkeypatch.setenv("DISPATCHES_TPU_SWEEP_RESULT_DIR", "/tmp/sw")
    opts = tsw.SweepOptions.from_env(backend="serve")
    assert (opts.chunk_size, opts.max_retries, opts.result_dir,
            opts.backend) == (16, 3, "/tmp/sw", "serve")


@pytest.mark.parametrize("flag", ["OBS_FLIGHT_DIR", "OBS_PROFILE", "OBS_LEDGER_DIR"])
def test_unported_obs_flags_raise_before_any_chunk(nlps, tmp_path, monkeypatch, flag):
    monkeypatch.setenv(f"DISPATCHES_TPU_{flag}", str(tmp_path / "obs"))
    with pytest.raises(NotImplementedError, match="item 12"):
        _run(nlps, tmp_path / "s")
    assert not (tmp_path / "s").exists()


def test_mesh_and_default_device_guards(nlps, tmp_path):
    with pytest.raises(NotImplementedError, match="item 7"):
        _run(nlps, tmp_path / "m", options=_opts(backend="mesh"))
    with pytest.raises(NotImplementedError, match="item 7"):
        _run(nlps, tmp_path / "m", mesh=object())
    if not torch.cuda.is_available():
        for backend in ("direct", "serve"):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                tsw.run_sweep(nlps[1], _spec(tsw), store_dir=tmp_path / backend,
                              options=_opts(backend=backend))
            assert not (tmp_path / backend).exists()


# -- resume determinism ------------------------------------------------


def test_resume_after_interrupt_is_bitwise_identical(nlps, tmp_path, ref_store):
    class Killed(RuntimeError):
        pass

    def die_after_first(cid, n_chunks):
        raise Killed(f"killed after chunk {cid}/{n_chunks}")

    with pytest.raises(Killed):
        _run(nlps, tmp_path / "cut", on_chunk=die_after_first)
    cut = tsw.ResultStore(tmp_path / "cut")
    assert cut.completed == {0} and not cut.is_complete
    resumed = []
    st = _run(nlps, tmp_path / "cut", resume=True, on_chunk=lambda cid, n: resumed.append(cid))
    assert st.is_complete and resumed == [1, 2]
    assert _identity_hashes(ref_store.path) == _identity_hashes(tmp_path / "cut")


def test_resume_via_max_chunks_partial_runs(nlps, tmp_path, ref_store):
    for _ in range(3):
        st = _run(nlps, tmp_path / "step", options=_opts(max_chunks=1), resume=True)
    assert st.is_complete
    assert _identity_hashes(ref_store.path) == _identity_hashes(tmp_path / "step")


# -- chunk-to-chunk warm starts ----------------------------------------


def test_warm_sweeps(nlps, tmp_path, ref_store, monkeypatch):
    """Warm seeding keeps objectives at solver tolerance against cold and
    records x/z in every chunk; a killed+resumed warm run is bitwise the
    uninterrupted one; the kill switch gives the cold store; a cold
    store is not resumed warm; warm needs direct + pdlp."""
    monkeypatch.delenv("DISPATCHES_TPU_WARMSTART", raising=False)
    warm = _run(nlps, tmp_path / "warm", options=_opts(warm_start=True))
    assert warm.is_complete and warm.warm_start is True
    np.testing.assert_allclose(warm.objectives(), ref_store.objectives(), rtol=0, atol=1e-5)
    for cid in sorted(warm.completed):
        done = warm.load_chunk(cid)
        assert done["x"].shape == (4, nlps[1].n)
        assert done["z"].shape == (4, nlps[1].m_eq + nlps[1].m_ineq)

    class Killed(RuntimeError):
        pass

    def die(cid, n):
        raise Killed

    with pytest.raises(Killed):
        _run(nlps, tmp_path / "warm_cut", options=_opts(warm_start=True), on_chunk=die)
    st = _run(nlps, tmp_path / "warm_cut", options=_opts(warm_start=True), resume=True)
    assert st.is_complete
    assert _identity_hashes(tmp_path / "warm") == _identity_hashes(tmp_path / "warm_cut")
    inputs, xs, zs = st.training_pairs()
    assert len(inputs) == 12 and xs.shape[0] == zs.shape[0] == 12

    with pytest.raises(ValueError, match="warm_start"):
        _run(nlps, ref_store.path, options=_opts(warm_start=True), resume=True)
    with pytest.raises(ValueError, match="direct-backend only"):
        _run(nlps, tmp_path / "wb", options=_opts(warm_start=True, backend="serve"))
    with pytest.raises(ValueError, match="pdlp"):
        _run(nlps, tmp_path / "ws", options=_opts(warm_start=True, solver="ipm",
                                                  solver_options=None))

    monkeypatch.setenv("DISPATCHES_TPU_WARMSTART", "0")
    killed = _run(nlps, tmp_path / "killed", options=_opts(warm_start=True))
    assert killed.warm_start is False
    assert _identity_hashes(ref_store.path) == _identity_hashes(tmp_path / "killed")


# -- quarantine and refine-failed --------------------------------------


class FakeResult(NamedTuple):
    obj: torch.Tensor
    converged: torch.Tensor
    iterations: torch.Tensor


def _poisoned_solver(params):
    """Lane-batched stand-in kernel: points whose price[0] > 8 come back
    NaN (the non-finite lane a diverged solve produces)."""
    price = params["p"]["price"]
    bad = price[:, 0] > 8.0
    return FakeResult(torch.where(bad, torch.nan, price.sum(-1)), ~bad, torch.tensor(3))


def test_nonfinite_points_quarantined_not_poisoning(nlps, tmp_path):
    from dispatches_tpu_torch.obs import registry as obs_registry
    from dispatches_tpu_torch.obs import trace as obs_trace

    rng = np.random.default_rng(2)
    profiles = rng.uniform(1.0, 7.0, (8, T))
    profiles[2, 0] = 9.5
    profiles[5, 0] = 9.9
    spec = tsw.SweepSpec((tsw.grid("price", profiles),))
    pts = obs_registry.counter("sweep.points")
    before = {ev: pts.value(event=ev) for ev in ("ok", "quarantined")}
    obs_trace.enable(True)
    try:
        store = _run(nlps, tmp_path / "q", spec=spec, options=tsw.SweepOptions(
            chunk_size=4, solver=_poisoned_solver, max_retries=2))
        assert pts.value(event="ok") - before["ok"] == 6
        assert pts.value(event="quarantined") - before["quarantined"] == 2
        insts = [e for e in obs_trace.events() if e["name"] == "sweep.quarantine"]
        assert sorted(e["args"]["point"] for e in insts) == [2, 5]
        retries = [e for e in obs_trace.events() if e["name"] == "sweep.retry"]
        assert len(retries) == 4  # 2 points x max_retries
    finally:
        obs_trace.enable(False)
        obs_trace.reset()
    a = store.arrays()
    assert list(a["status"]) == [0, 0, 2, 0, 0, 2, 0, 0]
    assert list(a["retries"]) == [0, 0, 2, 0, 0, 2, 0, 0]
    assert np.isnan(a["obj"][[2, 5]]).all()
    good = np.delete(np.arange(8), [2, 5])
    np.testing.assert_allclose(a["obj"][good], profiles[good].sum(axis=1))
    assert not a["converged"][[2, 5]].any()
    X, y = store.training_data()
    assert len(y) == 6 and np.isfinite(y).all()
    assert store.summary()["quarantined"] == 2


class RefinedResult(NamedTuple):
    obj: torch.Tensor
    converged: torch.Tensor
    iterations: torch.Tensor
    refined: torch.Tensor


def _refine_capped_solver(params):
    price = params["p"]["price"]
    hard = price[:, 0] > 8.0
    return RefinedResult(price.sum(-1), ~hard, torch.tensor(3),
                         torch.where(hard, 3, 1).to(torch.int32))


def test_refine_failed_points_get_distinct_status(nlps, tmp_path):
    rng = np.random.default_rng(4)
    profiles = rng.uniform(1.0, 7.0, (8, T))
    profiles[1, 0] = 9.5
    profiles[6, 0] = 9.9
    spec = tsw.SweepSpec((tsw.grid("price", profiles),))
    store = _run(nlps, tmp_path / "rf", spec=spec, options=tsw.SweepOptions(
        chunk_size=4, solver=_refine_capped_solver, max_retries=2))
    a = store.arrays()
    assert list(a["status"]) == [0, 3, 0, 0, 0, 0, 3, 0]
    np.testing.assert_allclose(a["obj"], profiles.sum(axis=1))
    assert list(a["refined"]) == [1, 3, 1, 1, 1, 1, 3, 1]
    assert len(store.training_data()[1]) == 6
    s = store.summary()
    assert s["refine_failed"] == 2 and s["quarantined"] == 0
    assert "2 refine-failed" in tsw.format_report(s)


# -- timing, backends, CLI, surrogate ----------------------------------


def test_chunk_timer_covers_device_completion(nlps, tmp_path, monkeypatch):
    """The chunk timer stops only after the plan's fence (``collect``,
    which waits on the batch's CUDA event on the card)."""
    from dispatches_tpu_torch.plan import ExecutionPlan

    events = []
    real_perf = engine_mod.time.perf_counter
    real_collect = ExecutionPlan.collect

    class _TimeSpy:
        @staticmethod
        def perf_counter():
            events.append("timer")
            return real_perf()

    def _collect_spy(self, ticket):
        out = real_collect(self, ticket)
        events.append("fence")
        return out

    monkeypatch.setattr(engine_mod, "time", _TimeSpy)
    monkeypatch.setattr(ExecutionPlan, "collect", _collect_spy)
    spec = tsw.SweepSpec((tsw.grid("price", np.random.default_rng(2).uniform(1.0, 10.0, (2, T))),))
    assert _run(nlps, tmp_path / "fence", spec=spec, options=_opts(chunk_size=2)).is_complete
    assert "fence" in events
    first_timer = events.index("timer")
    last_timer = len(events) - 1 - events[::-1].index("timer")
    assert first_timer < events.index("fence") < last_timer, events


def test_direct_and_serve_backends_match(nlps, tmp_path, ref_store):
    from dispatches_tpu_torch.serve import ServeOptions, SolveService

    svc = SolveService(ServeOptions(max_batch=4, max_wait_ms=1e12, warm_start=False),
                       device=CPU)
    serve = tsw.run_sweep(nlps[1], _spec(tsw), store_dir=tmp_path / "serve",
                          options=_opts(backend="serve"), service=svc)
    assert serve.is_complete and np.all(serve.statuses() == tsw.STATUS_OK)
    np.testing.assert_allclose(serve.objectives(), ref_store.objectives(), rtol=1e-8, atol=1e-9)
    m = svc.metrics()
    assert m["solved"] == 12 and m["occupancy_mean"] == 1.0


def test_report_cli(tmp_path, ref_store, capsys):
    from dispatches_tpu_torch.sweep.__main__ import main

    assert main(["--report", str(ref_store.path)]) == 0
    out = capsys.readouterr().out
    assert ref_store.fingerprint[:12] in out
    assert "chunks 3/3 done" in out and "throughput" in out
    assert main(["--report", "--json", str(ref_store.path)]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["chunks_done"] == 3 and payload["points_done"] == 12
    assert payload == json.loads(json.dumps(ref_store.summary()))
    assert main(["--report", str(tmp_path / "nope")]) == 2


def test_sweep_trains_revenue_surrogate(ref_store, j_store):
    """A finished store feeds the port's trainer directly, and trains as
    the JAX handoff does from the same initial weights."""
    import jax

    from dispatches_tpu.workflow import surrogates as js
    from dispatches_tpu_torch.workflow import surrogates as ts

    trainer, params = tsw.train_revenue_surrogate(ref_store, NN_size=[2, 8, 8, 1], epochs=60,
                                                  device=CPU)
    scaling = trainer._model_params
    assert {"xm_inputs", "xstd_inputs", "y_mean", "y_std", "R2", "train_loss"} <= set(scaling)
    pred = trainer.predict(params, scaling, ref_store.arrays()["inputs"][:3], device=CPU)
    assert pred.shape == (3, 1) and np.isfinite(pred).all()
    t2 = ts.TrainNNSurrogates.from_sweep(ref_store)
    x2, y2 = t2._transform_dict_to_array()
    X, y = ref_store.training_data()
    np.testing.assert_array_equal(x2, X)
    np.testing.assert_array_equal(y2[:, 0], y)
    # from JAX's initial weights, on JAX's store: JAX's handoff
    orig = ts._init_mlp
    ts._init_mlp = lambda sizes, seed: [
        {"W": np.array(p["W"]), "b": np.array(p["b"])}
        for p in js._init_mlp(sizes, jax.random.PRNGKey(seed))]
    try:
        tt, tp = tsw.train_revenue_surrogate(j_store, NN_size=[2, 8, 1], epochs=60, device=CPU)
    finally:
        ts._init_mlp = orig
    jt, jp = jsw.train_revenue_surrogate(j_store, NN_size=[2, 8, 1], epochs=60)
    want = np.asarray(jt.predict(jp, jt._model_params, X))
    got = tt.predict(tp, tt._model_params, X, device=CPU)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_flags_are_registered():
    from dispatches_tpu_torch.analysis.flags import REGISTERED_FLAGS

    from dispatches_tpu.analysis.flags import REGISTERED_FLAGS as J

    for f in ("SWEEP_CHUNK", "SWEEP_MAX_RETRIES", "SWEEP_RESULT_DIR"):
        assert REGISTERED_FLAGS[f] == J[f]
    assert "OBS_LEDGER_DIR" in REGISTERED_FLAGS
