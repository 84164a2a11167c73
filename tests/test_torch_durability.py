"""The port's durable serve (write-ahead journal, learned-state snapshots,
crash recovery) held to the JAX package on the CPU.

* The cases of tests/test_durability.py that cover the journal, the
  snapshots and recovery, run on the port with a lane-batched stub solver:
  the codec round trip, replay's open set (terminal statuses, the ``orig``
  link, a torn tail, idempotence), the clean-shutdown marker, the
  warm index round trip (``nearest`` bitwise), the v2 predictor section
  and v1 compatibility, crash recovery with two identical-params
  requests, ``drain``, the write-ahead order under a concurrent flusher,
  and the disarmed service never constructing a journal.
* Cross-package formats: ``encode_tree`` writes the JAX package's bytes
  for dict, list, tuple, None and f32/f64/int32/bool leaves (and for a
  tensor the bytes of its numpy array); a journal written by either
  package replays in the other to the same open set, torn tail included,
  with equal fingerprints; a port snapshot loads in JAX's ``load_state``
  and restores a JAX service's bucket, and a JAX snapshot restores a port
  service's bucket (index state, P² markers and predictor weights equal
  bitwise).
* State hooks: ``WarmStartIndex``, ``StartPredictor`` and
  ``OnlineTrainer`` state round trips equal JAX's, bitwise.
* The device rule: the durable service raises without a card.
"""

import json
import os
import threading
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu.learn import OnlineTrainer as JOnlineTrainer  # noqa: E402
from dispatches_tpu.learn import fit as jfit  # noqa: E402
from dispatches_tpu.serve import ServeOptions as JServeOptions  # noqa: E402
from dispatches_tpu.serve import SolveService as JSolveService  # noqa: E402
from dispatches_tpu.serve import journal as jjournal  # noqa: E402
from dispatches_tpu.serve import snapshot as jsnapshot  # noqa: E402
from dispatches_tpu.serve import warmstart as jwarmstart  # noqa: E402
from dispatches_tpu.serve.__main__ import _arbitrage_nlp as j_arbitrage_nlp  # noqa: E402
from dispatches_tpu.serve.bucket import request_fingerprint as j_fingerprint  # noqa: E402

from dispatches_tpu_torch.learn import OnlineTrainer, fit  # noqa: E402
from dispatches_tpu_torch.plan import ExecutionPlan, PlanOptions  # noqa: E402
from dispatches_tpu_torch.serve import (  # noqa: E402
    RequestStatus,
    ServeOptions,
    SolveService,
    journal,
    snapshot,
    warmstart,
)
from dispatches_tpu_torch.serve.__main__ import _arbitrage_nlp  # noqa: E402
from dispatches_tpu_torch.serve.bucket import request_fingerprint  # noqa: E402
from test_torch_stacked import one_torch_thread  # noqa: E402,F401

CPU = "cpu"


@pytest.fixture(autouse=True)
def _disarmed(monkeypatch):
    """Every test starts disarmed: the durability and serve flags unset."""
    for var in ("SERVE_JOURNAL_DIR", "SERVE_SNAPSHOT_INTERVAL_S", "WARMSTART",
                "WARMSTART_PREDICT", "PDLP_PRECISION", "PDLP_ALGO", "FAULTS",
                "OBS_EXPORT_DIR", "OBS_FLIGHT_DIR", "OBS_PROFILE"):
        monkeypatch.delenv(f"DISPATCHES_TPU_{var}", raising=False)
    yield


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class StubNLP:
    """What the service's pdlp-with-``base_solver`` path reads:
    ``default_params()`` (tests/test_durability.py's stub)."""

    def __init__(self, n: int = 8):
        self._price = np.linspace(1.0, 2.0, n)

    def default_params(self):
        return {"p": {"price": np.array(self._price)}, "fixed": {}}


class StubResult(NamedTuple):
    obj: object
    converged: object
    iters: object


def stub_solver(params):
    """Lane-batched: the objective is each lane's price sum."""
    price = params["p"]["price"]
    return StubResult(obj=price.sum(-1), converged=torch.ones_like(price[:, 0], dtype=torch.bool),
                      iters=20.0 + 40.0 * price.mean(-1))


@pytest.fixture(scope="module")
def stub_nlp():
    return StubNLP()


def _new_service(**kw):
    """tests/test_durability.py's service, on a fake clock so that only a
    full batch of 4 flushes."""
    plan = ExecutionPlan(PlanOptions(inflight=2, device=CPU))
    return SolveService(ServeOptions(max_batch=4, max_wait_ms=5.0, warm_start=False,
                                     plan=plan), clock=FakeClock(), **kw)


def _params(nlp, i):
    p = nlp.default_params()
    p["p"]["price"] = p["p"]["price"] * (1.0 + 0.01 * i)
    return p


def _segments(d):
    return sorted(n for n in os.listdir(d) if n.startswith("journal-"))


# ---------------------------------------------------------------------------
# the codec, byte for byte with JAX's
# ---------------------------------------------------------------------------


def _tree():
    rng = np.random.default_rng(0)
    return {
        "p": {"price": np.linspace(0.0, 1.0, 24),
              "cf": rng.random(24).astype(np.float32),
              "n": np.arange(6, dtype=np.int32).reshape(2, 3),
              "on": np.array([True, False, True]),
              "scalar": np.float64(2.5),
              "zero_d": np.array(7.0)},
        "fixed": {"cap": 25.0, "n": 3, "flag": True, "name": "pem"},
        "tup": (np.arange(4, dtype=np.int64), 2.5),
        "lst": [np.ones(2, np.float32), None, [1, 2]],
        "none": None,
        "strided": np.arange(12.0).reshape(3, 4)[:, ::2],
    }


def test_encode_tree_bytes_equal_jax():
    tree = _tree()
    want = json.dumps(jjournal.encode_tree(tree))
    assert json.dumps(journal.encode_tree(tree)) == want
    # tensor leaves write the bytes of the numpy arrays they came from
    as_t = {"p": {k: torch.as_tensor(v) for k, v in tree["p"].items()}}
    as_np = {"p": {k: np.asarray(v) for k, v in tree["p"].items()}}
    assert json.dumps(journal.encode_tree(as_t)) == json.dumps(jjournal.encode_tree(as_np))
    # decodes cross: each package decodes the other's encoding bitwise
    for enc, dec in ((journal.encode_tree, jjournal.decode_tree),
                     (jjournal.encode_tree, journal.decode_tree)):
        back = dec(json.loads(json.dumps(enc(tree))))
        assert isinstance(back["tup"], tuple) and back["lst"][1] is None
        assert back["p"]["scalar"] == 2.5  # a numpy scalar is a float
        for k, v in tree["p"].items():
            if k != "scalar":
                assert back["p"][k].dtype == v.dtype, k
                assert back["p"][k].tobytes() == v.tobytes(), k
        assert back["strided"].shape == (3, 2)


def test_journal_codec_round_trips_params_bitwise():
    params = {
        "p": {"price": np.linspace(0.0, 1.0, 24),
              "cf": np.random.default_rng(0).random(24).astype(np.float32)},
        "fixed": {"cap": 25.0, "n": 3, "flag": True, "name": "pem"},
        "tup": (np.arange(4, dtype=np.int64), 2.5),
        "none": None,
    }
    decoded = journal.decode_tree(json.loads(json.dumps(journal.encode_tree(params))))
    assert isinstance(decoded["tup"], tuple)
    np.testing.assert_array_equal(decoded["p"]["price"], params["p"]["price"])
    assert decoded["p"]["cf"].dtype == np.float32
    assert request_fingerprint(decoded) == request_fingerprint(params)
    # a tensor tree fingerprints as the decoded numpy tree it journals to
    t_params = {"p": {k: torch.as_tensor(v) for k, v in params["p"].items()}}
    back = journal.decode_tree(json.loads(json.dumps(journal.encode_tree(t_params))))
    assert request_fingerprint(back) == request_fingerprint(t_params) == j_fingerprint(back)


# ---------------------------------------------------------------------------
# replay, and journals across packages
# ---------------------------------------------------------------------------


def _write_crashed_journal(mod, d):
    """tests/test_durability.py's crashed journal, written by ``mod``."""
    j = mod.RequestJournal(d, segment_records=4)  # forces rotation
    for i in (1, 2, 3, 4, 5):
        j.accept(i, f"fp-{i}", solver="pdlp", options=None,
                 deadline_ms=50.0 if i == 1 else None, t=float(i),
                 params={"x": np.array([float(i)])})
    j.accept(6, "fp-4", solver="pdlp", options=None, deadline_ms=None,
             t=6.0, params={"x": np.array([4.0])}, origin=4)
    j.accept(7, "fp-5", solver="pdlp", options={"tol": 1e-8, "pair": (1, 2)},
             deadline_ms=None, t=7.0, params={"x": np.array([5.0])})
    j.status([1, 2], "DISPATCHED")
    j.status([2], "DONE")
    j.status([3], "TIMEOUT")
    j.close()  # no clean marker: this journal "crashed"
    segs = _segments(d)
    assert len(segs) > 1  # rotation happened
    with open(os.path.join(d, segs[-1]), "a", encoding="utf-8") as fh:
        fh.write('{"k":"a","id":9,"fp":"fp-9"')  # torn mid-write


def _open_set(rep):
    return [(r["id"], r["fp"], r["solver"], r["options"], r["deadline_ms"],
             r["params"]["x"].tobytes()) for r in rep.open_requests]


def test_journal_replay_open_set_torn_tail_and_idempotence(tmp_path):
    d = str(tmp_path)
    _write_crashed_journal(journal, d)
    rep = journal.replay(d)
    assert rep.torn == 1 and not rep.clean_shutdown and rep.accepted == 7
    assert [r["id"] for r in rep.open_requests] == [1, 5, 6, 7]
    assert [r["fp"] for r in rep.open_requests] == ["fp-1", "fp-5", "fp-4", "fp-5"]
    assert rep.open_requests[0]["deadline_ms"] == 50.0
    assert rep.open_requests[3]["options"] == {"tol": 1e-8, "pair": (1, 2)}
    np.testing.assert_array_equal(rep.open_requests[2]["params"]["x"], [4.0])
    assert rep.max_id == 7
    assert _open_set(journal.replay(d)) == _open_set(rep)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_journals_replay_across_packages(tmp_path, writer):
    """A journal written by either package replays in both to the same
    open set (ids, fingerprints, options, payload bytes), the segment
    files byte-equal, the torn tail counted alike."""
    d_j, d_t = str(tmp_path / "j"), str(tmp_path / "t")
    _write_crashed_journal(jjournal, d_j)
    _write_crashed_journal(journal, d_t)
    assert _segments(d_j) == _segments(d_t)
    for seg in _segments(d_j):
        assert (open(os.path.join(d_j, seg), "rb").read()
                == open(os.path.join(d_t, seg), "rb").read()), seg
    d = d_j if writer == "jax" else d_t
    got, want = journal.replay(d), jjournal.replay(d)
    assert _open_set(got) == _open_set(want)
    assert (got.torn, got.accepted, got.max_id, got.clean_shutdown) == \
        (want.torn, want.accepted, want.max_id, want.clean_shutdown) == (1, 7, 7, False)


def test_port_service_journal_replays_in_jax_with_equal_fingerprints(tmp_path, stub_nlp):
    d = str(tmp_path)
    svc = _new_service(journal_dir=d)
    for i in range(3):
        svc.submit(stub_nlp, _params(stub_nlp, i), solver="pdlp", base_solver=stub_solver)
    del svc  # crash with three requests queued
    rep = jjournal.replay(d)
    assert [r["id"] for r in rep.open_requests] == [1, 2, 3]
    for i, r in enumerate(rep.open_requests):
        assert r["fp"] == j_fingerprint(r["params"]) == request_fingerprint(_params(stub_nlp, i))
        assert r["params"]["p"]["price"].tobytes() == _params(stub_nlp, i)["p"]["price"].tobytes()


def test_journal_clean_shutdown_empties_replay(tmp_path):
    j = journal.RequestJournal(str(tmp_path))
    j.accept(1, "fp-1", solver="pdlp", options=None, deadline_ms=None,
             t=0.0, params={"x": np.array([1.0])})
    j.shutdown(clean=True)
    j.close()
    for mod in (journal, jjournal):
        rep = mod.replay(str(tmp_path))
        assert rep.clean_shutdown and rep.open_requests == []
    # post-close writes are silent no-ops
    j.accept(2, "fp-2", solver="pdlp", options=None, deadline_ms=None, t=1.0, params={})


# ---------------------------------------------------------------------------
# state hooks: warm index, predictor, trainer
# ---------------------------------------------------------------------------


def _filled_indexes(seed=3):
    rng = np.random.default_rng(seed)
    idx = warmstart.WarmStartIndex(capacity=6, k=3, radius=0.5)
    jidx = jwarmstart.WarmStartIndex(capacity=6, k=3, radius=0.5)
    base = rng.random(8) + 1.0
    for i in range(8):  # wraps the ring: two oldest evicted
        vec = base * (1.0 + 0.03 * rng.standard_normal(8))
        x, z = rng.standard_normal(8), rng.standard_normal(3)
        idx.add(f"k{i}", vec, x, z)
        jidx.add(f"k{i}", vec, x, z)
    return idx, jidx, base, rng


def test_warm_index_state_round_trip_nearest_bitwise():
    idx, jidx, base, rng = _filled_indexes()
    enc = json.dumps(journal.encode_tree(idx.to_state()))
    assert enc == json.dumps(jjournal.encode_tree(jidx.to_state()))
    state = journal.decode_tree(json.loads(enc))
    idx2 = warmstart.WarmStartIndex.from_state(state)
    jidx2 = jwarmstart.WarmStartIndex.from_state(state)
    assert len(idx2) == len(idx) == 6
    assert json.dumps(journal.encode_tree(idx2.to_state())) == enc
    assert json.dumps(jjournal.encode_tree(jidx2.to_state())) == enc
    for _ in range(5):
        probe = base * (1.0 + 0.03 * rng.standard_normal(8))
        a, b, c = idx.nearest(probe), idx2.nearest(probe), jidx2.nearest(probe)
        if a is None:
            assert b is None and c is None
            continue
        for got in (b, c):
            assert np.asarray(got[0]).tobytes() == np.asarray(a[0]).tobytes()
            assert np.asarray(got[1]).tobytes() == np.asarray(a[1]).tobytes()
            assert float(got[2]) == float(a[2])


def _fit_data(seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((16, 4)).astype(np.float32),
            rng.standard_normal((16, 3)).astype(np.float32),
            rng.standard_normal((16, 2)).astype(np.float32))


def test_predictor_and_trainer_state_round_trips_match_jax():
    vecs, xs, zs = _fit_data()
    pred = fit(vecs, xs, zs, hidden=4, epochs=20, device=CPU)
    tr = OnlineTrainer(3, 2, hidden=4, device=CPU)
    tr.adopt(pred, trained_samples=16)
    tr.samples, tr.refits = 40, 2
    state = tr.to_state()
    jtr = JOnlineTrainer(3, 2, hidden=4)
    jtr.load_state(jjournal.decode_tree(json.loads(json.dumps(journal.encode_tree(state)))))
    # the JAX trainer re-serializes the port's state to the same bytes
    assert json.dumps(jjournal.encode_tree(jtr.to_state())) == \
        json.dumps(journal.encode_tree(state))
    # and back: a JAX-fitted predictor's state loads into the port
    jtr.adopt(jfit(vecs, xs, zs, hidden=4, epochs=20), trained_samples=16)
    tr2 = OnlineTrainer(3, 2, hidden=4, device=CPU)
    tr2.load_state(journal.decode_tree(json.loads(json.dumps(jjournal.encode_tree(jtr.to_state())))))
    assert tr2.ready() and tr2.samples == 40 and tr2.refits == 2
    for k, v in jtr.predictor.params.items():
        assert tr2.predictor.params[k].dtype == np.float32
        assert tr2.predictor.params[k].tobytes() == np.asarray(v).tobytes(), k
    # a shape mismatch leaves the trainer untrained
    tr3 = OnlineTrainer(5, 2, hidden=4, device=CPU)
    tr3.load_state(state)
    assert not tr3.ready()


class _LadderBucket:
    """The slice of a serve bucket the snapshot codec reads and writes."""

    def __init__(self, n=3, m=2):
        self.warm_fallback = False
        self.warm_consec_mispredicts = 0
        self.refine_fails = 0
        self.est = None
        self.arrivals = None
        self.warm_guard = warmstart.MispredictGuard()
        self.warm_index = warmstart.WarmStartIndex(capacity=8)
        self.predict_fallback = False
        self.predict_consec_mispredicts = 0
        self.predict_trainer = OnlineTrainer(n, m, hidden=4, device=CPU)
        self.predict_weights = None


def test_snapshot_v2_round_trips_predictor_weights_bitwise():
    vecs, xs, zs = _fit_data()
    b = _LadderBucket()
    b.predict_trainer.adopt(fit(vecs, xs, zs, hidden=4, epochs=20, device=CPU),
                            trained_samples=16)
    b.predict_fallback = True  # degraded rungs must not un-degrade
    b.predict_consec_mispredicts = 3
    state = json.loads(json.dumps(snapshot._bucket_state(b)))
    b2 = _LadderBucket()
    snapshot.apply_bucket_state(b2, state)
    assert b2.predict_trainer.ready() and b2.predict_trainer.trained_samples == 16
    for k, v in b.predict_trainer.predictor.params.items():
        assert np.asarray(v).tobytes() == b2.predict_trainer.predictor.params[k].tobytes(), k
        # the dispatch head's copy, staged on the trainer's device
        w = b2.predict_weights[k]
        assert isinstance(w, torch.Tensor) and w.device.type == "cpu"
        assert w.numpy().tobytes() == np.asarray(v).tobytes(), k
    assert b2.predict_fallback and b2.predict_consec_mispredicts == 3


def test_snapshot_v1_schema_loads_with_predictor_fresh(tmp_path):
    state = {"schema": 1, "generation": 3, "t": 0.0, "warm_lru": [],
             "buckets": {"pdlp#0": {"ladder": {
                 "warm_fallback": True, "warm_consec_mispredicts": 2,
                 "refine_fails": 0}}}}
    (tmp_path / snapshot.SNAPSHOT_FILE).write_text(json.dumps(state))
    loaded = snapshot.load_state(str(tmp_path))
    assert loaded is not None and loaded["generation"] == 3
    b = _LadderBucket()
    snapshot.apply_bucket_state(b, loaded["buckets"]["pdlp#0"])
    assert b.warm_fallback and b.warm_consec_mispredicts == 2
    assert not b.predict_fallback
    assert not b.predict_trainer.ready() and b.predict_weights is None
    state["schema"] = 99
    (tmp_path / snapshot.SNAPSHOT_FILE).write_text(json.dumps(state))
    assert snapshot.load_state(str(tmp_path)) is None


# ---------------------------------------------------------------------------
# snapshots across packages, on the battery-arbitrage LP's warm buckets
# ---------------------------------------------------------------------------


def _lp_params(nlp, price):
    d = nlp.default_params()
    return {"p": {**d["p"], "price": price}, "fixed": d["fixed"]}


def _warm_pass(svc, nlp, seed, adopt_fit):
    rng = np.random.default_rng(seed)
    prices = [30.0 + 10.0 * rng.standard_normal(8) for _ in range(6)]
    out = svc.solve_many(nlp, [_lp_params(nlp, p) for p in prices], solver="pdlp",
                         options={"tol": 1e-7, "dtype": "float64"})
    assert all(r.status == RequestStatus.DONE for r in out)
    bucket = next(iter(svc._buckets.values()))
    vecs, xs, zs = bucket.warm_index.export_pairs()
    bucket.predict_trainer.adopt(
        adopt_fit(np.stack(vecs).astype(np.float32), np.stack(xs), np.stack(zs)),
        trained_samples=len(vecs))
    return bucket


def _bucket_view(bucket, enc):
    """What a restore must carry over and a queued submit leaves alone:
    index state bytes, P² markers, guard state, predictor weights."""
    p2 = bucket.est._p95
    return {
        "index": json.dumps(enc(bucket.warm_index.to_state())),
        "p2": (p2.p, list(p2._q), list(p2._n), list(p2._np), list(p2._dn), p2._count),
        "est_samples": bucket.est.samples,
        "guard": (bucket.warm_guard.cold_iters_ema, bucket.warm_guard.mispredicts),
        "weights": {k: np.asarray(v).tobytes()
                    for k, v in bucket.predict_trainer.predictor.params.items()},
    }


def test_snapshots_load_across_packages(tmp_path):
    d_t, d_j = str(tmp_path / "t"), str(tmp_path / "j")
    jn, tn = j_arbitrage_nlp(8), _arbitrage_nlp(8)
    opts = {"max_batch": 4, "max_wait_ms": 1e9}

    # port -> JAX
    tsvc = SolveService(ServeOptions(**opts), clock=FakeClock(), device=CPU, journal_dir=d_t)
    tb = _warm_pass(tsvc, tn, 1, lambda v, x, z: fit(v, x, z, hidden=4, epochs=10, device=CPU))
    want = _bucket_view(tb, journal.encode_tree)
    assert tsvc.drain()["snapshot"] is not None
    state = jsnapshot.load_state(d_t)
    assert state is not None and state["generation"] == 1
    jsvc = JSolveService(JServeOptions(**opts), clock=FakeClock())
    jsnapshot.apply_to_service(jsvc, state)
    assert jsvc.generation == 2
    jsvc.submit(jn, _lp_params(jn, np.full(8, 30.0)), solver="pdlp",
                options={"tol": 1e-7, "dtype": "float64"})
    jb = next(iter(jsvc._buckets.values()))
    assert _bucket_view(jb, jjournal.encode_tree) == want
    assert jb.arrivals._gap == tb.arrivals._gap

    # JAX -> port
    jsvc2 = JSolveService(JServeOptions(**opts), clock=FakeClock(), journal_dir=d_j)
    jb2 = _warm_pass(jsvc2, jn, 2, lambda v, x, z: jfit(v, x, z, hidden=4, epochs=10))
    want2 = _bucket_view(jb2, jjournal.encode_tree)
    jsvc2.drain()
    tsvc2 = SolveService(ServeOptions(**opts), clock=FakeClock(), device=CPU,
                         recover_dir=d_j, recover_nlp=tn)
    assert tsvc2.generation == 2 and tsvc2.recovery["recovered"] == 0
    assert tsvc2.recovery["clean_shutdown"]
    # the warm LRU and the bucket's state restore on first use of the label
    assert len(tsvc2._warm) == len(jsvc2._warm)
    h = tsvc2.submit(tn, _lp_params(tn, np.full(8, 30.0)), solver="pdlp",
                     options={"tol": 1e-7, "dtype": "float64"})
    tb2 = next(iter(tsvc2._buckets.values()))
    assert _bucket_view(tb2, journal.encode_tree) == want2
    assert tb2.arrivals._gap == jb2.arrivals._gap
    for k, v in jb2.predict_trainer.predictor.params.items():
        assert tb2.predict_weights[k].numpy().tobytes() == np.asarray(v).tobytes()
    tsvc2.flush_all()
    assert h.result().status == RequestStatus.DONE


# ---------------------------------------------------------------------------
# crash recovery on the port's service
# ---------------------------------------------------------------------------


def test_service_crash_recovery_completes_open_requests(tmp_path, stub_nlp):
    d = str(tmp_path)
    svc1 = _new_service(journal_dir=d, snapshot_interval_s=1e-6)
    done = [svc1.submit(stub_nlp, _params(stub_nlp, i), solver="pdlp",
                        base_solver=stub_solver) for i in range(3)]
    svc1.flush_all()
    assert all(h.result().status == RequestStatus.DONE for h in done)
    svc1.poll()  # the first maybe_snapshot always writes
    assert os.path.exists(os.path.join(d, snapshot.SNAPSHOT_FILE))
    # two more accepted but never dispatched, then the process "dies"
    lost = [svc1.submit(stub_nlp, _params(stub_nlp, 10 + i), solver="pdlp",
                        base_solver=stub_solver) for i in range(2)]
    del svc1, lost

    svc2 = _new_service(recover_dir=d, recover_nlp=stub_nlp,
                        recover_base_solver=stub_solver, snapshot_interval_s=1e-6)
    rec = svc2.recovery
    assert rec["recovered"] == 2 and rec["lost"] == 0
    assert not rec["clean_shutdown"] and rec["recovery_ms"] >= 0.0
    assert svc2.generation == 2
    assert len(svc2.recovered_handles) == 2
    svc2.flush_all()
    assert all(h.result().status == RequestStatus.DONE for h in svc2.recovered_handles)
    assert [float(h.result().obj) for h in svc2.recovered_handles] == pytest.approx(
        [float(_params(stub_nlp, 10 + i)["p"]["price"].sum()) for i in range(2)], rel=1e-14)
    dur = svc2.metrics()["durability"]
    assert dur["journaled"] and dur["generation"] == 2 and dur["recovery"]["recovered"] == 2
    assert dur["snapshot_writes"] >= 1

    svc2.drain()
    svc3 = _new_service(recover_dir=d, recover_nlp=stub_nlp,
                        recover_base_solver=stub_solver, snapshot_interval_s=1e-6)
    assert svc3.recovery["recovered"] == 0 and svc3.recovery["clean_shutdown"]
    assert svc3.recovered_handles == []


def test_stub_crash_recovery_completes_every_open_request_once(tmp_path, stub_nlp):
    """Of 7 accepted requests, the first batch of 4 completes before the
    crash; recovery resubmits exactly the 3 open ones, each once, and a
    second crash before they dispatch leaves the same 3 to a third
    process.  JAX's replay reads the port's journal to the same set."""
    d = str(tmp_path)
    svc1 = _new_service(journal_dir=d)
    hs = [svc1.submit(stub_nlp, _params(stub_nlp, i), solver="pdlp",
                      base_solver=stub_solver) for i in range(7)]
    assert [h.done() for h in hs] == [True] * 4 + [False] * 3  # max_batch 4 flushed
    del svc1, hs
    open_ids = [r["id"] for r in journal.replay(d).open_requests]
    assert open_ids == [5, 6, 7]
    assert [r["id"] for r in jjournal.replay(d).open_requests] == open_ids

    svc2 = _new_service(recover_dir=d, recover_nlp=stub_nlp, recover_base_solver=stub_solver)
    assert svc2.recovery["recovered"] == 3
    del svc2  # crash again before the recovered requests dispatch
    svc3 = _new_service(recover_dir=d, recover_nlp=stub_nlp, recover_base_solver=stub_solver)
    assert svc3.recovery == {**svc3.recovery, "recovered": 3, "lost": 0}
    svc3.flush_all()
    objs = sorted(float(h.result().obj) for h in svc3.recovered_handles)
    assert objs == pytest.approx(
        sorted(float(_params(stub_nlp, i)["p"]["price"].sum()) for i in range(4, 7)), rel=1e-14)
    svc3.drain()
    assert journal.replay(d).open_requests == [] and jjournal.replay(d).clean_shutdown


def test_crash_recovery_keeps_both_same_params_requests(tmp_path, stub_nlp):
    d = str(tmp_path)
    svc1 = _new_service(journal_dir=d)
    same = _params(stub_nlp, 7)
    a = svc1.submit(stub_nlp, same, solver="pdlp", base_solver=stub_solver)
    b = svc1.submit(stub_nlp, same, solver="pdlp", base_solver=stub_solver)
    assert a.request_id != b.request_id and not a.done() and not b.done()
    del svc1, a, b

    svc2 = _new_service(recover_dir=d, recover_nlp=stub_nlp, recover_base_solver=stub_solver)
    assert svc2.recovery["recovered"] == 2 and svc2.recovery["lost"] == 0
    del svc2
    svc3 = _new_service(recover_dir=d, recover_nlp=stub_nlp, recover_base_solver=stub_solver)
    assert svc3.recovery["recovered"] == 2
    svc3.flush_all()
    assert all(h.result().status == RequestStatus.DONE for h in svc3.recovered_handles)


def test_drain_closes_submissions_and_is_idempotent(tmp_path, stub_nlp):
    svc = _new_service(journal_dir=str(tmp_path), snapshot_interval_s=1e-6)
    h = svc.submit(stub_nlp, _params(stub_nlp, 0), solver="pdlp", base_solver=stub_solver)
    out = svc.drain()
    assert h.result().status == RequestStatus.DONE
    assert out["snapshot"] is not None
    with pytest.raises(RuntimeError, match="draining"):
        svc.submit(stub_nlp, _params(stub_nlp, 1), solver="pdlp", base_solver=stub_solver)
    svc.drain()
    assert journal.replay(str(tmp_path)).clean_shutdown


def test_write_ahead_accept_precedes_completion_under_concurrent_flush(tmp_path, stub_nlp):
    d = str(tmp_path)
    svc = _new_service(journal_dir=d)
    stop = threading.Event()
    flush_errors = []

    def flusher():
        try:
            while not stop.is_set():
                svc.flush_all()
        except Exception as exc:  # pragma: no cover - the failure mode
            flush_errors.append(exc)

    t = threading.Thread(target=flusher)
    t.start()
    try:
        handles = [svc.submit(stub_nlp, _params(stub_nlp, i), solver="pdlp",
                              base_solver=stub_solver) for i in range(32)]
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and not flush_errors
    svc.flush_all()
    assert all(h.result().status == RequestStatus.DONE for h in handles)
    accepted_ids, terminal_before_accept = set(), []
    for seg in _segments(d):
        with open(os.path.join(d, seg), encoding="utf-8") as fh:
            for line in fh:
                rec = json.loads(line)
                if rec["k"] == "a":
                    accepted_ids.add(rec["id"])
                elif rec["k"] == "s" and rec["st"] in journal.TERMINAL_STATUSES:
                    terminal_before_accept.extend(i for i in rec["ids"] if i not in accepted_ids)
    assert terminal_before_accept == [] and len(accepted_ids) == 32
    rep = journal.replay(d)
    assert rep.accepted == 32 and rep.open_requests == []


def test_timeout_and_error_statuses_are_journaled(tmp_path, stub_nlp):
    clock = FakeClock()
    plan = ExecutionPlan(PlanOptions(inflight=2, device=CPU))
    svc = SolveService(ServeOptions(max_batch=4, max_wait_ms=1e9, warm_start=False, plan=plan),
                       clock=clock, journal_dir=str(tmp_path))
    late = svc.submit(stub_nlp, _params(stub_nlp, 0), solver="pdlp", base_solver=stub_solver,
                      deadline_ms=5.0)
    clock.t = 1.0
    svc.flush_all()
    assert late.result().status == RequestStatus.TIMEOUT

    def broken(params):
        raise RuntimeError("solver down")

    bad = svc.submit(stub_nlp, _params(stub_nlp, 1), solver="pdlp", base_solver=broken)
    svc.flush_all()
    assert bad.result().status == RequestStatus.ERROR
    statuses = {}
    for seg in _segments(str(tmp_path)):
        for line in open(os.path.join(str(tmp_path), seg), encoding="utf-8"):
            rec = json.loads(line)
            if rec["k"] == "s":
                for i in rec["ids"]:
                    statuses.setdefault(i, []).append(rec["st"])
    assert statuses[late.request_id] == ["TIMEOUT"]
    assert statuses[bad.request_id][0] == "DISPATCHED" and statuses[bad.request_id][-1] == "ERROR"
    assert journal.replay(str(tmp_path)).open_requests == []


def test_env_flag_arms_the_journal(tmp_path, monkeypatch, stub_nlp):
    monkeypatch.setenv("DISPATCHES_TPU_SERVE_JOURNAL_DIR", str(tmp_path))
    monkeypatch.setenv("DISPATCHES_TPU_SERVE_SNAPSHOT_INTERVAL_S", "1e9")
    svc = _new_service()
    assert svc._snapshots.interval_s == 1e9
    svc.submit(stub_nlp, _params(stub_nlp, 0), solver="pdlp", base_solver=stub_solver)
    assert journal.replay(str(tmp_path)).accepted == 1


def test_disarmed_service_never_touches_the_journal(monkeypatch, stub_nlp):
    def _boom(*a, **k):
        raise AssertionError("RequestJournal constructed while disarmed")

    monkeypatch.setattr(journal.RequestJournal, "__init__", _boom)
    svc = _new_service()
    hs = [svc.submit(stub_nlp, _params(stub_nlp, i), solver="pdlp",
                     base_solver=stub_solver) for i in range(3)]
    svc.flush_all()
    assert all(h.result().status == RequestStatus.DONE for h in hs)
    dur = svc.metrics()["durability"]
    assert not dur["journaled"] and dur["recovery"] is None
    assert svc._journal is None and svc._snapshots is None


def test_durable_service_follows_the_device_rule(tmp_path):
    """Durable or not, the service runs on cuda unless asked for the CPU,
    and raises without a card (before it writes anything)."""
    if torch.cuda.is_available():
        svc = SolveService(journal_dir=str(tmp_path / "j"))
        assert svc.plan.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SolveService(journal_dir=str(tmp_path / "j"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SolveService(recover_dir=str(tmp_path / "r"))
    assert not (tmp_path / "j").exists() and not (tmp_path / "r").exists()
    assert SolveService(journal_dir=str(tmp_path / "c"), device=CPU).plan.device.type == "cpu"
