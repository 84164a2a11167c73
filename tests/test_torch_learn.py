"""The port's learned warm-start predictor, warm-start index and
checkpoint warm starts held to the JAX package's on the CPU.

* ``init_params`` draws the same numpy weights, bitwise;
* ``forward`` on tensors equals JAX's within 1e-6 on the same weights
  (carried over with ``interop.predictor_from_numpy``), in float32 and in
  the float64 a bucket's parameter vectors promote it to;
* ``fit`` (full-batch Adam, float32 autograd, the JAX loop's constants):
  after the default 300 epochs the port's predictions are as close to
  JAX's as JAX's own fit is to itself when the same rows come in another
  order.  The first Adam step of ``b2`` is pure rounding noise (normalized
  targets have zero mean, and Adam scales every gradient to the step
  size), so any change of summation order — JAX against itself included —
  moves weights by ~1e-3 relative and predictions by ~1e-4, so a 1e-4
  bound on the weights would fail JAX against itself;
* ``ReplayBuffer`` / ``OnlineTrainer`` due/ready/adopt and the
  ``WarmStartIndex`` / ``MispredictGuard`` retrieval behave identically;
* ``checkpoint.solution_x0`` / ``warm_start_from`` give the same x0."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dispatches_tpu.learn import predictor as j_pred  # noqa: E402
from dispatches_tpu.learn import train as j_train  # noqa: E402
from dispatches_tpu.serve import warmstart as j_ws  # noqa: E402
from dispatches_tpu.utils import checkpoint as j_ckpt  # noqa: E402

from dispatches_tpu_torch.interop import predictor_from_numpy  # noqa: E402
from dispatches_tpu_torch.learn import predictor as t_pred  # noqa: E402
from dispatches_tpu_torch.learn import train as t_train  # noqa: E402
from dispatches_tpu_torch.serve import warmstart as t_ws  # noqa: E402
from dispatches_tpu_torch.utils import checkpoint as t_ckpt  # noqa: E402
from test_torch_stacked import one_torch_thread  # noqa: E402,F401

CPU = "cpu"
D, N, M = 12, 10, 7


def _problem(rows=40, seed=0):
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((rows, D))
    X = V @ rng.standard_normal((D, N))
    Z = np.tanh(V @ rng.standard_normal((D, M)))
    return V, X, Z


def test_init_params_bitwise():
    a = j_pred.init_params(D, N, M, 32, seed=3)
    b = t_pred.init_params(D, N, M, 32, seed=3)
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_forward_matches_jax_on_same_weights(dtype):
    V, X, Z = _problem()
    pred = j_train.fit(V, X, Z, epochs=30)
    vecs = V[:8].astype(dtype)
    want = np.asarray(j_pred.forward({k: jnp.asarray(v) for k, v in pred.params.items()},
                                     jnp.asarray(vecs)))
    got = t_pred.forward(predictor_from_numpy(pred.params, CPU), torch.as_tensor(vecs))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    # the host-side predict of both packages is the same numpy code
    np.testing.assert_array_equal(np.concatenate(t_pred.StartPredictor(pred.params, N, M)
                                                 .predict(V[0])),
                                  np.concatenate(pred.predict(V[0])))


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-30))


def test_fit_agrees_with_jax_as_jax_agrees_with_itself():
    V, X, Z = _problem()
    perm = np.random.default_rng(1).permutation(V.shape[0])
    want = j_train.fit(V, X, Z)
    again = j_train.fit(V[perm], X[perm], Z[perm])
    got = t_train.fit(V, X, Z, device=CPU)
    for k in j_pred.NORM_KEYS:  # data statistics: the same numpy code
        assert got.params[k].tobytes() == want.params[k].tobytes(), k

    def preds(p):
        return np.stack([np.concatenate(p.predict(v)) for v in V])

    pw, pa, pg = preds(want), preds(again), preds(got)
    self_spread = _rel(pw, pa)
    assert 0.0 < self_spread < 5e-4
    assert _rel(pw, pg) <= 3.0 * self_spread
    for k in j_pred.PARAM_KEYS:
        spread = _rel(want.params[k], again.params[k])
        assert _rel(want.params[k], got.params[k]) <= max(3.0 * spread, 1e-4), k
    # and the fit does its job: training error well below the data's scale
    Y = np.concatenate([X, Z], axis=1)
    assert np.sqrt(np.mean((pg - Y) ** 2)) < 0.1 * np.std(Y)


def test_fit_recovers_linear_map_and_drops_nonfinite_rows():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((D, N + M))
    V = rng.standard_normal((64, D))
    Y = V @ A
    V[3, 0] = np.nan
    got = t_train.fit(V, Y[:, :N], Y[:, N:], device=CPU, epochs=300)
    want = j_train.fit(V, Y[:, :N], Y[:, N:], epochs=300)
    keep = np.isfinite(V).all(axis=1)
    pg = np.stack([np.concatenate(got.predict(v)) for v in V[keep]])
    pw = np.stack([np.concatenate(want.predict(v)) for v in V[keep]])
    assert _rel(Y[keep], pg) < 0.05 and _rel(pw, pg) < 1e-3
    with pytest.raises(ValueError, match="at least one finite"):
        t_train.fit(np.full((2, D), np.nan), np.zeros((2, N)), np.zeros((2, M)), device=CPU)


def test_replay_buffer_and_online_trainer_match_jax():
    V, X, Z = _problem(rows=30, seed=4)
    X[5, 0] = np.inf  # dropped by both buffers
    jb, tb = j_train.ReplayBuffer(8), t_train.ReplayBuffer(8)
    jt = j_train.OnlineTrainer(N, M, refit_every=6, capacity=16, min_points=8)
    tt = t_train.OnlineTrainer(N, M, refit_every=6, capacity=16, min_points=8, device=CPU)
    trace = []
    for i in range(len(V)):
        jb.append(V[i], X[i], Z[i])
        tb.append(V[i], X[i], Z[i])
        jt.observe(V[i], X[i], Z[i])
        tt.observe(V[i], X[i], Z[i])
        state = (len(jb), len(tb), jt.due(), tt.due(), jt.ready(), tt.ready(),
                 jt.samples, tt.samples, len(jt.buffer), len(tt.buffer))
        trace.append(state)
        if jt.due():
            jt.refit(epochs=5)
            tt.refit(epochs=5)
            assert (jt.refits, jt.trained_samples) == (tt.refits, tt.trained_samples)
    assert all(s[0::2] == s[1::2] for s in trace)
    for a, b in zip(jb.arrays(), tb.arrays()):
        assert a.tobytes() == b.tobytes()
    # adopt: shape-checked, counters carried
    other = t_train.fit(V[:10], X[:10, :N], Z[:10], device=CPU, epochs=2)
    tt.adopt(other, trained_samples=99)
    assert tt.ready() and tt.trained_samples == 99
    with pytest.raises(ValueError, match="does not match"):
        tt.adopt(t_pred.StartPredictor(other.params, N + 1, M), 1)


def test_warm_index_and_guard_match_jax():
    rng = np.random.default_rng(5)
    ji, ti = j_ws.WarmStartIndex(capacity=6), t_ws.WarmStartIndex(capacity=6)
    base = rng.uniform(1.0, 2.0, 8)
    for i in range(9):  # past capacity: the ring evicts
        vec = base * (1.0 + 0.05 * rng.standard_normal(8))
        x, z = rng.standard_normal(5), rng.standard_normal(3)
        ji.add(("k", i), vec, x, z)
        ti.add(("k", i), vec, x, z)
    assert len(ji) == len(ti) == 6
    assert ti.exact(("k", 1)) is None and ji.exact(("k", 1)) is None
    np.testing.assert_array_equal(ti.exact(("k", 8))[0], ji.exact(("k", 8))[0])
    for q in (base, base * 3.0):
        a, b = ji.nearest(q), ti.nearest(q)
        assert (a is None) == (b is None)
        if a is not None:
            assert all(np.asarray(u).tobytes() == np.asarray(v).tobytes() for u, v in zip(a, b))
    params = {"p": {"b": np.arange(3.0), "a": np.ones(2)}, "fixed": {}}
    tparams = {"p": {"b": torch.arange(3.0, dtype=torch.float64),
                     "a": torch.ones(2, dtype=torch.float64)}, "fixed": {}}
    np.testing.assert_array_equal(t_ws.param_vector(params), j_ws.param_vector(params))
    np.testing.assert_array_equal(t_ws.param_vector(tparams), j_ws.param_vector(params))
    jg, tg = j_ws.MispredictGuard(), t_ws.MispredictGuard()
    for it, cold in ((400, True), (300, False), (500, False), (380, True), (390, False)):
        if cold:
            jg.observe_cold(it)
            tg.observe_cold(it)
        else:
            assert jg.observe_warm(it) == tg.observe_warm(it)
    assert (jg.cold_iters_ema, jg.mispredicts) == (tg.cold_iters_ema, tg.mispredicts)


def test_checkpoint_warm_start_matches_jax(tmp_path):
    from dispatches_tpu import Flowsheet as JF
    from dispatches_tpu_torch.core.graph import Flowsheet as TF

    def nlp(F, xp):
        fs = F(horizon=4)
        fs.add_var("u", lb=0, ub=2.0, scale=10.0)
        fs.add_var("v", shape=(), lb=0, ub=3.0)
        fs.add_eq("bal", lambda v, p: v["u"] - v["v"])
        return fs.compile(objective=lambda v, p: xp.sum(v["u"]))

    jn, tn = nlp(JF, jnp), nlp(TF, torch)
    sol = {"u": np.arange(4.0), "v": np.asarray(1.5)}
    np.testing.assert_array_equal(t_ckpt.solution_x0(sol, tn), j_ckpt.solution_x0(sol, jn))
    assert t_ckpt.solution_x0({"u": np.arange(3.0), "v": 1.0}, tn) is None  # layout guard
    t_ckpt.save_state(tmp_path / "s", {"solution": sol})
    np.testing.assert_array_equal(t_ckpt.warm_start_from(tmp_path / "s", tn),
                                  j_ckpt.warm_start_from(tmp_path / "s", jn))
    assert t_ckpt.warm_start_from(tmp_path / "missing", tn) is None


def test_flags_drive_defaults(monkeypatch):
    monkeypatch.setenv("DISPATCHES_TPU_WARMSTART_PREDICT_HIDDEN", "7")
    monkeypatch.setenv("DISPATCHES_TPU_WARMSTART_PREDICT_REFIT_N", "5")
    monkeypatch.setenv("DISPATCHES_TPU_WARMSTART_PREDICT", "0")
    assert (t_pred.default_hidden(), t_train.default_refit_every(), t_pred.predict_enabled()) == \
        (j_pred.default_hidden(), j_train.default_refit_every(), j_pred.predict_enabled()) == \
        (7, 5, False)
