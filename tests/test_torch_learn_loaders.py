"""Small host-side pieces of modules the port already had, held to the
JAX package bitwise on the CPU:

* ``learn.train.fit_from_store`` and ``fit_from_index``: the triples they
  hand to ``fit`` (from ``ResultStore.training_pairs`` and
  ``WarmStartIndex.export_pairs``) are JAX's, byte for byte; the port's
  fit then runs; an empty index raises as in JAX.
* ``learn.predictor.snap_to_bounds`` on ``tests/test_learn.py``'s case
  and on seeded boxes.
* ``utils.checkpoint.save_solution``: the port's file, read by JAX's
  ``load_state``, holds what JAX's ``save_solution`` writes for the same
  solve (tensors brought to the host).
* ``case_studies/renewables/load_parameters.py``'s loaders: the synthetic
  wind and price series without a data directory, and the SRW, CSV and
  ``.npy`` paths on files this test writes from a seed, all bitwise;
  ``default_input_params`` equal key by key.  The CSV's prices are
  written with two decimals, as market LMPs are.  Written with 17
  significant digits, 17% of them parse apart (by at most one ulp of the
  column's largest price): the JAX package reads
  the CSV with pandas, whose default float parser is not correctly
  rounded, and the port with Python's ``float``, which is
  (``test_full_precision_prices_parse_correctly_rounded``).
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu import Flowsheet as JFlowsheet  # noqa: E402
from dispatches_tpu.case_studies.renewables import load_parameters as jlp  # noqa: E402
from dispatches_tpu.learn import predictor as jpred  # noqa: E402
from dispatches_tpu.learn import train as jtrain  # noqa: E402
from dispatches_tpu.serve.warmstart import WarmStartIndex as JIndex  # noqa: E402
from dispatches_tpu.utils import checkpoint as jck  # noqa: E402

from dispatches_tpu_torch.case_studies.renewables import load_parameters as tlp  # noqa: E402
from dispatches_tpu_torch.core.graph import Flowsheet as TFlowsheet  # noqa: E402
from dispatches_tpu_torch.learn import predictor as tpred  # noqa: E402
from dispatches_tpu_torch.learn import train as ttrain  # noqa: E402
from dispatches_tpu_torch.serve.warmstart import WarmStartIndex as TIndex  # noqa: E402
from dispatches_tpu_torch.utils import checkpoint as tck  # noqa: E402

D, N, M = 3, 5, 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one intra-op thread, as the other test_torch_* modules."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# learn
# ---------------------------------------------------------------------------


def _capture(monkeypatch, module):
    seen = []

    def fake_fit(vecs, xs, zs, **kw):
        seen.append((vecs, xs, zs, kw))
        return "fitted"

    monkeypatch.setattr(module, "fit", fake_fit)
    return seen


def test_fit_from_store_hands_fit_the_stores_pairs(monkeypatch):
    rng = np.random.default_rng(11)
    pairs = (rng.standard_normal((9, D)), rng.standard_normal((9, N)),
             rng.standard_normal((9, M)))
    store = SimpleNamespace(training_pairs=lambda: pairs)
    t_seen, j_seen = _capture(monkeypatch, ttrain), _capture(monkeypatch, jtrain)
    assert ttrain.fit_from_store(store, hidden=4, epochs=3) == "fitted"
    assert jtrain.fit_from_store(store, hidden=4, epochs=3) == "fitted"
    for a, b in zip(t_seen[0][:3], j_seen[0][:3]):
        assert _same(a, b)
    assert t_seen[0][3] == j_seen[0][3] == {"hidden": 4, "epochs": 3}


def _filled(Index, seed=12):
    idx = Index()
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((D, N + M)).astype(np.float32)
    for i in range(12):
        v = rng.standard_normal(D)
        y = (v @ A).astype(np.float32)
        idx.add(("k", i), v, y[:N], y[N:])
    return idx


def test_fit_from_index_hands_fit_the_indexs_pairs(monkeypatch):
    t_seen, j_seen = _capture(monkeypatch, ttrain), _capture(monkeypatch, jtrain)
    ttrain.fit_from_index(_filled(TIndex), hidden=4)
    jtrain.fit_from_index(_filled(JIndex), hidden=4)
    for a, b in zip(t_seen[0][:3], j_seen[0][:3]):
        assert _same(a, b)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="empty"):
        ttrain.fit_from_index(TIndex())


def test_fit_from_index_fits_on_the_port():
    pred = ttrain.fit_from_index(_filled(TIndex), hidden=4, epochs=300, device="cpu")
    assert (pred.n, pred.m, pred.d) == (N, M, D)
    x0, z0 = pred.predict(np.asarray([0.2, -0.4, 0.1], np.float32))
    assert x0.shape == (N,) and z0.shape == (M,) and np.all(np.isfinite(x0))
    import dispatches_tpu_torch.learn as tlearn
    assert tlearn.fit_from_store is ttrain.fit_from_store
    assert tlearn.snap_to_bounds is tpred.snap_to_bounds


def test_snap_to_bounds_matches_jax():
    lb = np.asarray([0.0, -1.0, -np.inf, 0.0], np.float32)
    ub = np.asarray([2.0, 1.0, np.inf, 0.0], np.float32)
    x = np.asarray([1e-4, 1.00005, 123.4, 0.5], np.float32)
    out = tpred.snap_to_bounds(x, lb, ub)
    np.testing.assert_array_equal(out, np.asarray([0.0, 1.0, 123.4, 0.0], np.float32))
    rng = np.random.default_rng(13)
    lo = rng.uniform(-5.0, 5.0, 256).astype(np.float32)
    hi = lo + rng.uniform(0.0, 3.0, 256).astype(np.float32)
    lo[::17], hi[::23] = -np.inf, np.inf
    xs = np.where(rng.random(256) < 0.5, lo, hi) + rng.normal(0.0, 2e-3, 256)
    for eps in (1e-3, 1e-2):
        assert _same(tpred.snap_to_bounds(xs, lo, hi, eps), jpred.snap_to_bounds(xs, lo, hi, eps))


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------


def _small(Flowsheet):
    fs = Flowsheet(horizon=3)
    fs.add_var("a", lb=0.0, ub=3.0, init=1.0, scale=2.0)
    fs.add_var("b", shape=(), init=0.5)
    fs.add_var("c", init=2.0)
    fs.fix("c", 2.5)
    fs.add_eq("e", lambda v, p: v["a"] - v["b"])
    return fs.compile()


def test_save_solution_writes_jaxs_file(tmp_path):
    rng = np.random.default_rng(14)
    tn, jn = _small(TFlowsheet), _small(JFlowsheet)
    x, lam, zl, zu = (rng.standard_normal(k) for k in (tn.n, 3, tn.n, tn.n))
    t = {k: torch.tensor(v) for k, v in dict(x=x, lam=lam, z_l=zl, z_u=zu).items()}
    t_res = SimpleNamespace(**t, obj=torch.tensor(1.25, dtype=torch.float64),
                            kkt_error=torch.tensor(3e-9, dtype=torch.float64))
    j_res = SimpleNamespace(x=x, lam=lam, z_l=zl, z_u=zu, obj=np.float64(1.25),
                            kkt_error=np.float64(3e-9))
    tck.save_solution(tmp_path / "port", tn, t_res)
    jck.save_solution(tmp_path / "jax", jn, j_res)
    got, want = jck.load_state(tmp_path / "port"), jck.load_state(tmp_path / "jax")
    assert set(got) == set(want) == {"solution", "duals", "meta"}
    for grp in want:
        assert set(got[grp]) == set(want[grp])
        for k in want[grp]:
            assert _same(got[grp][k], want[grp][k]), (grp, k)
    # and the port reads it back as a warm start
    assert tck.load_state(tmp_path / "jax")["meta"]["obj"] == 1.25


# ---------------------------------------------------------------------------
# renewables data loaders
# ---------------------------------------------------------------------------


@pytest.fixture
def no_data(monkeypatch):
    monkeypatch.delenv("DISPATCHES_TPU_DATA", raising=False)
    monkeypatch.setattr(jlp, "_DEFAULT_DATA_DIRS", ["", str(_missing())])


def _missing():
    from pathlib import Path
    return Path(__file__).parent / "data" / "no_such_renewables_dir"


def test_synthetic_series_match_jax(no_data):
    assert tlp.data_dir() is None and jlp.data_dir() is None
    assert _same(tlp.load_wind_speeds(), jlp.load_wind_speeds())
    assert _same(tlp.load_da_lmps(), jlp.load_da_lmps())
    assert _same(tlp.load_da_lmps(cap=40.0), jlp.load_da_lmps(cap=40.0))
    assert tlp.load_rts_test_prices() is None and jlp.load_rts_test_prices() is None
    _same_params(tlp.default_input_params(), jlp.default_input_params())


def _same_params(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert _same(got[k], v), k
        else:
            assert got[k] == v and type(got[k]) is type(v), k


def _write_data(root, seed=15, price=lambda v: f"{v:.2f}"):
    """An SRW file, the RTS-GMLC dispatch CSV (prices formatted by
    ``price``) and the price .npy, written from a seed in the formats the
    loaders read."""
    from datetime import datetime, timedelta

    rng = np.random.default_rng(seed)
    (root / "data").mkdir(parents=True)
    (root / "tests").mkdir()
    speeds = rng.uniform(0.0, 25.0, 8760)
    lines = ["site,meta", "wind toolkit", "Temperature,Pressure,Speed,Direction",
             "C,atm,m/s,deg", "100,100,100,100"]
    lines += [f"{t:.3f},{p:.6f},{float(s)!r},{d:.1f}" for t, p, s, d in
              zip(rng.uniform(-10, 30, 8760), rng.uniform(0.9, 1.0, 8760), speeds,
                  rng.uniform(0, 360, 8760))]
    (root / "data" / "site.srw").write_text("\n".join(lines) + "\n")
    start = datetime(2020, 1, 1, 12)   # a day before the kept window, Feb 29 inside
    rows = ["Time,302_DALMP,303_DALMP"]
    for i in range(366 * 24 + 36):
        t = start + timedelta(hours=i)
        rows.append(f"{t:%Y-%m-%d %H:%M:%S},{price(float(rng.uniform(0, 90)))},"
                    f"{price(float(rng.uniform(-5.0, 350.0)))}")
    (root / "data" / "Wind_Thermal_Dispatch.csv").write_text("\n".join(rows) + "\n")
    with open(root / "tests" / "rts_results_all_prices.npy", "wb") as f:
        np.save(f, rng.uniform(0, 1, 8736))
        np.save(f, rng.uniform(-10.0, 400.0, 8736))
    return speeds


def test_file_loaders_match_jax(tmp_path, monkeypatch):
    pytest.importorskip("pandas")   # the JAX package reads the CSV with pandas
    speeds = _write_data(tmp_path)
    monkeypatch.setenv("DISPATCHES_TPU_DATA", str(tmp_path))
    monkeypatch.setattr(jlp, "_DEFAULT_DATA_DIRS", [str(tmp_path)])
    assert tlp.data_dir() == jlp.data_dir() == tmp_path
    w = tlp.load_wind_speeds()
    assert _same(w, jlp.load_wind_speeds()) and _same(w, speeds)
    assert _same(tlp.srw_to_wind_speeds(tmp_path / "data" / "site.srw"), speeds)
    lmps = tlp.load_da_lmps()
    assert lmps.shape == (8736,) and float(lmps.max()) <= 200.0
    assert _same(lmps, jlp.load_da_lmps())
    assert _same(tlp.load_da_lmps(cap=250.0), jlp.load_da_lmps(cap=250.0))
    assert _same(tlp.load_rts_test_prices(), jlp.load_rts_test_prices())
    _same_params(tlp.default_input_params(), jlp.default_input_params())


def test_full_precision_prices_parse_correctly_rounded(tmp_path, monkeypatch):
    pytest.importorskip("pandas")
    _write_data(tmp_path, price=repr)
    monkeypatch.setenv("DISPATCHES_TPU_DATA", str(tmp_path))
    monkeypatch.setattr(jlp, "_DEFAULT_DATA_DIRS", [str(tmp_path)])
    got, want = tlp.load_da_lmps(cap=1e9), jlp.load_da_lmps(cap=1e9)
    import csv
    from datetime import datetime
    with open(tmp_path / "data" / "Wind_Thermal_Dispatch.csv") as f:
        rows = list(csv.reader(f))[1:]
    hours = tlp._dispatch_hours()
    kept = [float(r[2]) for r in rows if datetime.fromisoformat(r[0]) in hours]
    assert _same(got, np.asarray(kept))          # correctly rounded, row order kept
    gap = np.abs(got - want)
    print(f"pandas vs correctly rounded: {int(np.count_nonzero(gap))} of {gap.size} apart, "
          f"at most {gap.max():.3e} $/MWh")
    assert gap.max() <= np.spacing(np.max(np.abs(want)))   # one ulp at the column's scale
