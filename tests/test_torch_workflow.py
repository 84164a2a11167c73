"""The PyTorch port's workflow layer (``dispatches_tpu_torch.workflow``)
held to the JAX package on the CPU: day slicing, k-means and soft-DTW
clustering, the surrogate MLPs and their training, the six shipped
surrogates (and the port's own copy of their artifacts), the clustering
model's JSON format, ``SimulationData`` and ``ManagedWorkflow``.

The seeded draws differ between the packages by design (``jax.random``
against a CPU ``torch.Generator``): k-means is held from JAX's own
k-means++ seeding (JAX's ``kmeans_fit`` at ``n_iter=0``) and, from the
port's own seeding, on well-separated clusters up to a relabelling; the
MLP trainer is held from JAX's initial weights carried across.  The
reference's own fixtures are not in the repository, so the
``SimulationData`` inputs are a CSV pair this file writes from a seed.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dispatches_tpu import workflow as jw  # noqa: E402
from dispatches_tpu.workflow import clustering as jc  # noqa: E402
from dispatches_tpu.workflow import surrogates as js  # noqa: E402

from dispatches_tpu_torch import workflow as tw  # noqa: E402
from dispatches_tpu_torch.workflow import clustering as tc  # noqa: E402
from dispatches_tpu_torch.workflow import surrogates as ts  # noqa: E402
from test_torch_stacked import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
GOLD = ROOT / "tests" / "data" / "surrogate_goldens"
CPU = "cpu"
KMEANS_TOL = 1e-10
SDTW_TOL, SDTW_GRAD_TOL = 1e-12, 1e-10
MLP_RTOL = 1e-6
APPLY_TOL = 1e-12
GOLD_RTOL, GOLD_ATOL = 2e-4, 1e-3   # tests/test_workflow_surrogates.py's


def _blobs(seed=0, n=40, d=24, levels=(0.2, 0.5, 0.8), scale=0.01):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(m, scale, (n, d)) for m in levels])


def _jax_init(X, k, seed=42):
    return jc.kmeans_fit(X, k, seed=seed, n_iter=0)[0]


# ---------------------------------------------------------------------
# clustering
# ---------------------------------------------------------------------

def test_slice_days_equals_jax():
    rng = np.random.default_rng(3)
    year = rng.random(24 * 9)
    year[24:48] = 0.0
    year[96:120] = 1.0
    for f in (True, False):
        a = jc.slice_days(year, 24, f)
        b = tc.slice_days(year, 24, f)
        assert a[1:] == b[1:]
        assert len(a[0]) == len(b[0])
        for x, y in zip(a[0], b[0]):
            np.testing.assert_array_equal(x, y)


def test_lloyd_from_jax_seeding_equals_jax_and_numpy():
    X = _blobs()
    c0 = _jax_init(X, 3)
    jcent, jlab, jin = jc.kmeans_fit(X, 3, seed=42)
    Xt = torch.as_tensor(X)
    cent, lab, inertia = tc._lloyd(Xt, torch.tensor(c0))
    np.testing.assert_array_equal(lab.numpy(), jlab)
    np.testing.assert_allclose(cent.numpy(), jcent, rtol=KMEANS_TOL, atol=KMEANS_TOL)
    assert float(inertia) == pytest.approx(jin, rel=KMEANS_TOL)
    # a plain numpy Lloyd from the same start
    c = c0.copy()
    for _ in range(300):
        d2 = ((X[:, None, :] - c[None]) ** 2).sum(-1)
        lab_np = d2.argmin(1)
        new = np.stack([X[lab_np == j].mean(0) if np.any(lab_np == j) else c[j]
                        for j in range(3)])
        shift = np.abs(new - c).max()
        c = new
        if shift <= 1e-6:
            break
    d2 = ((X[:, None, :] - c[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(lab.numpy(), d2.argmin(1))
    np.testing.assert_allclose(cent.numpy(), c, rtol=KMEANS_TOL, atol=KMEANS_TOL)
    assert float(inertia) == pytest.approx(d2.min(1).sum(), rel=KMEANS_TOL)


def test_kmeans_with_the_ports_seeding_matches_jax_up_to_labels():
    X = _blobs(seed=1)
    jcent, jlab, jin = jc.kmeans_fit(X, 3, seed=42)
    cent, lab, inertia = tc.kmeans_fit(X, 3, seed=42, device=CPU)
    assert lab.dtype.kind == "i" and cent.shape == (3, 24)
    perm = {int(a): int(b) for a, b in zip(lab, jlab)}
    assert len(perm) == 3 and len(set(perm.values())) == 3
    order = [c for c, _ in sorted(perm.items(), key=lambda kv: kv[1])]
    np.testing.assert_allclose(cent[order], jcent, rtol=KMEANS_TOL, atol=KMEANS_TOL)
    assert inertia == pytest.approx(jin, rel=KMEANS_TOL)
    # tests/test_workflow_surrogates.py's two-block recipe
    rng = np.random.default_rng(0)
    X2 = np.concatenate([rng.normal(0.2, 0.01, (40, 24)), rng.normal(0.8, 0.01, (40, 24))])
    centers, labels, _ = tc.kmeans_fit(X2, 2, seed=42, device=CPU)
    assert sorted(np.round(centers.mean(axis=1), 1)) == [0.2, 0.8]
    assert len(set(labels[:40])) == 1 and len(set(labels[40:])) == 1
    assert labels[0] != labels[-1]
    # the seeding is the generator's, whatever the device
    again = tc.kmeans_fit(X, 3, seed=42, device=CPU)
    np.testing.assert_array_equal(again[0], cent)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tc.kmeans_fit(X, 3)


@pytest.mark.parametrize("gamma", [1.0, 0.1])
def test_soft_dtw_value_and_gradient_match_jax(gamma):
    rng = np.random.default_rng(5)
    x = np.sin(np.linspace(0, 2 * np.pi, 24)) + 0.1 * rng.standard_normal(24)
    y = np.roll(x, 3) + 0.1 * rng.standard_normal(24)
    z = rng.standard_normal(17)  # unequal lengths
    for a, b in ((x, y), (x, x), (y, z)):
        want = float(jc.soft_dtw(a, b, gamma))
        got = tc.soft_dtw(torch.as_tensor(a), torch.as_tensor(b), gamma)
        assert abs(float(got) - want) <= SDTW_TOL * max(1.0, abs(want)), (float(got), want)
        gx_want = np.asarray(jax.grad(lambda u: jc.soft_dtw(u, jnp.asarray(b), gamma))(
            jnp.asarray(a)))
        at = torch.as_tensor(a).requires_grad_(True)
        (gx,) = torch.autograd.grad(tc.soft_dtw(at, torch.as_tensor(b), gamma), at)
        np.testing.assert_allclose(gx.numpy(), gx_want, rtol=0,
                                   atol=SDTW_GRAD_TOL * max(1.0, np.abs(gx_want).max()))
    # broadcast over leading axes = one call per pair
    batch = tc.soft_dtw(torch.as_tensor(np.stack([x, y]))[:, None, :],
                        torch.as_tensor(np.stack([x, y]))[None, :, :], gamma)
    for i, a in enumerate((x, y)):
        for j, b in enumerate((x, y)):
            assert float(batch[i, j]) == pytest.approx(float(jc.soft_dtw(a, b, gamma)),
                                                       rel=SDTW_TOL, abs=SDTW_TOL)


def test_soft_dtw_metric_separates_as_jax():
    """tests/test_workflow_surrogates.py::test_soft_dtw_metric on the port."""
    x = np.sin(np.linspace(0, 2 * np.pi, 24))
    y = np.roll(x, 3)
    z = np.full(24, 0.2)
    dxx, dxy, dxz = (float(tc.soft_dtw(torch.as_tensor(x), torch.as_tensor(s))) for s in (x, y, z))
    assert dxx < dxy < dxz
    rng = np.random.default_rng(0)
    X = np.vstack([x[None, :] + 0.05 * rng.standard_normal((8, 24)),
                   z[None, :] + 0.05 * rng.standard_normal((8, 24))])
    _, labels, inertia = tc.kmeans_fit_softdtw(X, 2, n_iter=4, barycenter_steps=8, device=CPU)
    assert len(set(labels[:8])) == 1 and len(set(labels[8:])) == 1
    assert labels[0] != labels[8]
    assert np.isfinite(inertia) and inertia >= 0.0
    # the block form (RE dispatch||wind features): two 24-h blocks
    _, lab2, _ = tc.kmeans_fit_softdtw(np.hstack([X, X]), 2, n_iter=2, barycenter_steps=4,
                                       block=24, device=CPU)
    assert len(set(lab2[:8])) == 1 and lab2[0] != lab2[8]


# ---------------------------------------------------------------------
# the MLP and its training
# ---------------------------------------------------------------------

def _jax_init_mlp(sizes, seed):
    """JAX's initial weights, carried across as numpy."""
    return [{"W": np.array(p["W"]), "b": np.array(p["b"])}
            for p in js._init_mlp(sizes, jax.random.PRNGKey(seed))]


@pytest.fixture
def jax_init(monkeypatch):
    monkeypatch.setattr(ts, "_init_mlp", _jax_init_mlp)


def _regression(n=40, d=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d))
    return x, np.sin(x @ np.array([[1.0], [-2.0], [0.5]])) + 0.1


def test_mlp_apply_and_params_round_trip_match_jax():
    params = _jax_init_mlp([3, 8, 8, 2], 4)
    x = np.random.default_rng(1).standard_normal((5, 3))
    want = np.asarray(js.mlp_apply(params, x))
    got = ts.mlp_apply(params, x, device=CPU)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=APPLY_TOL, atol=APPLY_TOL)
    back = ts.MLP.from_params(params).to_params()
    for a, b in zip(back, params):
        np.testing.assert_array_equal(a["W"], b["W"])
        np.testing.assert_array_equal(a["b"], b["b"])
    # the port's own initial weights: Glorot-uniform bounds, zero biases
    own = ts._init_mlp([3, 8, 2], 0)
    assert [p["W"].shape for p in own] == [(3, 8), (8, 2)]
    assert np.abs(own[0]["W"]).max() <= np.sqrt(6.0 / 11) and not own[1]["b"].any()
    # JAX-layout weights on a CPU tensor run there; on numpy, on the card
    torch.testing.assert_close(ts.mlp_apply(params, torch.as_tensor(x)), got,
                               rtol=0, atol=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ts.mlp_apply(params, x)


@pytest.mark.parametrize("batch_size", [None, 16], ids=["full", "minibatch"])
def test_train_mlp_from_jax_weights_matches_jax(jax_init, batch_size):
    """60 epochs of Adam from JAX's initial weights: the predictions agree
    within 1e-6 relative (optax's and torch's Adam round in another
    order; the minibatch permutations are numpy's in both packages)."""
    x, y = _regression()
    sizes = [3, 16, 16, 1]
    jp, jloss = js._train_mlp(x, y, sizes, epochs=60, batch_size=batch_size)
    mlp, loss = ts._train_mlp(x, y, sizes, epochs=60, batch_size=batch_size, device=CPU)
    want = np.asarray(js.mlp_apply(jp, x))
    got = ts.mlp_apply(mlp, x).detach().numpy()
    rel = np.abs(got - want).max() / np.abs(want).max()
    print(f"60 epochs, batch {batch_size}: prediction max rel diff {rel:.3e}, "
          f"loss {loss:.6e} vs JAX {jloss:.6e}")
    assert rel <= MLP_RTOL
    assert loss == pytest.approx(jloss, rel=MLP_RTOL)
    with pytest.raises(NotImplementedError, match="item 7"):
        ts._train_mlp(x, y, sizes, epochs=1, mesh=object(), device=CPU)


# ---------------------------------------------------------------------
# the shipped surrogates
# ---------------------------------------------------------------------

_NAMES = ["RE_revenue", "RE_20clusters_dispatch_frequency", "NE_revenue",
          "NE_30clusters_dispatch_frequency", "FE_revenue",
          "FE_20clusters_dispatch_frequency"]


def test_artifacts_are_byte_equal_to_the_jax_packages():
    mine = ROOT / "dispatches_tpu_torch" / "workflow" / "artifacts"
    ref = ROOT / "dispatches_tpu" / "workflow" / "artifacts"
    files = sorted(p.relative_to(ref) for p in ref.rglob("*") if p.is_file())
    assert sorted(p.relative_to(mine) for p in mine.rglob("*") if p.is_file()) == files
    assert len(files) == 13  # manifest, 6 .npz, 6 _params.json
    for f in files:
        assert (mine / f).read_bytes() == (ref / f).read_bytes(), f


def test_pretrained_manifest_complete():
    manifest = tw.pretrained_surrogates()
    assert manifest == jw.pretrained_surrogates()
    assert sorted(manifest) == sorted(_NAMES)
    assert manifest["FE_revenue"]["upstream_nan_weights"]
    with pytest.raises(KeyError):
        tw.load_pretrained_surrogate("nope")


@pytest.mark.parametrize("name", _NAMES)
def test_pretrained_predict_matches_jax_and_goldens(name):
    params, scaling = tw.load_pretrained_surrogate(name)
    jparams, jscaling = jw.load_pretrained_surrogate(name)
    assert scaling == jscaling
    gold = ROOT / "tests" / "data" / "surrogate_goldens" / f"{name}_golden.npz"
    x = np.load(gold)["x"] if gold.is_file() else np.random.default_rng(0).random((4, 5))
    got = tw.TrainNNSurrogates.predict(params, scaling, x, device=CPU)
    want = np.asarray(jw.TrainNNSurrogates.predict(jparams, jscaling, x))
    np.testing.assert_allclose(got, want, rtol=APPLY_TOL, atol=APPLY_TOL, equal_nan=True)
    if name == "FE_revenue":  # the upstream all-NaN output layer, kept
        assert np.isnan(got).all()
        return
    np.testing.assert_allclose(got, np.load(gold)["y"], rtol=GOLD_RTOL, atol=GOLD_ATOL)


# ---------------------------------------------------------------------
# SimulationData, the trainers and the clustering model
# ---------------------------------------------------------------------

N_SIMS, N_DAYS = 4, 12


@pytest.fixture(scope="module")
def sim_files(tmp_path_factory):
    """A dispatch CSV (one row per run ``sim_<i>``, hourly columns), a
    sweep-input CSV, a revenue CSV and an RTS-GMLC-style wind CSV."""
    d = tmp_path_factory.mktemp("simdata")
    rng = np.random.default_rng(11)
    hours = 24 * N_DAYS
    disp = 200.0 + 200.0 * rng.random((N_SIMS, hours))
    disp[0, :24] = 400.0   # a full day
    disp[1, 24:48] = 0.0   # a zero day
    names = [f"sim_{i}" for i in range(N_SIMS)]
    with open(d / "dispatch.csv", "w") as f:
        f.write("run," + ",".join(str(h) for h in range(hours)) + "\n")
        for n, row in zip(names, disp):
            f.write(n + "," + ",".join(repr(float(v)) for v in row) + "\n")
    inp = np.column_stack([np.arange(N_SIMS), 15 + rng.random(N_SIMS),
                           0.1 + 0.4 * rng.random(N_SIMS), 50 + rng.random(N_SIMS),
                           rng.random(N_SIMS)])
    np.savetxt(d / "input.csv", inp, delimiter=",", comments="",
               header="idx,pmax,pmin_frac,storage,cost")
    with open(d / "rev.csv", "w") as f:
        f.write("run,revenue\n")
        for n in names:
            f.write(f"{n},{1e5 * rng.random():.6f}\n")
    wind = rng.random(hours) * 847.0
    np.savetxt(d / "wind.csv", wind[:, None], delimiter=",", comments="",
               header="303_WIND_1")
    return d


@pytest.mark.parametrize("case", ["NE", "RE", "FE"])
def test_simulation_data_equals_jax(sim_files, case):
    d = sim_files
    a = jw.SimulationData(d / "dispatch.csv", d / "input.csv", N_SIMS, case)
    b = tw.SimulationData(d / "dispatch.csv", d / "input.csv", N_SIMS, case)
    assert a._index == b._index == list(range(N_SIMS))
    for f in ("_dispatch_dict", "_input_data_dict"):
        assert getattr(a, f).keys() == getattr(b, f).keys()
        for k in getattr(a, f):
            np.testing.assert_array_equal(getattr(a, f)[k], getattr(b, f)[k])
    sa, sb = a._scale_data(), b._scale_data()
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k])
    assert a.read_rev_data(d / "rev.csv") == b.read_rev_data(d / "rev.csv")
    for x, y in zip(a.read_wind_data(d / "wind.csv"), b.read_wind_data(d / "wind.csv")):
        np.testing.assert_array_equal(x, y)
    ta = jw.TimeSeriesClustering(2, a, filter_opt=True)._transform_data()
    tb = tw.TimeSeriesClustering(2, b, filter_opt=True)._transform_data()
    np.testing.assert_array_equal(ta, tb)
    with pytest.raises(TypeError):
        tw.SimulationData(d / "dispatch.csv", d / "input.csv", "3", case)
    with pytest.raises(ValueError):
        tw.SimulationData(d / "dispatch.csv", d / "input.csv", 3, "XX")


def test_clustering_model_json_is_read_by_both_packages(sim_files, tmp_path):
    d = sim_files
    sd = tw.SimulationData(d / "dispatch.csv", d / "input.csv", N_SIMS, "NE")
    tsc = tw.TimeSeriesClustering(3, sd, filter_opt=True, device=CPU)
    model = tsc.clustering_data()
    assert model["cluster_centers_"].shape == (3, 24) and model["metric"] == "euclidean"
    path = tmp_path / "model.json"
    tsc.save_clustering_model(model, path)
    jtsc = jw.TimeSeriesClustering(3, jw.SimulationData(d / "dispatch.csv", d / "input.csv",
                                                        N_SIMS, "NE"))
    jpath = tmp_path / "jmodel.json"
    jtsc.save_clustering_model(model, jpath)
    assert path.read_bytes() == jpath.read_bytes()
    for loader in (tw.TimeSeriesClustering.load_clustering_model,
                   jw.TimeSeriesClustering.load_clustering_model):
        loaded = loader(path)
        assert loaded["n_clusters"] == 3
        np.testing.assert_array_equal(loaded["cluster_centers_"], model["cluster_centers_"])
    assert tsc.get_cluster_centers(path).keys() == {0, 1, 2}
    with pytest.raises(ValueError):
        tw.TimeSeriesClustering(3, sd, metric="cosine")
    with pytest.raises(TypeError):
        tw.TimeSeriesClustering(3.0, sd)


def test_frequency_and_revenue_trainers_match_jax(sim_files, tmp_path, jax_init):
    """Labels, scaling metadata and trained weights (JAX's initial
    weights carried across), then the save/load/predict round trip."""
    d = sim_files
    jsd = jw.SimulationData(d / "dispatch.csv", d / "input.csv", N_SIMS, "NE")
    tsd = tw.SimulationData(d / "dispatch.csv", d / "input.csv", N_SIMS, "NE")
    centers = np.linspace(0.1, 0.9, 3)[:, None] * np.ones((1, 24))
    cm = tmp_path / "cm.json"
    cm.write_text(json.dumps({"n_clusters": 3, "metric": "euclidean",
                              "model_params": {"cluster_centers_": centers.tolist()}}))
    for kind, data_file, size in (("frequency", cm, [4, 8, 5]),
                                  ("revenue", d / "rev.csv", [4, 8, 1])):
        jt = jw.TrainNNSurrogates(jsd, data_file)
        tt = tw.TrainNNSurrogates(tsd, data_file, device=CPU)
        train = f"train_NN_{kind}"
        jp = getattr(jt, train)(size, epochs=60)
        tp = getattr(tt, train)(size, epochs=60)
        if kind == "frequency":
            assert tt._generate_label_data() == jt._generate_label_data()
        for key in ("xm_inputs", "xstd_inputs", "xmin", "xmax", "y_mean", "y_std"):
            assert tt._model_params[key] == jt._model_params[key], key
        x = np.array([tsd._input_data_dict[i] for i in range(N_SIMS)])
        want = np.asarray(jw.TrainNNSurrogates.predict(jp, jt._model_params, x))
        got = tw.TrainNNSurrogates.predict(tp, tt._model_params, x, device=CPU)
        np.testing.assert_allclose(got, want, rtol=MLP_RTOL, atol=MLP_RTOL * np.abs(want).max())
        mpath, ppath = tmp_path / f"{kind}.npz", tmp_path / f"{kind}.json"
        tt.save_model(tp, mpath, ppath)
        for loader in (tw.TrainNNSurrogates.load_model, jw.TrainNNSurrogates.load_model):
            loaded, scaling = loader(mpath, ppath)
            assert scaling == json.loads(json.dumps(tt._model_params))
            np.testing.assert_array_equal(
                tw.TrainNNSurrogates.predict(loaded, scaling, x, device=CPU), got)


def test_managed_workflow(tmp_path):
    wf = tw.ManagedWorkflow("test-wf", "ws")
    assert wf.name == "test-wf" and wf.workspace_name == "ws"
    assert wf.get_dataset("null") is None
    (tmp_path / "a.csv").write_text("x\n")
    ds = wf.get_dataset("rts-gmlc", path=str(tmp_path))
    assert isinstance(ds, tw.Dataset)
    assert ds.meta["directory"] == tmp_path and ds.meta["files"] == ["a.csv"]
    assert wf.get_dataset("rts-gmlc") is ds
    jds = jw.ManagedWorkflow("j", "ws").get_dataset("rts-gmlc", path=str(tmp_path))
    assert str(ds) == str(jds)
    with pytest.raises(KeyError):
        tw.DatasetFactory("unknown-type")
    with pytest.raises(FileNotFoundError):
        tw.DatasetFactory("rts-gmlc").create(path=str(tmp_path / "missing"))
