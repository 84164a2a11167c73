"""The PyTorch port's utility layer held to the JAX package on the CPU:
cash flows (``utils/cashflow.py``) at tests/test_utils.py's anchors, the
ARMA synthetic histories and the RAVEN ARMA ROM (``utils/synhist.py``).

The seeded draws are the one place the packages differ by design: the
JAX package draws with ``jax.random``, the port from a CPU
``torch.Generator``.  So the ARMA filter is held on JAX's own
innovations, and the ROM's k-means on JAX's own k-means++ seeding (JAX's
``kmeans_fit`` at ``n_iter=0``), where everything downstream must match;
with the port's own seeding the fitted clusters must agree up to a
relabelling.  The ROM artifact is written by the test from a seed, in
the schema ``RavenARMAROM.train_from_artifact`` parses.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from dispatches_tpu import utils as ju  # noqa: E402
from dispatches_tpu.workflow.clustering import kmeans_fit as j_kmeans_fit  # noqa: E402

from dispatches_tpu_torch import utils as tu  # noqa: E402
from dispatches_tpu_torch.utils import synhist as tsyn  # noqa: E402
from dispatches_tpu_torch.workflow import clustering as tclu  # noqa: E402
from test_torch_stacked import one_torch_thread  # noqa: E402,F401

CPU = "cpu"
CASH_TOL = 1e-12
ARMA_TOL = 1e-12
ROM_TOL = 1e-10


# ---------------------------------------------------------------------
# cash flows
# ---------------------------------------------------------------------

_IRR_RATE = 0.08
_CASES = {
    "annuity": np.array([0.0, 100.0, 100.0, 100.0]),
    "irr8": np.array([-1000.0] + [1000 * _IRR_RATE / (1 - (1 + _IRR_RATE) ** -10)] * 10),
    "pi": np.array([-1000.0, 600.0, 600.0]),
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_npv_irr_pi_match_jax(name):
    cash = _CASES[name]
    for fn, args in (("npv", (0.1,)), ("profitability_index", (0.1,)), ("irr", ())):
        want = float(getattr(ju, fn)(cash, *args))
        got = getattr(tu, fn)(cash, *args, device=CPU)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        np.testing.assert_allclose(float(got), want, rtol=CASH_TOL, atol=CASH_TOL, err_msg=fn)
    # tests/test_utils.py's anchors
    if name == "annuity":
        assert float(tu.npv(cash, 0.1, device=CPU)) == pytest.approx(
            100 * (1 - 1.1**-3) / 0.1, rel=1e-12)
    if name == "irr8":
        assert float(tu.irr(cash, device=CPU)) == pytest.approx(_IRR_RATE, abs=1e-8)
    if name == "pi":
        assert float(tu.profitability_index(cash, 0.1, device=CPU)) == pytest.approx(
            (600 / 1.1 + 600 / 1.21) / 1000, rel=1e-12)


def test_irr_zero_derivative_guard_and_clip_match_jax():
    """A flat cash array (NPV' = 0 everywhere: the zero-step guard) and one
    whose Newton steps run past the clip."""
    for cash in (np.zeros(4), np.array([-1.0, 1e6, 0.0, 0.0]), np.array([10.0, 10.0])):
        want = float(ju.irr(cash))
        got = float(tu.irr(cash, device=CPU))
        assert abs(got - want) <= CASH_TOL * max(1.0, abs(want)), (cash, got, want)


def test_macrs_and_build_cashflows_match_jax():
    for yrs in (3, 5, 7, 10, 15, 20):
        got = tu.macrs_amortization(1.0, yrs, device=CPU).numpy()
        np.testing.assert_array_equal(got, np.asarray(ju.macrs_amortization(1.0, yrs)))
        assert got.sum() == pytest.approx(1.0, abs=1e-3)
    for life, amort in ((10, 5), (3, 7), (30, None)):
        settings = (ju.CashFlowSettings(discount_rate=0.1, tax_rate=0.25, project_life=life),
                    tu.CashFlowSettings(discount_rate=0.1, tax_rate=0.25, project_life=life))
        want = np.asarray(ju.build_cashflows(
            [ju.Capex("plant", 1000.0, amortize_years=amort)],
            [ju.Recurring("sales", 300.0), ju.Recurring("om", -40.0)], settings[0]))
        got = tu.build_cashflows(
            [tu.Capex("plant", 1000.0, amortize_years=amort)],
            [tu.Recurring("sales", 300.0), tu.Recurring("om", -40.0)], settings[1],
            device=CPU).numpy()
        np.testing.assert_allclose(got, want, rtol=CASH_TOL, atol=CASH_TOL)
    # tests/test_utils.py's tax-shield anchor
    cash = tu.build_cashflows([tu.Capex("plant", 1000.0, amortize_years=5)],
                              [tu.Recurring("sales", 300.0)],
                              tu.CashFlowSettings(discount_rate=0.1, tax_rate=0.25,
                                                  project_life=10), device=CPU)
    assert float(cash[0]) == -1000.0
    assert float(cash[1]) == pytest.approx(300 * 0.75 + 0.25 * 0.2 * 1000)


def test_cashflow_is_differentiable_and_follows_the_device_rule():
    cash = torch.tensor([-1000.0, 600.0, 600.0], dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(tu.npv(cash, 0.1), cash)
    np.testing.assert_allclose(g.numpy(), [1.0, 1 / 1.1, 1 / 1.21], rtol=1e-15)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tu.npv(np.ones(3), 0.1)


# ---------------------------------------------------------------------
# ARMA synthetic histories
# ---------------------------------------------------------------------

def _signal():
    rng = np.random.default_rng(0)
    t = np.arange(24 * 200)
    return 30 + 10 * np.sin(2 * np.pi * t / 24) + rng.normal(0, 2, len(t))


@pytest.mark.parametrize("p,q", [(2, 0), (0, 0), (3, 0)])
def test_arma_fit_equals_jax(p, q):
    a = ju.ARMAModel.fit(_signal(), p=p, q=q, period=24)
    b = tu.ARMAModel.fit(_signal(), p=p, q=q, period=24)
    np.testing.assert_array_equal(a.phi, b.phi)
    np.testing.assert_array_equal(a.theta, b.theta)
    np.testing.assert_array_equal(a.seasonal_mean, b.seasonal_mean)
    assert a.sigma == b.sigma


@pytest.mark.parametrize("phi,theta", [([0.5, -0.2], []), ([0.6], [0.3, -0.1]), ([], [0.4])],
                         ids=["ar2", "arma12", "ma1"])
def test_arma_filter_on_jax_innovations(phi, theta):
    """The port's filter over the innovations JAX's ``sample`` draws
    (``split(PRNGKey(seed), n)``, then ``sigma * normal(key_i, (T + q,))``)
    reproduces JAX's sample within 1e-12."""
    mean = [30.0, 35.0, 40.0, 38.0, 33.0, 31.0]
    jm = ju.ARMAModel(phi=phi, theta=theta, sigma=1.5, seasonal_mean=mean)
    n, n_steps, seed = 5, 40, 3
    want = np.asarray(jm.sample(jax.random.PRNGKey(seed), n_steps, n))
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    e = np.stack([np.asarray(1.5 * jax.random.normal(k, (n_steps + len(theta),)))
                  for k in keys])
    got = tsyn._arma_filter(torch.as_tensor(e), phi, theta, mean, n_steps).numpy()
    assert got.shape == want.shape == (n, n_steps)
    np.testing.assert_allclose(got, want, rtol=0, atol=ARMA_TOL * np.abs(want).max())
    # the port's own sample is that filter over its own seeded draws
    tm = tu.ARMAModel(phi=phi, theta=theta, sigma=1.5, seasonal_mean=mean)
    own = tm.sample(seed, n_steps, n, device=CPU)
    e_own = tm.innovations(seed, n_steps, n)
    torch.testing.assert_close(
        own, tsyn._arma_filter(e_own, phi, theta, mean, n_steps), rtol=0, atol=0)
    torch.testing.assert_close(own, tm.sample(seed, n_steps, n, device=CPU), rtol=0, atol=0)


def test_generate_syn_realizations_shapes():
    model = tu.ARMAModel.fit(_signal(), p=2, q=0, period=24)
    reals = tu.generate_syn_realizations(model, 4, 24 * 7, seed=1, device=CPU)
    assert [r["realization"] for r in reals] == [0, 1, 2, 3]
    sample = reals[0]["LMP"]
    assert sample.shape == (24 * 7,) and np.isfinite(sample).all()
    assert abs(sample.mean() - 30) < 3


def test_synthetic_histories_follow_the_device_rule():
    """Without ``device=`` the ARMA filter runs on the card, and raises
    when there is none."""
    model = tu.ARMAModel.fit(_signal(), p=2, q=0, period=24)
    assert model.sample(0, 24, device=CPU).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.sample(0, 24)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tu.generate_syn_realizations(model, 2, 24)


# ---------------------------------------------------------------------
# the RAVEN ARMA ROM, on an artifact written here
# ---------------------------------------------------------------------

_XML = """<Simulation>
  <Files>
    <Input name="input" type="">pointer.csv</Input>
  </Files>
  <Models>
    <ROM name="arma" subType="ARMA">
      <Fourier>8760, 168, 24, 12</Fourier>
      <P>0</P>
      <Q>1</Q>
      <Segment grouping="interpolate">
        <subspace pivotLength="24" shift="zero">Time</subspace>
      </Segment>
    </ROM>
  </Models>
  <PostProcessor name="classifier">
    <KDD><n_clusters>3</n_clusters></KDD>
  </PostProcessor>
</Simulation>
"""


def _write_artifact(root):
    """Two trained years and an anchor year pointing at the second year's
    file; each day is one of three well-separated shapes plus noise."""
    rng = np.random.default_rng(7)
    h = np.arange(24)
    shapes = np.stack([20 + 2 * np.sin(2 * np.pi * h / 24),
                       60 + 15 * np.sin(2 * np.pi * (h - 6) / 24),
                       120 + 30 * np.exp(-((h - 17) / 3.0) ** 2)])
    (root / "ARMA_train.xml").write_text(_XML)
    rows = ["Year,filename"]
    for year in (2020, 2021):
        days = rng.integers(0, 3, 365)
        prices = (shapes[days] + rng.normal(0, 1.5, (365, 24))).ravel()
        name = f"Price_{year}.csv"
        np.savetxt(root / name, np.column_stack([np.arange(len(prices)), prices]),
                   delimiter=",", header="Time,price", comments="")
        rows.append(f"{year},{name}")
    rows.append("2030,Price_2021.csv")
    (root / "pointer.csv").write_text("\n".join(rows) + "\n")
    return root


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    return _write_artifact(tmp_path_factory.mktemp("arma"))


@pytest.fixture(scope="module")
def j_rom(artifact):
    return ju.RavenARMAROM.train_from_artifact(artifact)


def _jax_seeding(X, k, generator):
    """JAX's own k-means++ seeding of ``X`` (its ``kmeans_fit`` stops
    before the first Lloyd step at ``n_iter=0``)."""
    centers0, _, _ = j_kmeans_fit(X.cpu().numpy(), k, seed=42, n_iter=0)
    return torch.tensor(centers0, device=X.device)


def test_rom_trained_on_jax_seeding_equals_jax(artifact, j_rom, monkeypatch):
    monkeypatch.setattr(tclu, "_kmeanspp_init", _jax_seeding)
    rom = tu.RavenARMAROM.train_from_artifact(artifact, device=CPU)
    assert rom.years == j_rom.years == [2020, 2021, 2030]
    assert rom.periods == j_rom.periods and rom.n_clusters == j_rom.n_clusters == 3
    for y in rom.years:
        np.testing.assert_array_equal(rom.cluster_labels[y], j_rom.cluster_labels[y])
        np.testing.assert_array_equal(rom.rep_day[y], j_rom.rep_day[y])
        for f in ("fourier_coef", "sorted_resid", "sorted_price", "theta", "sigma"):
            np.testing.assert_allclose(getattr(rom, f)[y], getattr(j_rom, f)[y],
                                       rtol=ROM_TOL, atol=ROM_TOL, err_msg=f"{f} {y}")
    # numpy default_rng on both sides: the sampled histories agree too
    a = rom.generateSyntheticHistory("price", [2020, 2025], seed=5)
    b = j_rom.generateSyntheticHistory("price", [2020, 2025], seed=5)
    assert a["weights_days"] == b["weights_days"]
    assert a["cluster_map"].keys() == b["cluster_map"].keys()
    for y in (2020, 2025):
        assert {c: list(map(int, d)) for c, d in a["cluster_map"][y].items()} == \
            {c: list(map(int, d)) for c, d in b["cluster_map"][y].items()}
        got = np.array([list(v.values()) for v in a["LMP"][y].values()])
        want = np.array([list(v.values()) for v in b["LMP"][y].values()])
        np.testing.assert_allclose(got, want, rtol=ROM_TOL, atol=ROM_TOL)
    with pytest.raises(KeyError):
        rom.generateSyntheticHistory("bogus", [2020])
    with pytest.raises(ValueError):
        rom.generateSyntheticHistory("price", [2040])


def test_rom_with_the_ports_seeding_matches_jax_up_to_labels(artifact, j_rom):
    rom = tu.RavenARMAROM.train_from_artifact(artifact, device=CPU)
    for y in rom.years:
        lt, lj = rom.cluster_labels[y], j_rom.cluster_labels[y]
        perm = {int(a): int(b) for a, b in zip(lt, lj)}
        assert len(perm) == 3 and len(set(perm.values())) == 3  # a relabelling
        order = [c for c, _ in sorted(perm.items(), key=lambda kv: kv[1])]
        for f in ("theta", "sigma"):
            np.testing.assert_allclose(getattr(rom, f)[y][order], getattr(j_rom, f)[y],
                                       rtol=ROM_TOL, atol=ROM_TOL, err_msg=f"{f} {y}")
        np.testing.assert_array_equal(rom.rep_day[y][order], j_rom.rep_day[y])


def test_generate_clustered_realizations_shapes(artifact):
    rom = tu.RavenARMAROM.train_from_artifact(artifact, device=CPU)
    one = tu.generate_clustered_realizations(rom, [2020], n_days=365, seed=7)
    assert len(one[2020]) == 365 * 24 and np.isfinite(one[2020]).all()
    two = tu.generate_clustered_realizations(rom, [2020, 2021], n_scenarios=2, n_days=10)
    assert sorted(two) == [1, 2] and sorted(two[1]) == [2020, 2021]
    assert len(two[2][2021]) == 240
    assert not np.allclose(two[1][2020], two[2][2020])
    with pytest.raises(ValueError, match="n_days"):
        tu.generate_clustered_realizations(rom, [2020], n_days=400)
