"""The PyTorch port's lowering, models and LP data held to the JAX
package on the main-path model (the 24-h wind+battery price-taker LP):
layout bitwise, K and G to 1e-14 relative, the lowered callables to 1e-12
in float64.  Also checks that the port imports neither JAX nor the JAX
package."""

import ast
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dispatches_tpu.analysis import runtime as j_runtime  # noqa: E402
from dispatches_tpu.case_studies.renewables import wind_battery_lmp as j_lmp  # noqa: E402
from dispatches_tpu.core.graph import tshift as j_tshift  # noqa: E402
from dispatches_tpu.models import wind_power as j_wind  # noqa: E402
from dispatches_tpu.solvers import pdlp as j_pdlp  # noqa: E402

from dispatches_tpu_torch.analysis import runtime as t_runtime  # noqa: E402
from dispatches_tpu_torch.case_studies.renewables import wind_battery_lmp as t_lmp  # noqa: E402
from dispatches_tpu_torch.case_studies.renewables.flowsheet import create_model  # noqa: E402
from dispatches_tpu_torch.core.graph import tshift as t_tshift  # noqa: E402
from dispatches_tpu_torch.models import wind_power as t_wind  # noqa: E402
from dispatches_tpu_torch.solvers import pdlp as t_pdlp  # noqa: E402

T = 24
CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]


def _params_in(design_opt=False):
    rng = np.random.default_rng(0)
    return {
        "wind_mw": 200.0, "batt_mw": 25.0,
        "design_opt": design_opt, "extant_wind": True,
        "capacity_factors": np.clip(0.35 + 0.3 * rng.random(T), 0, 1),
        "DA_LMPs": 30.0 + 20.0 * rng.random(T),
    }


@pytest.fixture(scope="module", params=[False, True], ids=["fixed-batt", "design-opt"])
def pair(request):
    """(JAX nlp, port nlp) built from the same inputs; design_opt=False
    is the main-path LP (n 193), design_opt=True frees the battery size."""
    pin = _params_in(request.param)
    _, jn = j_lmp.wind_battery_pricetaker_nlp(T, pin)
    _, tn = t_lmp.wind_battery_pricetaker_nlp(T, pin)
    return jn, tn


@pytest.fixture(scope="module")
def lp_pair(pair):
    jn, tn = pair
    return j_pdlp.make_lp_data(jn), t_pdlp.make_lp_data(tn, device="cpu")


def test_layout_matches_jax(pair):
    jn, tn = pair
    assert (tn.n, tn.m_eq, tn.m_ineq) == (jn.n, jn.m_eq, jn.m_ineq)
    assert tn.free_names == jn.free_names
    assert tn.fixed_names == jn.fixed_names
    assert tn._slices == jn._slices
    assert tn.eq_slices == jn.eq_slices
    assert tn.ineq_slices == jn.ineq_slices
    for attr in ("x0", "lb", "ub", "var_scale"):
        np.testing.assert_array_equal(getattr(tn, attr), np.asarray(getattr(jn, attr)))


def _design_opt(nlp):
    return "battery.nameplate_power" in nlp.free_names


def test_lp_shape(pair, lp_pair):
    """The main-path LP is n 193, 122 equality and 96 inequality rows,
    504 nonzeros; freeing the battery size adds one column of 49."""
    _, tn = pair
    _, td = lp_pair
    nnz = int(np.count_nonzero(np.vstack([td["K"], td["G"]])))
    want = (194, 122, 96, 553) if _design_opt(tn) else (193, 122, 96, 504)
    assert (tn.n, tn.m_eq, tn.m_ineq, nnz) == want


def test_default_params_match(pair):
    jn, tn = pair
    jd, td = jn.default_params(), tn.default_params()
    assert jd.keys() == td.keys()
    for grp in jd:
        assert jd[grp].keys() == td[grp].keys()
        for k in jd[grp]:
            np.testing.assert_array_equal(td[grp][k], jd[grp][k])


def test_lp_data_matches_jax(lp_pair):
    jd, td = lp_pair
    for k in ("K", "G"):
        assert td[k].shape == jd[k].shape
        scale = max(1.0, float(np.abs(jd[k]).max()))
        assert float(np.abs(td[k] - jd[k]).max()) <= 1e-14 * scale
    for k in ("lb", "ub"):
        np.testing.assert_array_equal(td[k], jd[k])


@pytest.mark.parametrize("fn", ["objective", "user_objective", "eq", "ineq"])
def test_callables_match_jax_f64(pair, fn):
    jn, tn = pair
    rng = np.random.default_rng(3)
    params = jn.default_params()
    for _ in range(3):
        x = rng.standard_normal(jn.n)
        want = np.asarray(getattr(jn, fn)(jnp.asarray(x), params))
        got = getattr(tn, fn)(torch.as_tensor(x, dtype=torch.float64), params).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_gradient_matches_jax(pair):
    jn, tn = pair
    params = jn.default_params()
    x = np.random.default_rng(4).standard_normal(jn.n)
    want = np.asarray(jax.grad(lambda v: jn.objective(v, params))(jnp.asarray(x)))
    got = torch.func.grad(lambda v: tn.objective(v, params))(
        torch.as_tensor(x, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_unravel_and_constraint_report_match(pair):
    jn, tn = pair
    params = jn.default_params()
    x = np.random.default_rng(5).standard_normal(jn.n)
    ju, tu = jn.unravel(x), tn.unravel(x)
    assert ju.keys() == tu.keys()
    for k in ju:
        np.testing.assert_array_equal(tu[k], ju[k])
    jr = jn.constraint_report(x, params)
    tr = tn.constraint_report(torch.as_tensor(x, dtype=torch.float64), params)
    assert jr.keys() == tr.keys()
    for k in jr:
        assert tr[k] == pytest.approx(jr[k], rel=1e-12)


def test_tshift_matches_jax():
    arr = np.arange(5.0)
    got = t_tshift(torch.as_tensor(arr), torch.tensor(-1.0, dtype=torch.float64))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_tshift(jnp.asarray(arr), -1.0)))


@pytest.mark.parametrize("fn", ["atb2018_capacity_factors", "sam_windpower_capacity_factors",
                                "sam_weibull_capacity_factors", "sam_pdf_capacity_factors"])
def test_capacity_factors_bitwise(fn):
    speeds = np.linspace(0.0, 30.0, 61)
    np.testing.assert_array_equal(getattr(t_wind, fn)(speeds), getattr(j_wind, fn)(speeds))


@pytest.mark.parametrize("kw", [{"pem_bar": 1.0}, {"tank_type": "simple"},
                                {"turb_inlet_bar": 1.0}, {"re_type": "pv"}])
def test_unported_branches_raise(kw):
    args = dict(re_mw=1.0, pem_bar=None, batt_mw=1.0, tank_type=None,
                tank_length_m=None, turb_inlet_bar=None, horizon=2,
                capacity_factors=np.ones(2))
    args.update(kw)
    with pytest.raises(ValueError, match="not ported"):
        create_model(**args)


def test_make_lp_data_needs_cuda_or_explicit_cpu(pair):
    _, tn = pair
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the cuda default is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_pdlp.make_lp_data(tn)


def _entry_points():
    """Each entry point of the IPM slice as a call with ``device`` left to
    its default (``cuda``)."""
    from dispatches_tpu_torch.entry import _build_nlp, entry
    from dispatches_tpu_torch.solvers import (
        SolverFactory,
        make_ipm_solver,
        make_pdlp_solver,
        solve_nlp,
    )
    from dispatches_tpu_torch.solvers.structured import (
        detect_time_structure,
        make_structured_kkt,
    )

    def optimize(**kw):
        return t_lmp.wind_battery_optimize(T, {**_params_in(True), "max_iter": 2}, **kw)

    nlp = _build_nlp()
    ts = detect_time_structure(nlp, device="cpu")
    return {
        "make_ipm_solver": lambda **kw: make_ipm_solver(nlp, **kw),
        "solve_nlp": lambda **kw: solve_nlp(nlp, **kw),
        "detect_time_structure": lambda **kw: detect_time_structure(nlp, **kw),
        "make_structured_kkt": lambda **kw: make_structured_kkt(
            ts, nlp.n + nlp.m_ineq, nlp.m_eq + nlp.m_ineq, **kw),
        "make_pdlp_solver": lambda **kw: make_pdlp_solver(nlp, **kw),
        "SolverFactory(ipopt)": lambda **kw: SolverFactory("ipopt", **kw),
        "SolverFactory(cbc)": lambda **kw: SolverFactory("cbc", **kw),
        "wind_battery_optimize": optimize,
        "entry": lambda **kw: entry(**kw),
    }


@pytest.mark.parametrize("name", [
    "make_ipm_solver", "solve_nlp", "detect_time_structure", "make_structured_kkt",
    "make_pdlp_solver", "SolverFactory(ipopt)", "SolverFactory(cbc)",
    "wind_battery_optimize", "entry"])
def test_new_entry_points_need_cuda_or_explicit_cpu(name):
    """Without a card every entry point raises unless given device="cpu",
    and with it each one runs on the CPU."""
    fn = _entry_points()[name]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
    assert fn(device="cpu") is not None


@pytest.mark.parametrize("env,value", [
    ("PDLP_ALGO", "avg"), ("PDLP_ALGO", "HALPERN"), ("PDLP_ALGO", "junk"),
    ("PDLP_PRECISION", "bf16x-f32"), ("PDLP_PRECISION", "junk"),
    ("PDLP_REFINE_ROUNDS", "5"), ("PDLP_REFINE_ROUNDS", "-1"),
    ("PDLP_REFINE_ROUNDS", "x"),
])
def test_resolvers_match_jax(monkeypatch, env, value):
    monkeypatch.setenv(f"DISPATCHES_TPU_{env}", value)
    fn = {"PDLP_ALGO": "resolve_pdlp_algorithm",
          "PDLP_PRECISION": "resolve_pdlp_precision",
          "PDLP_REFINE_ROUNDS": "resolve_pdlp_refine_rounds"}[env]

    def outcome(mod):
        try:
            return getattr(mod, fn)(None)
        except ValueError:
            return ValueError

    assert outcome(t_pdlp) == outcome(j_pdlp)


@pytest.mark.parametrize("precision", ["f32", "bf16x-f32", "f32-f64"])
@pytest.mark.parametrize("rounds", [0, 3])
def test_precision_plan_matches_jax(precision, rounds):
    kw = dict(tol=1e-5, precision=precision, refine_rounds=rounds)
    got = t_pdlp._precision_plan(t_pdlp.PDLPOptions(**kw))
    want = j_pdlp._precision_plan(j_pdlp.PDLPOptions(**kw))
    assert tuple(got) == tuple(want)


def test_scalings_bitwise(lp_pair):
    jd, _ = lp_pair
    A = np.vstack([jd["K"], jd["G"]])
    for algo in ("halpern", "avg"):
        got = t_pdlp._scalings(A, t_pdlp.PDLPOptions(algorithm=algo))
        want = j_pdlp._scalings(A, j_pdlp.PDLPOptions(algorithm=algo))
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w)
        assert got[3] == want[3]
    assert t_pdlp._power_norm(A) == j_pdlp._power_norm(A)


def test_nan_guard_matches_jax(monkeypatch):
    monkeypatch.setenv("DISPATCHES_TPU_SANITIZE", "1")
    t_runtime.drain_sanitize_events()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t_runtime.nan_guard("ok", torch.ones(3))
        t_runtime.nan_guard("bad", torch.tensor([1.0, float("nan")]))
        # inside torch.func transforms the guard sees every lane
        torch.func.vmap(lambda v: t_runtime.nan_guard("vm", v) or v)(
            torch.tensor([[1.0], [float("inf")]]))
    assert t_runtime.drain_sanitize_events() == ["bad", "vm"]
    assert t_runtime.drain_sanitize_events() == []
    assert t_runtime.sanitize_enabled() == j_runtime.sanitize_enabled()
    monkeypatch.delenv("DISPATCHES_TPU_SANITIZE")
    t_runtime.nan_guard("off", torch.tensor([float("nan")]))
    assert t_runtime.drain_sanitize_events() == []
    assert t_runtime.sanitize_enabled() == j_runtime.sanitize_enabled()


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "dispatches_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {f"dispatches_tpu_torch/{f}" for f in (
        "entry.py", "interop.py", "solvers/ipm.py", "solvers/structured.py",
        "solvers/factory.py", "solvers/pdlp.py",
        "case_studies/renewables/wind_battery_lmp.py")} <= names
    bad = [(str(f.relative_to(ROOT)), mod) for f in files for mod in _imports(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "dispatches_tpu")]
    assert bad == []
