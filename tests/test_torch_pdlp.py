"""The PyTorch port's per-scenario PDLP solver held to the JAX package on
the CPU.

The tier-1 cases of tests/test_pdlp.py run through both packages on the
same battery LP: in float64 the iteration counts are equal and the
objectives agree within 1e-9 relative (and with scipy's HiGHS within
1e-6); in float32 each scenario's objective is within ``tol`` (1e-5
relative) of the JAX solve and within 1e-4 of HiGHS.  Also: a zero start
is bitwise the cold solve, a traced solve is bitwise the untraced one and
its rows match JAX's, the polish only tightens parity, the row duals are
the shadow prices and match JAX's, the bf16 tier's refinement tail
restores accuracy, and a non-affine model raises."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy.optimize import linprog  # noqa: E402

from dispatches_tpu import Flowsheet as JFlowsheet  # noqa: E402
from dispatches_tpu.core.graph import tshift as j_tshift  # noqa: E402
from dispatches_tpu.solvers import PDLPOptions as JPDLPOptions  # noqa: E402
from dispatches_tpu.solvers import make_pdlp_solver as j_make_pdlp  # noqa: E402

from dispatches_tpu_torch.core.graph import Flowsheet as TFlowsheet  # noqa: E402
from dispatches_tpu_torch.core.graph import tshift as t_tshift  # noqa: E402
from dispatches_tpu_torch.solvers import (  # noqa: E402
    START_COLD,
    PDLPOptions,
    make_lp_data,
    make_pdlp_solver,
)

CPU = "cpu"


def _battery_lp(F, tshift, xp, T=24):
    fs = F(horizon=T)
    for n in ["wind_elec", "grid", "batt_in", "batt_out"]:
        fs.add_var(n, lb=0, ub=1e6, scale=1e3)
    fs.add_var("soc", lb=0, ub=4e6, scale=1e3)
    fs.add_var("soc0", shape=(), lb=0)
    fs.fix("soc0", 0.0)
    fs.add_param("lmp", np.full(T, 0.02))
    fs.add_param("wind_cap_cf", np.full(T, 400e3))
    fs.add_eq("power_balance", lambda v, p: v["wind_elec"] - v["grid"] - v["batt_in"])
    fs.add_eq("soc_evolution", lambda v, p: v["soc"] - tshift(v["soc"], v["soc0"])
              - 0.95 * v["batt_in"] + v["batt_out"] / 0.95)
    fs.add_ineq("wind_cf", lambda v, p: v["wind_elec"] - p["wind_cap_cf"])
    fs.add_ineq("batt_p_in", lambda v, p: v["batt_in"] - 300e3)
    fs.add_ineq("batt_p_out", lambda v, p: v["batt_out"] - 300e3)
    fs.add_eq("periodic", lambda v, p: v["soc"][-1] - v["soc0"])
    return fs.compile(objective=lambda v, p: xp.sum(p["lmp"] * (v["grid"] + v["batt_out"])),
                      sense="max")


def _highs_battery(T, lmp, cf):
    n = 5 * T
    iw, ig, ibi, ibo, isoc = (slice(k * T, (k + 1) * T) for k in range(5))
    A = np.zeros((2 * T + 1, n))
    b = np.zeros(2 * T + 1)
    for t in range(T):
        A[t, iw.start + t] = 1.0
        A[t, ig.start + t] = -1.0
        A[t, ibi.start + t] = -1.0
        A[T + t, isoc.start + t] = 1.0
        if t > 0:
            A[T + t, isoc.start + t - 1] = -1.0
        A[T + t, ibi.start + t] = -0.95
        A[T + t, ibo.start + t] = 1.0 / 0.95
    A[2 * T, isoc.stop - 1] = 1.0
    c = np.zeros(n)
    c[ig] = -lmp
    c[ibo] = -lmp
    bounds = ([(0.0, cf[t]) for t in range(T)] + [(0.0, 1e6)] * T
              + [(0.0, 300e3)] * T + [(0.0, 300e3)] * T + [(0.0, 4e6)] * T)
    res = linprog(c, A_ub=None, b_ub=None, A_eq=A, b_eq=b, bounds=bounds, method="highs")
    assert res.status == 0
    return -res.fun


def _pair(T=24):
    return (_battery_lp(JFlowsheet, j_tshift, jnp, T),
            _battery_lp(TFlowsheet, t_tshift, torch, T))


def _scenarios(seed, N, T=24):
    rng = np.random.default_rng(seed)
    lmps = 0.02 + 0.015 * np.sin(
        2 * np.pi * (np.arange(T)[None, :] + rng.uniform(0, 24, (N, 1))) / 24)
    cfs = 400e3 * (0.4 + 0.6 * rng.random((N, T)))
    return lmps, cfs


def _lane(nlp, lmps, cfs, i):
    p = nlp.default_params()
    return {"p": {"lmp": lmps[i], "wind_cap_cf": cfs[i]}, "fixed": p["fixed"]}


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.mark.parametrize("algorithm", ["halpern", "avg"])
def test_f64_parity_iterations_equal(pair, algorithm):
    jn, tn = pair
    kw = dict(tol=1e-8, dtype="float64", algorithm=algorithm)
    want = jax.jit(j_make_pdlp(jn, JPDLPOptions(**kw)))(jn.default_params())
    got = make_pdlp_solver(tn, PDLPOptions(**kw), device=CPU)(tn.default_params())
    assert bool(got.converged) and bool(want.converged)
    assert int(got.iters) == int(want.iters)
    assert float(got.obj) == pytest.approx(float(want.obj), rel=1e-9)
    ref = _highs_battery(24, np.full(24, 0.02), np.full(24, 400e3))
    assert float(got.obj) == pytest.approx(ref, rel=1e-6)
    assert got.x.dtype == torch.float64 and got.obj.dtype == torch.float64


def test_f32_scenarios_within_tol(pair):
    """f32, tol 1e-5: each scenario within tol of the JAX solve and within
    1e-4 of HiGHS; the f32 policy spends no refinement epochs."""
    jn, tn = pair
    lmps, cfs = _scenarios(0, 8)
    kw = dict(tol=1e-5, dtype="float32")
    jsolve = jax.jit(j_make_pdlp(jn, JPDLPOptions(**kw)))
    tsolve = make_pdlp_solver(tn, PDLPOptions(**kw), device=CPU)
    for i in range(8):
        want = jsolve(_lane(jn, lmps, cfs, i))
        got = tsolve(_lane(tn, lmps, cfs, i))
        assert bool(got.converged) and int(got.refined) == 0
        assert got.x.dtype == torch.float32
        assert float(got.obj) == pytest.approx(float(want.obj), rel=1e-5)
        assert float(got.obj) == pytest.approx(_highs_battery(24, lmps[i], cfs[i]), rel=1e-4)


def test_polish_tightens_parity(pair):
    """The float64 polish never loosens the objective against HiGHS and
    keeps every lane within 1e-4; polished objectives match JAX's."""
    jn, tn = pair
    lmps, cfs = _scenarios(3, 4)
    refs = np.array([_highs_battery(24, lmps[i], cfs[i]) for i in range(4)])
    errs = {}
    for polish in (False, True):
        kw = dict(tol=1e-5, dtype="float32", polish=polish)
        solve = make_pdlp_solver(tn, PDLPOptions(**kw), device=CPU)
        objs = np.array([float(solve(_lane(tn, lmps, cfs, i)).obj) for i in range(4)])
        errs[polish] = np.abs(objs - refs) / np.abs(refs)
        if polish:
            jsolve = jax.jit(j_make_pdlp(jn, JPDLPOptions(**kw)))
            want = np.array([float(jsolve(_lane(jn, lmps, cfs, i)).obj) for i in range(4)])
            np.testing.assert_allclose(objs, want, rtol=1e-5)
    assert errs[True].max() <= 1e-4
    assert np.all(errs[True] <= errs[False] + 1e-6)


def test_duals_are_shadow_prices(pair):
    """Row duals in the original constraint space: the power-balance dual
    is the hour's LMP (sign: max lowers to min), as in JAX."""
    jn, tn = pair
    kw = dict(tol=1e-8, dtype="float64")
    want = jax.jit(j_make_pdlp(jn, JPDLPOptions(**kw)))(jn.default_params())
    got = make_pdlp_solver(tn, PDLPOptions(**kw), device=CPU)(tn.default_params())
    np.testing.assert_allclose(np.abs(got.z.numpy()[:24]), 0.02, atol=1e-5)
    np.testing.assert_allclose(got.z.numpy(), np.asarray(want.z), rtol=1e-6, atol=1e-9)


def test_zero_start_is_bitwise_cold(pair):
    _, tn = pair
    solve = make_pdlp_solver(tn, PDLPOptions(tol=1e-5, dtype="float32"), device=CPU)
    cold = solve(tn.default_params())
    warm = solve(tn.default_params(), start=(np.zeros(tn.n), np.zeros(tn.m_eq + tn.m_ineq),
                                             START_COLD))
    assert cold.start_kind is None and int(warm.start_kind) == START_COLD
    for f in ("x", "obj", "iters", "pr_err", "du_err", "gap", "z"):
        assert torch.equal(getattr(cold, f), getattr(warm, f)), f


def test_exact_restart_needs_no_iterations(pair):
    _, tn = pair
    solve = make_pdlp_solver(tn, PDLPOptions(tol=1e-8, dtype="float64"), device=CPU)
    first = solve(tn.default_params())
    again = solve(tn.default_params(), start=(first.x, first.z))
    assert int(again.iters) <= 40 and bool(again.converged)
    assert float(again.obj) == pytest.approx(float(first.obj), rel=1e-8)


def test_trace_is_bitwise_untraced_and_matches_jax(pair):
    jn, tn = pair
    kw = dict(tol=1e-8, dtype="float64", max_iter=4000)
    plain = make_pdlp_solver(tn, PDLPOptions(**kw), device=CPU)(tn.default_params())
    res, tr = make_pdlp_solver(tn, PDLPOptions(**kw), trace=True, device=CPU)(
        tn.default_params())
    for f in ("x", "obj", "iters", "pr_err", "du_err", "gap", "z"):
        assert torch.equal(getattr(plain, f), getattr(res, f)), f
    _, jtr = jax.jit(j_make_pdlp(jn, JPDLPOptions(**kw), trace=True))(jn.default_params())
    assert set(tr) == set(jtr) and tr["it"].shape == (100,)
    np.testing.assert_array_equal(tr["it"].numpy(), np.asarray(jtr["it"]))
    for k in ("err", "err_best", "pr", "du", "gap"):
        np.testing.assert_allclose(tr[k].numpy(), np.asarray(jtr[k]), rtol=1e-6, atol=1e-14)


def test_bf16_refinement_recovers_accuracy():
    """bf16 operands in the sweeps cannot reach 1e-4 alone; the f32
    refinement tail restores it and reports that it ran."""
    jn, tn = _pair(8)
    kw = dict(tol=1e-5, dtype="float32", precision="bf16x-f32")
    got = make_pdlp_solver(tn, PDLPOptions(**kw), device=CPU)(tn.default_params())
    want = jax.jit(j_make_pdlp(jn, JPDLPOptions(**kw)))(jn.default_params())
    assert bool(got.converged) and int(got.refined) > 0
    ref = _highs_battery(8, np.full(8, 0.02), np.full(8, 400e3))
    assert float(got.obj) == pytest.approx(ref, rel=1e-4)
    assert float(got.obj) == pytest.approx(float(want.obj), rel=1e-4)


def test_rejects_nonlinear():
    fs = TFlowsheet(horizon=4)
    fs.add_var("x", lb=0, ub=10)
    fs.add_eq("quad", lambda v, p: v["x"] ** 2 - 1.0)
    nlp = fs.compile(objective=lambda v, p: torch.sum(v["x"]))
    with pytest.raises(ValueError, match="not affine"):
        make_pdlp_solver(nlp, device=CPU)


def test_random_lps_vs_highs_and_jax():
    """Random feasible-by-construction box LPs, f64: equal iterations and
    objectives to the JAX solver, HiGHS parity 1e-6."""
    rng = np.random.default_rng(42)
    for trial in range(3):
        n, m = 30, 12
        A = rng.standard_normal((m, n))
        b = A @ rng.uniform(0.5, 1.5, n)
        cvec = rng.standard_normal(n)

        def model(F, xp, A_):
            fs = F(horizon=n)
            fs.add_var("x", lb=0.0, ub=3.0)
            fs.add_param("b", b)
            fs.add_eq("rows", lambda v, p: A_ @ v["x"] - p["b"])
            c_ = xp.asarray(cvec) if xp is jnp else torch.as_tensor(cvec)
            return fs.compile(objective=lambda v, p: (c_ * v["x"]).sum())

        jn = model(JFlowsheet, jnp, jnp.asarray(A))
        tn = model(TFlowsheet, torch, torch.as_tensor(A))
        kw = dict(tol=1e-8, dtype="float64", max_iter=60000)
        want = jax.jit(j_make_pdlp(jn, JPDLPOptions(**kw)))(jn.default_params())
        got = make_pdlp_solver(tn, PDLPOptions(**kw), device=CPU)(tn.default_params())
        ref = linprog(cvec, A_eq=A, b_eq=b, bounds=[(0.0, 3.0)] * n, method="highs")
        assert ref.status == 0 and bool(got.converged), f"trial {trial}"
        assert int(got.iters) == int(want.iters), f"trial {trial}"
        assert float(got.obj) == pytest.approx(ref.fun, rel=1e-6, abs=1e-6)


def test_lp_data_can_be_shared(pair):
    """lp_data from make_lp_data skips the extraction and gives the same
    solve."""
    _, tn = pair
    data = make_lp_data(tn, device=CPU)
    opts = PDLPOptions(tol=1e-6, dtype="float64")
    a = make_pdlp_solver(tn, opts, device=CPU)(tn.default_params())
    b = make_pdlp_solver(tn, opts, lp_data=data, device=CPU)(tn.default_params())
    assert torch.equal(a.x, b.x) and int(a.iters) == int(b.iters)
