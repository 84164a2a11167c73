"""The PyTorch port's interior-point solver held to the JAX package on the
CPU, in float64.

The cases of tests/test_ipm.py run through both packages on the same
model: statuses equal, objectives within rtol 1e-7 of each other (and of
scipy's HiGHS or the closed form), iteration counts equal.  The flagship
wind+battery model (``entry()``'s 8 LMP lanes) on the dense KKT path
agrees with the vmapped JAX IPM at max_iter 300: statuses all 0,
objectives within rtol 1e-7, and iterations equal on every lane whose
count the JAX package reproduces between its vmapped and per-scenario
solves (the degenerate-vertex endgame turns last-bit differences into
different iteration counts; see PERF.md).  Also: the trace, warm starts
carried over from a JAX result, and per-lane starts."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy.optimize import linprog  # noqa: E402

from __graft_entry__ import _build_nlp as j_build_nlp, _lmp_batch  # noqa: E402
from dispatches_tpu import Flowsheet as JFlowsheet  # noqa: E402
from dispatches_tpu.core.graph import tshift as j_tshift  # noqa: E402
from dispatches_tpu.solvers import IPMOptions as JIPMOptions  # noqa: E402
from dispatches_tpu.solvers import make_ipm_solver as j_make_ipm  # noqa: E402
from dispatches_tpu.solvers.ipm import format_iteration_trace as j_format  # noqa: E402

from dispatches_tpu_torch.core.graph import Flowsheet as TFlowsheet  # noqa: E402
from dispatches_tpu_torch.core.graph import tshift as t_tshift  # noqa: E402
from dispatches_tpu_torch.entry import _build_nlp as t_build_nlp  # noqa: E402
from dispatches_tpu_torch.interop import ipm_start_from_numpy  # noqa: E402
from dispatches_tpu_torch.solvers import (  # noqa: E402
    IPMOptions,
    format_iteration_trace,
    make_ipm_solver,
    solve_nlp,
)
import torch_records  # noqa: E402

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs files in parallel workers: one intra-op thread per
    worker keeps torch's small factorizations from oversubscribing the
    cores.  (The thread count changes the factorizations' last bits, and
    so the iteration counts of chaotic lanes.)"""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-7


def _small_lp(F, tshift, xp):
    # max 3x + 2y s.t. x + y <= 4, x + 3y <= 6, 0 <= x,y <= 3
    fs = F(horizon=1)
    fs.add_var("x", shape=(), lb=0, ub=3)
    fs.add_var("y", shape=(), lb=0, ub=3)
    fs.add_ineq("c1", lambda v, p: v["x"] + v["y"] - 4.0)
    fs.add_ineq("c2", lambda v, p: v["x"] + 3.0 * v["y"] - 6.0)
    return fs.compile(objective=lambda v, p: 3.0 * v["x"] + 2.0 * v["y"], sense="max")


def _eq_qp(F, tshift, xp):
    # min (x-1)^2 + (y-2)^2 s.t. x + y = 2  ->  x = 0.5, y = 1.5
    fs = F()
    fs.add_var("x", shape=())
    fs.add_var("y", shape=())
    fs.add_eq("bal", lambda v, p: v["x"] + v["y"] - 2.0)
    return fs.compile(objective=lambda v, p: (v["x"] - 1.0) ** 2 + (v["y"] - 2.0) ** 2)


def _nonlinear(F, tshift, xp):
    # min x^2 + y^2 s.t. x*y = 1, x >= 0 -> x = y = 1
    fs = F()
    fs.add_var("x", shape=(), lb=0.0, init=2.0)
    fs.add_var("y", shape=(), init=2.0)
    fs.add_eq("hyper", lambda v, p: v["x"] * v["y"] - 1.0)
    return fs.compile(objective=lambda v, p: v["x"] ** 2 + v["y"] ** 2)


def _fixed_var(F, tshift, xp):
    fs = F()
    fs.add_var("x", shape=(), lb=0)
    fs.add_var("cap", shape=(), lb=0)
    fs.fix("cap", 5.0)
    fs.add_ineq("le_cap", lambda v, p: v["x"] - v["cap"])
    return fs.compile(objective=lambda v, p: v["x"], sense="max")


def _budget(F, tshift, xp):
    fs = F()
    fs.add_var("x", shape=(), lb=0, ub=1)
    fs.add_var("y", shape=(), lb=0, ub=1)
    fs.add_param("c", [1.0, 1.0])
    fs.add_ineq("budget", lambda v, p: v["x"] + v["y"] - 1.5)
    return fs.compile(objective=lambda v, p: p["c"][0] * v["x"] + p["c"][1] * v["y"],
                      sense="max")


def _storage(F, tshift, xp):
    # 4-period storage arbitrage with shifted-slice linking: profit 8
    fs = F(horizon=4)
    fs.add_var("charge", lb=0, ub=1)
    fs.add_var("discharge", lb=0, ub=1)
    fs.add_var("soc", lb=0, ub=2)
    fs.add_var("soc0", shape=(), lb=0, ub=2)
    fs.fix("soc0", 0.0)
    fs.add_param("price", np.array([1.0, 5.0, 1.0, 5.0]))
    fs.add_eq("soc_evolution",
              lambda v, p: v["soc"] - tshift(v["soc"], v["soc0"]) - v["charge"] + v["discharge"])
    return fs.compile(objective=lambda v, p: xp.sum(p["price"] * (v["discharge"] - v["charge"])),
                      sense="max")


def _small_lp_ref():
    ref = linprog(c=[-3, -2], A_ub=[[1, 1], [1, 3]], b_ub=[4, 6],
                  bounds=[(0, 3), (0, 3)], method="highs")
    return -ref.fun


# (builder, options, params edit, reference objective or None)
CASES = {
    "small_lp": (_small_lp, {"tol": 1e-9}, None, _small_lp_ref),
    "eq_qp": (_eq_qp, {}, None, lambda: 0.5),
    "nonlinear": (_nonlinear, {}, None, lambda: 2.0),
    "fixed_var": (_fixed_var, {}, None, lambda: 5.0),
    "fixed_var_7": (_fixed_var, {}, ("fixed", "cap", 7.0), lambda: 7.0),
    "storage": (_storage, {"tol": 1e-9}, None, lambda: 8.0),
}


def _pair(builder):
    return builder(JFlowsheet, j_tshift, jnp), builder(TFlowsheet, t_tshift, torch)


def _params(nlp, edit):
    params = nlp.default_params()
    if edit is not None:
        grp, key, val = edit
        params[grp][key] = np.asarray(val)
    return params


@pytest.mark.parametrize("case", sorted(CASES))
def test_ipm_case_matches_jax(case):
    builder, kw, edit, ref = CASES[case]
    jn, tn = _pair(builder)
    want = jax.jit(j_make_ipm(jn, JIPMOptions(**kw)))(_params(jn, edit))
    got = solve_nlp(tn, params=_params(tn, edit), options=IPMOptions(**kw), device=CPU)
    assert int(got.status) == int(want.status) and bool(got.converged)
    assert int(got.iterations) == int(want.iterations)
    assert float(got.obj) == pytest.approx(float(want.obj), rel=RTOL, abs=1e-9)
    assert float(got.obj) == pytest.approx(ref(), rel=1e-6, abs=1e-6)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-6, atol=1e-7)
    assert got.x.dtype == torch.float64


def test_ipm_lanes_match_jax_vmap():
    """tests/test_ipm.py's params batch: a leaf with one extra leading
    axis is a lane axis; each lane equals the vmapped JAX solve."""
    jn, tn = _pair(_budget)
    batch_c = np.array([[3.0, 1.0], [1.0, 3.0], [2.0, 2.0]])
    batched = {"p": {"c": batch_c}, "fixed": jn.default_params()["fixed"]}
    want = jax.jit(jax.vmap(j_make_ipm(jn, JIPMOptions(tol=1e-9)),
                            in_axes=({"p": {"c": 0}, "fixed": None},)))(batched)
    got = make_ipm_solver(tn, IPMOptions(tol=1e-9), device=CPU)(batched)
    assert got.obj.shape == (3,) and got.x.shape == (3, tn.n)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))
    np.testing.assert_allclose(got.obj.numpy(), [3.5, 3.5, 3.0], atol=1e-6)
    np.testing.assert_allclose(got.obj.numpy(), np.asarray(want.obj), rtol=RTOL)


def test_trace_matches_untraced_and_jax():
    jn, tn = _pair(_small_lp)
    opts = {"tol": 1e-9, "max_iter": 40}
    jres, jtr = jax.jit(j_make_ipm(jn, JIPMOptions(**opts), trace=True))(jn.default_params())
    solver = make_ipm_solver(tn, IPMOptions(**opts), trace=True, device=CPU)
    res, tr = solver(tn.default_params())
    plain = make_ipm_solver(tn, IPMOptions(**opts), device=CPU)(tn.default_params())
    for a, b in zip(res, plain):
        assert torch.equal(a, b)
    assert {k: v.shape for k, v in tr.items()} == {k: (40,) for k in ("mu", "kkt_error", "alpha", "stall")}
    for k in tr:
        np.testing.assert_allclose(tr[k].numpy(), np.asarray(jtr[k]), rtol=1e-6, atol=1e-12)
    got = format_iteration_trace(tr, result=res).splitlines()
    want = j_format(jtr, result=jres).splitlines()
    assert len(got) == len(want) == int(res.iterations) + 1
    assert got[0] == want[0]


def test_warm_start_from_jax_result():
    """A JAX IPMResult carried over (x_phys, lam) restarts the port near
    the optimum: same objective, fewer iterations than cold."""
    jn, tn = _pair(_storage)
    jres = jax.jit(j_make_ipm(jn, JIPMOptions(tol=1e-9)))(jn.default_params())
    x0, lam0 = ipm_start_from_numpy(np.asarray(jres.x_phys), np.asarray(jres.lam), CPU)
    solver = make_ipm_solver(tn, IPMOptions(tol=1e-9), device=CPU)
    cold = solver(tn.default_params())
    warm = solver(tn.default_params(), x0, lam0)
    assert int(warm.status) == 0
    assert float(warm.obj) == pytest.approx(float(jres.obj), rel=RTOL)
    assert int(warm.iterations) < int(cold.iterations)


def test_per_lane_starts():
    """x0 with one row per lane batches the solve; each lane equals its
    own one-lane solve."""
    _, tn = _pair(_nonlinear)
    x0 = np.array([[2.0, 2.0], [0.5, 3.0], [1.5, 0.7]])
    solver = make_ipm_solver(tn, IPMOptions(), device=CPU)
    res = solver(tn.default_params(), x0)
    assert res.obj.shape == (3,)
    for i in range(3):
        one = solver(tn.default_params(), x0[i])
        assert int(one.iterations) == int(res.iterations[i])
        torch.testing.assert_close(one.x, res.x[i], rtol=1e-12, atol=1e-12)


FLAGSHIP_RECORD = "ipm_flagship_dense_jax"


def jax_record():
    """JAX's dense IPM over entry()'s 8 lanes at max_iter 300, vmapped and
    per scenario, with the params it ran on (compiles for minutes, so the
    tier-1 test reads it from ``tests/torch_records.py``'s record)."""
    jn = j_build_nlp()
    params = jn.default_params()
    lmps = _lmp_batch(8, 24)
    batched = {"p": {**params["p"], "lmp": lmps}, "fixed": params["fixed"]}
    axes = ({"p": {k: (0 if k == "lmp" else None) for k in params["p"]}, "fixed": None},)
    opts = JIPMOptions(max_iter=300, kkt="dense")
    res = jax.jit(jax.vmap(j_make_ipm(jn, opts), in_axes=axes))(batched)
    one = jax.jit(j_make_ipm(jn, opts))
    per_scenario = np.array([
        int(one({"p": {**params["p"], "lmp": lmps[s]}, "fixed": params["fixed"]}).iterations)
        for s in range(8)])
    return {"batched": jax.tree_util.tree_map(np.asarray, batched),
            "want": {k: np.asarray(getattr(res, k)) for k in ("status", "obj", "iterations")},
            "per_scenario": per_scenario}


@pytest.fixture(scope="module")
def flagship_dense():
    rec = torch_records.read(FLAGSHIP_RECORD)
    return rec["batched"], rec["want"], rec["per_scenario"]


@pytest.mark.slow
def test_flagship_dense_jax_record_is_current():
    """JAX's side of test_flagship_dense_matches_jax, rebuilt, equals its
    record bitwise."""
    assert torch_records.matches(FLAGSHIP_RECORD, jax_record())


def test_flagship_dense_matches_jax(flagship_dense):
    batched, want, per_scenario = flagship_dense
    res = make_ipm_solver(t_build_nlp(), IPMOptions(max_iter=300, kkt="dense"),
                          device=CPU)(batched)
    np.testing.assert_array_equal(res.status.numpy(), want["status"])
    assert (want["status"] == 0).all()
    np.testing.assert_allclose(res.obj.numpy(), want["obj"], rtol=RTOL)
    stable = want["iterations"] == per_scenario
    assert stable.any()
    np.testing.assert_array_equal(res.iterations.numpy()[stable], want["iterations"][stable])
