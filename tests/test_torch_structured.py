"""The PyTorch port's structured (bordered block-tridiagonal) KKT path held
to the JAX package on the CPU, in float64.

Detection: the index maps equal the JAX package's bitwise, on the
flagship model and on tests/test_structured.py's toy at T in {8, 17,
33}, and the non-banded toys are refused as there.  One KKT solve on
shared inputs agrees with the JAX structured solve within 1e-10 and with
the port's dense Cholesky condensation within 1e-8.  The flagship IPM
(``entry()``'s 8 LMP lanes, ``kkt="auto"``, which takes this path) agrees
with the vmapped JAX IPM: statuses equal at max_iter 300 and 60,
objectives within rtol 1e-7, and iterations equal on every lane whose
iteration count the JAX package itself reproduces between its vmapped and
its per-scenario solve (the endgame at a degenerate vertex turns
last-bit differences into different iteration counts; see PERF.md)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _build_nlp as j_build_nlp, _lmp_batch  # noqa: E402
from dispatches_tpu import Flowsheet as JFlowsheet  # noqa: E402
from dispatches_tpu.core.graph import tshift as j_tshift  # noqa: E402
from dispatches_tpu.solvers import IPMOptions as JIPMOptions  # noqa: E402
from dispatches_tpu.solvers import make_ipm_solver as j_make_ipm  # noqa: E402
from dispatches_tpu.solvers import structured as j_st  # noqa: E402

from dispatches_tpu_torch.core.graph import Flowsheet as TFlowsheet  # noqa: E402
from dispatches_tpu_torch.core.graph import tshift as t_tshift  # noqa: E402
from dispatches_tpu_torch.entry import _build_nlp as t_build_nlp, entry  # noqa: E402
from dispatches_tpu_torch.solvers import IPMOptions, make_ipm_solver  # noqa: E402
from dispatches_tpu_torch.solvers import structured as t_st  # noqa: E402
from dispatches_tpu_torch.solvers.ipm import _kkt_solve  # noqa: E402
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


F64 = torch.float64


def _toy(Flowsheet, tshift, xp, T):
    """tests/test_structured.py's battery arbitrage: a free design
    variable (border column), a periodic row (border row) and a quadratic
    degradation term (nonzero banded Hessian)."""
    fs = Flowsheet(horizon=T)
    fs.add_var("charge", lb=0, ub=500.0)
    fs.add_var("discharge", lb=0, ub=500.0)
    fs.add_var("soc", lb=0, ub=4000.0)
    fs.add_var("cap", shape=(), lb=10.0, ub=5000.0)
    fs.add_param("price", np.sin(np.arange(T)) * 30 + 40.0)
    zero = xp.asarray(0.0) if xp is jnp else torch.tensor(0.0, dtype=F64)
    fs.add_eq("soc_evolution", lambda v, p: v["soc"] - tshift(v["soc"], zero)
              - 0.9 * v["charge"] + v["discharge"] / 0.9)
    fs.add_ineq("soc_cap", lambda v, p: v["soc"] - v["cap"])
    fs.add_eq("periodic", lambda v, p: v["soc"][-1] - 0.0)

    def obj(v, p):
        rev = xp.sum(p["price"] * (v["discharge"] - v["charge"]))
        deg = 0.01 * xp.sum((v["charge"] + v["discharge"]) ** 2)
        return rev - deg - 3.0 * v["cap"]

    return fs.compile(objective=obj, sense="max")


def _toy_pair(T):
    return _toy(JFlowsheet, j_tshift, jnp, T), _toy(TFlowsheet, t_tshift, torch, T)


def _same_structure(got, want):
    assert want is not None and got is not None
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f


@pytest.mark.parametrize("T", [8, 17, 33])
def test_detect_matches_jax_toy(T):
    jn, tn = _toy_pair(T)
    want = j_st.detect_time_structure(jn)
    _same_structure(t_st.detect_time_structure(tn, device=CPU), want)
    assert (want.nps, want.npc, want.n_by, want.n_bc) == (4, 2, 1, 1)


def test_detect_matches_jax_flagship():
    want = j_st.detect_time_structure(j_build_nlp())
    _same_structure(t_st.detect_time_structure(t_build_nlp(), device=CPU), want)
    assert (want.T, want.nps, want.npc, want.n_by, want.n_bc) == (24, 12, 9, 1, 2)


def test_detect_rejects_nonbanded():
    """A cumulative-sum constraint couples all periods: no period rows."""
    fs = TFlowsheet(horizon=16)
    fs.add_var("x", lb=0, ub=10.0)
    fs.add_eq("cum", lambda v, p: torch.cumsum(v["x"], 0) - 1.0)
    nlp = fs.compile(objective=lambda v, p: torch.sum(v["x"]))
    assert t_st.detect_time_structure(nlp, device=CPU) is None


def test_detect_rejects_nonbanded_hessian():
    """(sum x)^2 couples every pair of periods in the Hessian."""
    fs = TFlowsheet(horizon=16)
    fs.add_var("x", lb=0, ub=10.0)
    fs.add_eq("local", lambda v, p: v["x"] - 1.0)
    nlp = fs.compile(objective=lambda v, p: torch.sum(v["x"]) ** 2)
    assert t_st.detect_time_structure(nlp, device=CPU) is None


def test_structured_kkt_matches_jax_and_dense():
    """One solve on shared random inputs (T = 17: the colour wraparound)
    against the JAX structured solve (1e-10) and against the port's dense
    condensation (1e-8), both relative to max(1, |want|)."""
    T = 17
    jn, tn = _toy_pair(T)
    ts = t_st.detect_time_structure(tn, device=CPU)
    n_x, m_eq, m_in = tn.n, tn.m_eq, tn.m_ineq
    n_y, m = n_x + m_in, m_eq + m_in
    params = tn.default_params()
    rng = np.random.default_rng(T)
    y, lam = rng.uniform(0.5, 1.5, n_y), rng.standard_normal(m)
    Sigma, r1, c = rng.uniform(0.5, 2.0, n_y), rng.standard_normal(n_y), rng.standard_normal(m)

    def j_cons(yv):
        return jnp.concatenate([jn.eq(yv[:n_x], params), jn.ineq(yv[:n_x], params) + yv[n_x:]])

    j_lag_grad = jax.grad(lambda yv: jn.objective(yv[:n_x], params) + j_cons(yv) @ lam)
    j_solve = j_st.make_structured_kkt(j_st.detect_time_structure(jn), n_y, m)
    want = jax.jit(lambda *a: j_solve(j_cons, j_lag_grad, *a, 1e-8, 1e-8))(
        *map(jnp.asarray, (y, Sigma, r1, c)))
    assert bool(want[2])

    def t_cons(yv):
        return torch.cat([tn.eq(yv[:n_x], params), tn.ineq(yv[:n_x], params) + yv[n_x:]])

    def t_lag(yv):
        return tn.objective(yv[:n_x], params) + t_cons(yv) @ torch.as_tensor(lam)

    t = [torch.as_tensor(a) for a in (y, Sigma, r1, c)]
    dy, dlam, ok = t_st.make_structured_kkt(ts, n_y, m, device=CPU)(
        t_cons, torch.func.grad(t_lag), *t, 1e-8, 1e-8)
    assert bool(ok)
    for got, w in ((dy, want[0]), (dlam, want[1])):
        w = np.asarray(w)
        assert np.abs(got.numpy() - w).max() <= 1e-10 * max(1.0, np.abs(w).max())

    W = torch.func.hessian(t_lag)(t[0])
    J = torch.func.jacrev(t_cons)(t[0])
    dy_d, dlam_d = _kkt_solve(W[None], t[1][None], J[None], t[2][None], t[3][None], 1e-8, 1e-8)
    for got, d in ((dy, dy_d[0]), (dlam, dlam_d[0])):
        assert float((got - d).abs().max()) <= 1e-8 * max(1.0, float(d.abs().max()))


def test_structured_kkt_solves_lanes_independently():
    """A batch of lanes gives each lane its own one-lane solve."""
    _, tn = _toy_pair(17)
    ts = t_st.detect_time_structure(tn, device=CPU)
    n_x, m_in = tn.n, tn.m_ineq
    n_y, m = n_x + m_in, tn.m_eq + m_in
    params = tn.default_params()
    rng = np.random.default_rng(5)
    B = 3
    ys, Sig, r1, c = (torch.as_tensor(rng.uniform(0.5, 1.5, (B, k))) for k in (n_y, n_y, n_y, m))

    def cons(yv):
        return torch.cat([tn.eq(yv[:n_x], params), tn.ineq(yv[:n_x], params) + yv[n_x:]])

    def lag_grad(yv):
        return torch.func.grad(lambda u: tn.objective(u[:n_x], params) + cons(u).sum())(yv)

    solve = t_st.make_structured_kkt(ts, n_y, m, device=CPU)
    dw = torch.tensor([1e-8, 1e-6, 1e-4], dtype=F64)
    dyb, dlb, okb = solve(torch.func.vmap(cons), torch.func.vmap(lag_grad), ys, Sig, r1, c, dw, 1e-8)
    for i in range(B):
        dy, dl, ok = solve(cons, lag_grad, ys[i], Sig[i], r1[i], c[i], float(dw[i]), 1e-8)
        assert bool(ok) and bool(okb[i])
        torch.testing.assert_close(dyb[i], dy, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(dlb[i], dl, rtol=1e-12, atol=1e-12)


# --- the flagship IPM on the structured path --------------------------

@pytest.fixture(scope="module")
def flagship():
    """JAX results for entry()'s 8 lanes with kkt="auto" (from the record
    of :func:`jax_record`)."""
    rec = torch_records.read(FLAGSHIP_RECORD)
    return {"batched": rec["batched"], 300: rec["max_iter_300"], 60: rec["max_iter_60"],
            "per_scenario_iters": rec["per_scenario_iters"]}


FLAGSHIP_RECORD = "structured_flagship_jax"


@pytest.mark.slow
def test_flagship_jax_record_is_current():
    """JAX's side of the flagship tests, rebuilt, equals its record
    bitwise."""
    assert torch_records.matches(FLAGSHIP_RECORD, jax_record())


def jax_record():
    """JAX results for entry()'s 8 lanes with kkt="auto": vmapped at
    max_iter 300 and 60, and per scenario at 300, with the params they ran
    on (compiles for minutes, so tier 1 reads the record)."""
    jn = j_build_nlp()
    params = jn.default_params()
    lmps = _lmp_batch(8, 24)
    batched = {"p": {**params["p"], "lmp": lmps}, "fixed": params["fixed"]}
    axes = ({"p": {k: (0 if k == "lmp" else None) for k in params["p"]}, "fixed": None},)
    out = {"batched": jax.tree_util.tree_map(np.asarray, batched)}
    for mi in (300, 60):
        res = jax.jit(jax.vmap(j_make_ipm(jn, JIPMOptions(max_iter=mi)), in_axes=axes))(batched)
        out[f"max_iter_{mi}"] = {k: np.asarray(getattr(res, k))
                                 for k in ("status", "obj", "iterations")}
    one = jax.jit(j_make_ipm(jn, JIPMOptions(max_iter=300)))
    out["per_scenario_iters"] = np.array([
        int(one({"p": {**params["p"], "lmp": lmps[s]}, "fixed": params["fixed"]}).iterations)
        for s in range(8)])
    return out


def test_flagship_takes_the_structured_path():
    nlp = t_build_nlp()
    assert nlp.n + nlp.m_ineq >= 256  # kkt="auto" probes for structure
    assert t_st.detect_time_structure(nlp, device=CPU) is not None


def test_flagship_ipm_matches_jax(flagship):
    res = make_ipm_solver(t_build_nlp(), IPMOptions(max_iter=300), device=CPU)(
        flagship["batched"])
    want = flagship[300]
    np.testing.assert_array_equal(res.status.numpy(), want["status"])
    assert (want["status"] == 0).all()
    np.testing.assert_allclose(res.obj.numpy(), want["obj"], rtol=1e-7)
    its = res.iterations.numpy()
    stable = want["iterations"] == flagship["per_scenario_iters"]
    assert stable.any()
    np.testing.assert_array_equal(its[stable], want["iterations"][stable])


def test_entry_matches_jax_at_60(flagship):
    """entry()'s own setting (max_iter 60): the same per-lane statuses as
    JAX (lanes 0 and 4 stop unconverged) and objectives within 1e-7."""
    fn, (batched,) = entry(device=CPU)
    obj = fn(batched)
    want = flagship[60]
    np.testing.assert_allclose(obj.numpy(), want["obj"], rtol=1e-7)
    res = make_ipm_solver(t_build_nlp(), IPMOptions(max_iter=60), device=CPU)(batched)
    np.testing.assert_array_equal(res.status.numpy(), want["status"])
    assert res.obj.dtype == F64 and res.obj.shape == (8,)


def test_matrix_free_cg_products_match_explicit(monkeypatch):
    """Above ``_J_BUDGET`` the CG products replay the VJP/JVP graphs (the
    JAX package's matrix-free form) instead of taking J explicitly: the
    same solve either way, on the structured path."""
    from dispatches_tpu_torch.solvers import ipm as t_ipm

    _, tn = _toy_pair(17)
    opts = IPMOptions(kkt="structured", max_iter=60)
    explicit = make_ipm_solver(tn, opts, device=CPU)(tn.default_params())
    monkeypatch.setattr(t_ipm, "_J_BUDGET", 0)
    free = make_ipm_solver(tn, opts, device=CPU)(tn.default_params())
    assert int(free.status) == int(explicit.status) == 0
    assert float(free.obj) == pytest.approx(float(explicit.obj), rel=1e-9)
