"""The multiperiod hour-plant (``storage_multiperiod.create_usc_model``)
and the batched reduced-space evaluation built on it, held to the JAX
package on the CPU, in float64.

* One JAX fixture: ``create_usc_model`` at ``MultiPeriodUscModel``'s power
  envelope from the checkpoint ``INIT``, and its
  compile, with one jitted forward derivative of its residual and
  inequalities.  No JAX Newton solve and no reduced-space jit run (JAX's
  vmapped evaluation of this plant takes tens of minutes to compile).
* The layouts are equal; at the checkpoint x the port's residual and
  inequality rows are within 1e-10 of each row's term size of JAX's.
* A T = 2 batched evaluation of the port's ``MultiPeriodUscModel`` at the
  feasible decisions (boiler flows 1.0 and 0.97 x design).  At each
  hour's solution and for each decision u_j:
  - JAX's inequality rows equal the port's g (1e-10 of the row terms);
  - the tangent dx/du_j from the port's Jacobians solves JAX's
    linearised residual, and JAX's derivative of the inequality rows
    along it equals the port's adjoint dG column, each row within 1e-10
    of its terms plus the rounding of its column (``_deriv_err``);
  - ``MultiPeriodUscModel``'s objective, coupling inequalities and
    periodic row, as JAX builds them, give the port's f, g2 and e3, and
    their JAX derivatives along the same tangents give the port's dfU,
    dG2 and dE3.  JAX's closures are taken from its own
    ``MultiPeriodUscModel`` with the batched solver replaced by a
    recorder, so no JAX solver is built.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dispatches_tpu.case_studies.fossil import storage_multiperiod as jsmp  # noqa: E402
from dispatches_tpu.core.graph import Vals as JVals  # noqa: E402

from dispatches_tpu_torch.case_studies.fossil import storage_multiperiod as smp  # noqa: E402
from dispatches_tpu_torch.interop import x_from_numpy  # noqa: E402
from torch_storage_cases import layout  # noqa: E402

CPU = "cpu"
INIT = Path(__file__).parent / "data" / "integrated_storage_usc_init"
LMP = np.array([22.0, 200.0])
BOILER_FRACS = (1.0, 0.97)
ROW_RTOL = 1e-10    # values and derivatives, relative to each row's terms
EPS = np.finfo(np.float64).eps


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one intra-op thread, as the other test_torch_* modules."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class _Recorder:
    """Stands in for JAX's ``BatchedReducedSpaceNLP`` inside its
    ``MultiPeriodUscModel``: keeps the objective, the coupling rows and
    the runtime params, builds nothing."""

    def __init__(self, nlp, decisions, T, objective, sense, coupling_ineqs=(),
                 coupling_eqs=(), runtime_params=None, **_):
        self.objective, self.sense = objective, sense
        self.coupling_ineqs, self.coupling_eqs = list(coupling_ineqs), list(coupling_eqs)
        self.runtime_params = dict(runtime_params or {})


@pytest.fixture(scope="module")
def jax_hour():
    # the envelope MultiPeriodUscModel builds with (pmin 284, pmax 466)
    m = jsmp.create_usc_model(jsmp.PMIN_DEFAULT, jsmp.PMAX_DEFAULT, load_from_file=INIT)
    nlp = m.fs.compile()
    p = nlp.default_params()

    def rows(x, fx):
        q = {"p": p["p"], "fixed": {**p["fixed"], **fx}}
        return jnp.concatenate([nlp.eq(x, q), nlp.ineq(x, q)])

    lin = jax.jit(lambda x, fx, dx, dfx: jax.jvp(rows, (x, fx), (dx, dfx)))
    mp = pytest.MonkeyPatch()
    mp.setattr(jsmp, "BatchedReducedSpaceNLP", _Recorder)
    mp.setattr(jsmp, "create_usc_model", lambda *a, **k: m)
    mp.setattr(m.fs, "compile", lambda *a, **k: nlp)
    try:
        jmp = jsmp.MultiPeriodUscModel(n_time_points=2, periodic=True, lmp=LMP)
    finally:
        mp.undo()
    return nlp, lin, jmp.brs


@pytest.fixture(scope="module")
def port_eval():
    mp = smp.MultiPeriodUscModel(n_time_points=2, periodic=True, lmp=LMP,
                                 load_from_file=INIT, device=CPU)
    brs = mp.brs
    U = smp.feasible_U(brs, 2, BOILER_FRACS)
    out = brs._evaluate_b(U, np.tile(mp.nlp.x0, (2, 1)), brs.runtime_on_device())
    assert out[9].tolist() == [True, True]
    return mp, U, out


def _port_jacobians(mp, x, u):
    """The port's eq and ineq Jacobians in x and in the scaled decisions
    at one hour's (x, u)."""
    base, nlp = mp.brs.base, mp.nlp
    x, u = torch.as_tensor(x), torch.as_tensor(u)

    def rows(xx, uu):
        q = base._patch(base._params0, uu)
        return torch.cat([nlp.eq(xx, q), nlp.ineq(xx, q)])

    Rx, Ru = torch.func.jacfwd(rows, argnums=(0, 1))(x, u)
    return _np(Rx), _np(Ru)


def _jax_decisions(mp, u, du=None):
    """The decision entries of the params (and their tangents) for the
    scaled decisions ``u``, as the port's ``_patch`` writes them."""
    fx, dfx = {}, {}
    for d, (a, b, shape, scale) in mp.brs.base._u_layout.items():
        fx[d] = jnp.asarray((np.asarray(u[a:b]) * scale).reshape(shape))
        dv = np.zeros(b - a) if du is None else np.asarray(du[a:b])
        dfx[d] = jnp.asarray((dv * scale).reshape(shape))
    return fx, dfx


def _row_err(got, want, terms):
    """Largest |got - want| over each row's term size."""
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want)) / terms))


def _deriv_err(got, want, terms):
    """Largest |got - want| over ROW_RTOL x each row's terms plus the
    rounding of a sum of ``len(terms)`` terms of the column's largest
    size: at most 1 where the two agree.  A row whose terms cancel to
    rounding (a tangent entry of 1e-17 where its column has 1e4) is held
    at that rounding."""
    bound = ROW_RTOL * terms + EPS * terms.size * terms.max()
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want)) / bound))


def test_hour_plant_layout_and_rows_at_the_checkpoint(jax_hour, port_eval):
    jn, lin, _ = jax_hour
    mp = port_eval[0]
    nlp = mp.nlp
    assert layout(nlp) == layout(jn)
    x0 = _np(x_from_numpy(np.asarray(jn.x0), jn, nlp, CPU))
    u0 = mp.brs.base.u0
    fx, dfx = _jax_decisions(mp, u0)
    r_j, _ = lin(jnp.asarray(x0), fx, jnp.zeros_like(jnp.asarray(x0)), dfx)
    q = mp.brs.base._patch(mp.brs.base._params0, torch.as_tensor(u0))
    xt = torch.as_tensor(x0)
    r_p = np.concatenate([_np(nlp.eq(xt, q)), _np(nlp.ineq(xt, q))])
    assert r_p.shape == (nlp.n + 24,)
    Rx, _ = _port_jacobians(mp, x0, u0)
    terms = np.maximum(1.0, np.abs(Rx) @ np.abs(x0))
    assert _row_err(r_p, r_j, terms) <= ROW_RTOL


def test_batched_evaluation_matches_jax_linearisation(jax_hour, port_eval):
    jn, lin, jbrs = jax_hour
    mp, U, out = port_eval
    n, m_u, T = mp.nlp.n, mp.brs.base.m_u, 2
    X, f, g1, g2, e3, dfU, dG1, dG2, dE3 = out[:9]
    m1 = g1.shape[1]
    assert (m1, g2.shape[0], e3.shape[0]) == (24, 4 * T + 2 * T, 1)

    # the stacked physical values of both lanes, the closures' input
    sol = mp.brs.stack_solution(X, U)
    scale = np.asarray(mp.nlp.var_scale)
    pj = JVals({**{k: jnp.asarray(v) for k, v in jn.default_params()["p"].items()},
                **{k: jnp.asarray(v) for k, v in jbrs.runtime_params.items()}})
    sgn = -1.0 if jbrs.sense == "max" else 1.0

    def closures(d):
        vb = JVals(d)
        return jnp.concatenate([
            jnp.atleast_1d(sgn * jbrs.objective(vb, pj)),
            *[jnp.ravel(fn(vb, pj)) for _, fn in jbrs.coupling_ineqs],
            *[jnp.ravel(fn(vb, pj)) for _, fn in jbrs.coupling_eqs]])

    primal = {k: jnp.asarray(v) for k, v in sol.items()}
    c_j = np.asarray(closures(primal))
    c_p = np.concatenate([[float(f)], g2, e3])
    assert np.max(np.abs(c_j - c_p) / np.maximum(1.0, np.abs(c_p))) <= ROW_RTOL

    worst = {"g": 0.0, "coupling": 0.0}      # relative, at most ROW_RTOL
    ratio = {"tangent": 0.0, "dG": 0.0}      # _deriv_err, at most 1
    for t in range(T):
        x, u = X[t], U[t]
        Rx, Ru = _port_jacobians(mp, x, u)
        Jx, Fu, Gx, Gu = Rx[:n], Ru[:n], Rx[n:], Ru[n:]
        dX = -np.linalg.solve(Jx, Fu)                       # (n, m_u)
        fx, _ = _jax_decisions(mp, u)
        r_j, _ = lin(jnp.asarray(x), fx, jnp.zeros(n), _jax_decisions(mp, u)[1])
        g_terms = np.maximum(1.0, np.abs(Gx) @ np.abs(x))
        worst["g"] = max(worst["g"], _row_err(g1[t], np.asarray(r_j)[n:], g_terms))
        for j in range(m_u):
            e = np.zeros(m_u)
            e[j] = 1.0
            _, dfx = _jax_decisions(mp, u, e)
            _, dr = lin(jnp.asarray(x), fx, jnp.asarray(dX[:, j]), dfx)
            dr = np.asarray(dr)
            eq_terms = np.abs(Jx) @ np.abs(dX[:, j]) + np.abs(Fu[:, j])
            ratio["tangent"] = max(ratio["tangent"], _deriv_err(dr[:n], 0.0, eq_terms))
            dg_terms = np.abs(Gx) @ np.abs(dX[:, j]) + np.abs(Gu[:, j])
            ratio["dG"] = max(ratio["dG"], _deriv_err(dG1[t][:, j], dr[n:], dg_terms))
            # the closures along the same tangent (lane t only)
            DX = np.zeros((T, n))
            DX[t] = dX[:, j]
            DU = np.zeros((T, m_u))
            DU[t, j] = 1.0
            tan = {}
            for name, (a, b, shape) in mp.nlp._slices.items():
                tan[name] = jnp.asarray((DX[:, a:b] * scale[a:b]).reshape((T,) + tuple(shape)))
            for name in mp.nlp.fixed_names:
                if name in mp.brs.base._u_layout:
                    a, b, shape, sc = mp.brs.base._u_layout[name]
                    tan[name] = jnp.asarray((DU[:, a:b] * sc).reshape((T,) + tuple(shape)))
                else:
                    tan[name] = jnp.zeros_like(primal[name])
            _, dc = jax.jvp(closures, (primal,), (tan,))
            dc_p = np.concatenate([[dfU[t, j]], dG2[:, t, j], dE3[:, t, j]])
            worst["coupling"] = max(worst["coupling"], float(np.max(
                np.abs(np.asarray(dc) - dc_p) / np.maximum(1.0, np.abs(dc_p)))))
    assert max(worst.values()) <= ROW_RTOL, worst
    assert max(ratio.values()) <= 1.0, ratio
