"""The port's ``BatchedReducedSpaceNLP`` (``solvers/reduced.py``) held to
the JAX package on the CPU, in float64, on the discharge-HX problem of
``tests/test_torch_reduced.py`` (whose fixtures and problem it shares) at
T = 3, with a coupling inequality (a salt budget), coupling equalities
(one area for all hours) and a runtime param (per-hour weights):

* the evaluation against JAX within 1e-9, with the lanes' Newton
  iterations 1, 3 and 9;
* ``solve`` against JAX for ``BATCHED_ITERS`` outer iterations (U within
  1e-6, the objective within 1e-8, the coupling rows within 1e-7);
  re-binding the runtime param moves the result as in JAX; an unknown key
  raises ``KeyError``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from dispatches_tpu.solvers.reduced import BatchedReducedSpaceNLP as JBatched  # noqa: E402

from dispatches_tpu_torch.solvers.reduced import BatchedReducedSpaceNLP  # noqa: E402
from test_torch_reduced import (  # noqa: E402,F401
    CPU,
    LANES,
    SOLVE_KW,
    T,
    _batched,
    _bounds,
    _one_thread,
    problems,
)
from test_torch_stacked import one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def batched(problems):
    jn, tn, dec = problems
    return (_batched(JBatched, jn, dec, jnp),
            _batched(BatchedReducedSpaceNLP, tn, dec, torch, device=CPU))


def test_batched_evaluation_matches_jax(batched, problems):
    jb, tb = batched
    jn, tn, _ = problems
    U = LANES / np.array([100.0, 1e3])
    X0 = np.tile(np.asarray(tn.x0), (T, 1))
    rp_j = {k: jnp.asarray(v) for k, v in jb._rp0.items()}
    want = [np.asarray(o) for o in jb._evaluate_b(jnp.asarray(U), jnp.asarray(X0), rp_j)]
    got = tb._evaluate_b(U, X0, tb.runtime_on_device())
    names = ("X", "f", "g1", "g2", "e3", "dfU", "dG1", "dG2", "dE3")
    assert [g.shape for g in got[:9]] == [w.shape for w in want[:9]]
    for i, what in enumerate(names):
        scale = max(1.0, float(np.max(np.abs(want[i])))) if want[i].size else 1.0
        assert np.max(np.abs(got[i] - want[i]), initial=0.0) <= 1e-9 * scale, what
    assert got[9].tolist() == want[9].tolist() == [True] * T
    assert got[11].tolist() == [1, 3, 9]


#: outer iterations of the batched solves: the two packages' trust-constr
#: paths are held to each other step for step (not run to convergence,
#: which takes ~25 more evaluations of three plants in each package)
BATCHED_ITERS = 6


def test_batched_solve_and_runtime_rebinding_match_jax(batched, problems):
    jb, tb = batched
    _, _, dec = problems
    runs = {}
    for w in (None, np.array([0.2, 3.0, 1.0])):
        rp = None if w is None else {"w": w}
        kw = dict(SOLVE_KW, maxiter=BATCHED_ITERS)
        jr = jb.solve(u_bounds=_bounds(dec), runtime_params=rp, **kw)
        tr = tb.solve(u_bounds=_bounds(dec), runtime_params=rp, **kw)
        assert tr.converged == jr.converged
        assert tr.outer_iterations == jr.outer_iterations == BATCHED_ITERS
        assert tr.inner_failures == jr.inner_failures == 0
        np.testing.assert_allclose(tr.U, jr.U, rtol=0, atol=1e-6)
        assert abs(tr.obj - jr.obj) <= 1e-8 * max(1.0, abs(jr.obj))
        for a, b in ((tr.g_local, jr.g_local), (tr.g_coupling, jr.g_coupling),
                     (tr.eq_coupling, jr.eq_coupling)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-7)
        runs[w is None] = (tr, jr)
    # the re-bound weights move the optimum, in both packages alike
    (t0, j0), (t1, j1) = runs[True], runs[False]
    assert np.max(np.abs(t1.U - t0.U)) > 1e-3
    np.testing.assert_allclose(t1.U - t0.U, j1.U - j0.U, rtol=0, atol=2e-6)
    sol = tb.stack_solution(t0.X, t0.U)
    assert sol[dec[1]].shape == (T,) and sol["hx.tube_outlet.eos.temperature"].shape == (T, 1)
    with pytest.raises(KeyError, match="unknown runtime params"):
        tb.solve(u_bounds=_bounds(dec), runtime_params={"lmp": np.zeros(T)})
    with pytest.raises(KeyError, match="unknown runtime params"):
        jb.solve(u_bounds=_bounds(dec), runtime_params={"lmp": np.zeros(T)})


