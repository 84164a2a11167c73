"""The PyTorch port's solver-log decoders (``dispatches_tpu_torch.obs.solverlog``)
held to the JAX package's ``obs.solverlog``.

- On one trace dict (numpy, and the same values as CPU tensors) both
  packages' ``decode_pdlp`` / ``decode_ipm`` / ``decode_newton`` give equal
  ``ConvergenceTrace`` s: rows, columns bitwise, ``start_kind``, ``tail()``
  and ``format()``.
- The port's own ``trace=True`` solves, decoded, match JAX's decoded
  traces on the serve CLI's battery-arbitrage LP (PDLP at float64 tol
  1e-8; the IPM at tol 1e-9) and on a 3-period square system (Newton):
  rows and the integer ``it`` column equal, float columns within the
  tolerances ``test_torch_pdlp.py``, ``test_torch_ipm.py`` and
  ``test_torch_usc.py`` state for the raw traces.  JAX's three traced
  solves are recorded in ``tests/data/solverlog_traces_jax.json``
  (``tests/torch_records.py``), which ``test_solverlog_jax_record_is_current``
  (slow) holds to fresh JAX solves bitwise.
"""

from typing import NamedTuple, Optional

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dispatches_tpu import Flowsheet as JFlowsheet  # noqa: E402
from dispatches_tpu.obs import solverlog as jlog  # noqa: E402
from dispatches_tpu.serve.__main__ import _arbitrage_nlp as j_arbitrage  # noqa: E402
from dispatches_tpu.solvers import IPMOptions as JIPMOptions  # noqa: E402
from dispatches_tpu.solvers import PDLPOptions as JPDLPOptions  # noqa: E402
from dispatches_tpu.solvers import make_ipm_solver as j_make_ipm  # noqa: E402
from dispatches_tpu.solvers import make_pdlp_solver as j_make_pdlp  # noqa: E402
from dispatches_tpu.solvers.newton import NewtonOptions as JNewtonOptions  # noqa: E402
from dispatches_tpu.solvers.newton import make_newton_solver as j_make_newton  # noqa: E402

from dispatches_tpu_torch.core.graph import Flowsheet as TFlowsheet  # noqa: E402
from dispatches_tpu_torch.obs import solverlog as tlog  # noqa: E402
from dispatches_tpu_torch.serve.__main__ import _arbitrage_nlp as t_arbitrage  # noqa: E402
from dispatches_tpu_torch.solvers import IPMOptions, PDLPOptions  # noqa: E402
from dispatches_tpu_torch.solvers import make_ipm_solver, make_pdlp_solver  # noqa: E402
from dispatches_tpu_torch.solvers.newton import NewtonOptions, make_newton_solver  # noqa: E402
import torch_records  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

CPU = "cpu"
PRICE = np.array([12.0, 55.0, 20.0, 61.0, 8.0, 40.0])
PDLP_RTOL, PDLP_ATOL = 1e-6, 1e-14     # test_torch_pdlp.py's trace tolerance
IPM_RTOL, IPM_ATOL = 1e-6, 1e-12       # test_torch_ipm.py's
NEWTON_RTOL, NEWTON_FLOOR = 1e-8, 1e-6  # test_torch_usc.py's (above the floor)
TRACE_RECORD = "solverlog_traces_jax"
PDLP_KW = dict(tol=1e-8, dtype="float64", max_iter=4000)
IPM_T, IPM_KW = 4, dict(tol=1e-9, max_iter=40)


class _Res(NamedTuple):
    iters: object = None
    iterations: object = None
    start_kind: Optional[object] = None


def _same(a, b):
    assert (a.solver, a.iterations, a.start_kind) == (b.solver, b.iterations, b.start_kind)
    assert list(a.columns) == list(b.columns)
    for k in a.columns:
        assert a.columns[k].dtype == b.columns[k].dtype, k
        np.testing.assert_array_equal(a.columns[k], b.columns[k])
    assert a.tail(5) == b.tail(5)
    assert a.format(every=2) == b.format(every=2)


def test_api_matches_jax():
    assert tlog.__all__ == jlog.__all__
    assert tlog._START_KIND_NAMES == jlog._START_KIND_NAMES


@pytest.mark.parametrize("lanes", [None, 3])
def test_decoders_equal_jax_on_one_trace_dict(lanes):
    rng = np.random.default_rng(5)
    shape = (12,) if lanes is None else (lanes, 12)
    it = np.cumsum(np.full(shape, 40, np.int32), axis=-1)
    it[..., 9:] = it[..., 8:9]  # finished: the last check repeats
    pdlp = {"it": it, **{k: rng.lognormal(-8, 2, shape) for k in
                         ("err", "err_best", "pr", "du", "gap")}}
    ipm = {"mu": rng.lognormal(-5, 2, shape), "kkt_error": rng.lognormal(-6, 2, shape),
           "alpha": rng.random(shape), "stall": rng.integers(0, 3, shape).astype(np.int32)}
    newton = {"max_residual": rng.lognormal(-10, 3, shape)}
    n = (1,) if lanes is None else (lanes,)
    res_p = _Res(iters=np.full(n, 360).squeeze(), start_kind=np.full(n, 2).squeeze())
    res_i = _Res(iterations=np.full(n, 7).squeeze())
    as_t = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}  # noqa: E731
    for lane in range(lanes or 1):
        for dec, tr, res in (("decode_pdlp", pdlp, res_p), ("decode_ipm", ipm, res_i),
                             ("decode_newton", newton, res_i)):
            want = getattr(jlog, dec)(tr, res, lane=lane)
            _same(getattr(tlog, dec)(tr, res, lane=lane), want)
            t_res = _Res(*(None if f is None else torch.as_tensor(f) for f in res))
            _same(getattr(tlog, dec)(as_t(tr), t_res, lane=lane), want)
            _same(getattr(tlog, dec)(tr, lane=lane), getattr(jlog, dec)(tr, lane=lane))


def _params(nlp, T):
    d = nlp.default_params()
    return {"p": {**d["p"], "price": PRICE[:T]}, "fixed": d["fixed"]}


def _close(got, want, rtol, atol, floor=None):
    assert got.iterations == want.iterations > 1
    assert list(got.columns) == list(want.columns)
    assert got.start_kind == want.start_kind
    for k in want.columns:
        g, w = got.columns[k], want.columns[k]
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
            continue
        if floor is not None:
            big = w > floor
            np.testing.assert_allclose(g[big], w[big], rtol=rtol)
            assert np.all(g[~big] <= floor)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _jax_res(rec):
    return _Res(iters=rec.get("iters"), iterations=rec.get("iterations"),
                start_kind=rec.get("start_kind"))


def test_pdlp_trace_decodes_like_jax():
    T = len(PRICE)
    tn = t_arbitrage(T)
    rec = torch_records.read(TRACE_RECORD)["pdlp"]
    tres, ttr = make_pdlp_solver(tn, PDLPOptions(**PDLP_KW), trace=True, device=CPU)(
        _params(tn, T))
    assert bool(tres.converged) and bool(rec["converged"])
    _close(tlog.decode_pdlp(ttr, tres), jlog.decode_pdlp(rec["trace"], _jax_res(rec)),
           PDLP_RTOL, PDLP_ATOL)


def test_ipm_trace_decodes_like_jax():
    tn = t_arbitrage(IPM_T)
    rec = torch_records.read(TRACE_RECORD)["ipm"]
    tres, ttr = make_ipm_solver(tn, IPMOptions(**IPM_KW), trace=True, device=CPU)(
        _params(tn, IPM_T))
    assert int(tres.status) == int(rec["status"]) == 0
    _close(tlog.decode_ipm(ttr, tres), jlog.decode_ipm(rec["trace"], _jax_res(rec)),
           IPM_RTOL, IPM_ATOL)


def _square(Flowsheet, xp):
    fs = Flowsheet(horizon=3)
    fs.add_var("a", lb=0.0, ub=3.0, init=2.9, scale=2.0)
    fs.add_var("b", lb=-5.0, ub=5.0, init=-4.0)
    fs.add_var("c", lb=0.05, ub=10.0, init=9.0, scale=5.0)
    fs.add_param("k", np.array([1.0, 1.5, 2.0]))
    fs.add_eq("e1", lambda v, p: v["a"] ** 2 + v["b"] - 2.0 * p["k"])
    fs.add_eq("e2", lambda v, p: v["b"] * v["c"] - 1.5 + 0.1 * v["a"], scale=2.0)
    fs.add_eq("e3", lambda v, p: xp.exp(0.3 * v["a"]) + v["c"] - 3.0 * p["k"])
    return fs.compile()


def jax_record():
    """JAX's traced PDLP, IPM and Newton solves of the three models."""
    host = lambda tr: {k: np.asarray(v) for k, v in tr.items()}  # noqa: E731
    T = len(PRICE)
    jn = j_arbitrage(T)
    res, tr = jax.jit(j_make_pdlp(jn, JPDLPOptions(**PDLP_KW), trace=True))(_params(jn, T))
    out = {"pdlp": {"trace": host(tr), "iters": np.asarray(res.iters),
                    "converged": np.asarray(res.converged)}}
    jn = j_arbitrage(IPM_T)
    res, tr = jax.jit(j_make_ipm(jn, JIPMOptions(**IPM_KW), trace=True))(_params(jn, IPM_T))
    out["ipm"] = {"trace": host(tr), "iterations": np.asarray(res.iterations),
                  "status": np.asarray(res.status)}
    jn = _square(JFlowsheet, jnp)
    res, tr = jax.jit(j_make_newton(jn, JNewtonOptions(), trace=True))(jn.default_params())
    out["newton"] = {"trace": host(tr), "iterations": np.asarray(res.iterations),
                     "converged": np.asarray(res.converged)}
    return out


@pytest.mark.slow
def test_solverlog_jax_record_is_current():
    assert torch_records.matches(TRACE_RECORD, jax_record())


def test_newton_trace_decodes_like_jax():
    tn = _square(TFlowsheet, torch)
    rec = torch_records.read(TRACE_RECORD)["newton"]
    tres, ttr = make_newton_solver(tn, NewtonOptions(), trace=True, device=CPU)(
        tn.default_params())
    assert bool(tres.converged) and bool(rec["converged"])
    got, want = tlog.decode_newton(ttr, tres), jlog.decode_newton(rec["trace"], _jax_res(rec))
    _close(got, want, NEWTON_RTOL, None, floor=NEWTON_FLOOR)
