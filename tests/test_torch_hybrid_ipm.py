"""The first 15 interior-point iterations of the full hybrid (wind +
battery + PEM + tank + turbine) in the PyTorch port against the JAX
package's, on the CPU in float64, with both solvers traced
(``make_ipm_solver(..., trace=True)``, ``max_iter=15``).

At T = 4 the hybrid has no detectable time structure (detection needs
T >= 8), so both KKT options run the dense Cholesky condensation: the
port's ``kkt="structured"`` run is bitwise its ``"dense"`` run, and the
dense run is held to JAX's.  Its Schur complement is ill-conditioned,
so the iterates depend on how the BLAS blocks its products: the port's
own run on one thread differs from its run on all of them (the gap is
printed).  The barrier parameter is held bitwise, the traced KKT error
and the iterate within 1e-6 relative (the measured gaps are printed
under ``pytest -s``).

The structured path proper runs from T = 8. There its first Newton step
equals the dense path's in the primal; against JAX its 15 iterations take
~3 minutes (the JAX program compiles for most of it), so that case is
marked ``slow``.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu.solvers import IPMOptions as JIPMOptions  # noqa: E402
from dispatches_tpu.solvers import make_ipm_solver as j_make_ipm_solver  # noqa: E402

from dispatches_tpu_torch.case_studies.renewables import (  # noqa: E402
    wind_battery_pem_tank_turbine_lmp as t_hyb,
)
from dispatches_tpu_torch.solvers import IPMOptions, make_ipm_solver  # noqa: E402
from dispatches_tpu_torch.solvers import structured as t_st  # noqa: E402

from test_torch_re_hybrid import _params, j_hybrid_nlp  # noqa: E402

N_ITER = 15
TRACE_RTOL = 1e-6


def _traces(horizon, kkt):
    """(JAX result, JAX trace, port result, port trace) of N_ITER traced
    iterations from the default start."""
    params = _params(horizon)
    jn = j_hybrid_nlp(horizon, params)
    _, tn = t_hyb.wind_battery_pem_tank_turb_nlp(horizon, params)
    jres, jtr = jax.jit(j_make_ipm_solver(jn, JIPMOptions(max_iter=N_ITER, kkt=kkt),
                                          trace=True))(jn.default_params())
    tres, ttr = make_ipm_solver(tn, IPMOptions(max_iter=N_ITER, kkt=kkt), trace=True,
                                device="cpu")(tn.default_params())
    return jres, jtr, tres, ttr, tn


def _rel(got, want):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300)))


def _assert_traces_match(jres, jtr, tres, ttr, label):
    np.testing.assert_array_equal(ttr["mu"].numpy(), np.asarray(jtr["mu"]))
    np.testing.assert_array_equal(ttr["stall"].numpy(), np.asarray(jtr["stall"]))
    assert int(tres.iterations) == int(jres.iterations) == N_ITER
    assert int(tres.status) == int(jres.status)
    err_rel = _rel(ttr["kkt_error"].numpy(), jtr["kkt_error"])
    jx = np.asarray(jres.x)
    x_rel = float(np.max(np.abs(tres.x.numpy() - jx)) / np.max(np.abs(jx)))
    print(f"{label}: traced KKT error max relative gap {err_rel:.3e}, "
          f"iterate {x_rel:.3e}")
    assert err_rel <= TRACE_RTOL
    assert x_rel <= TRACE_RTOL


def test_hybrid_ipm_first_iterations_match_jax():
    jres, jtr, tres, ttr, tn = _traces(4, "dense")
    _assert_traces_match(jres, jtr, tres, ttr, "T=4 dense")
    # "structured" finds no time structure at T = 4: the same solver
    assert t_st.detect_time_structure(tn, device="cpu") is None
    sres, strace = make_ipm_solver(tn, IPMOptions(max_iter=N_ITER, kkt="structured"),
                                   trace=True, device="cpu")(tn.default_params())
    assert torch.equal(sres.x, tres.x)
    for k in ("mu", "kkt_error", "alpha", "stall"):
        assert torch.equal(strace[k], ttr[k]), k
    # the port's own spread: the same solve on one BLAS thread
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ores, otr = make_ipm_solver(tn, IPMOptions(max_iter=N_ITER, kkt="dense"), trace=True,
                                    device="cpu")(tn.default_params())
    finally:
        torch.set_num_threads(threads)
    print(f"T=4 dense, one BLAS thread against {threads}: traced KKT error max relative gap "
          f"{_rel(otr['kkt_error'].numpy(), ttr['kkt_error'].numpy()):.3e}, iterate "
          f"{float((ores.x - tres.x).abs().max() / tres.x.abs().max()):.3e}")


def test_hybrid_kkt_paths_take_the_same_first_step():
    """T = 8, where the structured path runs: its first Newton step (W by
    coloured Hessian-vector products) equals the dense path's (W by
    ``jacrev(grad)``) in the primal.  The multipliers differ in the null
    space of J, which is rank-deficient here; they enter W from the
    second iteration on, so the two paths part there."""
    _, tn = t_hyb.wind_battery_pem_tank_turb_nlp(8, _params(8))
    assert t_st.detect_time_structure(tn, device="cpu") is not None
    step = {kkt: make_ipm_solver(tn, IPMOptions(max_iter=1, kkt=kkt), device="cpu")(
        tn.default_params()) for kkt in ("structured", "dense")}
    s, d = step["structured"], step["dense"]
    assert int(s.iterations) == int(d.iterations) == 1
    assert float((d.x - s.x).abs().max() / s.x.abs().max()) <= TRACE_RTOL
    assert float((d.lam - s.lam).abs().max() / s.lam.abs().max()) > TRACE_RTOL


@pytest.mark.slow
def test_hybrid_structured_ipm_first_iterations_match_jax():
    """T = 8: the bordered block-tridiagonal KKT solve with the turbine's
    nonzero Hessian blocks, against JAX's structured path."""
    jres, jtr, tres, ttr, tn = _traces(8, "structured")
    assert t_st.detect_time_structure(tn, device="cpu") is not None
    _assert_traces_match(jres, jtr, tres, ttr, "T=8 structured")
