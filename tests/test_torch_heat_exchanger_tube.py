"""The port's tube-side heat exchanger (``models/heat_exchanger_tube.py``)
held to the JAX package on the CPU, in float64.

* ``tests/test_heat_exchanger_tube.py`` on the port: the component
  census (square, 20 segments), and the boil-through solve (1 mol/s water
  at 1 atm and 300 K against a 1000 K wall): outlet enthalpy 55,702.16 ±
  1 J/mol, flow 1.0 ± 1e-5, monotone node enthalpies, the tube area.
* The cocurrent case and a countercurrent one (a 900-1000 K wall ramp)
  built in both packages: the same layout (bounds within ``SAT_RTOL``,
  which the saturation constants at 1 atm set, see
  ``tests/test_torch_concrete_tes.py``), ``initialize``'s x0 within
  ``X0_RTOL``, and the residual rows at JAX's x0 within 1e-10 of each
  row's terms.
* ``ConcreteTubeSide`` and ``ConcreteTES`` exported from
  ``dispatches_tpu_torch.models`` as the JAX package exports them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu.core.graph import Flowsheet as JFlowsheet  # noqa: E402
from dispatches_tpu.models import heat_exchanger_tube as jtube  # noqa: E402
from dispatches_tpu.properties import iapws95 as jw95  # noqa: E402

import dispatches_tpu_torch.models as tmodels  # noqa: E402
from dispatches_tpu_torch.core.graph import Flowsheet as TFlowsheet  # noqa: E402
from dispatches_tpu_torch.interop import x_from_numpy  # noqa: E402
from dispatches_tpu_torch.models import heat_exchanger_tube as ttube  # noqa: E402
from dispatches_tpu_torch.properties import iapws95 as tw95  # noqa: E402
from dispatches_tpu_torch.solvers import solve_square  # noqa: E402
from torch_fossil_cases import (  # noqa: E402
    CPU,
    assert_rows_match,
    assert_same_layout,
    jax_rows,
    tube_flowsheet,
    x0_gap,
)

SAT_RTOL = 1e-10     # bounds set by the 1-atm saturation constants (8.5e-12 apart)
X0_RTOL = 1e-9       # initialize's x0, per entry relative to max(1, |x0|)
H_OUT = 55702.16     # J/mol, the reference test's outlet enthalpy (abs 1)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one intra-op thread, as the other test_torch_* modules."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tube():
    return tube_flowsheet(TFlowsheet, ttube, tw95)


def test_build(tube):
    fs, u = tube
    assert u.n_segments == 20
    for attr in ("tube_area", "tube_length", "d_tube_inner", "d_tube_outer", "htc",
                 "temperature_wall"):
        assert getattr(u, attr) is not None
    nlp = fs.compile()
    assert nlp.n == nlp.m_eq  # DoF = 0


def test_solve_regression(tube):
    fs, u = tube
    nlp = fs.compile()
    res = solve_square(nlp, device=CPU)
    assert bool(res.converged)
    sol = nlp.unravel(res.x)
    assert float(np.ravel(sol["unit.tube_outlet.flow_mol"])[0]) == pytest.approx(1.0, abs=1e-5)
    assert float(np.ravel(sol["unit.tube_outlet.enth_mol"])[0]) == pytest.approx(H_OUT, abs=1.0)
    h_nodes = np.ravel(sol["unit.enth_mol"])
    assert np.all(np.diff(h_nodes) > 0)
    assert float(np.ravel(sol["unit.tube_area"])[0]) == pytest.approx(
        np.pi / 4 * 0.01167 ** 2, rel=1e-9)


@pytest.mark.parametrize("flow_type", ["cocurrent", "countercurrent"])
def test_layout_x0_and_rows_match_jax(flow_type):
    tfs, tu = tube_flowsheet(TFlowsheet, ttube, tw95, flow_type)
    jfs, ju = tube_flowsheet(JFlowsheet, jtube, jw95, flow_type)
    nlp, jn = tfs.compile(), jfs.compile()
    assert_same_layout(nlp, jn, rtol=SAT_RTOL)
    assert nlp.n == jn.n
    gap = x0_gap(nlp, jn)
    assert gap <= X0_RTOL, gap
    x = x_from_numpy(np.asarray(jn.x0), jn, nlp, CPU)
    assert_rows_match(nlp, x, jax_rows(jn, jn.x0)[0])


def test_guards_and_exports():
    with pytest.raises(ValueError, match="unknown flow_type"):
        ttube.ConcreteTubeSide(TFlowsheet(horizon=1), "u", flow_type="crossflow")
    assert tmodels.ConcreteTubeSide is ttube.ConcreteTubeSide
    assert "ConcreteTubeSide" in tmodels.__all__ and "ConcreteTES" in tmodels.__all__
    from dispatches_tpu_torch.models.concrete_tes import ConcreteTES
    assert tmodels.ConcreteTES is ConcreteTES
