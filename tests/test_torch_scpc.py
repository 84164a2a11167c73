"""The port's 692 MW supercritical plant
(``case_studies/fossil/scpc_plant.py``) without the concrete TES held to
the JAX package on the CPU, in float64 (the plant with the TES is
``tests/test_torch_scpc_tes.py``: each file builds one JAX plant).

* ``tests/test_scpc_plant.py``'s census on the port, square.
* The flowsheet built in both packages, the port's ``initialize`` warm
  start carried into JAX's flowsheet (JAX's eager ``initialize`` of the
  plant takes ~35 s; its compile's probing ~40 s more): the same layout,
  and the residual rows at that x0 within 1e-10 of each row's terms.
* The plant solved by Newton on the port's CPU: 692 MW at rel 1e-2 and
  JAX's landed value ``JAX_NET_POWER_MW`` within 1e-6 relative; the BFP
  turbine's work equals the BFP's (1e-9).
* Slow: the plant built, initialized and solved in both packages
  (``test_solves_match_jax``, ~2 min of this CPU): ``initialize``'s x0
  within ``X0_RTOL``, the solved x within 1e-8 relative to max(1, |x|),
  and the net powers within 1e-9 of ``JAX_NET_POWER_MW``.
* The device rule of ``solve_plant``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu.case_studies.fossil import scpc_plant as jsp  # noqa: E402

from dispatches_tpu_torch.case_studies.fossil import scpc_plant as sp  # noqa: E402
from dispatches_tpu_torch.interop import x_from_numpy  # noqa: E402
from torch_fossil_cases import (  # noqa: E402
    CPU,
    assert_rows_match,
    assert_same_layout,
    jax_rows,
    np_,
    x0_gap,
)

SAT_RTOL = 1e-10   # the TES's saturation constants (tests/test_torch_concrete_tes.py)
#: initialize's x0, per entry relative to max(1, |x0|) (the scaled vector):
#: the gap, 4.3e-9 at turbine 9's work, is its wet exhaust's h_ps into the
#: dome at the condenser pressure, where the two packages' saturation
#: solvers' pressure noise shows (as at the USC plant's turbine 11,
#: tests/test_torch_usc.py's X0_RTOL)
X0_RTOL = 1e-8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one intra-op thread, as the other test_torch_* modules."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


TES = False


@pytest.fixture(scope="module")
def plant():
    """The port's plant, built and initialized."""
    m = sp.build_scpc_flowsheet(include_concrete_tes=TES)
    sp.initialize(m)
    return m


def census(m, tes):
    """tests/test_scpc_plant.py's census of the units, and squareness."""
    u = m.units
    assert ("tes" in u) == ("discharge_turbine" in u) == tes
    for name in ("boiler", "reheater", "hp_splitter", "bfpt", "condenser", "cond_pump", "bfp",
                 "bfp_splitter"):
        assert name in u
    assert sum(1 for k in u if k.startswith("turbine_")) == 9
    assert sum(1 for k in u if k.startswith("t_splitter_")) == 8
    assert sum(1 for k in u if k.startswith("fwh_") and "mix" not in k) == 7
    nlp = m.fs.compile()
    assert nlp.n == nlp.m_eq


def layout_and_rows(m, tes, n):
    """The layout and the residual rows against JAX's flowsheet of the
    same plant, built with the port's warm start."""
    jm = jsp.build_scpc_flowsheet(include_concrete_tes=tes)
    for name, spec in m.fs.var_specs.items():
        jm.fs.set_init(name, np.array(spec.init, dtype=np.float64))
    nlp, jn = m.fs.compile(), jm.fs.compile()
    assert_same_layout(nlp, jn, rtol=SAT_RTOL)
    assert nlp.n == jn.n == n
    np.testing.assert_array_equal(np.asarray(jn.x0), nlp.x0)
    x = x_from_numpy(np.asarray(jn.x0), jn, nlp, CPU)
    assert_rows_match(nlp, x, jax_rows(jn, jn.x0)[0])


def solves_match_jax(tes):
    """Both packages build, initialize and solve the plant."""
    m = sp.build_scpc_flowsheet(include_concrete_tes=tes)
    sp.initialize(m)
    jm = jsp.build_scpc_flowsheet(include_concrete_tes=tes)
    jsp.initialize(jm)
    gap = x0_gap(m.fs.compile(), jm.fs.compile())
    print(f"initialize x0 gap {gap:.3e}")
    assert gap <= X0_RTOL
    nlp, res = sp.solve_plant(m, device=CPU)
    jn, jres = jsp.solve_plant(jm)
    assert bool(res.converged) and bool(jres.converged)
    a, b = np_(res.x), np.asarray(jres.x)
    assert float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b)))) <= 1e-8
    net = float(np.ravel(nlp.unravel(res.x)["net_power_output"])[0])
    jnet = float(np.ravel(jn.unravel(jres.x)["net_power_output"])[0])
    print(f"net power: port {net!r}, JAX {jnet!r} MW")
    assert abs(jnet - sp.JAX_NET_POWER_MW[tes]) <= 1e-9 * jnet
    assert abs(net - jnet) <= 1e-9 * jnet


def test_census(plant):
    census(plant, TES)


def test_layout_and_rows_match_jax(plant):
    layout_and_rows(plant, TES, 568)


def test_scpc_without_tes_solve():
    m = sp.build_scpc_flowsheet(include_concrete_tes=False)
    sp.initialize(m)
    nlp, res = sp.solve_plant(m, device=CPU)
    assert bool(res.converged)
    sol = nlp.unravel(res.x)
    net = float(np.ravel(sol["net_power_output"])[0])
    assert net == pytest.approx(692.0, rel=1e-2)
    assert abs(net - sp.JAX_NET_POWER_MW[False]) <= 1e-6 * sp.JAX_NET_POWER_MW[False]
    assert float(np.ravel(sol["bfpt.work_mechanical"])[0]) == pytest.approx(
        -float(np.ravel(sol["bfp.work_mechanical"])[0]), rel=1e-9)
    # the solution was written back as the inits
    assert float(np.ravel(m.fs.var_specs["net_power_output"].init)[0]) == net


@pytest.mark.slow  # ~2 min of this CPU: JAX's initialization, compile and solve
def test_solves_match_jax():
    solves_match_jax(TES)


@pytest.mark.skipif(torch.cuda.is_available(), reason="the CPU-only rule")
def test_solve_plant_follows_the_device_rule(plant):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sp.solve_plant(plant)
