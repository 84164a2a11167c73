"""The port's supercritical plant with the concrete TES charging at a
0.1 HP split (``case_studies/fossil/scpc_plant.py``) held to the JAX
package on the CPU, in float64 (the seam of ``tests/test_torch_scpc.py``:
each file builds one JAX plant, ~50 s of JAX's compile here).

* ``tests/test_scpc_plant.py``'s census on the port, square.
* Slow (~70 s, the tier-1 clock): the flowsheet (n 1201) built in both
  packages, the port's ``initialize`` warm start carried into JAX's: the
  same layout (bounds and fixed values within ``SAT_RTOL``: the TES's
  in-tube saturation constants), and the residual rows at that x0 within
  1e-10 of each row's terms.
* Slow: the plant solved on the port alone (``test_scpc_with_tes_solve``,
  ~100 s): 625 MW at rel 1e-2 and JAX's landed value
  ``JAX_NET_POWER_MW`` within 1e-6 relative, the charge flow 0.1 x the
  boiler flow, charging h_in > h_out, then
  ``unfix_dof_for_optimization``; and in both packages
  (``test_solves_match_jax``, ~4 min): x0 within ``X0_RTOL``, the solved
  x within 1e-8, the net powers within 1e-9 of ``JAX_NET_POWER_MW``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu_torch.case_studies.fossil import scpc_plant as sp  # noqa: E402
from test_torch_scpc import census, layout_and_rows, solves_match_jax  # noqa: E402
from torch_fossil_cases import CPU  # noqa: E402

TES = True


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one intra-op thread, as the other test_torch_* modules."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def plant():
    """The port's plant, built and initialized."""
    m = sp.build_scpc_flowsheet(include_concrete_tes=TES)
    sp.initialize(m)
    return m


def test_census(plant):
    census(plant, TES)


@pytest.mark.slow  # ~70 s: JAX's eager compile probing of the plant (the tier-1 clock)
def test_layout_and_rows_match_jax(plant):
    layout_and_rows(plant, TES, 1201)


@pytest.mark.slow  # ~100 s: the TES-coupled Newton solve on one CPU thread
def test_scpc_with_tes_solve():
    m = sp.build_scpc_flowsheet(include_concrete_tes=True)
    sp.initialize(m)
    nlp, res = sp.solve_plant(m, device=CPU)
    assert bool(res.converged)
    sol = nlp.unravel(res.x)
    net = float(np.ravel(sol["net_power_output"])[0])
    assert net == pytest.approx(625.0, rel=1e-2)
    assert abs(net - sp.JAX_NET_POWER_MW[True]) <= 1e-6 * sp.JAX_NET_POWER_MW[True]
    h_in = float(np.ravel(sol["tes.inlet_charge.enth_mol"])[0])
    h_out = float(np.ravel(sol["tes.outlet_charge.enth_mol"])[0])
    F_chg = float(np.ravel(sol["tes.inlet_charge.flow_mol"])[0])
    assert F_chg == pytest.approx(0.1 * sp.BOILER_FLOW, rel=1e-6)
    assert h_in > h_out
    sp.unfix_dof_for_optimization(m)
    for name in ("boiler.inlet.flow_mol", "hp_splitter.split_fraction_2",
                 "tes.inlet_discharge.flow_mol"):
        assert not m.fs.var_specs[name].fixed, name


@pytest.mark.slow  # ~4 min of this CPU: JAX's initialization, compile and solve
def test_solves_match_jax():
    solves_match_jax(TES)
