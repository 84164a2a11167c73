"""The PyTorch port's unit ``report()`` stream tables held to the JAX
package's byte for byte, on the CPU: the battery of tests/test_report.py
(solved by each package, with that test's 4.75 / 2.5 anchors) and the
simple hydrogen tank, hydrogen turbine, PEM and mixer of the T = 4 full
hybrid at its initial point, at every time point and with ``dof=True``.
"""

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu import Flowsheet as JFlowsheet  # noqa: E402
from dispatches_tpu.models import BatteryStorage as JBatteryStorage  # noqa: E402
from dispatches_tpu.solvers import solve_nlp as j_solve_nlp  # noqa: E402

from dispatches_tpu_torch.case_studies.renewables import (  # noqa: E402
    wind_battery_pem_tank_turbine_lmp as t_hyb,
)
from dispatches_tpu_torch.core.graph import Flowsheet as TFlowsheet  # noqa: E402
from dispatches_tpu_torch.models import BatteryStorage as TBatteryStorage  # noqa: E402
from dispatches_tpu_torch.solvers import solve_nlp as t_solve_nlp  # noqa: E402

from test_torch_re_hybrid import T_HYB, _params, j_hybrid_nlp  # noqa: E402
from test_torch_stacked import one_torch_thread  # noqa: E402,F401


def _battery(Flowsheet, BatteryStorage, solve):
    """tests/test_report.py's battery: charge at 5 kW for one hour."""
    fs = Flowsheet(horizon=1)
    b = BatteryStorage(fs)
    fs.fix(b.v("nameplate_power"), 5)
    fs.fix(b.v("nameplate_energy"), 20)
    fs.fix(b.v("initial_state_of_charge"), 0)
    fs.fix(b.v("initial_energy_throughput"), 0)
    fs.fix(b.v("elec_in"), 5)
    fs.fix(b.v("elec_out"), 0)
    nlp = fs.compile()
    res = solve(nlp)
    assert bool(res.converged)
    return b, nlp.unravel(res.x)


@pytest.fixture(scope="module")
def batteries():
    return (_battery(JFlowsheet, JBatteryStorage, j_solve_nlp),
            _battery(TFlowsheet, TBatteryStorage, lambda nlp: t_solve_nlp(nlp, device="cpu")))


@pytest.mark.parametrize("dof", [False, True])
def test_battery_report_matches_jax(batteries, dof):
    (jb, jsol), (tb, tsol) = batteries
    buf = io.StringIO()
    got = tb.report(tsol, dof=dof, ostream=buf)
    assert got == buf.getvalue()
    assert got == jb.report(jsol, dof=dof, ostream=io.StringIO())
    for text in ("Unit : battery", "Time: 0", "power_in", "power_out", "kWh",
                 "state_of_charge", "energy_throughput", "4.75", "2.5"):
        assert text in got
    assert ("Local Variable Elements:" in got) == dof


@pytest.fixture(scope="module")
def hybrid_x0():
    """(JAX nlp, port model, port nlp) of the T = 4 full hybrid."""
    params = _params(T_HYB)
    m, tn = t_hyb.wind_battery_pem_tank_turb_nlp(T_HYB, params)
    return j_hybrid_nlp(T_HYB, params), m, tn


@pytest.mark.parametrize("unit", ["h2_tank", "h2_turbine", "pem", "mixer", "battery"])
def test_hybrid_unit_reports_match_jax(hybrid_x0, unit):
    """The reports at x0, every time point, plain and with model
    statistics; solution tensors (the port's unravel is numpy already)
    give the same text."""
    jn, m, tn = hybrid_x0
    jsol = jn.unravel(jn.x0)
    tsol = tn.unravel(torch.as_tensor(tn.x0))
    ju, tu = jn.fs.units[unit], m.units[unit]
    for t in range(T_HYB):
        for dof in (False, True):
            want = ju.report(jsol, time_point=t, dof=dof, ostream=io.StringIO())
            got = tu.report(tsol, time_point=t, dof=dof, ostream=io.StringIO())
            assert got == want, (unit, t, dof)
    as_tensors = {k: torch.as_tensor(np.asarray(v)) for k, v in tsol.items()}
    assert tu.report(as_tensors, ostream=io.StringIO()) == \
        ju.report(jsol, ostream=io.StringIO())
    if unit == "h2_tank":
        assert "tank_holdup_previous" in want and "mol" in want
