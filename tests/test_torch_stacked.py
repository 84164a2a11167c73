"""The PyTorch port's config tier and scenario-stacked NLP held to the JAX
package on the CPU, in float64.

- ``core/config.py``: every case of tests/test_config.py, run against the
  port's module (the same test source with the port's imports);
- ``StackedScenarioNLP`` in both couplings (``"first_stage"``, the
  SelfScheduler's; ``"monotone"``, the Bidder's) over
  ``MultiPeriodWindBattery`` at tests/test_stacked_bidder.py's sizes
  (T = 24, S = 3): the layout (``n``, ``lb``, ``ub``, ``x0``,
  ``var_scale``, slices) exactly; objective, eq, ineq and their Jacobians
  at x0 and at a seeded random x within 1e-12 relative (the max-norm of
  the difference over max(1, the max-norm of JAX's value));
- the stacked IPM solve against JAX's (equal iterations and status, x
  within 1e-8) is held in tests/test_torch_grid.py, on the same two
  programs, where the bidders solve them.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dispatches_tpu.case_studies.renewables.wind_battery_double_loop import (  # noqa: E402
    MultiPeriodWindBattery as JMP,
)
from dispatches_tpu import grid as jgrid  # noqa: E402

from dispatches_tpu_torch.case_studies.renewables.wind_battery_double_loop import (  # noqa: E402
    MultiPeriodWindBattery as TMP,
)
from dispatches_tpu_torch import grid as tgrid  # noqa: E402

from test_torch_h2_models import assert_rel  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

RTOL = 1e-12
T_DA, T_RT = 24, 4


# ---------------------------------------------------------------------------
# core/config.py: tests/test_config.py on the port
# ---------------------------------------------------------------------------

_SRC = (Path(__file__).resolve().parent / "test_config.py").read_text()
_SRC = _SRC.replace("from dispatches_tpu.core import", "from dispatches_tpu_torch.core.config import")
_SRC = _SRC.replace("dispatches_tpu.", "dispatches_tpu_torch.")
assert "dispatches_tpu." not in _SRC.replace("dispatches_tpu_torch.", "")
_NS: dict = {}
exec(compile(_SRC, "test_config.py (on dispatches_tpu_torch)", "exec"), _NS)
for _name, _fn in list(_NS.items()):
    if _name.startswith("test_") and callable(_fn):
        globals()[f"{_name}_on_the_port"] = _fn
del _name, _fn


def test_config_cases_collected():
    ported = [k for k in globals() if k.endswith("_on_the_port")]
    assert len(ported) >= 12


# ---------------------------------------------------------------------------
# the stacked program
# ---------------------------------------------------------------------------


class FixedForecaster:
    def __init__(self, scenarios):
        self.scenarios = np.asarray(scenarios, float)  # (S, H)

    def forecast_day_ahead_prices(self, date, hour, bus, horizon, n):
        return self.scenarios[:n, :horizon]

    forecast_real_time_prices = forecast_day_ahead_prices


def _cfs(h=96):
    rng = np.random.default_rng(2)
    return 0.2 + 0.6 * rng.random(h)


def _scenarios(kind):
    if kind == "first_stage":
        return 20.0 + 15.0 * np.random.default_rng(0).random((3, T_DA))
    return np.sort(15.0 + 25.0 * np.random.default_rng(3).random((3, T_DA)), axis=0)


def make_bidder(pkg, kind, scenarios=None, n_scenario=3, **kw):
    """tests/test_stacked_bidder.py's SelfScheduler (``"first_stage"``) or
    Bidder (``"monotone"``) in either package."""
    g, MP = (jgrid, JMP) if pkg == "jax" else (tgrid, TMP)
    if pkg == "torch":
        kw.setdefault("device", "cpu")
    if kind == "first_stage":
        md = g.RenewableGeneratorModelData(gen_name="309_WIND_1", bus="Carter",
                                           p_min=0.0, p_max=200.0)
        cls = g.SelfScheduler
    else:
        md = g.ThermalGeneratorModelData(gen_name="309_WIND_1", bus="Carter", p_min=0.0,
                                         p_max=200.0, startup_capacity=0.0,
                                         shutdown_capacity=225.0)
        cls = g.Bidder
    mp = MP(model_data=md, wind_capacity_factors=_cfs(), wind_pmax_mw=200,
            battery_pmax_mw=25, battery_energy_capacity_mwh=100)
    sc = _scenarios(kind) if scenarios is None else scenarios
    return cls(bidding_model_object=mp, day_ahead_horizon=T_DA, real_time_horizon=T_RT,
               n_scenario=n_scenario, forecaster=FixedForecaster(sc), **kw)


@pytest.fixture(scope="module", params=["first_stage", "monotone"])
def pair(request):
    kind = request.param
    return kind, make_bidder("torch", kind), make_bidder("jax", kind)


def _params(bidder, kind):
    p = bidder.day_ahead_model.stacked.default_params()
    p["p"]["energy_price"] = _scenarios(kind)
    return p


def test_stacked_layout_is_exact(pair):
    kind, tb, jb = pair
    for horizon_model in ("day_ahead_model", "real_time_model"):
        ts = getattr(tb, horizon_model).stacked
        js = getattr(jb, horizon_model).stacked
        assert ts.coupling == js.coupling == kind
        assert (ts.n, ts.m_eq, ts.m_ineq, ts.S, ts.T) == (js.n, js.m_eq, js.m_ineq, js.S, js.T)
        assert ts.free_names == js.free_names and ts._slices == js._slices
        assert ts.fixed_names == js.fixed_names
        assert ts.eq_slices == js.eq_slices and ts.ineq_slices == js.ineq_slices
        for attr in ("n", "lb", "ub", "x0", "var_scale"):
            np.testing.assert_array_equal(getattr(ts, attr), np.asarray(getattr(js, attr)),
                                          err_msg=attr)
        tp, jp = ts.default_params(), js.default_params()
        assert sorted(tp["p"]) == sorted(jp["p"])
        for k in jp["p"]:
            np.testing.assert_array_equal(tp["p"][k], np.asarray(jp["p"][k]), err_msg=k)
        # the scenario key keeps its per-scenario (S, T) shape: a day
        # batch (D, S, T) is one lane axis
        assert tp["p"]["energy_price"].shape == (ts.S, ts.T)
    assert ts._w.dtype == np.float64


def test_stacked_callables_match_jax(pair):
    kind, tb, jb = pair
    ts, js = tb.day_ahead_model.stacked, jb.day_ahead_model.stacked
    tp, jp = _params(tb, kind), _params(jb, kind)
    rng = np.random.default_rng(11)
    x0 = np.asarray(js.x0)
    x_rand = x0 * (1.0 + 0.2 * (rng.random(x0.shape) - 0.5)) + 0.05 * rng.random(x0.shape)
    for x in (x0, x_rand):
        tx = torch.as_tensor(x)
        for fn in ("objective", "eq", "ineq"):
            jf, tf = getattr(js, fn), getattr(ts, fn)
            assert_rel(tf(tx, tp), jf(jnp.asarray(x), jp), RTOL, what=fn)
            want = jax.jacfwd(lambda y: jf(y, jp))(jnp.asarray(x))
            got = torch.func.jacrev(lambda y: tf(y, tp))(tx)
            assert_rel(got, want, RTOL, what=f"jacobian of {fn}")
        assert_rel(ts.scenario_profiles(x, tp), js.scenario_profiles(x, jp), RTOL,
                   what="scenario_profiles")


def test_stacked_rejects_bad_options():
    from dispatches_tpu_torch.core.stacked import StackedScenarioNLP

    nlp = make_bidder("torch", "first_stage").day_ahead_model.nlp
    with pytest.raises(ValueError, match="coupling"):
        StackedScenarioNLP(nlp, 2, ["energy_price"], lambda v, p: v, coupling="bogus")
    with pytest.raises(ValueError, match="price_key"):
        StackedScenarioNLP(nlp, 2, ["energy_price"], lambda v, p: v, coupling="monotone")
    with pytest.raises(ValueError, match="weights"):
        StackedScenarioNLP(nlp, 2, ["energy_price"], lambda v, p: v, weights=[0.2, 0.2])
