"""The PyTorch port's nuclear case study held to the JAX package on the
CPU, in float64.

- tests/test_ne_case.py's compositions (plant only; + PEM; + tank; + the
  turbine train; the capacity-bounded build): the NLP layout exactly (the
  turbine's inits within 1e-12, they come from host bisections), and the
  objective, residuals and Jacobians at x0 and at a seeded random x within
  1e-12 relative; the square solves' anchors of that file on the port;
- tests/test_ne_multiperiod.py's price-taker at LMP 5 (T = 4, h2 price 3,
  max_iter 600): iterations equal, objective within 1e-8 relative (JAX's
  result recorded, ``nuclear_price_taker_jax`` in tests/torch_records.py,
  and held to JAX by a ``slow`` test);
- the ``MultiPeriodNuclear`` protocol (populate, solve against a flat
  price, implemented profile, update, record/write) with CSV output equal
  to JAX's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dispatches_tpu.case_studies import nuclear as jn  # noqa: E402
from dispatches_tpu.case_studies.nuclear import multiperiod as jmp  # noqa: E402
from dispatches_tpu.grid.model_data import ThermalGeneratorModelData as JMD  # noqa: E402
from dispatches_tpu.solvers import IPMOptions as JOpts, solve_nlp as j_solve  # noqa: E402

from dispatches_tpu_torch.case_studies import nuclear as tn  # noqa: E402
from dispatches_tpu_torch.case_studies.nuclear import multiperiod as tmp  # noqa: E402
from dispatches_tpu_torch.grid.model_data import ThermalGeneratorModelData as TMD  # noqa: E402
from dispatches_tpu_torch.solvers import IPMOptions as TOpts, solve_nlp as t_solve  # noqa: E402

import torch_records  # noqa: E402
from test_torch_h2_models import assert_callables_match, assert_same_layout  # noqa: E402
from test_torch_stacked import one_torch_thread  # noqa: E402,F401

RTOL = 1e-12
T = 4

COMPOSITIONS = {
    "npp_only": (dict(np_capacity=1000, include_pem=False), {}),
    "npp_pem": (dict(np_capacity=1000, include_tank=False), dict(split_frac_grid=0.8)),
    "npp_pem_tank": (dict(np_capacity=1000, include_turbine=False), dict(split_frac_grid=0.8)),
    "npp_pem_tank_turbine": (dict(np_capacity=1000),
                             dict(split_frac_grid=0.8, flow_mol_to_pipeline=10,
                                  flow_mol_to_turbine=10)),
    "capacity_bounds": (dict(np_capacity=1000, pem_capacity=250, tank_capacity=4000,
                             turbine_capacity=100), dict(split_frac_grid=0.8)),
}


def _build(pkg, name):
    mod = jn if pkg == "jax" else tn
    build_kw, fix_kw = COMPOSITIONS[name]
    m = mod.build_ne_flowsheet(**build_kw)
    mod.fix_dof_and_initialize(m, **fix_kw)
    return m, m.fs.compile()


@pytest.mark.parametrize("name", sorted(COMPOSITIONS))
def test_ne_composition_matches_jax(name):
    _, jnlp = _build("jax", name)
    _, tnlp = _build("torch", name)
    assert_same_layout(tnlp, jnlp, x0_rtol=RTOL if "turbine" in name or "capacity" in name else 0.0)
    assert_callables_match(tnlp, jnlp, seed=sorted(COMPOSITIONS).index(name), rtol=RTOL)


def test_ne_square_solves_hold_the_anchors():
    """tests/test_ne_case.py's anchors on the port's solves."""
    _, nlp = _build("torch", "npp_pem")
    res = t_solve(nlp, device="cpu")
    sol = nlp.unravel(res.x)
    assert bool(res.converged)
    assert sol["pem.outlet.flow_mol"][0] == pytest.approx(505.481, rel=1e-3)
    _, nlp = _build("torch", "npp_pem_tank")
    res = t_solve(nlp, device="cpu")
    sol = nlp.unravel(res.x)
    assert bool(res.converged)
    assert sol["h2_tank.tank_holdup"][0] == pytest.approx(3600 * (200e3 * 0.002527406 - 1.0),
                                                          rel=1e-6)
    m, _ = _build("torch", "capacity_bounds")
    assert m.fs.var_specs["pem.electricity"].ub == pytest.approx(250e3)
    assert m.fs.has_constraint("h2_turbine.turbine_capacity")


def test_multiperiod_model_matches_jax():
    jm_ = jmp.create_multiperiod_nuclear_model(n_time_points=T)
    tm_ = tmp.create_multiperiod_nuclear_model(n_time_points=T)
    assert not tm_.fs.is_fixed("np_power_split.split_fraction_np_to_grid")
    jnlp, tnlp = jm_.fs.compile(), tm_.fs.compile()
    assert_same_layout(tnlp, jnlp)
    with pytest.raises(ValueError, match="demand_type"):
        tmp.create_multiperiod_nuclear_model(demand_type="bogus")
    fixed = tmp.create_multiperiod_nuclear_model(n_time_points=T, demand_type="fixed",
                                                 h2_demand=0.2)
    tank = fixed.units["h2_tank"]
    assert float(np.asarray(fixed.fs.var_specs[tank.pipeline_state.flow_mol].fixed_value)[0]) \
        == pytest.approx(0.2 / tn.MW_H2)


PRICE_TAKER_RECORD = "nuclear_price_taker_jax"
PRICE_TAKER_KW = dict(h2_price=3.0, max_iter=600)


def jax_record():
    """JAX's price-taker at LMP 5 (its IPM compiles for minutes, so tier 1
    reads this record; test_price_taker_jax_record_is_current holds it to
    JAX bitwise)."""
    _, _, j_res, _ = jmp.ne_price_taker_optimize(T, np.full(T, 5.0), **PRICE_TAKER_KW)
    return {f: np.asarray(getattr(j_res, f)) for f in ("converged", "iterations", "obj")}


@pytest.mark.slow
def test_price_taker_jax_record_is_current():
    assert torch_records.matches(PRICE_TAKER_RECORD, jax_record())


def test_price_taker_at_lmp_5_matches_jax():
    kw = PRICE_TAKER_KW
    j_res = type("JRes", (), torch_records.read(PRICE_TAKER_RECORD))
    _, tnlp, t_res, t_sol = tmp.ne_price_taker_optimize(T, np.full(T, 5.0), device="cpu", **kw)
    assert bool(t_res.converged) and bool(j_res.converged)
    assert int(t_res.iterations) == int(j_res.iterations)
    assert abs(float(t_res.obj) - float(j_res.obj)) <= 1e-8 * abs(float(j_res.obj))
    # tests/test_ne_multiperiod.py's holdup balance on the port
    holdup = t_sol["h2_tank.tank_holdup"]
    prev = np.concatenate([[float(t_sol["h2_tank.tank_holdup_previous"])], holdup[:-1]])
    net_in = (t_sol["h2_tank.inlet.flow_mol"] - t_sol["h2_tank.outlet_to_pipeline.flow_mol"]
              - t_sol["h2_tank.outlet_to_turbine.flow_mol"]) * 3600.0
    np.testing.assert_allclose(holdup - prev, net_in, atol=1e-4)


def _protocol_run(pkg, tmp_path):
    MP, MD, opts, solve, sumf = ((jmp.MultiPeriodNuclear, JMD, JOpts, j_solve, jnp.sum)
                                 if pkg == "jax" else
                                 (tmp.MultiPeriodNuclear, TMD, TOpts, t_solve, torch.sum))
    mpn = MP(model_data=MD(gen_name="121_NUCLEAR_1", bus="Attlee", p_min=355.0, p_max=400.0))
    assert mpn.pmin == 355.0 and mpn.pmax == 400.0
    assert mpn.power_output == "P_T" and mpn.total_cost == ("tot_cost", 1)

    class Blk:
        pass

    blk = Blk()
    mpn.populate_model(blk, horizon=T)
    fs = blk.m.fs
    fs.add_param("lmp", np.full(T, 20.0))

    def objective(v, p):
        return sumf(p["lmp"] * blk.power_output_expr(v, p) - blk.total_cost_expr(v, p))

    nlp = fs.compile(objective=objective, sense="max")
    kw = {"device": "cpu"} if pkg == "torch" else {}
    res = solve(nlp, options=opts(max_iter=600), **kw)
    sol = nlp.unravel(res.x)
    profile = mpn.get_implemented_profile(blk, sol, T - 1)
    mpn.update_model(blk, profile["implemented_tank_holdup"])
    mpn.record_results(blk, sol, date="2020-01-01", hour=0)
    out = tmp_path / f"ne_{pkg}.csv"
    mpn.write_results(out)
    return res, mpn.get_last_delivered_power(blk, sol, T - 1), profile, fs, out


def test_multiperiod_nuclear_protocol_matches_jax(tmp_path):
    t_res, t_last, t_prof, t_fs, t_out = _protocol_run("torch", tmp_path)
    j_res, j_last, j_prof, j_fs, j_out = _protocol_run("jax", tmp_path)
    assert bool(t_res.converged) and int(t_res.iterations) == int(j_res.iterations)
    assert t_last > 0 and abs(t_last - j_last) <= 1e-8 * abs(j_last)
    np.testing.assert_allclose(t_prof["implemented_tank_holdup"],
                               np.asarray(j_prof["implemented_tank_holdup"]), rtol=1e-8)
    name = "h2_tank.tank_holdup_previous"
    assert float(t_fs.var_specs[name].fixed_value) == float(j_fs.var_specs[name].fixed_value)
    assert t_out.read_text() == j_out.read_text()
