"""The port's multiperiod integrated USC + TES model
(``case_studies/fossil/storage_multiperiod.py``) on the CPU, in float64.

* The five fast cases of ``tests/test_storage_multiperiod.py`` on the
  port (configuration, the square inner system, the constants, the
  hot-inventory trajectory, ``run_pricetaker_analysis``'s argument check).
* The ramp, inventory and periodic coupling rows against numpy formulas
  of the reference lines the JAX code cites (``multiperiod_integrated_
  storage_usc.py:125-164``; the JAX closures would need JAX's 47 s
  compile of the plant and a 47 s eager probe).
* One batched evaluation at T = 2 against two single-lane (T = 1)
  evaluations of the port within 1e-10, with equal Newton iterations.
  The decisions are ``smp.FEASIBLE_DECISIONS``: at the model's default decisions (HP
  split 0.1) the hour-plant has no inner solution inside its variable
  bounds (the charge HX's outlet would need a vapor fraction below the
  wet state's -0.5 bound), and Newton stalls at a max residual of 7.057
  after 80 iterations in both packages (ROADMAP.md §3).
* Slow: ``test_multiperiod_solve_small`` on the port, from ``smp.FEASIBLE_DECISIONS``.
* The device rule.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu_torch.case_studies.fossil import storage_integrated as isp  # noqa: E402
from dispatches_tpu_torch.case_studies.fossil import storage_multiperiod as smp  # noqa: E402
from dispatches_tpu_torch.core.graph import Vals  # noqa: E402
from dispatches_tpu_torch.solvers.reduced import BatchedReducedSpaceNLP  # noqa: E402

CPU = "cpu"
DATA = Path(__file__).parent / "data"
INIT = DATA / "integrated_storage_usc_init"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one intra-op thread, as the other test_torch_* modules."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def usc_model():
    return smp.create_usc_model(load_from_file=INIT, device=CPU)


def test_create_usc_model(usc_model):
    m = usc_model
    fs = m.fs
    hxc, hxd = m.units["hxc"], m.units["hxd"]
    assert fs.is_fixed(hxc.area)
    assert float(fs.var_specs[hxc.area].fixed_value) == 1904.0
    assert fs.is_fixed(hxd.area)
    assert float(fs.var_specs[hxd.area].fixed_value) == 2830.0
    assert np.ravel(fs.var_specs[hxc.salt_out.temperature].fixed_value).tolist() == [831.0]
    assert np.ravel(fs.var_specs[hxd.salt_in.temperature].fixed_value).tolist() == [831.0]
    assert np.ravel(fs.var_specs[hxd.salt_out.temperature].fixed_value).tolist() == [513.15]
    assert not fs.is_fixed(hxc.salt_in.flow_mass)
    assert not fs.is_fixed(hxd.salt_in.flow_mass)
    for name in ("plant_power_min", "plant_power_max", "hxc_duty_min",
                 "hxc_duty_max", "hxd_duty_min", "hxd_duty_max"):
        assert fs.has_constraint(name)


def test_square_inner_system(usc_model):
    nlp = usc_model.fs.compile()
    r = nlp.eq(torch.as_tensor(nlp.x0), nlp.default_params())
    assert r.shape[-1] == nlp.n
    for d in smp.DECISIONS:
        assert d in nlp.fixed_names


def test_multiperiod_model_coupling():
    assert smp.PMIN_DEFAULT == 284.0
    assert smp.PMAX_DEFAULT == 466.0
    assert smp.MIN_STORAGE_HEAT_DUTY == 10e6
    assert smp.MAX_STORAGE_HEAT_DUTY == 200e6
    assert smp.INVENTORY_MIN == 75000
    assert smp.TANK_MAX == 6739292
    assert smp.PREVIOUS_POWER_0 == 447.66
    assert len(smp.MOD_RTS_LMP) == 24
    assert smp.MOD_RTS_LMP[16] == pytest.approx(19.0342)
    assert smp.MOD_RTS_LMP[-1] == 200.0


def test_hot_inventory_trajectory():
    Fc = np.array([100.0, 0.0, 50.0, 0.0])
    Fd = np.array([0.0, 20.0, 0.0, 80.0])
    vb = Vals({
        "hxc.tube_inlet.flow_mass": torch.as_tensor(Fc[:, None]),
        "hxd.shell_inlet.flow_mass": torch.as_tensor(Fd[:, None]),
    })
    inv = smp.MultiPeriodUscModel._hot_inventory(
        vb, Vals({"initial_hot_inventory": torch.tensor(1e6, dtype=torch.float64)}))
    expect = 1e6 + 3600.0 * np.cumsum(Fc - Fd)
    np.testing.assert_allclose(inv.numpy(), expect, rtol=1e-12)


def test_pricetaker_wiring():
    with pytest.raises(ValueError, match="tank_status"):
        smp.run_pricetaker_analysis(tank_status="bogus", device=CPU)


# ---------------------------------------------------------------------------
# the multiperiod model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mp2():
    return smp.MultiPeriodUscModel(n_time_points=2, periodic=True, lmp=np.array([22.0, 200.0]),
                                   load_from_file=INIT, device=CPU)


def test_coupling_rows_match_the_reference_formulas(mp2):
    """Ramp (:125-135 with the linking pairs :334-342), inventory
    (:137-164) and periodic (`pricetaker...py:88-90`) rows on a synthetic
    two-hour trajectory."""
    brs = mp2.brs
    power = np.array([420.0, 350.0])
    Fc, Fd = np.array([30.0, 0.0]), np.array([5.0, 60.0])
    vb = Vals({"plant_power_out": torch.as_tensor(power[:, None]),
               "hxc.tube_inlet.flow_mass": torch.as_tensor(Fc[:, None]),
               "hxd.shell_inlet.flow_mass": torch.as_tensor(Fd[:, None])})
    p0, inv0 = 380.0, 2e5
    p = Vals({k: torch.as_tensor(v) for k, v in {
        "previous_power": np.float64(p0), "initial_hot_inventory": np.float64(inv0)}.items()})
    (_, ramp), (_, inventory) = brs.coupling_ineqs
    prev = np.array([p0, power[0]])
    np.testing.assert_allclose(
        ramp(vb, p).numpy(),
        np.concatenate([(power - prev - 60.0) * 1e-2, (prev - power - 60.0) * 1e-2]),
        rtol=0, atol=1e-14)
    inv = inv0 + 3600.0 * np.cumsum(Fc - Fd)
    prev_inv = np.array([inv0, inv[0]])
    want = np.concatenate([(3600.0 * Fd - prev_inv) * 1e-5,
                           (3600.0 * Fc - (isp.SALT_AMOUNT - prev_inv)) * 1e-5,
                           (inv - smp.INVENTORY_MAX) * 1e-5, -inv * 1e-5])
    np.testing.assert_allclose(inventory(vb, p).numpy(), want, rtol=1e-14, atol=1e-14)
    (name, periodic), = brs.coupling_eqs
    assert name == "periodic_hot_inventory"
    assert float(periodic(vb, p)) == pytest.approx((inv[-1] - inv0) * 1e-5, rel=1e-14)


def test_batched_evaluation_matches_single_lanes(mp2):
    brs = mp2.brs
    U = smp.feasible_U(brs, 2, boiler_fracs=[1.0, 0.97])
    X0 = np.tile(mp2.nlp.x0, (2, 1))
    out = brs._evaluate_b(U, X0, brs.runtime_on_device())
    assert out[9].tolist() == [True, True]
    one = BatchedReducedSpaceNLP(
        mp2.nlp, list(smp.DECISIONS), 1, objective=lambda vb, p: vb["net_power"].sum(),
        u_scales={d: brs.base._u_layout[d][3] for d in smp.DECISIONS}, device=CPU)
    for t in range(2):
        o1 = one._evaluate_b(U[t:t + 1], X0[t:t + 1], one.runtime_on_device())
        assert o1[11][0] == out[11][t]  # Newton iterations
        for i, what in ((0, "X"), (2, "g1"), (6, "dG1"), (10, "max residual")):
            want = o1[i][0]
            got = out[i][t]
            scale = max(1.0, float(np.max(np.abs(want))))
            assert np.max(np.abs(got - want)) <= 1e-10 * scale, (t, what)


@pytest.mark.slow  # the 3-hour solve: ~60 outer iterations over three 792-state plants
def test_multiperiod_solve_small():
    mp = smp.MultiPeriodUscModel(
        n_time_points=3, load_from_file=INIT, periodic=True,
        lmp=np.array([22.0, 0.0, 200.0]), device=CPU)
    out = mp.solve(U0=smp.feasible_U(mp.brs, 3), maxiter=60)
    res = out["res"]
    assert float(np.max(res.g_local)) < 1e-4
    assert float(np.max(res.g_coupling)) < 1e-4
    assert abs(float(np.max(np.abs(res.eq_coupling)))) < 1e-4
    assert np.all(out["plant_power"] >= smp.MIN_POWER - 1e-3)
    assert np.all(out["plant_power"] <= smp.MAX_POWER + 1e-3)
    assert np.all(out["hxc_duty"] >= 10.0 - 1e-3)
    assert np.all(out["hxd_duty"] >= 10.0 - 1e-3)
    assert out["hot_tank_level"][-1] == pytest.approx(mp.initial_hot_inventory, rel=1e-5)


@pytest.mark.skipif(torch.cuda.is_available(), reason="the CPU-only rule")
def test_entry_points_follow_the_device_rule():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        smp.MultiPeriodUscModel(n_time_points=2, load_from_file=INIT)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        smp.run_pricetaker_analysis()
