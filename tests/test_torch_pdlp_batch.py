"""The PyTorch port's batch PDLP solver held to the JAX package on the
CPU: 16 LMP lanes through both packages on the same LP data (the JAX side
on its XLA sweep; its results recorded, ``pdlp_batch_jax`` in
tests/torch_records.py, and held to JAX bitwise by a ``slow`` test), the
zero start, the params and batch-axis checks, the builder's guards and
the PEM operator (both packages live).  The PDHG sweeps themselves are
held in tests/test_torch_pdlp_batch_sweeps.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dispatches_tpu.case_studies.renewables.wind_battery_lmp import (  # noqa: E402
    wind_battery_pricetaker_nlp as j_pricetaker,
)
from dispatches_tpu.solvers.pdlp import (  # noqa: E402
    _scalings,
    PDLPOptions as JPDLPOptions,
    make_lp_data as j_make_lp_data,
)
from dispatches_tpu.solvers.pdlp_batch import (  # noqa: E402
    BatchPDLPOptions as JBatchOptions,
    make_pdlp_batch_solver as j_make_solver,
)

from dispatches_tpu_torch.case_studies.renewables.wind_battery_lmp import (  # noqa: E402
    wind_battery_pricetaker_nlp as t_pricetaker,
)
from dispatches_tpu_torch.interop import lp_data_from_numpy, params_from_numpy  # noqa: E402
from dispatches_tpu_torch.solvers import (  # noqa: E402
    START_COLD,
    BatchPDLPOptions,
    make_pdlp_batch_solver,
)
import torch_records  # noqa: E402
from test_torch_stacked import one_torch_thread  # noqa: E402,F401

T = 24
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def models():
    return _models()


def _models():
    rng = np.random.default_rng(0)
    params_in = {
        "wind_mw": 200.0, "batt_mw": 25.0,
        "design_opt": False, "extant_wind": True,
        "capacity_factors": np.clip(0.35 + 0.3 * rng.random(T), 0, 1),
        "DA_LMPs": 30.0 + 20.0 * rng.random(T),
    }
    _, jn = j_pricetaker(T, params_in)
    _, tn = t_pricetaker(T, params_in)
    return jn, tn, j_make_lp_data(jn)


# ---------------------------------------------------------------------
# the whole batch solver
# ---------------------------------------------------------------------

def _lmp_batch(B, seed):
    rng = np.random.default_rng(seed)
    return 1e-3 * np.clip(35.0 + 25.0 * rng.standard_normal((B, T)), 0.0, 200.0)


# the four configurations held to JAX: (lanes, options).  JAX's solver
# compiles for minutes per configuration, so its results are recorded
# (tests/torch_records.py, ``pdlp_batch_jax``; the slow
# test_pdlp_batch_jax_record_is_current holds the record to JAX bitwise)
CONFIGS = {
    "f64": (16, dict(tol=1e-6, dtype="float64")),
    "f32": (16, dict(tol=1e-5, dtype="float32")),
    "avg": (4, dict(tol=1e-6, dtype="float64", algorithm="avg")),
    "bf16": (8, dict(tol=1e-5, dtype="float32", precision="bf16x-f32")),
}
PDLP_RECORD = "pdlp_batch_jax"


def _jax_solve(models, key):
    jn, _, data = models
    B, opts = CONFIGS[key]
    d = jn.default_params()
    return jax.jit(j_make_solver(jn, JBatchOptions(sweep="xla", **opts), lp_data=data))(
        {"p": {**d["p"], "lmp": jnp.asarray(_lmp_batch(B, 1))}, "fixed": d["fixed"]})


def jax_record():
    """JAX's objectives, iterations and convergence flags in every
    configuration of CONFIGS."""
    models = _models()
    return {key: {f: np.asarray(getattr(_jax_solve(models, key), f))
                  for f in ("obj", "iters", "converged")} for key in CONFIGS}


@pytest.mark.slow
def test_pdlp_batch_jax_record_is_current():
    assert torch_records.matches(PDLP_RECORD, jax_record())


def _solve_both(models, key):
    """(JAX's recorded result, the port's result, the port's solver) in
    configuration ``key`` on the same LP data and params."""
    jn, tn, data = models
    B, opts = CONFIGS[key]
    lmp = _lmp_batch(B, 1)
    d = jn.default_params()
    jres = type("JRes", (), torch_records.read(PDLP_RECORD)[key])
    solver = make_pdlp_batch_solver(tn, BatchPDLPOptions(**opts),
                                    lp_data=lp_data_from_numpy(data), device="cpu")
    tres = solver({"p": {**d["p"], "lmp": lmp}, "fixed": d["fixed"]})
    return jres, tres, solver


def test_batch_solver_matches_jax_f64(models):
    jres, tres, _ = _solve_both(models, "f64")
    np.testing.assert_allclose(tres.obj.numpy(), np.asarray(jres.obj), rtol=1e-6)
    assert int(np.sum(tres.iters.numpy() == np.asarray(jres.iters))) >= 15
    np.testing.assert_array_equal(tres.converged.numpy(), np.asarray(jres.converged))
    assert tres.x.shape == (16, models[1].n) and tres.z.shape == (16, 218)
    assert tres.start_kind is None and int(tres.refined.sum()) == 0


def test_batch_solver_matches_jax_f32(models):
    jres, tres, _ = _solve_both(models, "f32")
    np.testing.assert_allclose(tres.obj.numpy(), np.asarray(jres.obj), rtol=5e-5)
    assert float(tres.converged.float().mean()) > 0.8


def test_batch_solver_avg_matches_jax_f64(models):
    jres, tres, _ = _solve_both(models, "avg")
    np.testing.assert_allclose(tres.obj.numpy(), np.asarray(jres.obj), rtol=1e-6)
    assert int(np.sum(tres.iters.numpy() == np.asarray(jres.iters))) >= 3


def test_batch_solver_bf16_tier_matches_jax(models):
    jres, tres, _ = _solve_both(models, "bf16")
    np.testing.assert_allclose(tres.obj.numpy(), np.asarray(jres.obj), rtol=5e-5)
    assert int(tres.refined.max()) > 0


def test_zero_start_is_bitwise_cold(models):
    jn, tn, data = models
    B = 4
    d = tn.default_params()
    params = {"p": {**d["p"], "lmp": _lmp_batch(B, 2)}, "fixed": d["fixed"]}
    solver = make_pdlp_batch_solver(tn, BatchPDLPOptions(tol=1e-6, dtype="float64"),
                                    lp_data=data, device="cpu")
    cold = solver(params)
    warm = solver(params, start=(np.zeros((B, tn.n)), np.zeros((B, 218)),
                                 np.full(B, START_COLD, np.int32)))
    for f in ("x", "z", "obj", "iters"):
        assert torch.equal(getattr(warm, f), getattr(cold, f))
    assert warm.start_kind.tolist() == [START_COLD] * B
    # an exact re-seed from the solution certifies at once
    again = solver(params, start=(cold.x, cold.z))
    assert int(again.iters.max()) <= int(cold.iters.min())


def test_params_from_numpy_matches_numpy_leaves(models):
    _, tn, data = models
    d = tn.default_params()
    params = {"p": {**d["p"], "lmp": _lmp_batch(3, 3)}, "fixed": d["fixed"]}
    solver = make_pdlp_batch_solver(tn, BatchPDLPOptions(tol=1e-5, max_iter=400),
                                    lp_data=data, device="cpu")
    a = solver(params)
    b = solver(params_from_numpy(params, CPU))
    assert torch.equal(a.x, b.x) and torch.equal(a.obj, b.obj)


def test_batch_axis_validation(models):
    _, tn, data = models
    d = tn.default_params()
    solver = make_pdlp_batch_solver(tn, BatchPDLPOptions(max_iter=40),
                                    lp_data=data, device="cpu")
    with pytest.raises(ValueError, match="batch axis"):
        solver(d)  # nothing batched
    with pytest.raises(ValueError, match="extra leading dims"):
        solver({"p": {**d["p"], "lmp": np.zeros((2, 2, T))}, "fixed": d["fixed"]})
    with pytest.raises(ValueError, match="inconsistent batch sizes"):
        solver({"p": {**d["p"], "lmp": np.zeros((2, T)),
                      "windpower.capacity_factor": np.zeros((3, T))},
                "fixed": d["fixed"]})


def test_solver_builder_guards(models):
    _, tn, data = models
    with pytest.raises(NotImplementedError):
        make_pdlp_batch_solver(tn, BatchPDLPOptions(polish=True), lp_data=data,
                               device="cpu")
    with pytest.raises(ValueError, match="unknown sweep"):
        make_pdlp_batch_solver(tn, BatchPDLPOptions(sweep="pallas"), lp_data=data,
                               device="cpu")
    with pytest.raises(ValueError, match="needs a cuda device"):
        make_pdlp_batch_solver(tn, BatchPDLPOptions(sweep="cuda"), lp_data=data,
                               device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_pdlp_batch_solver(tn, BatchPDLPOptions(), lp_data=data)


def test_torch_sweep_option_is_the_plain_sweep(models):
    _, tn, data = models
    d = tn.default_params()
    params = {"p": {**d["p"], "lmp": _lmp_batch(3, 5)}, "fixed": d["fixed"]}
    a = make_pdlp_batch_solver(tn, BatchPDLPOptions(tol=1e-5), lp_data=data,
                               device="cpu")(params)
    b = make_pdlp_batch_solver(tn, BatchPDLPOptions(tol=1e-5, sweep="torch"),
                               lp_data=data, device="cpu")(params)
    assert torch.equal(a.x, b.x) and torch.equal(a.iters, b.iters)


def test_scalings_feed_the_same_matrix(models):
    """The solver's preconditioned matrix is the JAX package's, bitwise
    (host numpy on both sides)."""
    _, _, data = models
    from dispatches_tpu_torch.solvers.pdlp import PDLPOptions, _scalings as t_scalings

    A = np.vstack([data["K"], data["G"]])
    np.testing.assert_array_equal(t_scalings(A, PDLPOptions())[2],
                                  _scalings(A, JPDLPOptions())[2])


# ---------------------------------------------------------------------
# the second real operator: the PEM price-taker LP
# ---------------------------------------------------------------------

def test_batch_solver_matches_jax_f64_on_the_pem_operator():
    """chip_smoke.py's PEM price-taker LP (bench.py's nlp_pem24h recipe:
    wind 200 MW, battery and PEM 25 MW, sizes fixed) through both packages'
    batch solvers in f64 at 16 LMP lanes (halpern, tol 1e-5): every lane's
    iteration count equal, objectives within 1e-9 relative."""
    from dispatches_tpu.case_studies.renewables import wind_battery_pem_optimize as j_pem
    from dispatches_tpu_torch.case_studies.renewables import wind_battery_pem_optimize as t_pem

    rng = np.random.default_rng(1)
    base = 35.0 + 25.0 * np.sin(2 * np.pi * np.arange(T) / 24)
    params = {"wind_mw": 200.0, "batt_mw": 25.0, "pem_mw": 25.0, "design_opt": False,
              "extant_wind": True, "capacity_factors": 0.35 + 0.3 * rng.random(T),
              "DA_LMPs": base}
    jn = j_pem(T, params).nlp
    tn = t_pem(T, params, device="cpu").nlp
    data = j_make_lp_data(jn)
    lmp = 1e-3 * (base[None, :] + 10.0 * rng.standard_normal((16, T)))
    d = jn.default_params()
    opts = dict(tol=1e-5, dtype="float64")
    jres = jax.jit(j_make_solver(jn, JBatchOptions(sweep="xla", **opts), lp_data=data))(
        {"p": {**d["p"], "lmp": jnp.asarray(lmp)}, "fixed": d["fixed"]})
    tres = make_pdlp_batch_solver(tn, BatchPDLPOptions(**opts), lp_data=lp_data_from_numpy(data),
                                  device="cpu")({"p": {**d["p"], "lmp": lmp}, "fixed": d["fixed"]})
    np.testing.assert_array_equal(tres.iters.numpy(), np.asarray(jres.iters))
    np.testing.assert_array_equal(tres.converged.numpy(), np.asarray(jres.converged))
    j_obj = np.asarray(jres.obj)
    assert np.abs(tres.obj.numpy() - j_obj).max() <= 1e-9 * np.abs(j_obj).max()

