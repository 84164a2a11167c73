"""The PyTorch port's PDHG sweeps held to the JAX package on the CPU: the
plain PyTorch versions (what the CUDA kernels are held to on the card)
against the Pallas kernels in interpret mode (f32 and f64 tiers) and
against the XLA transcription of the bf16 recipe, on the cases of
tests/test_pdlp_batch.py, to max|diff| <= 1e-5 * max(1, |want|) in f32
and 1e-10 in f64; and the kernel wrappers' CPU path, operand checks and
launch configuration.  The whole batch solver is held in
tests/test_torch_pdlp_batch.py (a file of its own, so that the parallel
tier-1 run puts the two halves on two workers)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dispatches_tpu.case_studies.renewables.wind_battery_lmp import (  # noqa: E402
    wind_battery_pricetaker_nlp as j_pricetaker,
)
from dispatches_tpu.solvers.pdlp import (  # noqa: E402
    _power_norm,
    _ruiz_equilibrate,
    make_lp_data as j_make_lp_data,
)
from dispatches_tpu.solvers.pdlp_batch import (  # noqa: E402
    _pallas_halpern_sweep_fn,
    _pallas_sweep_fn,
)

from dispatches_tpu_torch.case_studies.renewables.wind_battery_lmp import (  # noqa: E402
    wind_battery_pricetaker_nlp as t_pricetaker,
)
from dispatches_tpu_torch.kernels import pdhg_sweep as ks  # noqa: E402
from test_torch_stacked import one_torch_thread  # noqa: E402,F401

T = 24
CPU = torch.device("cpu")
TOL = {np.float32: 1e-5, np.float64: 1e-10}


@pytest.fixture(scope="module")
def models():
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


def _close(got, want, dtype):
    got = [g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    assert len(got) == len(want)
    scale = max(1.0, max(float(np.abs(w).max()) for w in want))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert float(np.abs(g - w).max()) <= TOL[dtype] * scale


def _ruiz_case(data, dtype):
    """Ruiz-equilibrated Ah, bounds and equality mask, as in the JAX
    package's sweep tests."""
    K, G = data["K"], data["G"]
    A = np.vstack([K, G])
    dr, dc = _ruiz_equilibrate(A, 10)
    Ah = (dr[:, None] * A * dc[None, :]).astype(dtype)
    lb = (data["lb"] / dc).astype(dtype)
    ub = (data["ub"] / dc).astype(dtype)
    eq = np.concatenate([np.ones(K.shape[0]), np.zeros(G.shape[0])]).astype(dtype)
    return Ah, lb, ub, eq


def _t(*arrays):
    return [torch.as_tensor(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_avg_sweep_matches_pallas(models, dtype):
    """Case of test_pdlp_batch.py:74 (B 8, k 24)."""
    _, _, data = models
    Ah, lb, ub, eq = _ruiz_case(data, dtype)
    m, n = Ah.shape
    rng = np.random.default_rng(2)
    B, k = 8, 24
    x = np.clip(rng.standard_normal((B, n)).astype(dtype), lb, ub)
    z = rng.standard_normal((B, m)).astype(dtype)
    xs, zs = np.zeros_like(x), np.zeros_like(z)
    c = 0.1 * rng.standard_normal((B, n)).astype(dtype)
    b = 0.1 * rng.standard_normal((B, m)).astype(dtype)
    tau = (0.5 / _power_norm(Ah) * np.ones((B, 1))).astype(dtype)
    sig = tau.copy()

    sweep_p = _pallas_sweep_fn(jnp.asarray(Ah), jnp.asarray(Ah.T), lb, ub, eq, k,
                               lanes_per_block=8, interpret=True)
    want = sweep_p(*map(jnp.asarray, (x, z, xs, zs, c, b, tau, sig)))
    got = ks.avg_sweep(*_t(Ah, Ah.T, lb, ub, eq, x, z, xs, zs, c, b, tau, sig), k=k)
    _close(got, want, dtype)


def _halpern_case(data, dtype, B, seed):
    Ah, lb, ub, eq = _ruiz_case(data, dtype)
    m, n = Ah.shape
    rng = np.random.default_rng(seed)
    x = np.clip(rng.standard_normal((B, n)).astype(dtype), lb, ub)
    z = rng.standard_normal((B, m)).astype(dtype)
    xa = np.clip(rng.standard_normal((B, n)).astype(dtype), lb, ub)
    za = rng.standard_normal((B, m)).astype(dtype)
    xs = rng.standard_normal((B, n)).astype(dtype)
    zs = rng.standard_normal((B, m)).astype(dtype)
    c = 0.1 * rng.standard_normal((B, n)).astype(dtype)
    b = 0.1 * rng.standard_normal((B, m)).astype(dtype)
    tau = (0.4 / _power_norm(Ah) * np.ones((B, 1))).astype(dtype)
    sig = tau.copy()
    k0 = rng.integers(0, 200, (B, 1)).astype(dtype)
    return (Ah, lb, ub, eq), (x, z, xa, za, xs, zs, c, b, tau, sig, k0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("B,k,lanes", [(8, 12, 4), (6, 40, 4)], ids=["b8k12", "b6k40"])
def test_halpern_sweep_matches_pallas(models, dtype, B, k, lanes):
    """Case of test_pdlp_batch.py:123 (B 8, k 12, per-lane k0), and a
    ragged batch at the main path's k = 40 (B 6 over 4-lane blocks: the
    Pallas wrapper pads, the port masks)."""
    _, _, data = models
    (Ah, lb, ub, eq), args = _halpern_case(data, dtype, B, seed=6)
    sweep_p = _pallas_halpern_sweep_fn(jnp.asarray(Ah), jnp.asarray(Ah.T), lb, ub,
                                       eq, k, lanes_per_block=lanes, interpret=True)
    want = sweep_p(*map(jnp.asarray, args))
    got = ks.halpern_sweep(*_t(Ah, Ah.T, lb, ub, eq, *args), k=k)
    _close(got, want, dtype)


def _dot_lo(u, M):
    return jax.lax.dot_general(
        u.astype(jnp.bfloat16), M, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)


def test_bf16_avg_sweep_matches_xla_recipe(models):
    """Case of test_pdlp_batch.py:186 (B 8, k 24): the bf16 tier against
    the XLA transcription of the bf16 recipe; and the tier really
    differs from the full one."""
    _, _, data = models
    Ah, lb, ub, eq = _ruiz_case(data, np.float32)
    m, n = Ah.shape
    rng = np.random.default_rng(13)
    B, k = 8, 24
    x = np.clip(rng.standard_normal((B, n)).astype(np.float32), lb, ub)
    z = rng.standard_normal((B, m)).astype(np.float32)
    xs, zs = np.zeros_like(x), np.zeros_like(z)
    c = 0.1 * rng.standard_normal((B, n)).astype(np.float32)
    b = 0.1 * rng.standard_normal((B, m)).astype(np.float32)
    tau = (0.5 / _power_norm(Ah) * np.ones((B, 1))).astype(np.float32)
    sig = tau.copy()
    A_lo = jnp.asarray(Ah).astype(jnp.bfloat16)
    AT_lo = jnp.asarray(Ah.T).astype(jnp.bfloat16)

    def body(carry, _):
        x, z, xs, zs = carry
        xn = jnp.clip(x - tau * (c + _dot_lo(z, A_lo)), lb[None, :], ub[None, :])
        zt = z + sig * (_dot_lo(2 * xn - x, AT_lo) - b)
        zn = jnp.where(eq[None, :] > 0.5, zt, jnp.clip(zt, 0.0, None))
        return (xn, zn, xs + xn, zs + zn), None

    want, _ = jax.lax.scan(body, tuple(map(jnp.asarray, (x, z, xs, zs))), None, length=k)
    args = _t(Ah, Ah.T, lb, ub, eq, x, z, xs, zs, c, b, tau, sig)
    got = ks.avg_sweep(*args, k=k, low_precision=True)
    _close(got, want, np.float32)
    hi = ks.avg_sweep(*args, k=k)
    assert float((hi[0] - got[0]).abs().max()) > 0


def test_bf16_halpern_sweep_matches_xla_recipe(models):
    """The halpern bf16 tier against the JAX transcription of the same
    recipe (the fallback sweep of pdlp_batch.py:417-436), run op by op.
    Inside a jitted scan XLA fuses the anchor update and contracts its
    multiply-adds; a last-bit difference there can flip a bf16 operand
    rounding, which the next steps amplify past the f32 tolerance, so
    the jitted loop is not a reference for this tier."""
    _, _, data = models
    (Ah, lb, ub, eq), args = _halpern_case(data, np.float32, B=8, seed=7)
    x, z, xa, za, xs, zs, c, b, tau, sig, k0 = args
    A_lo = jnp.asarray(Ah).astype(jnp.bfloat16)
    AT_lo = jnp.asarray(Ah.T).astype(jnp.bfloat16)
    k = 24

    def body(carry, i):
        x, z, _, _, xs, zs = carry
        xt = jnp.clip(x - tau * (c + _dot_lo(z, A_lo)), lb[None, :], ub[None, :])
        z_t = z + sig * (_dot_lo(2 * xt - x, AT_lo) - b)
        zt = jnp.where(eq[None, :] > 0.5, z_t, jnp.clip(z_t, 0.0, None))
        j = k0 + i.astype(jnp.float32)
        w = (j + 1.0) / (j + 2.0)
        return (w * (2 * xt - x) + (1 - w) * xa, w * (2 * zt - z) + (1 - w) * za,
                xt, zt, xs + xt, zs + zt), None

    x_, z_ = jnp.asarray(x), jnp.asarray(z)
    want = (x_, z_, x_, z_, jnp.asarray(xs), jnp.asarray(zs))
    with jax.disable_jit():
        for i in range(k):
            want, _ = body(want, jnp.int32(i))
    got = ks.halpern_sweep(*_t(Ah, Ah.T, lb, ub, eq, *args), k=k, low_precision=True)
    _close(got, want, np.float32)


def test_avg_sweep_uneven_batch(models):
    """Case of test_pdlp_batch.py:266: B 6 over 4-lane Pallas blocks
    (padded there) matches the port's plain sweep."""
    _, _, data = models
    Ah, lb, ub, eq = _ruiz_case(data, np.float32)
    m, n = Ah.shape
    rng = np.random.default_rng(4)
    B = 6
    x = np.clip(rng.standard_normal((B, n)).astype(np.float32), lb, ub)
    z = rng.standard_normal((B, m)).astype(np.float32)
    step = (0.3 / _power_norm(Ah) * np.ones((B, 1))).astype(np.float32)
    args = (x, z, np.zeros_like(x), np.zeros_like(z),
            0.1 * rng.standard_normal((B, n)).astype(np.float32),
            0.1 * rng.standard_normal((B, m)).astype(np.float32), step, step.copy())
    sweep4 = _pallas_sweep_fn(jnp.asarray(Ah), jnp.asarray(Ah.T), lb, ub, eq, 8,
                              lanes_per_block=4, interpret=True)
    want = sweep4(*map(jnp.asarray, args))
    got = ks.avg_sweep(*_t(Ah, Ah.T, lb, ub, eq, *args), k=8)
    _close(got, want, np.float32)


def test_wrappers_on_cpu_are_the_plain_versions(models):
    _, _, data = models
    (Ah, lb, ub, eq), args = _halpern_case(data, np.float32, B=5, seed=9)
    tensors = _t(Ah, Ah.T, lb, ub, eq, *args)
    before = ks.halpern_sweep.launches
    got = ks.halpern_sweep(*tensors, k=7)
    want = ks.halpern_sweep_reference(*tensors, k=7)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ks.halpern_sweep.launches == before  # the CPU path launches nothing


def test_wrappers_validate_operands(models):
    _, _, data = models
    (Ah, lb, ub, eq), args = _halpern_case(data, np.float32, B=3, seed=10)
    tensors = _t(Ah, Ah.T, lb, ub, eq, *args)
    with pytest.raises(ValueError, match="dtype|float"):
        ks.halpern_sweep(*tensors[:5], tensors[5].double(), *tensors[6:], k=1)
    with pytest.raises(ValueError, match="shape"):
        ks.halpern_sweep(*tensors[:5], tensors[5][:, :-1].contiguous(), *tensors[6:], k=1)
    with pytest.raises(ValueError, match="contiguous"):
        bad = torch.empty(tensors[5].shape[::-1]).T
        bad.copy_(tensors[5])
        ks.halpern_sweep(*tensors[:5], bad, *tensors[6:], k=1)
    meta = [t.to("meta") for t in tensors]
    with pytest.raises(ValueError, match="no kernel for device"):
        ks.halpern_sweep(*meta, k=1)
    with pytest.raises(ValueError, match="no kernel for device"):
        ks.avg_sweep(*[meta[i] for i in (0, 1, 2, 3, 4, 5, 6, 9, 10, 11, 12, 13, 14)], k=1)


def test_smem_bytes_matches_the_kernel_layout():
    # per lane: the two operand vectors and tau, sig, k0, (m + n + 3)
    # elements, plus the state when it lives in shared memory (halpern
    # 5 (m + n), avg 3 (m + n)); per block: the packed operator, 2 nnz
    # values and m + n + 2 + 2 nnz int32, when it fits
    def op(esz):
        return 2 * 504 * esz + 4 * (411 + 2 + 2 * 504)

    cfg = ks.launch_config(True, 218, 193, 504, 8, torch.float32)
    assert cfg == (2, 896, True, 8 * (411 + 3) * 4 + op(4))
    cfg = ks.launch_config(False, 218, 193, 504, 8, torch.float64)
    assert cfg == (4, 448, True, 8 * (411 + 3) * 8 + op(8))
    cfg = ks.launch_config(True, 2100, 200, 4200, 2, torch.float32)
    assert cfg.items == 0 and cfg.op_in_smem
    assert cfg.smem_bytes == 2 * (2303 + 5 * 2300) * 4 + 2 * 4200 * 4 + 4 * (2302 + 8400)
    cfg = ks.launch_config(False, 218, 193, 218 * 193, 8, torch.float32)
    assert not cfg.op_in_smem and cfg.smem_bytes == 8 * 414 * 4
    for lanes, dtype in ((16, torch.float32), (8, torch.float64)):
        assert ks.launch_config(True, 218, 193, 504, lanes, dtype).smem_bytes \
            <= ks.SMEM_LIMIT_BYTES
