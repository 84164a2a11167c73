"""The packed operator and the launch shapes of the port's PDHG sweep
kernels (``dispatches_tpu_torch/kernels/pdhg_sweep.py``), on the CPU.

The kernels run only on the card, where ``chip_smoke.py`` holds them to
their plain versions; these tests pin what the kernels are given: the
nonzeros of the main path's preconditioned operator (the matrix the JAX
package's batch solver sweeps, bitwise) in both packed forms, and the
launch shape the wrapper picks."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu.case_studies.renewables.wind_battery_lmp import (  # noqa: E402
    wind_battery_pricetaker_nlp as j_pricetaker,
)
from dispatches_tpu.solvers.pdlp import (  # noqa: E402
    PDLPOptions as JPDLPOptions,
    _scalings as j_scalings,
    make_lp_data as j_make_lp_data,
)

from dispatches_tpu_torch.kernels import pdhg_sweep as ks  # noqa: E402
from test_torch_stacked import one_torch_thread  # noqa: E402,F401

T = 24


@pytest.fixture(scope="module")
def main_Ah():
    """The preconditioned (218, 193) operator of the 24-h wind+battery LP."""
    _, nlp = j_pricetaker(T, {
        "wind_mw": 200.0, "batt_mw": 25.0, "design_opt": False,
        "extant_wind": True, "capacity_factors": np.full(T, 0.5),
        "DA_LMPs": np.full(T, 30.0)})
    data = j_make_lp_data(nlp)
    return j_scalings(np.vstack([data["K"], data["G"]]), JPDLPOptions())[2]


def _unpack(packed):
    """Both packed forms back to dense, checking that indices ascend
    within every column and row."""
    m, n = packed.shape
    p = {k: v.numpy() for k, v in packed._asdict().items()}
    by_col = np.zeros((m, n), p["col_val"].dtype)
    for j in range(n):
        s = slice(p["col_ptr"][j], p["col_ptr"][j + 1])
        assert np.all(np.diff(p["row_idx"][s]) > 0)
        by_col[p["row_idx"][s], j] = p["col_val"][s]
    by_row = np.zeros((m, n), p["row_val"].dtype)
    for i in range(m):
        s = slice(p["row_ptr"][i], p["row_ptr"][i + 1])
        assert np.all(np.diff(p["col_idx"][s]) > 0)
        by_row[i, p["col_idx"][s]] = p["row_val"][s]
    return by_col, by_row


def test_pack_operator_main_path(main_Ah):
    packed = ks.pack_operator(main_Ah)
    assert packed.shape == (218, 193) and packed.nnz == 504
    assert packed.col_ptr.dtype == torch.int32 and packed.col_val.dtype == torch.float64
    for dense in _unpack(packed):
        np.testing.assert_array_equal(dense, main_Ah)
    per_row = np.diff(packed.row_ptr.numpy())
    per_col = np.diff(packed.col_ptr.numpy())
    assert per_row.min() >= 1 and per_row.max() == 4
    assert per_col.min() >= 1 and per_col.max() == 25
    assert int((per_col > 4).sum()) == 1


def _cases(main_Ah):
    rng = np.random.default_rng(3)
    empty = main_Ah.copy()
    empty[5, :] = 0.0
    empty[:, 7] = 0.0
    return {"dense": rng.standard_normal((64, 48)), "empty_row_col": empty,
            "all_zero": np.zeros((5, 3))}


@pytest.mark.parametrize("case", ["dense", "empty_row_col", "all_zero"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pack_operator_round_trips(main_Ah, case, dtype):
    A = torch.as_tensor(_cases(main_Ah)[case]).to(dtype)
    packed = ks.pack_operator(A)
    assert packed.col_val.dtype == dtype and packed.col_val.device == A.device
    assert packed.nnz == int(torch.count_nonzero(A))
    for dense in _unpack(packed):
        np.testing.assert_array_equal(dense, A.numpy())
    if case == "empty_row_col":
        assert int(packed.row_ptr[6] - packed.row_ptr[5]) == 0
        assert int(packed.col_ptr[8] - packed.col_ptr[7]) == 0


def test_packed_products_are_the_dense_products(main_Ah):
    """The column form gives z Ah and the row form v AhT: the two
    products the kernels compute from it."""
    packed = ks.pack_operator(main_Ah)
    m, n = packed.shape
    rng = np.random.default_rng(4)
    z = torch.as_tensor(rng.standard_normal((6, m)))
    v = torch.as_tensor(rng.standard_normal((6, n)))
    col_of = torch.repeat_interleave(torch.arange(n), torch.diff(packed.col_ptr))
    row_of = torch.repeat_interleave(torch.arange(m), torch.diff(packed.row_ptr))
    zA = torch.zeros(6, n, dtype=z.dtype).index_add_(
        1, col_of, z[:, packed.row_idx.long()] * packed.col_val)
    vAT = torch.zeros(6, m, dtype=v.dtype).index_add_(
        1, row_of, v[:, packed.col_idx.long()] * packed.row_val)
    A = torch.as_tensor(main_Ah)
    torch.testing.assert_close(zA, z @ A, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(vAT, v @ A.T, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("args,want", [
    ((True, 218, 193, 504, 1, torch.float32), (1, 224, True)),
    ((True, 218, 193, 504, 4, torch.float32), (1, 896, True)),
    ((True, 218, 193, 504, 8, torch.float32), (2, 896, True)),
    ((False, 218, 193, 504, 16, torch.float32), (8, 448, True)),
    ((True, 218, 193, 504, 8, torch.float64), (4, 448, True)),
    ((True, 218, 193, 218 * 193, 8, torch.float32), (2, 896, False)),
    ((True, 2100, 200, 4200, 2, torch.float32), (0, 1024, True)),
    ((True, 2100, 200, 4200, 2, torch.float64), (0, 1024, False)),
], ids=["f32-L1", "f32-L4", "f32-L8", "f32-L16", "f64-L8", "dense-op", "wide-f32",
        "wide-f64"])
def test_launch_config_main_path_and_fallbacks(args, want):
    """Registers at the main path's widths; the operator through the
    read-only cache when it does not fit; the state in shared memory
    when the registers cannot hold it."""
    assert tuple(ks.launch_config(*args))[:3] == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_launch_config_satisfies_the_kernel(dtype):
    """Every register-state shape passes the CUDA dispatcher's checks:
    whole warps, one lane per thread, enough workers for the wider
    side, and within the launch bound."""
    assert (ks.max_threads(1, torch.float32), ks.max_threads(4, torch.float32),
            ks.max_threads(8, torch.float64)) == (1024, 800, 288)
    for width in (1, 7, 33, 193, 218, 500, 1000, 2300):
        for lanes in ks.LANES_PER_BLOCK:
            try:
                cfg = ks.launch_config(True, width, 3, 10, lanes, dtype)
            except ValueError:
                continue
            assert cfg.threads % 32 == 0 and cfg.threads <= 1024
            assert cfg.smem_bytes <= ks.SMEM_LIMIT_BYTES
            if cfg.items:
                assert cfg.threads % lanes == 0
                assert cfg.threads // lanes * cfg.items >= width
                assert cfg.threads <= ks.max_threads(cfg.items, dtype)


def test_launch_config_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="smaller lanes_per_block"):
        ks.launch_config(True, 218, 193, 504, 16, torch.float64)
    with pytest.raises(ValueError, match="must be one of"):
        ks.launch_config(True, 218, 193, 504, 32, torch.float32)


def test_wrappers_validate_the_packed_operator(main_Ah):
    Ah = torch.as_tensor(main_Ah, dtype=torch.float32)
    m, n = Ah.shape
    rng = np.random.default_rng(5)
    B = 3
    lane = [torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
            for s in ((B, n), (B, m), (B, n), (B, m), (B, n), (B, m), (B, 1), (B, 1))]
    x, z, xs, zs, c, b, tau, sig = lane
    tau.fill_(0.1)
    sig.fill_(0.1)
    const = [Ah, Ah.T.contiguous(), torch.full((n,), -1.0), torch.full((n,), 1.0),
             (torch.arange(m) < 122).float()]
    packed = ks.pack_operator(Ah)
    got = ks.avg_sweep(*const, x, z, xs, zs, c, b, tau, sig, k=3, packed=packed)
    want = ks.avg_sweep_reference(*const, x, z, xs, zs, c, b, tau, sig, k=3)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="shape"):
        ks.avg_sweep(*const, *lane, k=1, packed=ks.pack_operator(Ah[:, :-1]))
    with pytest.raises(ValueError, match="int32"):
        ks.avg_sweep(*const, *lane, k=1,
                     packed=packed._replace(col_ptr=packed.col_ptr.long()))
    with pytest.raises(ValueError, match="float32"):
        ks.avg_sweep(*const, *lane, k=1, packed=ks.pack_operator(Ah.double()))


def test_default_lanes_follow_the_batch(monkeypatch):
    """4 lanes a block while those blocks fit one wave on the card's SMs
    (the annual batch of 366), 8 beyond (the peak batches)."""
    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: Props())
    assert [ks.default_lanes(B, "cuda") for B in (1, 366, 528, 529, 1024, 4096)] == \
        [4, 4, 4, 8, 8, 8]


@pytest.mark.parametrize("algo", ["halpern", "avg"])
def test_one_step_sweeps_compose_to_a_k_step_sweep(main_Ah, algo):
    """k one-step sweeps, each started from the last one's state (halpern's
    k0 counting on), equal one k-step sweep bit for bit in the bf16 tier:
    the premise of chip_smoke.py's stepwise check of that tier."""
    Ah = torch.as_tensor(main_Ah, dtype=torch.float32)
    m, n = Ah.shape
    rng = np.random.default_rng(6)
    B, k = 4, 12

    def r(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)

    const = [Ah, Ah.T.contiguous(), torch.full((n,), -2.0), torch.full((n,), 2.0),
             (torch.arange(m) < 122).float()]
    step = torch.full((B, 1), 0.05)
    if algo == "halpern":
        fn = ks.halpern_sweep_reference
        args = const + [r(B, n), r(B, m), r(B, n), r(B, m), r(B, n), r(B, m),
                        0.1 * r(B, n), 0.1 * r(B, m), step, step.clone(),
                        torch.as_tensor(rng.integers(0, 50, (B, 1)), dtype=torch.float32)]
    else:
        fn = ks.avg_sweep_reference
        args = const + [r(B, n), r(B, m), r(B, n), r(B, m), 0.1 * r(B, n),
                        0.1 * r(B, m), step, step.clone()]
    want = fn(*args, k=k, low_precision=True)
    for _ in range(k):
        got = fn(*args, k=1, low_precision=True)
        if algo == "halpern":
            args[5:7], args[9:11], args[15] = got[:2], got[4:], args[15] + 1.0
        else:
            args[5:9] = got
    for g, w in zip(got, want):
        assert torch.equal(g, w)
