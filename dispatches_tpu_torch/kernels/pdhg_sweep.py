"""Fused k-step PDHG sweeps: the CUDA kernels of ``csrc/pdhg_sweep.cu``,
their wrappers and their plain PyTorch versions.

Replaces the Pallas TPU kernels ``_pallas_sweep_fn`` (avg) and
``_pallas_halpern_sweep_fn`` (halpern) of
``dispatches_tpu/solvers/pdlp_batch.py``, with the two precision tiers of
its ``_pallas_dot``: full-dtype products, or both operands rounded to
bfloat16 with products and sums in the working dtype.

Bound: the products need 4 nnz k FLOPs per lane — Ah holds 504 nonzeros
(1.2%) on the main path, 0.005 ms at B 4096, k 40 at the H100's 67 TFLOP/s
f32 CUDA-core peak — against 0.0142 ms to read the lane state and the
operator once and write the outputs once, so the function is bound by
bytes.  The kernels visit only the nonzeros, in the packed form of
``pack_operator``, and keep the operator and the lane state on chip for
all k steps; the design is described in the CUDA source.

Each wrapper checks dtype, device, shape and contiguity and allocates
its outputs.  On a CUDA tensor it launches the kernel (counting the
launch in its ``launches`` attribute) or raises; only a tensor on the
CPU goes to the plain version.  The library is built with ``nvcc`` into
``build/kernels/`` at first use, keyed by a hash of the source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "pdhg_sweep.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# -fmad=false: elementwise ops round like the plain version's (see the
# CUDA source); -Xptxas -v: registers and spills go into the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LANES_PER_BLOCK = (1, 2, 4, 8, 16)
ITEMS_PER_THREAD = (1, 2, 4, 8)   # register-state kernels; 0 = state in shared memory
SMEM_LIMIT_BYTES = 232448   # dynamic shared memory one block may use (H100)

_ENTRIES = tuple(f"pdhg_{algo}_{dt}_{tier}" for algo in ("avg", "halpern")
                 for dt in ("f32", "f64") for tier in ("full", "bf16"))
_DT = {torch.float32: "f32", torch.float64: "f64"}
_build_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the PDHG sweep kernels cannot be built")


def library_path() -> Path:
    """Path of the built kernel library, building it first if this
    source has not been built yet."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libpdhg_sweep_{key}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def build():
    """Build (if needed) and load the kernel library; returns it."""
    global _lib
    # held across the nvcc build on purpose: the library is built once per
    # process, and every other launcher must wait for it, not build it too
    with _build_lock:  # lockcheck: intentional(GL009)
        if _lib is None:
            lib = ctypes.CDLL(str(library_path()))
            for name in _ENTRIES:
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_void_p] * 26 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


# ---------------------------------------------------------------------
# the packed operator and the launch shape
# ---------------------------------------------------------------------

class PackedOperator(NamedTuple):
    """Ah's nonzeros by column (for ``z Ah``) and by row (for
    ``v AhT``), indices ascending within each column and row.  Pointers
    and indices are int32; values keep Ah's dtype."""
    col_ptr: torch.Tensor  # (n+1,) column j holds [col_ptr[j], col_ptr[j+1])
    row_idx: torch.Tensor  # (nnz,)
    col_val: torch.Tensor  # (nnz,)
    row_ptr: torch.Tensor  # (m+1,) row i holds [row_ptr[i], row_ptr[i+1])
    col_idx: torch.Tensor  # (nnz,)
    row_val: torch.Tensor  # (nnz,)

    @property
    def shape(self):
        return self.row_ptr.shape[0] - 1, self.col_ptr.shape[0] - 1

    @property
    def nnz(self):
        return self.row_idx.shape[0]


def pack_operator(Ah, device=None) -> PackedOperator:
    """The packed form of the (m, n) matrix ``Ah`` (a tensor or a numpy
    array), on ``device`` (Ah's own unless given).  Host numpy work: a
    solver packs its operator once, from a CPU tensor, so no sweep
    copies the operator back from the card."""
    if isinstance(Ah, torch.Tensor):
        A = Ah.detach().cpu().numpy()
        device = Ah.device if device is None else device
    else:
        A = np.asarray(Ah)
        device = "cpu" if device is None else device
    if A.ndim != 2:
        raise ValueError(f"pack_operator: Ah must be 2-D, got {A.shape}")
    m, n = A.shape
    rows, cols = np.nonzero(A)           # rows ascending, columns within a row
    by_col = np.lexsort((rows, cols))    # columns ascending, rows within a column

    def ptr(idx, size):
        return np.concatenate([[0], np.cumsum(np.bincount(idx, minlength=size))])

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    return PackedOperator(
        col_ptr=t(ptr(cols, n), np.int32), row_idx=t(rows[by_col], np.int32),
        col_val=t(A[rows[by_col], cols[by_col]]),
        row_ptr=t(ptr(rows, m), np.int32), col_idx=t(cols, np.int32),
        row_val=t(A[rows, cols]))


class LaunchConfig(NamedTuple):
    items: int         # items per thread and phase; 0: state in shared memory
    threads: int       # threads per block
    op_in_smem: bool   # packed operator in shared memory (else read via __ldg)
    smem_bytes: int    # dynamic shared memory of one block


def max_threads(items: int, dtype) -> int:
    """Threads one block of the kernel with ``items`` items per thread
    may have: ~12 state values per item and 32 other registers a thread
    within the SM's 65,536 (the CUDA source's launch bound)."""
    regs = items * 12 * (torch.empty((), dtype=dtype).element_size() // 4) + 32
    return min(1024, 65536 // regs // 32 * 32)


def default_lanes(B: int, device) -> int:
    """Lanes per block when the caller names none: 4 while the batch's
    4-lane blocks fit one wave of one block per SM, else 8.  At the main
    path's widths a 4-lane block gives each thread one item and the
    shortest steps, which is what a batch too small to fill the card
    needs; a larger batch is cheaper in fewer 8-lane blocks of two items
    a thread (the lanes sweep of chip_smoke.py, in PERF.md)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return 4 if -(-B // 4) <= sms else 8


def launch_config(halpern: bool, m: int, n: int, nnz: int, lanes: int,
                  dtype) -> LaunchConfig:
    """The launch shape of one sweep: the fewest items per thread whose
    block fits the register budget, else the state in shared memory; the
    packed operator in shared memory where it fits beside the rest."""
    if lanes not in LANES_PER_BLOCK:
        raise ValueError(
            f"lanes_per_block must be one of {LANES_PER_BLOCK}, got {lanes}")
    width = max(m, n)
    for items in ITEMS_PER_THREAD:
        # workers per lane, rounded so that a block is whole warps
        step = max(1, 32 // lanes)
        workers = -(-width // items)
        workers = -(-workers // step) * step
        if workers * lanes <= max_threads(items, dtype):
            threads = workers * lanes
            break
    else:
        items = 0
        threads = min(1024, -(-width * lanes // 32) * 32)
    esz = torch.empty((), dtype=dtype).element_size()
    elems = lanes * (m + n + 3)
    if items == 0:
        elems += (5 if halpern else 3) * (m + n) * lanes
    base = elems * esz
    op = 2 * nnz * esz + 4 * (m + n + 2 + 2 * nnz)
    if base > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"a sweep with {lanes} {dtype} lanes per block at m={m}, n={n} "
            f"needs {base} bytes of shared memory (limit {SMEM_LIMIT_BYTES}); "
            "use a smaller lanes_per_block")
    op_in_smem = base + op <= SMEM_LIMIT_BYTES
    return LaunchConfig(items, threads, op_in_smem, base + (op if op_in_smem else 0))


# ---------------------------------------------------------------------
# plain PyTorch versions (the XLA-fallback sweeps of pdlp_batch.py)
# ---------------------------------------------------------------------

def _operand(u, low_precision):
    return u.to(torch.bfloat16).to(u.dtype) if low_precision else u


def _mm(u, M, low_precision):
    return _operand(u, low_precision) @ _operand(M, low_precision)


def avg_sweep_reference(Ah, AhT, lb, ub, eq, x, z, xs, zs, c, b, tau, sig, *,
                        k, low_precision=False):
    """``k`` restarted-averaged PDHG steps; returns ``(x, z, xs, zs)``."""
    is_eq = eq != 0
    for _ in range(k):
        grad = c + _mm(z, Ah, low_precision)
        xn = torch.clamp(x - tau * grad, lb, ub)
        ax = _mm(2.0 * xn - x, AhT, low_precision)
        zt = z + sig * (ax - b)
        zn = torch.where(is_eq, zt, torch.clamp(zt, min=0.0))
        x, z, xs, zs = xn, zn, xs + xn, zs + zn
    return x, z, xs, zs


def halpern_sweep_reference(Ah, AhT, lb, ub, eq, x, z, xa, za, xs, zs, c, b,
                            tau, sig, k0, *, k, low_precision=False):
    """``k`` reflected-Halpern PDHG steps with per-lane anchor ``(xa, za)``
    and per-lane step count ``k0``; returns ``(x, z, xt, zt, xs, zs)``."""
    is_eq = eq != 0
    xt, zt = x, z
    for i in range(k):
        grad = c + _mm(z, Ah, low_precision)
        xt = torch.clamp(x - tau * grad, lb, ub)
        ax = _mm(2.0 * xt - x, AhT, low_precision)
        z_t = z + sig * (ax - b)
        zt = torch.where(is_eq, z_t, torch.clamp(z_t, min=0.0))
        j = k0 + float(i)          # (B, 1) per-lane step count
        w = (j + 1.0) / (j + 2.0)
        x, z = (w * (2.0 * xt - x) + (1.0 - w) * xa,
                w * (2.0 * zt - z) + (1.0 - w) * za)
        xs, zs = xs + xt, zs + zt
    return x, z, xt, zt, xs, zs


# ---------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------

def _check(Ah, AhT, lb, ub, eq, lane_n, lane_m, lane_1, packed):
    dtype, device = Ah.dtype, Ah.device
    if dtype not in _DT:
        raise ValueError(f"PDHG sweep: dtype {dtype} is not float32/float64")
    if Ah.ndim != 2:
        raise ValueError(f"PDHG sweep: Ah must be 2-D, got {tuple(Ah.shape)}")
    m, n = Ah.shape
    B = lane_n[0].shape[0] if lane_n[0].ndim == 2 else -1
    want = ([(AhT, (n, m), dtype), (lb, (n,), dtype), (ub, (n,), dtype),
             (eq, (m,), dtype)]
            + [(t, (B, n), dtype) for t in lane_n]
            + [(t, (B, m), dtype) for t in lane_m]
            + [(t, (B, 1), dtype) for t in lane_1])
    if packed is not None:
        nnz, i32 = packed.nnz, torch.int32
        want += [(packed.col_ptr, (n + 1,), i32), (packed.row_idx, (nnz,), i32),
                 (packed.col_val, (nnz,), dtype), (packed.row_ptr, (m + 1,), i32),
                 (packed.col_idx, (nnz,), i32), (packed.row_val, (nnz,), dtype)]
    for t, shape, want_dtype in want:
        if t.dtype != want_dtype or t.device != device:
            raise ValueError(
                f"PDHG sweep: expected {want_dtype} on {device}; got "
                f"{t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(
                f"PDHG sweep: expected shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("PDHG sweep: operands must be contiguous")
    return B, m, n


def _launch(algo, low_precision, lanes_per_block, k, B, packed, ins, outs):
    dtype = ins[0].dtype
    m, n = packed.shape
    if lanes_per_block is None:
        lanes_per_block = default_lanes(B, ins[0].device)
    cfg = launch_config(algo == "halpern", m, n, packed.nnz, lanes_per_block, dtype)
    lib = build()
    fn = getattr(lib, f"pdhg_{algo}_{_DT[dtype]}_{'bf16' if low_precision else 'full'}")
    stream = torch.cuda.current_stream(ins[0].device).cuda_stream
    ptr = [None if t is None else t.data_ptr() for t in [*packed, *ins, *outs]]
    err = fn(*ptr, B, m, n, packed.nnz, k, lanes_per_block, cfg.items,
             cfg.threads, int(cfg.op_in_smem), stream)
    if err != 0:
        raise RuntimeError(f"pdhg_{algo} sweep kernel launch failed: cudaError {err}")


def avg_sweep(Ah, AhT, lb, ub, eq, x, z, xs, zs, c, b, tau, sig, *, k,
              low_precision=False, lanes_per_block=None, packed=None):
    """``k`` restarted-averaged PDHG steps per lane: the kernel on a CUDA
    tensor, the plain version on a CPU tensor.  ``packed`` is
    ``pack_operator(Ah)`` (made here from ``Ah`` if not given);
    ``lanes_per_block`` defaults to ``default_lanes(B)``.  Returns
    ``(x, z, xs, zs)`` in new tensors."""
    B, m, n = _check(Ah, AhT, lb, ub, eq, (x, xs, c), (z, zs, b), (tau, sig),
                     packed)
    if x.device.type == "cpu":
        return avg_sweep_reference(Ah, AhT, lb, ub, eq, x, z, xs, zs, c, b,
                                   tau, sig, k=k, low_precision=low_precision)
    if x.device.type != "cuda":
        raise ValueError(f"PDHG sweep: no kernel for device {x.device}")
    outs = [torch.empty_like(t) for t in (x, z, xs, zs)]
    if B:
        _launch("avg", low_precision, lanes_per_block, k, B,
                packed if packed is not None else pack_operator(Ah),
                [lb, ub, eq, c, b, tau, sig, None, x, z, None, None, xs, zs],
                [outs[0], outs[1], None, None, outs[2], outs[3]])
        avg_sweep.launches += 1
    return tuple(outs)


avg_sweep.launches = 0


def halpern_sweep(Ah, AhT, lb, ub, eq, x, z, xa, za, xs, zs, c, b, tau, sig,
                  k0, *, k, low_precision=False, lanes_per_block=None, packed=None):
    """``k`` reflected-Halpern PDHG steps per lane: the kernel on a CUDA
    tensor, the plain version on a CPU tensor.  ``packed`` is
    ``pack_operator(Ah)`` (made here from ``Ah`` if not given);
    ``lanes_per_block`` defaults to ``default_lanes(B)``.  Returns
    ``(x, z, xt, zt, xs, zs)`` in new tensors."""
    B, m, n = _check(Ah, AhT, lb, ub, eq, (x, xa, xs, c), (z, za, zs, b),
                     (tau, sig, k0), packed)
    if x.device.type == "cpu":
        return halpern_sweep_reference(Ah, AhT, lb, ub, eq, x, z, xa, za, xs,
                                       zs, c, b, tau, sig, k0, k=k,
                                       low_precision=low_precision)
    if x.device.type != "cuda":
        raise ValueError(f"PDHG sweep: no kernel for device {x.device}")
    outs = [torch.empty_like(t) for t in (x, z, x, z, xs, zs)]
    if B:
        _launch("halpern", low_precision, lanes_per_block, k, B,
                packed if packed is not None else pack_operator(Ah),
                [lb, ub, eq, c, b, tau, sig, k0, x, z, xa, za, xs, zs], outs)
        halpern_sweep.launches += 1
    return tuple(outs)


halpern_sweep.launches = 0
