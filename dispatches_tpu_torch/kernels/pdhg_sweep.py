"""Fused k-step PDHG sweeps: the CUDA kernels of ``csrc/pdhg_sweep.cu``,
their wrappers and their plain PyTorch versions.

Replaces the Pallas TPU kernels ``_pallas_sweep_fn`` (avg) and
``_pallas_halpern_sweep_fn`` (halpern) of
``dispatches_tpu/solvers/pdlp_batch.py``, with the two precision tiers of
its ``_pallas_dot``: full-dtype products, or both operands rounded to
bfloat16 with products and sums in the working dtype.

Bound: the dense products are 4 m n k FLOPs per lane — 27.6 GFLOP at the
main-path shapes (m 218, n 193, k 40, B 4096), 0.41 ms at the H100's
67 TFLOP/s f32 CUDA-core peak — against ~14 us to read and write the
lane state once, so the dense kernel is bound by f32 operations.  The
work the data needs is smaller: Ah holds 504 nonzeros (1.2%), so the
products need 4 nnz k FLOPs per lane and the function is bound by the
bytes of lane state; only a sparse kernel could approach that.  The
design (one block per few lanes, all k steps in shared memory, matrices
read from L2) is described in the CUDA source.

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

import torch

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "pdhg_sweep.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# -fmad=false: elementwise ops round like the plain version's (see the
# CUDA source); -Xptxas -v: registers and spills go into the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LANES_PER_BLOCK = (1, 2, 4, 8, 16)
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
    with _build_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(library_path()))
            for name in _ENTRIES:
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def smem_bytes(halpern: bool, m: int, n: int, lanes: int, dtype) -> int:
    """Dynamic shared memory one block of the sweep kernel uses."""
    per_lane = (6 if halpern else 4) * (m + n) + 3
    return lanes * per_lane * torch.empty((), dtype=dtype).element_size()


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

def _check(Ah, AhT, lb, ub, eq, lane_n, lane_m, lane_1):
    dtype, device = Ah.dtype, Ah.device
    if dtype not in _DT:
        raise ValueError(f"PDHG sweep: dtype {dtype} is not float32/float64")
    if Ah.ndim != 2:
        raise ValueError(f"PDHG sweep: Ah must be 2-D, got {tuple(Ah.shape)}")
    m, n = Ah.shape
    B = lane_n[0].shape[0] if lane_n[0].ndim == 2 else -1
    want = ([(AhT, (n, m)), (lb, (n,)), (ub, (n,)), (eq, (m,))]
            + [(t, (B, n)) for t in lane_n] + [(t, (B, m)) for t in lane_m]
            + [(t, (B, 1)) for t in lane_1])
    for t, shape in want:
        if t.dtype != dtype or t.device != device:
            raise ValueError(
                f"PDHG sweep: every operand must be {dtype} on {device}; got "
                f"{t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(
                f"PDHG sweep: expected shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("PDHG sweep: operands must be contiguous")
    return B, m, n


def _launch(algo, low_precision, lanes_per_block, k, B, m, n, ins, outs):
    if lanes_per_block not in LANES_PER_BLOCK:
        raise ValueError(
            f"lanes_per_block must be one of {LANES_PER_BLOCK}, got "
            f"{lanes_per_block}")
    dtype = ins[0].dtype
    need = smem_bytes(algo == "halpern", m, n, lanes_per_block, dtype)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"{algo} sweep with {lanes_per_block} {dtype} lanes per block "
            f"needs {need} bytes of shared memory (limit {SMEM_LIMIT_BYTES}); "
            "use a smaller lanes_per_block")
    lib = build()
    fn = getattr(lib, f"pdhg_{algo}_{_DT[dtype]}_{'bf16' if low_precision else 'full'}")
    stream = torch.cuda.current_stream(ins[0].device).cuda_stream
    ptr = [None if t is None else t.data_ptr() for t in ins + outs]
    err = fn(*ptr, B, m, n, k, lanes_per_block, stream)
    if err != 0:
        raise RuntimeError(f"pdhg_{algo} sweep kernel launch failed: cudaError {err}")


def avg_sweep(Ah, AhT, lb, ub, eq, x, z, xs, zs, c, b, tau, sig, *, k,
              low_precision=False, lanes_per_block=8):
    """``k`` restarted-averaged PDHG steps per lane: the kernel on a CUDA
    tensor, the plain version on a CPU tensor.  Returns
    ``(x, z, xs, zs)`` in new tensors."""
    B, m, n = _check(Ah, AhT, lb, ub, eq, (x, xs, c), (z, zs, b), (tau, sig))
    if x.device.type == "cpu":
        return avg_sweep_reference(Ah, AhT, lb, ub, eq, x, z, xs, zs, c, b,
                                   tau, sig, k=k, low_precision=low_precision)
    if x.device.type != "cuda":
        raise ValueError(f"PDHG sweep: no kernel for device {x.device}")
    outs = [torch.empty_like(t) for t in (x, z, xs, zs)]
    if B:
        _launch("avg", low_precision, lanes_per_block, k, B, m, n,
                [Ah, AhT, lb, ub, eq, c, b, tau, sig, None, x, z, None, None,
                 xs, zs],
                [outs[0], outs[1], None, None, outs[2], outs[3]])
        avg_sweep.launches += 1
    return tuple(outs)


avg_sweep.launches = 0


def halpern_sweep(Ah, AhT, lb, ub, eq, x, z, xa, za, xs, zs, c, b, tau, sig,
                  k0, *, k, low_precision=False, lanes_per_block=8):
    """``k`` reflected-Halpern PDHG steps per lane: the kernel on a CUDA
    tensor, the plain version on a CPU tensor.  Returns
    ``(x, z, xt, zt, xs, zs)`` in new tensors."""
    B, m, n = _check(Ah, AhT, lb, ub, eq, (x, xa, xs, c), (z, za, zs, b),
                     (tau, sig, k0))
    if x.device.type == "cpu":
        return halpern_sweep_reference(Ah, AhT, lb, ub, eq, x, z, xa, za, xs,
                                       zs, c, b, tau, sig, k0, k=k,
                                       low_precision=low_precision)
    if x.device.type != "cuda":
        raise ValueError(f"PDHG sweep: no kernel for device {x.device}")
    outs = [torch.empty_like(t) for t in (x, z, x, z, xs, zs)]
    if B:
        _launch("halpern", low_precision, lanes_per_block, k, B, m, n,
                [Ah, AhT, lb, ub, eq, c, b, tau, sig, k0, x, z, xa, za, xs, zs],
                outs)
        halpern_sweep.launches += 1
    return tuple(outs)


halpern_sweep.launches = 0
