// Fused k-step PDHG sweeps for the batch PDLP solver, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of dispatches_tpu/solvers/pdlp_batch.py:
//   _pallas_sweep_fn          (restarted-averaged PDHG, algorithm="avg")
//   _pallas_halpern_sweep_fn  (reflected-Halpern PDHG, algorithm="halpern")
// together with the precision tiers of _pallas_dot: the full tier multiplies
// and adds in the working type T on the CUDA cores (never TF32); the bf16
// tier rounds both product operands to bfloat16 (round to nearest even) and
// multiplies and adds in T, which is what preferred_element_type=T does.
//
// Per lane and step (avg; halpern adds the anchor pull-back):
//   xt = clip(x - tau (c + z Ah), lb, ub)         Ah (m, n)
//   zt = proj(z + sig ((2 xt - x) AhT - b))
//   halpern: w = (k0+s+1)/(k0+s+2), x <- w (2xt - x) + (1-w) xa, same for z
//   avg:     x <- xt, z <- zt
//   xs += xt, zs += zt
//
// Bound.  The products need 4 nnz k FLOPs per lane; at the main-path shapes
// (m 218, n 193, nnz 504, k 40, B 4096) that is 0.33 GFLOP, 0.005 ms at the
// 67 TFLOP/s f32 CUDA-core peak.  Reading each lane input and the operator
// once and writing each output once moves 47 MB in halpern f32, 0.0142 ms at
// 3.35 TB/s.  So the function is bound by bytes.
//
// Design.  Everything the k steps touch stays on chip, so device memory sees
// each byte once per launch:
// - The operator.  Both products visit only the nonzeros of Ah, in the packed
//   form of kernels/pdhg_sweep.py:pack_operator: by column for z Ah and by row
//   for (2xt - x) AhT, indices ascending within each column and row.  That is
//   the order in which a dense loop sums, and skipping an exact zero in an fma
//   chain leaves the sum unchanged (up to the sign of a zero sum), so each
//   product equals the dense one bit for bit.  A block copies the packed form
//   into shared memory once per launch (main path: 1,421 int32 pointers and
//   indices and 1,008 values, 9.7 KB in f32); a form too large for shared
//   memory is read through the read-only cache (__ldg) instead.
// - The work.  One block owns L lanes and runs all k steps.  In the primal
//   phase a thread takes (lane, column) items, in the dual phase (lane, row)
//   items, lanes innermost: the threads of a warp take consecutive lanes of a
//   column, walk its nonzeros together and read the lane-minor operand
//   z[i L + l] at consecutive addresses.  Per lane and step that is ~1,000
//   operand reads and FMAs, against 84,148 in the dense product.
// - The state.  Thread t keeps lane l = t mod L and the columns and rows
//   t / L + r W (r < ITEMS, W = threads / L) for all k steps, so the lane
//   state (x, xs, c, xa, xt and the bounds; z, zs, b, za, zt) lives in its
//   registers and shared memory holds only the two operand vectors.  Where
//   the widths would need more than 8 items a thread, the state lives in
//   shared memory instead (ITEMS = 0), lane-minor.
// - A ragged last lane block is zero-filled on load and masked on store.
// The earlier dense version of this kernel, one thread per output column
// looping over all m (or n) entries, took 2.51 ms per halpern f32 launch at
// B 4096 on an H100 80GB HBM3 at 700 W; this design takes 0.31 ms there, at
// 4.6% of the byte bound: every step waits at two block barriers for its
// slowest thread (the column with 25 nonzeros), and at B 4096 the SMs are
// bound by instruction issue (chip_smoke.py prints both numbers).
//
// Rounding.  Build with -fmad=false: every elementwise multiply and add then
// rounds as the plain PyTorch version's separate tensor ops do, while the
// explicit fma() of the products stays fused.  With contraction, a last-bit
// difference in x or z can flip a bf16 operand rounding in the low tier, and
// the following steps amplify it far past the f32 tolerance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ T bf16_round(T v);

template <>
__device__ __forceinline__ float bf16_round<float>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <>
__device__ __forceinline__ double bf16_round<double>(double v) {
  // through float, as torch's and XLA's double -> bfloat16 casts round
  return static_cast<double>(
      __bfloat162float(__float2bfloat16_rn(static_cast<float>(v))));
}

template <typename T, bool LOW>
__device__ __forceinline__ T operand(T v) {
  if constexpr (LOW) {
    return bf16_round<T>(v);
  } else {
    return v;
  }
}

// NaN-propagating clip and projection, like jnp.clip / torch.clamp
template <typename T>
__device__ __forceinline__ T clip(T v, T lo, T hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// a load from the packed operator: shared memory, or the read-only cache
template <bool SMEM, typename U>
__device__ __forceinline__ U ld(const U* p) {
  if constexpr (SMEM) {
    return *p;
  } else {
    return __ldg(p);
  }
}

template <typename T>
struct SweepArgs {
  const int* col_ptr;  // (n+1,) column j's nonzeros are [col_ptr[j], col_ptr[j+1])
  const int* row_idx;  // (nnz,) their rows, ascending within each column
  const T* col_val;    // (nnz,)
  const int* row_ptr;  // (m+1,) row i's nonzeros are [row_ptr[i], row_ptr[i+1])
  const int* col_idx;  // (nnz,) their columns, ascending within each row
  const T* row_val;    // (nnz,)
  const T* lb;   // (n,)
  const T* ub;   // (n,)
  const T* eq;   // (m,) 1 on equality rows, 0 on inequality rows
  const T* c;    // (B, n)
  const T* b;    // (B, m)
  const T* tau;  // (B,)
  const T* sig;  // (B,)
  const T* k0;   // (B,)  halpern: steps since the lane's last restart
  const T* x;    // (B, n)
  const T* z;    // (B, m)
  const T* xa;   // (B, n) halpern anchor
  const T* za;   // (B, m) halpern anchor
  const T* xs;   // (B, n) running sums
  const T* zs;   // (B, m)
  T* x_out;
  T* z_out;
  T* xt_out;     // halpern: last operator output
  T* zt_out;
  T* xs_out;
  T* zs_out;
  int B, m, n, nnz, k;
};

// Threads one block may have, so that ~12 state values per item and 32 other
// registers a thread fit the SM's 65,536 registers (the kernel's launch bound;
// kernels/pdhg_sweep.py:max_threads computes the same).
template <typename T, int ITEMS>
constexpr int max_threads() {
  constexpr int regs = ITEMS * 12 * static_cast<int>(sizeof(T) / 4) + 32;
  constexpr int t = 65536 / regs / 32 * 32;
  return t < 1024 ? t : 1024;
}

// Dynamic shared memory of one block, in bytes: the operand vectors (m + n)
// and tau, sig, k0 for L lanes; the lane state when ITEMS is 0; the packed
// operator when it is held in shared memory (kernels/pdhg_sweep.py:
// launch_config computes the same).
size_t smem_bytes(bool halpern, int items, bool op_smem, int m, int n, int nnz,
                  int L, size_t esz) {
  size_t elems = static_cast<size_t>(L) * (m + n + 3);
  if (items == 0) elems += static_cast<size_t>(halpern ? 5 : 3) * (m + n) * L;
  size_t bytes = elems * esz;
  if (op_smem) {
    bytes += 2 * static_cast<size_t>(nnz) * esz +
             static_cast<size_t>(m + n + 2 + 2 * static_cast<size_t>(nnz)) * 4;
  }
  return bytes;
}

// sum over the nonzeros [ptr[col], ptr[col+1]) of opnd[idx L + l] * val, in
// ascending index order, as the dense product sums
template <typename T, bool LOW, bool SMEM>
__device__ __forceinline__ T spdot(const int* ptr, const int* idx, const T* val,
                                   int col, const T* opnd, int L, int l) {
  const int p0 = ld<SMEM>(ptr + col), p1 = ld<SMEM>(ptr + col + 1);
  T acc = T(0);
  for (int p = p0; p < p1; ++p) {
    acc = fma(opnd[ld<SMEM>(idx + p) * L + l], operand<T, LOW>(ld<SMEM>(val + p)), acc);
  }
  return acc;
}

// one primal item: xt = clip(x - tau (c + acc)), then the lane's update;
// writes the operand 2xt - x of the dual product to *vb
template <typename T, bool HALPERN, bool LOW>
__device__ __forceinline__ void primal_item(T acc, T tau, T w, T& x, T& xs, T c,
                                            T xa, T& xt, T lo, T hi, T* vb) {
  const T xv = x;
  const T t = clip(xv - tau * (c + acc), lo, hi);
  const T v = T(2) * t - xv;
  *vb = operand<T, LOW>(v);
  if constexpr (HALPERN) {
    x = w * v + (T(1) - w) * xa;
    xt = t;
  } else {
    x = t;
  }
  xs += t;
}

// one dual item: zt = proj(z + sig (acc - b)), then the lane's update;
// writes the operand of the next primal product to *zb
template <typename T, bool HALPERN, bool LOW>
__device__ __forceinline__ void dual_item(T acc, T sig, T w, bool is_eq, T& z,
                                          T& zs, T b, T za, T& zt, T* zb) {
  const T zv = z;
  const T zr = zv + sig * (acc - b);
  const T t = (is_eq || !(zr < T(0))) ? zr : T(0);
  T zn;
  if constexpr (HALPERN) {
    zn = w * (T(2) * t - zv) + (T(1) - w) * za;
    zt = t;
  } else {
    zn = t;
  }
  z = zn;
  *zb = operand<T, LOW>(zn);
  zs += t;
}

template <typename T, bool HALPERN>
__device__ __forceinline__ T halpern_weight(T k0, int s) {
  if constexpr (HALPERN) {
    const T jj = k0 + static_cast<T>(s);
    return (jj + T(1)) / (jj + T(2));
  } else {
    return T(0);
  }
}

template <typename T, bool HALPERN, bool LOW, int ITEMS, bool OP_SMEM>
__global__ void __launch_bounds__(max_threads<T, ITEMS>())
pdhg_sweep_kernel(const SweepArgs<T> a, const int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m = a.m, n = a.n, nnz = a.nnz;
  constexpr int NS = HALPERN ? 5 : 3;  // state arrays per side when ITEMS == 0
  // lane-minor product operands, [row * L + l] and [col * L + l]
  T* s_zb = reinterpret_cast<T*>(smem_raw);
  T* s_vb = s_zb + m * L;
  T* s_tau = s_vb + n * L;
  T* s_sig = s_tau + L;
  T* s_k0 = s_sig + L;
  T* s_state = s_k0 + L;
  T* s_op = s_state + (ITEMS == 0 ? NS * (m + n) * L : 0);

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const long lane0 = static_cast<long>(blockIdx.x) * L;

  const int* cp;
  const int* ri;
  const T* cv;
  const int* rp;
  const int* ci;
  const T* rv;
  if constexpr (OP_SMEM) {
    T* s_cv = s_op;
    T* s_rv = s_cv + nnz;
    int* s_cp = reinterpret_cast<int*>(s_rv + nnz);
    int* s_ri = s_cp + (n + 1);
    int* s_rp = s_ri + nnz;
    int* s_ci = s_rp + (m + 1);
    for (int e = tid; e < nnz; e += nth) {
      s_cv[e] = a.col_val[e];
      s_rv[e] = a.row_val[e];
      s_ri[e] = a.row_idx[e];
      s_ci[e] = a.col_idx[e];
    }
    for (int e = tid; e <= n; e += nth) s_cp[e] = a.col_ptr[e];
    for (int e = tid; e <= m; e += nth) s_rp[e] = a.row_ptr[e];
    cp = s_cp;
    ri = s_ri;
    cv = s_cv;
    rp = s_rp;
    ci = s_ci;
    rv = s_rv;
  } else {
    cp = a.col_ptr;
    ri = a.row_idx;
    cv = a.col_val;
    rp = a.row_ptr;
    ci = a.col_idx;
    rv = a.row_val;
  }

  for (int e = tid; e < m * L; e += nth) {
    const int i = e / L, l = e - i * L;
    const bool ok = lane0 + l < a.B;
    s_zb[e] = operand<T, LOW>(ok ? a.z[(lane0 + l) * m + i] : T(0));
  }
  if (tid < L) {
    const bool ok = lane0 + tid < a.B;
    s_tau[tid] = ok ? a.tau[lane0 + tid] : T(0);
    s_sig[tid] = ok ? a.sig[lane0 + tid] : T(0);
    s_k0[tid] = (HALPERN && ok) ? a.k0[lane0 + tid] : T(0);
  }

  if constexpr (ITEMS > 0) {
    // ---- state in registers: lane l, columns and rows w0 + r W ---------
    const int l = tid % L, w0 = tid / L, W = nth / L;
    const bool ok = lane0 + l < a.B;
    const long gx = (lane0 + l) * n, gz = (lane0 + l) * m;
    T x[ITEMS], xs[ITEMS], c[ITEMS], xa[ITEMS], xt[ITEMS], lo[ITEMS], hi[ITEMS];
    T z[ITEMS], zs[ITEMS], b[ITEMS], za[ITEMS], zt[ITEMS];
    unsigned eq_bits = 0;
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      const int j = w0 + r * W;
      const bool okj = ok && j < n;
      x[r] = okj ? a.x[gx + j] : T(0);
      xs[r] = okj ? a.xs[gx + j] : T(0);
      c[r] = okj ? a.c[gx + j] : T(0);
      xa[r] = (HALPERN && okj) ? a.xa[gx + j] : T(0);
      xt[r] = x[r];
      lo[r] = j < n ? a.lb[j] : T(0);
      hi[r] = j < n ? a.ub[j] : T(0);
      const int i = w0 + r * W;
      const bool oki = ok && i < m;
      z[r] = oki ? a.z[gz + i] : T(0);
      zs[r] = oki ? a.zs[gz + i] : T(0);
      b[r] = oki ? a.b[gz + i] : T(0);
      za[r] = (HALPERN && oki) ? a.za[gz + i] : T(0);
      zt[r] = z[r];
      if (i < m && a.eq[i] != T(0)) eq_bits |= 1u << r;
    }
    __syncthreads();
    const T tau = s_tau[l], sig = s_sig[l], k0 = s_k0[l];

    for (int s = 0; s < a.k; ++s) {
      const T w = halpern_weight<T, HALPERN>(k0, s);
#pragma unroll
      for (int r = 0; r < ITEMS; ++r) {
        const int j = w0 + r * W;
        if (j < n) {
          const T acc = spdot<T, LOW, OP_SMEM>(cp, ri, cv, j, s_zb, L, l);
          primal_item<T, HALPERN, LOW>(acc, tau, w, x[r], xs[r], c[r], xa[r],
                                       xt[r], lo[r], hi[r], s_vb + j * L + l);
        }
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < ITEMS; ++r) {
        const int i = w0 + r * W;
        if (i < m) {
          const T acc = spdot<T, LOW, OP_SMEM>(rp, ci, rv, i, s_vb, L, l);
          dual_item<T, HALPERN, LOW>(acc, sig, w, (eq_bits >> r) & 1u, z[r],
                                     zs[r], b[r], za[r], zt[r], s_zb + i * L + l);
        }
      }
      __syncthreads();
    }

    if (ok) {
#pragma unroll
      for (int r = 0; r < ITEMS; ++r) {
        const int j = w0 + r * W;
        if (j < n) {
          a.x_out[gx + j] = x[r];
          a.xs_out[gx + j] = xs[r];
          if constexpr (HALPERN) a.xt_out[gx + j] = xt[r];
        }
        const int i = w0 + r * W;
        if (i < m) {
          a.z_out[gz + i] = z[r];
          a.zs_out[gz + i] = zs[r];
          if constexpr (HALPERN) a.zt_out[gz + i] = zt[r];
        }
      }
    }
  } else {
    // ---- state in shared memory, lane-minor [col * L + l] ---------------
    T* s_x = s_state;
    T* s_xs = s_x + n * L;
    T* s_c = s_xs + n * L;
    T* s_xa = s_c + n * L;                    // halpern only
    T* s_xt = s_xa + n * L;                   // halpern only
    T* s_z = s_state + NS * n * L;
    T* s_zs = s_z + m * L;
    T* s_b = s_zs + m * L;
    T* s_za = s_b + m * L;                    // halpern only
    T* s_zt = s_za + m * L;                   // halpern only
    for (int e = tid; e < n * L; e += nth) {
      const int j = e / L, l = e - j * L;
      const bool ok = lane0 + l < a.B;
      const long g = (lane0 + l) * n + j;
      s_x[e] = ok ? a.x[g] : T(0);
      s_xs[e] = ok ? a.xs[g] : T(0);
      s_c[e] = ok ? a.c[g] : T(0);
      if constexpr (HALPERN) {
        s_xa[e] = ok ? a.xa[g] : T(0);
        s_xt[e] = s_x[e];
      }
    }
    for (int e = tid; e < m * L; e += nth) {
      const int i = e / L, l = e - i * L;
      const bool ok = lane0 + l < a.B;
      const long g = (lane0 + l) * m + i;
      s_z[e] = ok ? a.z[g] : T(0);
      s_zs[e] = ok ? a.zs[g] : T(0);
      s_b[e] = ok ? a.b[g] : T(0);
      if constexpr (HALPERN) {
        s_za[e] = ok ? a.za[g] : T(0);
        s_zt[e] = s_z[e];
      }
    }
    __syncthreads();

    T unused = T(0);
    for (int s = 0; s < a.k; ++s) {
      for (int e = tid; e < n * L; e += nth) {
        const int j = e / L, l = e - j * L;
        const T acc = spdot<T, LOW, OP_SMEM>(cp, ri, cv, j, s_zb, L, l);
        primal_item<T, HALPERN, LOW>(
            acc, s_tau[l], halpern_weight<T, HALPERN>(s_k0[l], s), s_x[e], s_xs[e],
            s_c[e], HALPERN ? s_xa[e] : T(0), HALPERN ? s_xt[e] : unused,
            __ldg(a.lb + j), __ldg(a.ub + j), s_vb + e);
      }
      __syncthreads();
      for (int e = tid; e < m * L; e += nth) {
        const int i = e / L, l = e - i * L;
        const T acc = spdot<T, LOW, OP_SMEM>(rp, ci, rv, i, s_vb, L, l);
        dual_item<T, HALPERN, LOW>(
            acc, s_sig[l], halpern_weight<T, HALPERN>(s_k0[l], s),
            __ldg(a.eq + i) != T(0), s_z[e], s_zs[e], s_b[e],
            HALPERN ? s_za[e] : T(0), HALPERN ? s_zt[e] : unused, s_zb + e);
      }
      __syncthreads();
    }

    for (int e = tid; e < n * L; e += nth) {
      const int j = e / L, l = e - j * L;
      if (lane0 + l >= a.B) continue;
      const long g = (lane0 + l) * n + j;
      a.x_out[g] = s_x[e];
      a.xs_out[g] = s_xs[e];
      if constexpr (HALPERN) a.xt_out[g] = s_xt[e];
    }
    for (int e = tid; e < m * L; e += nth) {
      const int i = e / L, l = e - i * L;
      if (lane0 + l >= a.B) continue;
      const long g = (lane0 + l) * m + i;
      a.z_out[g] = s_z[e];
      a.zs_out[g] = s_zs[e];
      if constexpr (HALPERN) a.zt_out[g] = s_zt[e];
    }
  }
}

template <typename T, bool HALPERN, bool LOW, int ITEMS, bool OP_SMEM>
int launch(const SweepArgs<T>& a, int L, int threads, cudaStream_t stream) {
  if (threads > max_threads<T, ITEMS>()) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(HALPERN, ITEMS, OP_SMEM, a.m, a.n, a.nnz, L, sizeof(T));
  auto kernel = pdhg_sweep_kernel<T, HALPERN, LOW, ITEMS, OP_SMEM>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((a.B + L - 1) / L);
  kernel<<<blocks, threads, smem, stream>>>(a, L);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool HALPERN, bool LOW>
int dispatch(const SweepArgs<T>& a, int lanes, int items, int threads, int op_smem,
             cudaStream_t st) {
  if (lanes < 1 || lanes > 32 || threads < 32 || threads % 32 != 0 ||
      threads < lanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the register kernels need every thread on one lane and enough of them
  // to cover the wider side
  const int width = a.m > a.n ? a.m : a.n;
  if (items > 0 && (threads % lanes != 0 ||
                    static_cast<long>(threads / lanes) * items < width)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define PDHG_CASE(I)                                                          \
  case I:                                                                     \
    return op_smem ? launch<T, HALPERN, LOW, I, true>(a, lanes, threads, st)  \
                   : launch<T, HALPERN, LOW, I, false>(a, lanes, threads, st);
  switch (items) {
    PDHG_CASE(0)
    PDHG_CASE(1)
    PDHG_CASE(2)
    PDHG_CASE(4)
    PDHG_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PDHG_CASE
}

}  // namespace

// One plain C entry point per (type, algorithm, tier).  The launch shape
// (lanes per block, items per thread with 0 for state in shared memory,
// threads per block, operator in shared memory or not) comes from
// kernels/pdhg_sweep.py:launch_config.  Returns the cudaError_t of the launch.
#define PDHG_ENTRY(NAME, T, HALPERN, LOW)                                       \
  extern "C" int NAME(                                                          \
      const void* col_ptr, const void* row_idx, const void* col_val,            \
      const void* row_ptr, const void* col_idx, const void* row_val,            \
      const void* lb, const void* ub, const void* eq, const void* c,            \
      const void* b, const void* tau, const void* sig, const void* k0,          \
      const void* x, const void* z, const void* xa, const void* za,             \
      const void* xs, const void* zs, void* x_out, void* z_out, void* xt_out,   \
      void* zt_out, void* xs_out, void* zs_out, int B, int m, int n, int nnz,   \
      int k, int lanes, int items, int threads, int op_smem, void* stream) {    \
    const SweepArgs<T> a{                                                       \
        static_cast<const int*>(col_ptr), static_cast<const int*>(row_idx),     \
        static_cast<const T*>(col_val),   static_cast<const int*>(row_ptr),     \
        static_cast<const int*>(col_idx), static_cast<const T*>(row_val),       \
        static_cast<const T*>(lb),        static_cast<const T*>(ub),            \
        static_cast<const T*>(eq),        static_cast<const T*>(c),             \
        static_cast<const T*>(b),         static_cast<const T*>(tau),           \
        static_cast<const T*>(sig),       static_cast<const T*>(k0),            \
        static_cast<const T*>(x),         static_cast<const T*>(z),             \
        static_cast<const T*>(xa),        static_cast<const T*>(za),            \
        static_cast<const T*>(xs),        static_cast<const T*>(zs),            \
        static_cast<T*>(x_out),           static_cast<T*>(z_out),               \
        static_cast<T*>(xt_out),          static_cast<T*>(zt_out),              \
        static_cast<T*>(xs_out),          static_cast<T*>(zs_out),              \
        B, m, n, nnz, k};                                                       \
    return dispatch<T, HALPERN, LOW>(a, lanes, items, threads, op_smem,         \
                                     static_cast<cudaStream_t>(stream));        \
  }

PDHG_ENTRY(pdhg_avg_f32_full, float, false, false)
PDHG_ENTRY(pdhg_avg_f32_bf16, float, false, true)
PDHG_ENTRY(pdhg_avg_f64_full, double, false, false)
PDHG_ENTRY(pdhg_avg_f64_bf16, double, false, true)
PDHG_ENTRY(pdhg_halpern_f32_full, float, true, false)
PDHG_ENTRY(pdhg_halpern_f32_bf16, float, true, true)
PDHG_ENTRY(pdhg_halpern_f64_full, double, true, false)
PDHG_ENTRY(pdhg_halpern_f64_bf16, double, true, true)
