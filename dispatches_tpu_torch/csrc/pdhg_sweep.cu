// Fused k-step PDHG sweeps for the batch PDLP solver, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of dispatches_tpu/solvers/pdlp_batch.py:
//   _pallas_sweep_fn          (restarted-averaged PDHG, algorithm="avg")
//   _pallas_halpern_sweep_fn  (reflected-Halpern PDHG, algorithm="halpern")
// together with the precision tiers of _pallas_dot: the full tier multiplies
// and adds in the working type T on the CUDA cores (never TF32); the bf16
// tier rounds both matmul operands to bfloat16 (round to nearest even) and
// multiplies and adds in T, which is what preferred_element_type=T does.
//
// Per lane and step (avg; halpern adds the anchor pull-back):
//   xt = clip(x - tau (c + z Ah), lb, ub)         Ah  (m, n) row-major
//   zt = proj(z + sig ((2 xt - x) AhT - b))       AhT (n, m) row-major
//   halpern: w = (k0+s+1)/(k0+s+2), x <- w (2xt - x) + (1-w) xa, same for z
//   avg:     x <- xt, z <- zt
//   xs += xt, zs += zt
//
// Design.  One thread block owns L lanes and runs all k steps in a loop,
// with the lanes' state in shared memory; blocks share nothing, as the
// Pallas grid steps over lane blocks shared nothing.  Thread t owns output
// columns t, t+blockDim, ... of both products for all L lanes: it reads Ah
// (first product) and AhT (second) row by row from global memory, so
// neighbouring threads read neighbouring addresses, and reuses each loaded
// element across the L lanes.  The vector operand of each product (z, then
// 2xt - x) sits in shared memory lane-minor, so the L values a thread needs
// for one matrix element are contiguous and every thread of a warp reads
// the same address (a broadcast).  Both matrices stay in L2 (f32: 336 KB of
// 50 MB): together they exceed the 227 KB a block may hold in shared memory.
// A ragged last lane block is zero-filled on load and masked on store.
//
// Rounding.  Build with -fmad=false: every elementwise multiply and add then
// rounds as the plain PyTorch version's separate tensor ops do, while the
// explicit fma() of the products stays fused.  With contraction, a last-bit
// difference in x or z can flip a bf16 operand rounding in the low tier, and
// the following steps amplify it far past the f32 tolerance.
//
// Bound.  The dense products are 4 m n k FLOPs per lane: at the main-path
// shapes (m 218, n 193, k 40, B 4096) 27.6 GFLOP, 0.41 ms at the 67 TFLOP/s
// f32 CUDA-core peak, against ~14 us to move the lane state once.  So the
// dense kernel is bound by f32 operations.  Ah is 1.2% dense; a sparse form
// would be bound by bytes instead, and is later work.

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

template <typename T>
struct SweepArgs {
  const T* Ah;   // (m, n)
  const T* AhT;  // (n, m)
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
  int B, m, n, k;
};

// shared-memory elements of one block: per lane x, xs, c, v (n each) and
// z, zs, b, zb (m each), plus xa, xt (n) and za, zt (m) for halpern, plus
// tau, sig, k0 (kernels/pdhg_sweep.py:smem_bytes computes the same)
constexpr long smem_elems(bool halpern, int m, int n, int L) {
  return static_cast<long>(L) * ((halpern ? 6 : 4) * (static_cast<long>(m) + n) + 3);
}

template <typename T, bool HALPERN, bool LOW, int L>
__global__ void pdhg_sweep_kernel(const SweepArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int m = a.m, n = a.n;
  // lane-major state, [l * width + col]
  T* s_x = smem;
  T* s_xs = s_x + L * n;
  T* s_c = s_xs + L * n;
  T* s_z = s_c + L * n;
  T* s_zs = s_z + L * m;
  T* s_b = s_zs + L * m;
  // lane-minor matmul operands, [col * L + l]
  T* s_zb = s_b + L * m;
  T* s_vb = s_zb + L * m;
  T* s_xa = s_vb + L * n;
  T* s_xt = HALPERN ? s_xa + L * n : s_xa;
  T* s_za = HALPERN ? s_xt + L * n : s_xa;
  T* s_zt = HALPERN ? s_za + L * m : s_xa;
  T* s_tau = HALPERN ? s_zt + L * m : s_xa;
  T* s_sig = s_tau + L;
  T* s_k0 = s_sig + L;

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const long lane0 = static_cast<long>(blockIdx.x) * L;

  for (int e = tid; e < L * n; e += nth) {
    const int l = e / n, j = e - l * n;
    const bool ok = lane0 + l < a.B;
    const long g = (lane0 + l) * n + j;
    const T xv = ok ? a.x[g] : T(0);
    s_x[e] = xv;
    s_xs[e] = ok ? a.xs[g] : T(0);
    s_c[e] = ok ? a.c[g] : T(0);
    if constexpr (HALPERN) {
      s_xa[e] = ok ? a.xa[g] : T(0);
      s_xt[e] = xv;
    }
  }
  for (int e = tid; e < L * m; e += nth) {
    const int l = e / m, i = e - l * m;
    const bool ok = lane0 + l < a.B;
    const long g = (lane0 + l) * m + i;
    const T zv = ok ? a.z[g] : T(0);
    s_z[e] = zv;
    s_zb[i * L + l] = operand<T, LOW>(zv);
    s_zs[e] = ok ? a.zs[g] : T(0);
    s_b[e] = ok ? a.b[g] : T(0);
    if constexpr (HALPERN) {
      s_za[e] = ok ? a.za[g] : T(0);
      s_zt[e] = zv;
    }
  }
  if (tid < L) {
    const bool ok = lane0 + tid < a.B;
    s_tau[tid] = ok ? a.tau[lane0 + tid] : T(0);
    s_sig[tid] = ok ? a.sig[lane0 + tid] : T(0);
    s_k0[tid] = (HALPERN && ok) ? a.k0[lane0 + tid] : T(0);
  }
  __syncthreads();

  for (int s = 0; s < a.k; ++s) {
    // ---- primal: xt = clip(x - tau (c + z Ah)) ----------------------
    for (int j = tid; j < n; j += nth) {
      T acc[L];
#pragma unroll
      for (int l = 0; l < L; ++l) acc[l] = T(0);
#pragma unroll 4
      for (int i = 0; i < m; ++i) {
        const T av = operand<T, LOW>(__ldg(a.Ah + static_cast<long>(i) * n + j));
        const T* zr = s_zb + i * L;
#pragma unroll
        for (int l = 0; l < L; ++l) acc[l] = fma(zr[l], av, acc[l]);
      }
      const T lo = a.lb[j], hi = a.ub[j];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const int e = l * n + j;
        const T xv = s_x[e];
        const T xt = clip(xv - s_tau[l] * (s_c[e] + acc[l]), lo, hi);
        const T v = T(2) * xt - xv;
        s_vb[j * L + l] = operand<T, LOW>(v);
        if constexpr (HALPERN) {
          const T jj = s_k0[l] + static_cast<T>(s);
          const T w = (jj + T(1)) / (jj + T(2));
          s_x[e] = w * v + (T(1) - w) * s_xa[e];
          s_xt[e] = xt;
        } else {
          s_x[e] = xt;
        }
        s_xs[e] += xt;
      }
    }
    __syncthreads();

    // ---- dual: zt = proj(z + sig ((2xt - x) AhT - b)) ---------------
    for (int i = tid; i < m; i += nth) {
      T acc[L];
#pragma unroll
      for (int l = 0; l < L; ++l) acc[l] = T(0);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const T av = operand<T, LOW>(__ldg(a.AhT + static_cast<long>(j) * m + i));
        const T* vr = s_vb + j * L;
#pragma unroll
        for (int l = 0; l < L; ++l) acc[l] = fma(vr[l], av, acc[l]);
      }
      const bool is_eq = a.eq[i] != T(0);
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const int e = l * m + i;
        const T zv = s_z[e];
        const T zr = zv + s_sig[l] * (acc[l] - s_b[e]);
        const T zt = (is_eq || !(zr < T(0))) ? zr : T(0);
        T zn;
        if constexpr (HALPERN) {
          const T jj = s_k0[l] + static_cast<T>(s);
          const T w = (jj + T(1)) / (jj + T(2));
          zn = w * (T(2) * zt - zv) + (T(1) - w) * s_za[e];
          s_zt[e] = zt;
        } else {
          zn = zt;
        }
        s_z[e] = zn;
        s_zb[i * L + l] = operand<T, LOW>(zn);
        s_zs[e] += zt;
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < L * n; e += nth) {
    const int l = e / n, j = e - l * n;
    if (lane0 + l >= a.B) continue;
    const long g = (lane0 + l) * n + j;
    a.x_out[g] = s_x[e];
    a.xs_out[g] = s_xs[e];
    if constexpr (HALPERN) a.xt_out[g] = s_xt[e];
  }
  for (int e = tid; e < L * m; e += nth) {
    const int l = e / m, i = e - l * m;
    if (lane0 + l >= a.B) continue;
    const long g = (lane0 + l) * m + i;
    a.z_out[g] = s_z[e];
    a.zs_out[g] = s_zs[e];
    if constexpr (HALPERN) a.zt_out[g] = s_zt[e];
  }
}

template <typename T, bool HALPERN, bool LOW, int L>
int launch(const SweepArgs<T>& a, cudaStream_t stream) {
  const size_t smem = smem_elems(HALPERN, a.m, a.n, L) * sizeof(T);
  auto kernel = pdhg_sweep_kernel<T, HALPERN, LOW, L>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int width = a.m > a.n ? a.m : a.n;
  int threads = (width + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  const unsigned blocks = static_cast<unsigned>((a.B + L - 1) / L);
  kernel<<<blocks, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool HALPERN, bool LOW>
int dispatch(const void* Ah, const void* AhT, const void* lb, const void* ub,
             const void* eq, const void* c, const void* b, const void* tau,
             const void* sig, const void* k0, const void* x, const void* z,
             const void* xa, const void* za, const void* xs, const void* zs,
             void* x_out, void* z_out, void* xt_out, void* zt_out, void* xs_out,
             void* zs_out, int B, int m, int n, int k, int lanes, void* stream) {
  SweepArgs<T> a{static_cast<const T*>(Ah), static_cast<const T*>(AhT),
                 static_cast<const T*>(lb), static_cast<const T*>(ub),
                 static_cast<const T*>(eq), static_cast<const T*>(c),
                 static_cast<const T*>(b), static_cast<const T*>(tau),
                 static_cast<const T*>(sig), static_cast<const T*>(k0),
                 static_cast<const T*>(x), static_cast<const T*>(z),
                 static_cast<const T*>(xa), static_cast<const T*>(za),
                 static_cast<const T*>(xs), static_cast<const T*>(zs),
                 static_cast<T*>(x_out), static_cast<T*>(z_out),
                 static_cast<T*>(xt_out), static_cast<T*>(zt_out),
                 static_cast<T*>(xs_out), static_cast<T*>(zs_out),
                 B, m, n, k};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1: return launch<T, HALPERN, LOW, 1>(a, st);
    case 2: return launch<T, HALPERN, LOW, 2>(a, st);
    case 4: return launch<T, HALPERN, LOW, 4>(a, st);
    case 8: return launch<T, HALPERN, LOW, 8>(a, st);
    case 16: return launch<T, HALPERN, LOW, 16>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// One plain C entry point per (type, algorithm, tier); lanes per block is
// an argument (1, 2, 4, 8 or 16).  Returns the cudaError_t of the launch.
#define PDHG_ENTRY(NAME, T, HALPERN, LOW)                                      \
  extern "C" int NAME(const void* Ah, const void* AhT, const void* lb,         \
                      const void* ub, const void* eq, const void* c,           \
                      const void* b, const void* tau, const void* sig,         \
                      const void* k0, const void* x, const void* z,            \
                      const void* xa, const void* za, const void* xs,          \
                      const void* zs, void* x_out, void* z_out, void* xt_out,  \
                      void* zt_out, void* xs_out, void* zs_out, int B, int m,  \
                      int n, int k, int lanes, void* stream) {                 \
    return dispatch<T, HALPERN, LOW>(Ah, AhT, lb, ub, eq, c, b, tau, sig, k0,  \
                                     x, z, xa, za, xs, zs, x_out, z_out,       \
                                     xt_out, zt_out, xs_out, zs_out, B, m, n,  \
                                     k, lanes, stream);                        \
  }

PDHG_ENTRY(pdhg_avg_f32_full, float, false, false)
PDHG_ENTRY(pdhg_avg_f32_bf16, float, false, true)
PDHG_ENTRY(pdhg_avg_f64_full, double, false, false)
PDHG_ENTRY(pdhg_avg_f64_bf16, double, false, true)
PDHG_ENTRY(pdhg_halpern_f32_full, float, true, false)
PDHG_ENTRY(pdhg_halpern_f32_bf16, float, true, true)
PDHG_ENTRY(pdhg_halpern_f64_full, double, true, false)
PDHG_ENTRY(pdhg_halpern_f64_bf16, double, true, true)
