// Fused multi-RHS Jacobi-preconditioned conjugate gradients on the
// mask-padded KKT operator, for NVIDIA Hopper (sm_90a).
//
// Replaces ssqp_tpu/ops/pallas_cg.py::_cg_kernel (semantics of
// ssqp_tpu/ops/kkt.py::_vp_cg_xla). Each row c of the flattened batch is one
// independent system  vp_c(x) = b_c  with
//
//     vp_c(x) = fm_c . (V_c (fm_c . x)) + (1 - fm_c) . x
//
// (fm the free mask, V_c the instance's covariance), solved by Jacobi-
// preconditioned CG from the warm start already stored in X. A row freezes on
// its own: alpha = 0 when rr <= tol2 or pAp <= 0, beta = 0 when rr <= tol2,
// with a 1e-30 floor under both divisions. The any-alive exit of a block is
// checked every 8 steps, with the chunk clamped to the remaining budget, so
// every row runs exactly min(iters, steps to converge) effective steps, as
// in the reference loop.
//
// Work split: one thread block owns a tile of TR rows and runs the WHOLE CG
// loop for them. p, fm.p, r and Ap (later z) for the tile live in dynamic
// shared memory; x is updated in place in device memory (each element is
// touched once per step). Thread j owns column j (and j + 256, ...) of every
// row of the tile, so all elementwise work is thread-private and the three
// per-row sums (pAp, r.z, r.r) are block reductions.
//
// What bounds it on this card: per step a tile costs N^2 * TR FMAs on the
// CUDA cores (fp32 or fp64 FFMA/DFMA only: no TF32, the reference runs at
// "highest" matmul precision) and reads N^2 words of V, which stays resident
// in L2 (256 KB at N=256 f32, 4 MB at N=1024) and is shared by all tiles.
// The TR-row tile reuses each V word TR times from registers; the tile's
// fm.p values are broadcast from shared memory with vector loads. Against
// this the plain PyTorch version pays a kernel launch per elementwise op and
// a host synchronisation per 8 steps. Faster forms (wgmma with 3xTF32
// splitting, TMA-fed V tiles) are later work.
//
// A per-instance V is handled by a per-row instance index and a V stride
// (stride 0 and no index for a shared V). The C entry points return
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;

// jnp.maximum semantics: a NaN first operand propagates.
template <typename T>
__device__ __forceinline__ T floor_max(T a, T b) {
  return (a != a) ? a : (a > b ? a : b);
}

template <typename T, int TR>
__host__ __device__ constexpr size_t smem_elems(int N) {
  // pm (N x TR) | p, r, ap (TR x N each) | reduction scratch | row scalars
  return (size_t)4 * TR * N + (size_t)kWarps * 2 * TR + 8 * TR;
}

// TR consecutive values from shared memory (vector loads where aligned: pm is
// placed first in shared memory and each k-slice is TR values wide).
template <typename T, int TR>
__device__ __forceinline__ void load_tile(const T* src, T (&dst)[TR]) {
  if constexpr (sizeof(T) == 4 && TR % 4 == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int i = 0; i < TR / 4; ++i) {
      const float4 v = s4[i];
      dst[4 * i] = v.x; dst[4 * i + 1] = v.y;
      dst[4 * i + 2] = v.z; dst[4 * i + 3] = v.w;
    }
  } else if constexpr (sizeof(T) == 8 && TR % 2 == 0) {
    const double2* s2 = reinterpret_cast<const double2*>(src);
#pragma unroll
    for (int i = 0; i < TR / 2; ++i) {
      const double2 v = s2[i];
      dst[2 * i] = v.x; dst[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int t = 0; t < TR; ++t) dst[t] = src[t];
  }
}

// Sums NV per-thread values over the block; out[v] gets the total.
template <typename T, int NV>
__device__ __forceinline__ void block_reduce(T (&part)[NV], T* red, T* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    T s = part[v];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) red[warp * NV + v] = s;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    T s = T(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * NV + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// acc[t] = sum_k V_t[j, k] * pm[k, t]   (Vt is V transposed: Vt[k, j] = V[j, k])
template <typename T, int TR, bool SHARED>
__device__ __forceinline__ void matvec_col(const T* __restrict__ Vt,
                                           const long long (&voff)[TR],
                                           const T* pm, int N, int j,
                                           T (&acc)[TR]) {
#pragma unroll
  for (int t = 0; t < TR; ++t) acc[t] = T(0);
#pragma unroll 4
  for (int k = 0; k < N; ++k) {
    T pk[TR];
    load_tile<T, TR>(pm + (size_t)k * TR, pk);
    if constexpr (SHARED) {
      const T v = __ldg(Vt + (size_t)k * N + j);
#pragma unroll
      for (int t = 0; t < TR; ++t) acc[t] += pk[t] * v;
    } else {
#pragma unroll
      for (int t = 0; t < TR; ++t)
        acc[t] += pk[t] * __ldg(Vt + voff[t] + (size_t)k * N + j);
    }
  }
}

template <typename T, int TR, bool SHARED>
__global__ void __launch_bounds__(kThreads)
cg_rows_kernel(const T* __restrict__ Vt, long long vstride,
               const int* __restrict__ inst, const T* __restrict__ fm,
               const T* __restrict__ dinv, const T* __restrict__ Bm,
               const T* __restrict__ tol2, T* __restrict__ X,
               T* __restrict__ rr_out, int C, int N, int iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* pm_s = reinterpret_cast<T*>(smem_raw);   // [N][TR]  fm . p
  T* p_s = pm_s + (size_t)TR * N;              // [TR][N]
  T* r_s = p_s + (size_t)TR * N;               // [TR][N]
  T* ap_s = r_s + (size_t)TR * N;              // [TR][N]  Ap, then z
  T* red_s = ap_s + (size_t)TR * N;            // reduction scratch
  T* rz_s = red_s + kWarps * 2 * TR;           // [TR] r.z
  T* rr_s = rz_s + TR;                         // [TR] r.r
  T* tol_s = rr_s + TR;                        // [TR] tol2
  T* alpha_s = tol_s + TR;                     // [TR]
  T* beta_s = alpha_s + TR;                    // [TR]
  T* pap_s = beta_s + TR;                      // [TR] pAp
  T* new_s = pap_s + TR;                       // [2 TR] new r.z, r.r
  __shared__ int go_s;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TR;
  const int nrows = min(TR, C - row0);
  long long voff[TR];
#pragma unroll
  for (int t = 0; t < TR; ++t)
    voff[t] = (!SHARED && t < nrows) ? (long long)inst[row0 + t] * vstride : 0;

  auto gidx = [&](int t, int j) { return (size_t)(row0 + t) * N + j; };

  // ---- initial residual: r = b - vp(x0); z = r . dinv; p = z -------------
  for (int j = tid; j < N; j += kThreads) {
#pragma unroll
    for (int t = 0; t < TR; ++t) {
      T xv = T(0), f = T(0);
      if (t < nrows) { xv = X[gidx(t, j)]; f = fm[gidx(t, j)]; }
      p_s[t * N + j] = xv;
      pm_s[(size_t)j * TR + t] = f * xv;
    }
  }
  if (tid < TR) tol_s[tid] = (tid < nrows) ? tol2[row0 + tid] : T(0);
  __syncthreads();
  {
    T part[2 * TR];
#pragma unroll
    for (int v = 0; v < 2 * TR; ++v) part[v] = T(0);
    for (int j = tid; j < N; j += kThreads) {
      T acc[TR];
      matvec_col<T, TR, SHARED>(Vt, voff, pm_s, N, j, acc);
#pragma unroll
      for (int t = 0; t < TR; ++t) {
        if (t < nrows) {
          const T f = fm[gidx(t, j)];
          const T ap = f * acc[t] + (T(1) - f) * p_s[t * N + j];
          const T r = Bm[gidx(t, j)] - ap;
          const T z = r * dinv[gidx(t, j)];
          r_s[t * N + j] = r;
          ap_s[t * N + j] = z;
          part[t] += r * z;
          part[TR + t] += r * r;
        } else {
          r_s[t * N + j] = T(0);
          ap_s[t * N + j] = T(0);
        }
      }
    }
    __syncthreads();  // every column's matvec has read pm_s
    for (int j = tid; j < N; j += kThreads) {
#pragma unroll
      for (int t = 0; t < TR; ++t) {
        const T z = ap_s[t * N + j];
        const T f = (t < nrows) ? fm[gidx(t, j)] : T(0);
        p_s[t * N + j] = z;
        pm_s[(size_t)j * TR + t] = f * z;
      }
    }
    block_reduce<T, 2 * TR>(part, red_s, new_s);
    if (tid < TR) { rz_s[tid] = new_s[tid]; rr_s[tid] = new_s[TR + tid]; }
    __syncthreads();
  }

  auto any_alive = [&]() {
    if (tid == 0) {
      int go = 0;
      for (int t = 0; t < nrows; ++t) go |= (rr_s[t] > tol_s[t]);
      go_s = go;
    }
    __syncthreads();
    const int go = go_s;
    __syncthreads();
    return go != 0;
  };

  int i = 0;
  bool go = any_alive();
  while (i < iters && go) {
    const int n = min(kChunk, iters - i);
    for (int s = 0; s < n; ++s) {
      // ---- Ap = vp(p), pAp -------------------------------------------------
      T part[TR];
#pragma unroll
      for (int t = 0; t < TR; ++t) part[t] = T(0);
      for (int j = tid; j < N; j += kThreads) {
        T acc[TR];
        matvec_col<T, TR, SHARED>(Vt, voff, pm_s, N, j, acc);
#pragma unroll
        for (int t = 0; t < TR; ++t) {
          const T f = (t < nrows) ? fm[gidx(t, j)] : T(0);
          const T pv = p_s[t * N + j];
          const T ap = f * acc[t] + (T(1) - f) * pv;
          ap_s[t * N + j] = ap;
          part[t] += pv * ap;
        }
      }
      block_reduce<T, TR>(part, red_s, pap_s);
      if (tid < TR) {
        const bool alive = rr_s[tid] > tol_s[tid];
        const T pap = pap_s[tid];
        alpha_s[tid] = (alive && pap > T(0))
                           ? rz_s[tid] / floor_max(pap, T(1e-30)) : T(0);
      }
      __syncthreads();
      // ---- x += alpha p; r -= alpha Ap; z = r . dinv; r.z, r.r --------------
      T part2[2 * TR];
#pragma unroll
      for (int v = 0; v < 2 * TR; ++v) part2[v] = T(0);
      for (int j = tid; j < N; j += kThreads) {
#pragma unroll
        for (int t = 0; t < TR; ++t) {
          const T a = alpha_s[t];
          const T pv = p_s[t * N + j];
          const T r = r_s[t * N + j] - a * ap_s[t * N + j];
          T z = T(0);
          if (t < nrows) {
            X[gidx(t, j)] = X[gidx(t, j)] + a * pv;
            z = r * dinv[gidx(t, j)];
          }
          r_s[t * N + j] = r;
          ap_s[t * N + j] = z;
          part2[t] += r * z;
          part2[TR + t] += r * r;
        }
      }
      block_reduce<T, 2 * TR>(part2, red_s, new_s);
      if (tid < TR) {
        const bool alive = rr_s[tid] > tol_s[tid];
        beta_s[tid] = alive ? new_s[tid] / floor_max(rz_s[tid], T(1e-30)) : T(0);
        rz_s[tid] = new_s[tid];
        rr_s[tid] = new_s[TR + tid];
      }
      __syncthreads();
      // ---- p = z + beta p ------------------------------------------------------
      for (int j = tid; j < N; j += kThreads) {
#pragma unroll
        for (int t = 0; t < TR; ++t) {
          const T pn = ap_s[t * N + j] + beta_s[t] * p_s[t * N + j];
          const T f = (t < nrows) ? fm[gidx(t, j)] : T(0);
          p_s[t * N + j] = pn;
          pm_s[(size_t)j * TR + t] = f * pn;
        }
      }
      __syncthreads();
    }
    i += kChunk;
    go = any_alive();
  }
  if (tid < nrows) rr_out[row0 + tid] = rr_s[tid];
}

template <typename T, int TR, bool SHARED>
cudaError_t launch_tile(const T* Vt, long long vstride, const int* inst,
                        const T* fm, const T* dinv, const T* B, const T* tol2,
                        T* X, T* rr, int C, int N, int iters,
                        cudaStream_t stream) {
  const size_t smem = smem_elems<T, TR>(N) * sizeof(T);
  auto kern = cg_rows_kernel<T, TR, SHARED>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int grid = (C + TR - 1) / TR;
  kern<<<grid, kThreads, smem, stream>>>(Vt, vstride, inst, fm, dinv, B, tol2,
                                         X, rr, C, N, iters);
  return cudaGetLastError();
}

template <typename T, int TR>
cudaError_t launch_shared_or_not(const T* Vt, long long vstride,
                                 const int* inst, const T* fm, const T* dinv,
                                 const T* B, const T* tol2, T* X, T* rr, int C,
                                 int N, int iters, cudaStream_t stream) {
  if (inst == nullptr)
    return launch_tile<T, TR, true>(Vt, 0, nullptr, fm, dinv, B, tol2, X, rr,
                                    C, N, iters, stream);
  return launch_tile<T, TR, false>(Vt, vstride, inst, fm, dinv, B, tol2, X,
                                   rr, C, N, iters, stream);
}

template <typename T>
int run_cg(const T* Vt, long long vstride, const int* inst, const T* fm,
           const T* dinv, const T* B, const T* tol2, T* X, T* rr, int C, int N,
           int iters, void* stream_ptr) {
  if (C <= 0) return 0;
  if (N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  // Largest row tile whose state fits the block's shared memory.
  const size_t lim = (size_t)optin;
#define SSQP_TRY_TILE(TRV)                                                   \
  if (smem_elems<T, TRV>(N) * sizeof(T) <= lim)                              \
    return (int)launch_shared_or_not<T, TRV>(Vt, vstride, inst, fm, dinv, B, \
                                             tol2, X, rr, C, N, iters, stream);
  SSQP_TRY_TILE(16)
  SSQP_TRY_TILE(8)
  SSQP_TRY_TILE(4)
  SSQP_TRY_TILE(2)
  SSQP_TRY_TILE(1)
#undef SSQP_TRY_TILE
  return (int)cudaErrorInvalidConfiguration;  // N too large for one row tile
}

}  // namespace

extern "C" {

int ssqp_cg_rows_f32(const float* Vt, long long vstride, const int* inst,
                     const float* fm, const float* dinv, const float* B,
                     const float* tol2, float* X, float* rr, int C, int N,
                     int iters, void* stream) {
  return run_cg<float>(Vt, vstride, inst, fm, dinv, B, tol2, X, rr, C, N,
                       iters, stream);
}

int ssqp_cg_rows_f64(const double* Vt, long long vstride, const int* inst,
                     const double* fm, const double* dinv, const double* B,
                     const double* tol2, double* X, double* rr, int C, int N,
                     int iters, void* stream) {
  return run_cg<double>(Vt, vstride, inst, fm, dinv, B, tol2, X, rr, C, N,
                        iters, stream);
}

}  // extern "C"
