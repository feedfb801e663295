// Batched Cholesky factor-and-solve of SPD systems A X = RHS, for NVIDIA
// Hopper (sm_90a).
//
// Replaces ssqp_tpu/ops/pallas_chol.py::_chol_solve_kernel (reached through
// ssqp_tpu/ops/kkt.py::spd_solve for float32 batches with n >= 16). What it
// computes, per instance, with no pivoting:
//
//   factor    right-looking: for j = 0..n-1, with the trailing block kept in
//             place, inv = rsqrt(max(a_jj, 1e-30)), row j of L^T is
//             a_j,k * inv for k >= j, and every a_i,k with k >= i > j loses
//             L^T_j,i * L^T_j,k. Only the upper triangle is read or written:
//             row j of it is what the reference reads as "column j by
//             symmetry", so a not exactly symmetric input gives the same
//             factor as the reference's;
//   forward   L y = rhs in elimination form: y_j = r_j / L_jj, then
//             r_i -= L_ij y_j for i > j;
//   backward  L^T x = y as a row-dot recurrence:
//             x_j = (y_j - sum_{k>j} L^T_jk x_k) / L_jj.
//
// Singular or non-PD input does not fault: the floored pivot gives large,
// inf or NaN values, and the callers' finite and residual gates reject them.
//
// Work split: one thread block per instance. The n x n working matrix and
// the n x K right-hand sides live in dynamic shared memory when both fit the
// block's opt-in limit (n = 110, K = 110 in float32 is 97 KB); otherwise the
// kernel works in place on a per-instance copy in device memory (the N x N
// direct solves, n = 512). A warp takes a row of the trailing update and its
// lanes the row's columns; the substitutions spread the (row, column) pairs
// of one step over the block, and the backward step gives each column to a
// warp, which reduces its dot product with shuffles.
//
// What bounds it on this card: n^3/3 FLOPs of float32 FFMA for the factor
// and 2 n^2 K for the solves, against n^2 + 2 n K words moved. At the
// solver's shapes (n = 110) one instance is a few hundred thousand FMAs, so
// the arithmetic and the bytes are both far below what the card can do; the
// time goes to the 3n sequential steps, each ending in a block barrier.
// Many instances per launch (one block each, several blocks per SM) are what
// fill the card. Blocked factorizations, several instances per block,
// wgmma and TMA are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ T rsqrt_t(T v);
template <>
__device__ __forceinline__ float rsqrt_t<float>(float v) { return rsqrtf(v); }
template <>
__device__ __forceinline__ double rsqrt_t<double>(double v) { return rsqrt(v); }

// jnp.maximum semantics: a NaN first operand propagates.
template <typename T>
__device__ __forceinline__ T floor_max(T a, T b) {
  return (a != a) ? a : (a > b ? a : b);
}

// a: n x n working matrix (row-major, upper triangle used), x: n x K
// right-hand sides, solved in place. Both point to shared memory or to this
// instance's slice of device memory.
template <typename T>
__device__ void factor_and_solve(T* a, T* x, int n, int K) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // ---- factor: row j of the upper triangle becomes row j of L^T -----------
  for (int j = 0; j < n; ++j) {
    const T inv = rsqrt_t<T>(floor_max(a[(size_t)j * n + j], T(1e-30)));
    __syncthreads();  // every thread has read a_jj before it is overwritten
    for (int k = j + tid; k < n; k += kThreads) a[(size_t)j * n + k] *= inv;
    __syncthreads();
    const T* lt = a + (size_t)j * n;
    for (int i = j + 1 + warp; i < n; i += kWarps) {
      const T ci = lt[i];
      T* ai = a + (size_t)i * n;
      for (int k = i + lane; k < n; k += 32) ai[k] -= ci * lt[k];
    }
    __syncthreads();
  }

  if (K == 0) return;
  // ---- forward: L y = r, elimination form (L_ij = L^T_ji) -----------------
  for (int j = 0; j < n; ++j) {
    const T* lt = a + (size_t)j * n;
    const T djj = lt[j];
    T* xj = x + (size_t)j * K;
    for (int c = tid; c < K; c += kThreads) xj[c] = xj[c] / djj;
    __syncthreads();
    const int cnt = (n - j - 1) * K;
    for (int e = tid; e < cnt; e += kThreads) {
      const int i = j + 1 + e / K, c = e % K;
      x[(size_t)i * K + c] -= lt[i] * xj[c];
    }
    __syncthreads();
  }

  // ---- backward: L^T x = y, row-dot recurrence -----------------------------
  for (int j = n - 1; j >= 0; --j) {
    const T* lt = a + (size_t)j * n;
    for (int c = warp; c < K; c += kWarps) {
      T s = T(0);
      for (int k = j + 1 + lane; k < n; k += 32) s += lt[k] * x[(size_t)k * K + c];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
      if (lane == 0) x[(size_t)j * K + c] = (x[(size_t)j * K + c] - s) / lt[j];
    }
    __syncthreads();
  }
}

// SMEM: copy A and RHS into shared memory, solve there, write X back.
// Otherwise A is a per-instance device-memory copy factored in place and X
// (holding RHS on entry) is solved in place.
template <typename T, bool SMEM>
__global__ void __launch_bounds__(kThreads)
chol_solve_kernel(T* __restrict__ A, T* __restrict__ X, int n, int K) {
  const size_t b = blockIdx.x;
  T* ag = A + b * (size_t)n * n;
  T* xg = X + b * (size_t)n * K;
  if constexpr (SMEM) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* a_s = reinterpret_cast<T*>(smem_raw);
    T* x_s = a_s + (size_t)n * n;
    for (size_t e = threadIdx.x; e < (size_t)n * n; e += kThreads) a_s[e] = ag[e];
    for (size_t e = threadIdx.x; e < (size_t)n * K; e += kThreads) x_s[e] = xg[e];
    __syncthreads();
    factor_and_solve<T>(a_s, x_s, n, K);
    __syncthreads();
    for (size_t e = threadIdx.x; e < (size_t)n * K; e += kThreads) xg[e] = x_s[e];
  } else {
    factor_and_solve<T>(ag, xg, n, K);
  }
}

template <typename T>
size_t smem_bytes(int n, int K) {
  return ((size_t)n * n + (size_t)n * K) * sizeof(T);
}

template <typename T>
int fits_smem(int n, int K) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return smem_bytes<T>(n, K) <= (size_t)optin ? 1 : 0;
}

template <typename T>
int run_chol(T* A, T* X, int B, int n, int K, int smem, void* stream_ptr) {
  if (B <= 0 || n <= 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (smem) {
    const size_t bytes = smem_bytes<T>(n, K);
    auto kern = chol_solve_kernel<T, true>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    kern<<<B, kThreads, bytes, stream>>>(A, X, n, K);
  } else {
    chol_solve_kernel<T, false><<<B, kThreads, 0, stream>>>(A, X, n, K);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 when the n x n matrix and n x K right-hand sides of one instance fit a
// block's shared memory (then A is only read), 0 when the kernel works in
// place in device memory (then A must be a scratch copy), -1 on error.
int ssqp_chol_fits_smem_f32(int n, int K) { return fits_smem<float>(n, K); }
int ssqp_chol_fits_smem_f64(int n, int K) { return fits_smem<double>(n, K); }

// A (B, n, n) and X (B, n, K), contiguous; X holds RHS on entry and the
// solution on exit. Returns cudaGetLastError() after the launch.
int ssqp_chol_solve_f32(float* A, float* X, int B, int n, int K, int smem,
                        void* stream) {
  return run_chol<float>(A, X, B, n, K, smem, stream);
}

int ssqp_chol_solve_f64(double* A, double* X, int B, int n, int K, int smem,
                        void* stream) {
  return run_chol<double>(A, X, B, n, K, smem, stream);
}

}  // extern "C"
