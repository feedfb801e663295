// Batched Cholesky factor-and-solve of SPD systems A X = RHS, for NVIDIA
// Hopper (sm_90a).
//
// Replaces ssqp_tpu/ops/pallas_chol.py::_chol_solve_kernel (reached through
// ssqp_tpu/ops/kkt.py::spd_solve for float32 batches with n >= 16). What it
// computes, per instance, with no pivoting:
//
//   factor    right-looking: for j = 0..n-1, with the trailing block kept in
//             place, inv = rsqrt(max(a_jj, 1e-30)), row j of U = L^T is
//             a_j,k * inv for k >= j, and every a_i,k with k >= i > j loses
//             U_j,i * U_j,k. Only the upper triangle is read: row j of it is
//             what the reference reads as "column j by symmetry", so a not
//             exactly symmetric input gives the same factor as the
//             reference's;
//   forward   L y = rhs in elimination form: y_j = r_j / L_jj, then
//             r_i -= L_ij y_j for i > j;
//   backward  L^T x = y, x_j = (y_j - sum_{k>j} U_jk x_k) / U_jj.
//
// Singular or non-PD input does not fault and stays inside its instance: the
// floored pivot gives large, inf or NaN values, and the callers' finite and
// residual gates reject them.
//
// What bounds it on this card. At the solver's shapes (n = R = 110; K = 1
// for the Schur solves and dual recovery, K = 100 and 110 for the dropped-row
// multipliers and the QR purge's reconstruction; B = 256, or 64 in a tail
// pass) one instance is n^3/3 = 0.44 MFLOP of factor and 2 n^2 K of solves
// on n (n + 1) / 2 + 2 n K words (the upper triangle of A, RHS and X): 1.9 us
// of device-memory time for the batch at K = 1 (1.8 us of float32 FFMA time)
// and 11.9 us of FFMA time at K = 110. Neither is what a simple body
// meets: the factor and the substitutions are chains of n dependent steps,
// and one block per instance with a block barrier after each step (the
// rank-1 body below: 6 n barriers, a handful of FMAs per thread between two)
// is bound by the latency of those steps.
//
// The blocked body (float32, everything in shared memory) takes the steps in
// panels of 16 rows, with n padded to a multiple of 16 by an identity block:
//
//  * Load: the upper triangle of A and the right-hand sides, a warp taking
//    4 rows x 128 columns at a time with its 16 loads in flight together.
//  * Factor, per panel: one warp factors the 16 x 16 diagonal block in
//    registers (lane k holds column k, the pivot is broadcast with a
//    shuffle, no block barrier inside the panel); one thread per column
//    forms the panel's block row U_P,rest = U_PP^-T A_P,rest by a 16-step
//    substitution in registers; 4 x 4 register tiles apply the rank-16
//    trailing update to the upper triangle, each entry subtracting the
//    panel's 16 products in row order as the reference does. The warp
//    factors the next panel's diagonal block (applying this panel's update
//    to it first, in two half sums) while the other warps do the rest of
//    the trailing update.
//  * Substitutions, per panel: one thread per right-hand side solves the
//    16-row diagonal block in registers; the block then updates the rows
//    below (forward) or above (backward) with the panel, in register tiles
//    of 1 x 4 (K <= 4) or 4 x 4 (K > 4) entries. The diagonal's reciprocals
//    are formed once in the factor (one IEEE division each), so the
//    substitutions multiply. At K = 1 too: a warp-wide substitution without
//    block barriers was not tried.
//  * Two block barriers per panel and phase: 40 at n = 110 against the
//    rank-1 body's 660. Row strides of the padded size + 4 floats keep the
//    16-byte loads of the tiles aligned and the column walks free of bank
//    conflicts. ptxas (sm_90a, CUDA 12.8): 128 registers at both tile
//    widths (the launch bound of two 256-thread blocks per SM), no spills;
//    B = 256 instances run in one wave on 132 SMs.
//
// What still holds it back (PERF.md): the sum of many short latencies, the
// launch, the load and each phase's chain of panels; no single phase of the
// factor (diagonal chain, block row, trailing update) dominates it.
//
// Float64, and float32 shapes whose padded matrix and right-hand sides do not
// fit a block's shared memory, keep the rank-1 body: in shared memory when
// the unpadded n^2 + n K fit, else in place on a per-instance copy in device
// memory (the N x N direct solves, n = 512). chol_body() is the rule.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNb = 16;  // panel width of the blocked body

enum Body { kRank1Device = 0, kRank1Shared = 1, kBlocked = 2 };

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

// ---- the rank-1 body ---------------------------------------------------------
//
// One step per row and three barriers per factor step. A warp takes a row of
// the trailing update and its lanes the row's columns; the substitutions
// spread the (row, column) pairs of one step over the block, and the
// backward step gives each column to a warp, which reduces its dot product
// with shuffles. a: n x n working matrix (row-major, upper triangle used),
// x: n x K right-hand sides, solved in place, in shared or device memory.
template <typename T>
__device__ void factor_and_solve(T* a, T* x, int n, int K) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

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
  for (int j = 0; j < n; ++j) {  // L y = r, elimination form (L_ij = U_ji)
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

  for (int j = n - 1; j >= 0; --j) {  // U x = y, row-dot recurrence
    const T* lt = a + (size_t)j * n;
    for (int c = warp; c < K; c += kWarps) {
      T s = T(0);
      for (int k = j + 1 + lane; k < n; k += 32) s += lt[k] * x[(size_t)k * K + c];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(kFull, s, o);
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

// ---- the blocked body (float32, shared memory) -------------------------------

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Shared-memory layout, in floats: a (np x lda, upper triangle), x (np x kp),
// pinv (np: the factor's rsqrt of the floored pivots), rdiag (np: 1 / U_jj).
struct Blocked {
  int np, lda, kp;
  __host__ __device__ Blocked(int n, int K)
      : np(round_up(n, kNb)), lda(round_up(n, kNb) + 4), kp(round_up(K, 4)) {}
  __host__ __device__ int floats() const { return np * lda + np * kp + 2 * np; }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 16 consecutive floats of shared memory, 16-byte aligned, in 4 loads.
__device__ __forceinline__ void ld16(const float* p, float (&r)[kNb]) {
#pragma unroll
  for (int q = 0; q < kNb; q += 4) {
    const float4 v = ld4(p + q);
    r[q] = v.x; r[q + 1] = v.y; r[q + 2] = v.z; r[q + 3] = v.w;
  }
}

// Rows [0, rows) x columns [0, cols) of dst (row stride ldd) from src (row
// stride lds; rows_in x cols_in real entries, the rest pad: 1 on the
// diagonal when diag_pad, else 0). upper: only columns >= the row. A warp
// takes 4 rows x 128 columns at a time, its 16 loads in flight together, so
// the load costs a few device-memory latencies, not one per row.
__device__ void load_rows(float* dst, int ldd, const float* __restrict__ src,
                          int lds, int rows_in, int cols_in, int rows,
                          int cols, bool upper, bool diag_pad, int warp,
                          int lane) {
  for (int i0 = 4 * warp; i0 < rows; i0 += 4 * kWarps)
    for (int k0 = 0; k0 < cols; k0 += 128) {
      float v[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + r, k = k0 + 32 * q + lane;
          v[r][q] = (diag_pad && i == k) ? 1.f : 0.f;
          if (i < rows_in && k < cols_in && (!upper || k >= i))
            v[r][q] = src[(size_t)i * lds + k];
        }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + r, k = k0 + 32 * q + lane;
          if (i < rows && k < cols && (!upper || k >= i))
            dst[i * ldd + k] = v[r][q];
        }
    }
}

// One warp factors the diagonal block [q0, q0 + 16)^2. Lane k (and lane
// k + 16, which mirrors it) holds column k, and its diagonal entry again in
// d: lane j's d is step j's pivot, updated without a shuffle, so a step's
// chain is one shuffle, the rsqrt and two FMAs. With p0 >= 0 the block
// first takes the update of panel p0, whose block row is already in place:
// lanes 0-15 sum the products of the panel's rows 0-7, lanes 16-31 those of
// rows 8-15, and one shuffle adds the halves.
__device__ void factor_diag(float* a, int lda, float* pinv, float* rdiag,
                            int q0, int p0, int lane) {
  const int k = lane & (kNb - 1);
  float c[kNb];
#pragma unroll
  for (int i = 0; i < kNb; ++i) c[i] = a[(q0 + i) * lda + q0 + k];
  float d = a[(q0 + k) * lda + q0 + k];
  if (p0 >= 0) {
    float s[kNb], sd = 0.f;
#pragma unroll
    for (int i = 0; i < kNb; ++i) s[i] = 0.f;
    const int jh = (lane >> 4) * (kNb / 2);
#pragma unroll
    for (int j = 0; j < kNb / 2; ++j) {
      const float* u = a + (p0 + jh + j) * lda + q0;
      float ui[kNb];
      ld16(u, ui);
      const float ujk = u[k];
#pragma unroll
      for (int i = 0; i < kNb; ++i) s[i] += ui[i] * ujk;
      sd += ujk * ujk;  // the same products as s[k], in the same order
    }
#pragma unroll
    for (int i = 0; i < kNb; ++i)
      c[i] -= s[i] + __shfl_xor_sync(kFull, s[i], kNb);
    d -= sd + __shfl_xor_sync(kFull, sd, kNb);
  }
  // Entries with i > k are below the diagonal: computed, never used; d is
  // used up to lane k's own step.
  float myinv = 0.f, mydiag = 0.f;
#pragma unroll
  for (int j = 0; j < kNb; ++j) {
    const float piv = __shfl_sync(kFull, d, j);
    const float inv = rsqrtf(floor_max(piv, 1e-30f));
    c[j] *= inv;  // lane k >= j: U_jk
    d -= c[j] * c[j];
    if (lane == j) { myinv = inv; mydiag = piv * inv; }
#pragma unroll
    for (int i = j + 1; i < kNb; ++i) c[i] -= __shfl_sync(kFull, c[j], i) * c[j];
  }
  if (lane < kNb) {
#pragma unroll
    for (int i = 0; i < kNb; ++i) a[(q0 + i) * lda + q0 + k] = c[i];
    pinv[q0 + lane] = myinv;
    rdiag[q0 + lane] = 1.0f / mydiag;
  }
}

// The rank-16 update of panel p0 on the upper triangle of [r0, np)^2 minus
// the diagonal block [r0, r0 + 16)^2 (factor_diag's), in 4 x 4 tiles listed
// column by column; threads t0, t0 + nt, ... take them.
__device__ void trailing_update(float* a, int lda, int p0, int r0, int np,
                                int t0, int nt) {
  const int T = (np - r0) / 4;
  // the first tiles listed are the diagonal block's (factor_diag's)
  constexpr int skip = (kNb / 4) * (kNb / 4 + 1) / 2;
  const int count = T * (T + 1) / 2 - skip;
  for (int t = t0; t < count; t += nt) {
    const int u = t + skip;
    int tk = (int)((sqrtf(8.f * u + 1.f) - 1.f) * 0.5f);
    while (tk * (tk + 1) / 2 > u) --tk;
    while ((tk + 1) * (tk + 2) / 2 <= u) ++tk;
    const int ti = u - tk * (tk + 1) / 2;
    const int i0 = r0 + 4 * ti, k0 = r0 + 4 * tk;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 v = ld4(a + (i0 + r) * lda + k0);
      acc[r][0] = v.x; acc[r][1] = v.y; acc[r][2] = v.z; acc[r][3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < kNb; ++j) {
      const float* u_row = a + (p0 + j) * lda;
      const float4 ui = ld4(u_row + i0), uk = ld4(u_row + k0);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] -= at(ui, r) * at(uk, q);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      st4(a + (i0 + r) * lda + k0,
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
  }
}

// Rows [i_lo, i_hi) of x, in tiles of RT rows x 4 columns, lose the
// panel [p0, p0 + 16)'s contribution: below the panel (forward)
// x_ic -= sum_j U_j,i x_jc, above it (backward) x_ic -= sum_j U_i,j x_jc,
// j = p0 .. p0 + 15 in order.
template <int RT, bool BELOW>
__device__ void update_rows(const float* a, int lda, float* x, int kp, int p0,
                            int i_lo, int i_hi, int tid) {
  const int cgroups = kp / 4;
  const int count = (i_hi - i_lo) / RT * cgroups;
  for (int t = tid; t < count; t += kThreads) {
    const int g = t / cgroups;
    const int i0 = i_lo + g * RT, c0 = 4 * (t - g * cgroups);
    float acc[RT][4];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float4 v = ld4(x + (i0 + r) * kp + c0);
      acc[r][0] = v.x; acc[r][1] = v.y; acc[r][2] = v.z; acc[r][3] = v.w;
    }
#pragma unroll
    for (int j4 = 0; j4 < kNb; j4 += 4) {
      float u[RT][4];  // u[r][jj]: the coefficient of row i0 + r on p0 + j4 + jj
      if constexpr (BELOW && RT == 4) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 v = ld4(a + (p0 + j4 + jj) * lda + i0);
          u[0][jj] = v.x; u[1][jj] = v.y; u[2][jj] = v.z; u[3][jj] = v.w;
        }
      } else {
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if constexpr (BELOW) {
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              u[r][jj] = a[(p0 + j4 + jj) * lda + i0 + r];
          } else {
            const float4 v = ld4(a + (i0 + r) * lda + p0 + j4);
            u[r][0] = v.x; u[r][1] = v.y; u[r][2] = v.z; u[r][3] = v.w;
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 xj = ld4(x + (p0 + j4 + jj) * kp + c0);
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] -= u[r][jj] * at(xj, q);
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r)
      st4(x + (i0 + r) * kp + c0,
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
  }
}

// RT: rows per tile of the substitutions' updates (1 for K <= 4, else 4).
template <int RT>
__global__ void __launch_bounds__(kThreads, 2)
chol_solve_blocked_kernel(const float* __restrict__ A,
                          const float* __restrict__ RHS,
                          float* __restrict__ X, int n, int K) {
  extern __shared__ __align__(16) float sm[];
  const Blocked L(n, K);
  const int np = L.np, lda = L.lda, kp = L.kp;
  float* a = sm;
  float* x = a + np * lda;
  float* pinv = x + np * kp;
  float* rdiag = pinv + np;
  const size_t b = blockIdx.x;
  const float* ag = A + b * (size_t)n * n;
  const float* rg = RHS + b * (size_t)n * K;
  float* xg = X + b * (size_t)n * K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // The upper triangle of A and the right-hand sides; the padding is an
  // identity block with zero right-hand sides, so it adds exact zeros to
  // every real entry.
  load_rows(a, lda, ag, n, n, n, np, np, true, true, warp, lane);
  load_rows(x, kp, rg, K, n, K, np, kp, false, false, warp, lane);
  __syncthreads();

  // ---- factor ----
  const int npan = np / kNb;
  if (warp == 0) factor_diag(a, lda, pinv, rdiag, 0, -1, lane);
  __syncthreads();
  for (int p = 0; p + 1 < npan; ++p) {
    const int p0 = p * kNb, r0 = p0 + kNb;
    // block row: column k of U_P,rest by substitution through U_PP
    for (int k = r0 + tid; k < np; k += kThreads) {
      float v[kNb];
#pragma unroll
      for (int i = 0; i < kNb; ++i) v[i] = a[(p0 + i) * lda + k];
      float pv[kNb];
      ld16(pinv + p0, pv);
#pragma unroll
      for (int j = 0; j < kNb; ++j) {
        v[j] *= pv[j];
        float u[kNb];
        ld16(a + (p0 + j) * lda + p0, u);
#pragma unroll
        for (int i = j + 1; i < kNb; ++i) v[i] -= u[i] * v[j];
      }
#pragma unroll
      for (int i = 0; i < kNb; ++i) a[(p0 + i) * lda + k] = v[i];
    }
    __syncthreads();
    if (warp == 0)
      factor_diag(a, lda, pinv, rdiag, r0, p0, lane);
    else
      trailing_update(a, lda, p0, r0, np, tid - 32, kThreads - 32);
    __syncthreads();
  }

  // ---- forward: L y = r ----
  for (int p = 0; p < npan; ++p) {
    const int p0 = p * kNb;
    for (int c = tid; c < K; c += kThreads) {
      float v[kNb];
#pragma unroll
      for (int i = 0; i < kNb; ++i) v[i] = x[(p0 + i) * kp + c];
      float rd[kNb];
      ld16(rdiag + p0, rd);
#pragma unroll
      for (int j = 0; j < kNb; ++j) {
        v[j] *= rd[j];
        float u[kNb];
        ld16(a + (p0 + j) * lda + p0, u);
#pragma unroll
        for (int i = j + 1; i < kNb; ++i) v[i] -= u[i] * v[j];
      }
#pragma unroll
      for (int i = 0; i < kNb; ++i) x[(p0 + i) * kp + c] = v[i];
    }
    __syncthreads();
    if (p0 + kNb < np) {
      update_rows<RT, true>(a, lda, x, kp, p0, p0 + kNb, np, tid);
      __syncthreads();
    }
  }

  // ---- backward: U x = y ----
  for (int p = npan - 1; p >= 0; --p) {
    const int p0 = p * kNb;
    for (int c = tid; c < K; c += kThreads) {
      float v[kNb];
#pragma unroll
      for (int i = 0; i < kNb; ++i) v[i] = x[(p0 + i) * kp + c];
      float rd[kNb];
      ld16(rdiag + p0, rd);
#pragma unroll
      for (int j = kNb - 1; j >= 0; --j) {
        float u[kNb];
        ld16(a + (p0 + j) * lda + p0, u);
#pragma unroll
        for (int i = j + 1; i < kNb; ++i) v[j] -= u[i] * v[i];
        v[j] *= rd[j];
      }
#pragma unroll
      for (int i = 0; i < kNb; ++i) x[(p0 + i) * kp + c] = v[i];
    }
    __syncthreads();
    if (p0 > 0) {
      update_rows<RT, false>(a, lda, x, kp, p0, 0, p0, tid);
      __syncthreads();
    }
  }

  for (int i = warp; i < n; i += kWarps) {
    const float* xi = x + i * kp;
    float* gx = xg + (size_t)i * K;
    for (int c = lane; c < K; c += 32) gx[c] = xi[c];
  }
}

// ---- host side ---------------------------------------------------------------

cudaError_t optin_smem(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev);
}

template <typename T>
size_t rank1_smem_bytes(int n, int K) {
  return ((size_t)n * n + (size_t)n * K) * sizeof(T);
}

size_t blocked_smem_bytes(int n, int K) {
  return (size_t)Blocked(n, K).floats() * sizeof(float);
}

// The rule, on the current device: float32 whose padded matrix and
// right-hand sides fit a block's shared memory -> the blocked body; otherwise
// the rank-1 body, in shared memory when n^2 + n K fit, else in device memory.
template <typename T>
cudaError_t chol_body(int n, int K, Body* body) {
  int optin = 0;
  cudaError_t e = optin_smem(&optin);
  if (e != cudaSuccess) return e;
  if (sizeof(T) == sizeof(float) && blocked_smem_bytes(n, K) <= (size_t)optin)
    *body = kBlocked;
  else
    *body = rank1_smem_bytes<T>(n, K) <= (size_t)optin ? kRank1Shared
                                                       : kRank1Device;
  return cudaSuccess;
}

template <typename T>
const char* chol_body_name(int n, int K) {
  Body body;
  if (chol_body<T>(n, K, &body) != cudaSuccess) return nullptr;
  return body == kBlocked       ? "blocked"
         : body == kRank1Shared ? "rank1-shared"
                                : "rank1-device";
}

// Lets the kernel take `bytes` of dynamic shared memory, and asks for the
// largest shared-memory carveout so that several blocks fit an SM.
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T>
int run_chol(T* A, const T* RHS, T* X, int B, int n, int K,
             void* stream_ptr) {
  if (B <= 0 || n <= 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Body body;
  cudaError_t e = chol_body<T>(n, K, &body);
  if (e != cudaSuccess) return (int)e;
  if (body == kBlocked) {
    if constexpr (sizeof(T) != sizeof(float)) {
      return (int)cudaErrorInvalidValue;  // float32 only
    } else {
      const size_t bytes = blocked_smem_bytes(n, K);
      auto kern = K > 4 ? chol_solve_blocked_kernel<4>
                        : chol_solve_blocked_kernel<1>;
      if ((e = allow_smem(kern, bytes)) != cudaSuccess) return (int)e;
      kern<<<B, kThreads, bytes, stream>>>(A, RHS, X, n, K);
      return (int)cudaGetLastError();
    }
  }
  // the rank-1 body solves in place
  if (RHS != X &&
      (e = cudaMemcpyAsync(X, RHS, sizeof(T) * (size_t)B * n * K,
                           cudaMemcpyDeviceToDevice, stream)) != cudaSuccess)
    return (int)e;
  if (body == kRank1Shared) {
    const size_t bytes = rank1_smem_bytes<T>(n, K);
    auto kern = chol_solve_kernel<T, true>;
    if ((e = allow_smem(kern, bytes)) != cudaSuccess) return (int)e;
    kern<<<B, kThreads, bytes, stream>>>(A, X, n, K);
  } else {
    chol_solve_kernel<T, false><<<B, kThreads, 0, stream>>>(A, X, n, K);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The body chol_body() picks for one instance's n and K on the current
// device: "blocked" or "rank1-shared" (A only read), or "rank1-device" (A
// factored in place, so the caller passes a scratch copy); NULL on error.
const char* ssqp_chol_body_f32(int n, int K) {
  return chol_body_name<float>(n, K);
}
const char* ssqp_chol_body_f64(int n, int K) {
  return chol_body_name<double>(n, K);
}

// A (B, n, n), RHS and X (B, n, K), contiguous; X receives the solution
// (X may be RHS). The body is chol_body()'s; the rank-1 body in device
// memory factors A in place. Returns the first CUDA error of the launch,
// else cudaGetLastError() after it.
int ssqp_chol_solve_f32(float* A, const float* RHS, float* X, int B, int n,
                        int K, void* stream) {
  return run_chol<float>(A, RHS, X, B, n, K, stream);
}

int ssqp_chol_solve_f64(double* A, const double* RHS, double* X, int B, int n,
                        int K, void* stream) {
  return run_chol<double>(A, RHS, X, B, n, K, stream);
}

}  // extern "C"
