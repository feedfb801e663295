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
// in the reference loop. A row's result depends on no other row of its tile;
// only the summation order of the product differs from the plain version.
//
// Three bodies, picked by a fixed rule in run_cg on the arguments alone:
//
//  * cg_rows_tc_kernel, tensor cores: float32 with one shared V and
//    N <= 1024, the case of both float32 main paths (the frontier at N=256
//    with C = 4,096 and 16,384 rows; the inequality path at N=512 with
//    C = 7,104 and 28,416 rows).
//  * cg_rows_dmma_kernel, float64 tensor cores (DMMA): float64 with one
//    shared V and N <= 512, config 4's float64 search (N=512, 111 rows an
//    instance: C = 28,416 for a batch of 256, 111 for one problem).
//  * cg_rows_kernel, the first port's body (FFMA/DFMA, a tile of at most 16
//    rows, V read from L2 by every tile and step): float64 with N > 512
//    (config 8's float64 audit at N=1024), a per-instance V (inst !=
//    nullptr, on no main path) and float32 with N > 1024.
//
// The DMMA body measured faster than the first body at every C from 3 to
// 28,416 rows and N from 14 to 512 (1.5-3.6x), so the rule reads N only.
//
// What bounds the float32 shared-V case on this card: per row and step the
// matvec costs 2 N^2 FLOPs against ~14 N of vector work, 34.4 GFLOP per 64
// steps at (C=4096, N=256) and 1.43 TFLOP per 96 steps at (C=28416, N=512),
// on a few MB of inputs. So the work is the product Y = Pm Vt (Pm = fm . p
// of a tile's rows): 0.51 ms and 21.4 ms at the 67 TFLOP/s of float32
// FFMA, 0.21 ms and 8.7 ms as three TF32 products at 495 TFLOP/s. The first
// body re-read all of V from L2 for every 16 rows and step (179 GB at the
// ineq shape) and ran on FFMA. The tensor-core body:
//
//  * Tiles of TR = 16/32/64 rows x NP = 64 NT columns (N padded), TR NT <=
//    256; one block owns a tile for the whole CG loop. Warps own 32 x 32
//    pieces of the product (16 x 64 at TR = 16): 512 threads at TR NT =
//    256. The rule: NT the least of 4/8/16 with 64 NT >= N; TR the
//    largest the budget allows whose grid has more than half as many blocks
//    as the card has SMs, else 16 (TR = 32 at C=4096 and C=28416, 64 at
//    C=16384). A tile runs until its last row converges; chip_smoke.py
//    measures what that costs.
//  * Vt streams through shared memory in k-slices of 8 rows, 4 in flight
//    (2 at NP = 1024) with cp.async; every row of the tile uses every staged
//    slice, so L2 carries N^2 words per TR rows and step, 2-4x less than
//    the first body. Pm (fm . p) is the A operand in shared memory; its row
//    stride NP + 4 and the slices' NP + 8 keep fragment loads free of bank
//    conflicts.
//  * The product runs on the tensor cores as 3xTF32: mma.sync m16n8k8 with
//    each operand split into hi = rna_tf32(a), lo = rna_tf32(a - hi) (by
//    integer rounding; sm_90 emulates cvt.rna.tf32.f32 in four
//    instructions) and a_lo b_hi + a_hi b_lo + a_hi b_hi accumulated in
//    float32. The tensor cores' accumulation truncates, so each window of 4
//    slices goes to zeroed partial sums that are added to the accumulators
//    in float32; one chain over all of k carried that bias 3 N / 8 times
//    and left a true residual 4x the FFMA product's. No one-pass TF32, no
//    fast-math.
//  * After the product each thread stages its accumulators in shared memory
//    (over the idle slice buffers) and does the elementwise update for the
//    elements it owns in rolled loops, so that few values are live at once:
//    p in shared memory, r (a scratch array) and x in device memory, fm and
//    dinv read from it. Only the three row sums (pAp, r.z, r.r) cross
//    threads: two shuffles, then one pass over the warps sharing the row, in
//    a fixed order.
//
// What still holds it back (PERF.md): the operand splits and per-slice
// synchronisation (about 5 instructions per mma.sync), and the update's
// device-memory traffic (28 bytes per element and step), since a tile's
// state does not fit on chip beside the accumulators.
//
// What bounds the float64 shared-V case: the product again, 2 N^2 per row
// and step, at the 67 TFLOP/s of the float64 tensor cores (twice DFMA's):
// 14.4 ms per 64 steps at config 4's launch (C=28416, N=512). The first
// body ran it on DFMA with 8-row tiles (its shared-memory state allows no
// more at N=512) and took 115 ms: latency-bound, one load of V per k and
// thread in flight. The DMMA body:
//
//  * Tiles of 16 rows (one m16 tile) x NP = 64 NW columns (N padded, NW
//    the least of 2/4/8 with 64 NW >= N), 8 warps of 8 NW columns; one
//    block owns a tile for the whole CG loop.
//  * The product on mma.sync m16n8k8 f64: IEEE float64 FMAs, one
//    accumulation chain, no operand splits. Pm = fm . p is the A operand in
//    shared memory (row stride NP + 4: fragment loads free of bank
//    conflicts). Each element of Vt is used by one warp only, so it goes
//    from L2 into the B fragments in registers, two k8 steps ahead, with no
//    copy through shared memory and no barrier per k-slice; an n8-tile
//    pair's columns interleave so that a lane's two B values are one
//    16-byte load. L2 carries N^2 words per 16 rows and step (the first
//    body's per 8).
//  * p and r stay in shared memory (each thread's own slots), the
//    accumulators in registers through the elementwise passes; x in device
//    memory (read and written once a step, with dinv read: 24 bytes per
//    element and step, 16-byte accesses); fm read once per launch and kept
//    as one bit per element where the tile's values are 0 or 1 (else read
//    where needed). The row sums go in a fixed order as in the float32
//    body. Rows and columns outside the launch are zero throughout.
//
// What holds the DMMA body back (PERF.md): its L2 loads and its products do
// not overlap (each alone takes about half of the product's time), and the
// elementwise passes (a quarter of a step) run between products, one block
// per SM.
//
// All three bodies can count the steps each row runs: the steps that start
// with the row alive (rr > tol2), the plain version's own test, written once
// at the end to an optional int array (ops/cg.py passes one while a profiler
// records). The first and the DMMA body count in shared memory behind a
// null check. The tensor-core body takes a COUNT template flag instead,
// because the count cost its largest tiles spill stores: a launch without
// the array runs the body as it was.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8), tensor-core body (TR, NT):
// registers, spill stores/loads in bytes, threads, dynamic shared memory:
//   (64, 4) 128, 12/36, 512, 203,776  (32, 4) 157, 0/0, 256, 102,912
//   (16, 4) 147, 0/0, 128, 67,584      (32, 8) 128, 12/36, 512, 204,288
//   (16, 8) 145, 0/0, 256, 133,888     (16, 16) 128, 0/0, 512, 200,448
// With COUNT: (64, 4) and (32, 8) 128, 20/44; (32, 4) 159; the rest as
// without, and TR more ints of shared memory. First body: 32-255
// registers, spills of up to 144 bytes in some float64 and per-instance-V
// instantiations (float64, shared V, 8-row tiles: 128 registers, none;
// 80 and 56/40 before the count). DMMA body (NW), 256 threads: (8) 255,
// 184/256 (88/160 without 16-byte loads), 200,256 bytes; (4) 216 (202),
// 0/0, 101,952; (2) 152 (136), 0/0, 52,800. chip_smoke.py prints every
// kernel's report.
//
// A per-instance V is handled (first body) by a per-row instance index and a
// V stride. The C entry points return cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// The first port's body: float64, a per-instance V, float32 with N > 1024.
// ---------------------------------------------------------------------------

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
  // (8 TR) | each row's step count (TR ints)
  return (size_t)4 * TR * N + (size_t)kWarps * 2 * TR + 9 * TR;
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
               T* __restrict__ rr_out, int* __restrict__ steps_out, int C,
               int N, int iters) {
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
  int* nstep_s = reinterpret_cast<int*>(new_s + 2 * TR);  // [TR] steps run
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
  if (tid < TR) {
    tol_s[tid] = (tid < nrows) ? tol2[row0 + tid] : T(0);
    nstep_s[tid] = 0;
  }
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
        nstep_s[tid] += alive;  // a step that starts with the row alive
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
  if (tid < nrows) {
    rr_out[row0 + tid] = rr_s[tid];
    if (steps_out != nullptr) steps_out[row0 + tid] = nstep_s[tid];
  }
}

template <typename T, int TR, bool SHARED>
cudaError_t launch_tile(const T* Vt, long long vstride, const int* inst,
                        const T* fm, const T* dinv, const T* B, const T* tol2,
                        T* X, T* rr, int* steps, int C, int N, int iters,
                        cudaStream_t stream) {
  const size_t smem = smem_elems<T, TR>(N) * sizeof(T);
  auto kern = cg_rows_kernel<T, TR, SHARED>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int grid = (C + TR - 1) / TR;
  kern<<<grid, kThreads, smem, stream>>>(Vt, vstride, inst, fm, dinv, B, tol2,
                                         X, rr, steps, C, N, iters);
  return cudaGetLastError();
}

template <typename T, int TR>
cudaError_t launch_shared_or_not(const T* Vt, long long vstride,
                                 const int* inst, const T* fm, const T* dinv,
                                 const T* B, const T* tol2, T* X, T* rr,
                                 int* steps, int C, int N, int iters,
                                 cudaStream_t stream) {
  if (inst == nullptr)
    return launch_tile<T, TR, true>(Vt, 0, nullptr, fm, dinv, B, tol2, X, rr,
                                    steps, C, N, iters, stream);
  return launch_tile<T, TR, false>(Vt, vstride, inst, fm, dinv, B, tol2, X,
                                   rr, steps, C, N, iters, stream);
}

// ---------------------------------------------------------------------------
// Float32, shared V, N <= 1024: tensor-core body (3xTF32 mma.sync).
// ---------------------------------------------------------------------------

template <int TR, int NT>
struct Tc {
  static constexpr int NP = 64 * NT;          // padded columns
  static constexpr int MT = TR >= 32 ? 2 : 1;  // m16 tiles per warp
  static constexpr int NW = 8 / MT;           // n8 tiles per warp
  static constexpr int WR = TR / (16 * MT);   // warps along the rows
  static constexpr int WC = NP / (8 * NW);    // warps along the columns
  static constexpr int THREADS = 32 * WR * WC;
  static constexpr int LDA = NP + 4;          // Pm row stride (floats)
  static constexpr int KS = 8;                // rows of Vt per k-slice
  static constexpr int STAGES = NT >= 16 ? 2 : 4;  // k-slices in flight
  static constexpr int WIN = 4;               // k-slices per partial sum
  static constexpr int LDB = NP + 8;          // k-slice row stride (floats)
  static constexpr int PAIRS = MT * NW * 2;   // column pairs per thread
  static constexpr int SLICE_FLOATS = STAGES * KS * LDB;
  static constexpr int PAIR_FLOATS = PAIRS * THREADS * 2;
  // the k-slices during the product, the product's result after it
  static constexpr int WORK_FLOATS =
      SLICE_FLOATS > PAIR_FLOATS ? SLICE_FLOATS : PAIR_FLOATS;
  // Pm [TR][LDA] | p [PAIRS][THREADS] float2 | work | sums [3][WC][TR],
  // then, where the steps are counted, each row's count [TR] (ints)
  static constexpr size_t SMEM_FLOATS = (size_t)TR * LDA + PAIR_FLOATS +
                                        WORK_FLOATS + (size_t)3 * WC * TR;
};

// hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi), by integer rounding of
// the bit patterns: sm_90 runs cvt.rna.tf32.f32 as four instructions, this
// takes two. Equal to the conversion for every finite x; Inf and NaN give
// a NaN lo, so they propagate through the product as before.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  const float l = x - __uint_as_float(hi);  // exact
  lo = (__float_as_uint(l) + 0x1000u) & 0xffffe000u;
}

// d += a b, one m16n8k8 TF32 product with float32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Which copies of a k-slice this thread makes: the first (row, chunk) and
// the step between its copies, fixed for the launch (no division per copy).
struct CopyPlan {
  int w;        // floats per copy: 4 (16-byte cp.async) or 1
  int per_row;  // copies per row of Vt
  int kk0, q0;  // this thread's first copy
  int dkk, dq;  // one block's worth of copies further on
};

__device__ __forceinline__ CopyPlan copy_plan(int N, bool vec16) {
  CopyPlan c;
  c.w = vec16 ? 4 : 1;
  c.per_row = N / c.w;
  c.kk0 = threadIdx.x / c.per_row;
  c.q0 = threadIdx.x - c.kk0 * c.per_row;
  c.dkk = blockDim.x / c.per_row;
  c.dq = blockDim.x - c.dkk * c.per_row;
  return c;
}

// Rows [k0, k0 + KS) of Vt into a slice buffer: cp.async for the rows below
// N, zeros for the rows past it (columns >= N were zeroed once). Always
// commits one group, so that the pipeline's group count stays uniform.
template <int KS, int LDB>
__device__ __forceinline__ void fetch_slice(float* dst, const float* Vt,
                                            int N, int k0,
                                            const CopyPlan& c) {
  int kk = c.kk0, q = c.q0;
  while (kk < KS) {
    float* d = dst + kk * LDB + c.w * q;
    const float* src = Vt + (size_t)(k0 + kk) * N + c.w * q;
    if (c.w == 4) {
      if (k0 + kk < N)
        cp_async16(d, src);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      if (k0 + kk < N)
        cp_async4(d, src);
      else
        *d = 0.f;
    }
    kk += c.dkk;
    q += c.dq;
    if (q >= c.per_row) {
      q -= c.per_row;
      ++kk;
    }
  }
  cp_async_commit();
}

// Sums each of NQ per-row partials over the tile's threads. part[q][mt][h]
// belongs to row row0w + mt*16 + g + 8h of the tile (row0w: the warp's
// first row); every thread gets the totals of its rows. The order is fixed:
// the four lanes of a row, then the WC warps that share the row.
template <int TR, int MT, int WC, int NQ>
__device__ __forceinline__ void row_sums(float (&part)[NQ][MT][2],
                                         float* red, int row0w, int wc,
                                         float (&out)[NQ][MT][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2;
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = part[q][mt][h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if ((lane & 3) == 0)
          red[(q * WC + wc) * TR + row0w + mt * 16 + g + 8 * h] = v;
      }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0w + mt * 16 + g + 8 * h;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < WC; ++w) s += red[(q * WC + w) * TR + row];
        out[q][mt][h] = s;
      }
}

// y = Pm Vt over all k-slices of Vt, left in y_s (this thread's pairs of
// the result, in its own slots; y_s aliases the slice buffers). Slice
// s + STAGES - 1 is fetched while slice s is multiplied. Each window of WIN
// slices goes to zeroed partial sums that are added to acc in float32
// (round to nearest): the tensor cores' accumulation truncates, and a chain
// over all of k would carry that bias 3 N / 8 times. Within an n8 tile the
// products go term by term over the MT m16 tiles, so that
// consecutive mma.sync are independent.
template <int TR, int NT>
__device__ __forceinline__ void tc_matvec(const float* pm_s, float* work,
                                          const float* __restrict__ Vt, int N,
                                          const CopyPlan& cp) {
  using S = Tc<TR, NT>;
  constexpr int MT = S::MT, NW = S::NW, LDA = S::LDA, KS = S::KS,
                LDB = S::LDB, STAGES = S::STAGES, WIN = S::WIN;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int row_w = (warp / S::WC) * 16 * MT;  // the warp's first row
  const int col_w = (warp % S::WC) * NW * 8;   // and column
  const int nslices = (N + KS - 1) / KS;
  __syncthreads();  // Pm written, and the last reads of work done
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nslices)
      fetch_slice<KS, LDB>(work + s * KS * LDB, Vt, N, s * KS, cp);
    else
      cp_async_commit();  // an empty group keeps the count uniform
  }
  float acc[MT][NW][4], part[MT][NW][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NW; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
#pragma unroll 1
  for (int s = 0; s < nslices; ++s) {
    if (s % WIN == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NW; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
    }
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice s visible; slice s-1's buffer is free
    const int nxt = s + STAGES - 1;
    if (nxt < nslices)
      fetch_slice<KS, LDB>(work + (nxt % STAGES) * KS * LDB, Vt, N, nxt * KS,
                           cp);
    else
      cp_async_commit();
    const float* bs = work + (s % STAGES) * KS * LDB;
    uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* a = pm_s + (row_w + mt * 16 + g) * LDA + s * KS + t;
      split_tf32(a[0], ahi[mt][0], alo[mt][0]);
      split_tf32(a[8 * LDA], ahi[mt][1], alo[mt][1]);
      split_tf32(a[4], ahi[mt][2], alo[mt][2]);
      split_tf32(a[8 * LDA + 4], ahi[mt][3], alo[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NW; ++nt) {
      const float* b = bs + t * LDB + col_w + nt * 8 + g;
      uint32_t bhi[2], blo[2];
      split_tf32(b[0], bhi[0], blo[0]);
      split_tf32(b[4 * LDB], bhi[1], blo[1]);
      // small terms first
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_tf32(part[mt][nt], alo[mt], bhi);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_tf32(part[mt][nt], ahi[mt], blo);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_tf32(part[mt][nt], ahi[mt], bhi);
    }
    if (s % WIN == WIN - 1 || s == nslices - 1) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NW; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with Pm and the slice buffers
  float2* y_s = reinterpret_cast<float2*>(work);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NW; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        y_s[((mt * NW + nt) * 2 + h) * S::THREADS + threadIdx.x] =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
}

// Whether any row of the tile is still above its tolerance (a block vote).
template <int MT>
__device__ __forceinline__ bool tc_any_alive(const float (&rr)[MT][2],
                                             const float (&tol)[MT][2]) {
  int go = 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) go |= (rr[mt][h] > tol[mt][h]);
  return __syncthreads_or(go) != 0;
}

// Columns (col, col + 1) of one row in device memory, at index gi of the
// row-major (C, N) array: two loads without a branch (an element outside
// the array reads index 0 and yields 0), so that a pass's loads can all be
// in flight at once; the stores are predicated.
__device__ __forceinline__ float2 ld_pair(const float* base, size_t gi,
                                          bool v0, bool v1) {
  const float a = base[v0 ? gi : 0], b = base[v1 ? gi + 1 : 0];
  return make_float2(v0 ? a : 0.f, v1 ? b : 0.f);
}

__device__ __forceinline__ float2 ldg_pair(const float* __restrict__ base,
                                           size_t gi, bool v0, bool v1) {
  const float a = __ldg(base + (v0 ? gi : 0)),
              b = __ldg(base + (v1 ? gi + 1 : 0));
  return make_float2(v0 ? a : 0.f, v1 ? b : 0.f);
}

__device__ __forceinline__ void st_pair(float* base, size_t gi, float2 v,
                                        bool v0, bool v1) {
  if (v0) base[gi] = v.x;
  if (v1) base[gi + 1] = v.y;
}

template <int TR, int NT, bool COUNT>
__global__ void __launch_bounds__(Tc<TR, NT>::THREADS, 1)
cg_rows_tc_kernel(const float* __restrict__ Vt, const float* __restrict__ fm,
                  const float* __restrict__ dinv, const float* __restrict__ Bm,
                  const float* __restrict__ tol2, float* __restrict__ X,
                  float* __restrict__ R, float* __restrict__ rr_out,
                  int* __restrict__ steps_out, int C, int N, int iters,
                  int vec16) {
  using S = Tc<TR, NT>;
  constexpr int MT = S::MT, NW = S::NW, WC = S::WC, THREADS = S::THREADS,
                LDA = S::LDA;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* pm_s = reinterpret_cast<float*>(smem_raw);          // [TR][LDA]
  float2* p_s = reinterpret_cast<float2*>(pm_s + TR * LDA);  // [PAIRS][THREADS]
  float* work = reinterpret_cast<float*>(p_s) + S::PAIR_FLOATS;
  const float2* y_s = reinterpret_cast<const float2*>(work);
  float* red_s = work + S::WORK_FLOATS;                      // [3][WC][TR]
  // [TR] steps run (COUNT), each row's kept by the thread writing its rr
  int* nstep_s = reinterpret_cast<int*>(red_s + 3 * WC * TR);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * TR;
  const int nrows = min(TR, C - row0);
  const CopyPlan cp = copy_plan(N, vec16);

  // This thread owns, for each (mt, nt, h), columns col0 + 8 nt and the next
  // one of row row_w + mt*16 + g + 8h: the product's result (y_s) and p
  // (p_s) in its own slot of shared memory, r and x in device memory. The
  // elementwise passes loop over nt (rolled) inside compile-time loops over
  // the thread's 2 MT rows, so a pass keeps few values live.
  const int row_w = (warp / WC) * 16 * MT, wc = warp % WC;
  const int col0 = wc * NW * 8 + 2 * t;
  auto row_of = [&](int mt, int h) { return row_w + mt * 16 + g + 8 * h; };
  auto slot = [&](int mt, int nt, int h) {
    return ((mt * NW + nt) * 2 + h) * THREADS + tid;
  };

  // ---- Pm = fm . x0 ---------------------------------------------------------
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_of(mt, h);
      const bool in = row < nrows;
      const size_t gr = (size_t)(row0 + (in ? row : 0)) * N;
#pragma unroll 2
      for (int nt = 0; nt < NW; ++nt) {
        const int col = col0 + nt * 8;
        const bool v0 = in && col < N, v1 = in && col + 1 < N;
        const float2 f = ldg_pair(fm, gr + col, v0, v1);
        const float2 x = ld_pair(X, gr + col, v0, v1);
        *reinterpret_cast<float2*>(pm_s + row * LDA + col) =
            make_float2(f.x * x.x, f.y * x.y);
      }
    }
  float tol[MT][2], rz[MT][2], rr[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_of(mt, h);
      tol[mt][h] = row < nrows ? tol2[row0 + row] : 0.f;
      if constexpr (COUNT)
        if (wc == 0 && t == 0) nstep_s[row] = 0;
    }

  // ---- r = b - vp(x0); z = r . dinv; p = z ----------------------------------
  tc_matvec<TR, NT>(pm_s, work, Vt, N, cp);
  {
    float part[2][MT][2] = {};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row_of(mt, h);
        const bool in = row < nrows;
        const size_t gr = (size_t)(row0 + (in ? row : 0)) * N;
#pragma unroll 2
        for (int nt = 0; nt < NW; ++nt) {
          const int col = col0 + nt * 8;
          const bool v0 = in && col < N, v1 = in && col + 1 < N;
          const size_t gi = gr + col;
          const float2 f = ldg_pair(fm, gi, v0, v1);
          const float2 x = ld_pair(X, gi, v0, v1);
          const float2 b = ldg_pair(Bm, gi, v0, v1);
          const float2 d = ldg_pair(dinv, gi, v0, v1);
          const float2 y = y_s[slot(mt, nt, h)];
          const float ap0 = f.x * y.x + (1.f - f.x) * x.x,
                      ap1 = f.y * y.y + (1.f - f.y) * x.y;
          const float r0 = v0 ? b.x - ap0 : 0.f, r1 = v1 ? b.y - ap1 : 0.f;
          const float z0 = r0 * d.x, z1 = r1 * d.y;
          part[0][mt][h] += r0 * z0 + r1 * z1;
          part[1][mt][h] += r0 * r0 + r1 * r1;
          st_pair(R, gi, make_float2(r0, r1), v0, v1);
          p_s[slot(mt, nt, h)] = make_float2(z0, z1);
          *reinterpret_cast<float2*>(pm_s + row * LDA + col) =
              make_float2(f.x * z0, f.y * z1);
        }
      }
    float tot[2][MT][2];
    row_sums<TR, MT, WC, 2>(part, red_s + WC * TR, row_w, wc, tot);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rz[mt][h] = tot[0][mt][h];
        rr[mt][h] = tot[1][mt][h];
      }
  }

  int it = 0;
  bool go = tc_any_alive<MT>(rr, tol);
  while (it < iters && go) {
    const int n = min(kChunk, iters - it);
    for (int s = 0; s < n; ++s) {
      bool alive[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          alive[mt][h] = rr[mt][h] > tol[mt][h];
          if constexpr (COUNT)
            if (wc == 0 && t == 0) nstep_s[row_of(mt, h)] += alive[mt][h];
        }
      // ---- Ap = vp(p) (kept in p_s's neighbour y_s), pAp ----------------
      tc_matvec<TR, NT>(pm_s, work, Vt, N, cp);
      float2* ap_s = reinterpret_cast<float2*>(work);  // Ap, then z
      float pap[1][MT][2] = {};
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row_of(mt, h);
          const bool in = row < nrows;
          const size_t gr = (size_t)(row0 + (in ? row : 0)) * N;
#pragma unroll 2
          for (int nt = 0; nt < NW; ++nt) {
            const int col = col0 + nt * 8;
            const bool v0 = in && col < N, v1 = in && col + 1 < N;
            const float2 f = ldg_pair(fm, gr + col, v0, v1);
            const float2 pv = p_s[slot(mt, nt, h)];
            const float2 y = ap_s[slot(mt, nt, h)];
            const float ap0 = v0 ? f.x * y.x + (1.f - f.x) * pv.x : 0.f,
                        ap1 = v1 ? f.y * y.y + (1.f - f.y) * pv.y : 0.f;
            pap[0][mt][h] += pv.x * ap0 + pv.y * ap1;
            ap_s[slot(mt, nt, h)] = make_float2(ap0, ap1);
          }
        }
      float papt[1][MT][2];
      row_sums<TR, MT, WC, 1>(pap, red_s, row_w, wc, papt);
      float alpha[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float pa = papt[0][mt][h];
          alpha[mt][h] = (alive[mt][h] && pa > 0.f)
                             ? rz[mt][h] / floor_max(pa, 1e-30f) : 0.f;
        }
      // ---- x += alpha p; r -= alpha Ap; z = r . dinv --------------------
      float part[2][MT][2] = {};
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row_of(mt, h);
          const bool in = row < nrows;
          const size_t gr = (size_t)(row0 + (in ? row : 0)) * N;
          const float a = alpha[mt][h];
#pragma unroll 2
          for (int nt = 0; nt < NW; ++nt) {
            const int col = col0 + nt * 8;
            const bool v0 = in && col < N, v1 = in && col + 1 < N;
            const size_t gi = gr + col;
            const float2 pv = p_s[slot(mt, nt, h)];
            const float2 ap = ap_s[slot(mt, nt, h)];
            const float2 x = ld_pair(X, gi, v0, v1);
            const float2 r = ld_pair(R, gi, v0, v1);
            const float2 d = ldg_pair(dinv, gi, v0, v1);
            st_pair(X, gi, make_float2(x.x + a * pv.x, x.y + a * pv.y), v0,
                    v1);
            const float r0 = v0 ? r.x - a * ap.x : 0.f,
                        r1 = v1 ? r.y - a * ap.y : 0.f;
            const float z0 = r0 * d.x, z1 = r1 * d.y;
            part[0][mt][h] += r0 * z0 + r1 * z1;
            part[1][mt][h] += r0 * r0 + r1 * r1;
            st_pair(R, gi, make_float2(r0, r1), v0, v1);
            ap_s[slot(mt, nt, h)] = make_float2(z0, z1);
          }
        }
      float tot[2][MT][2];
      row_sums<TR, MT, WC, 2>(part, red_s + WC * TR, row_w, wc, tot);
      float beta[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          beta[mt][h] = alive[mt][h]
                            ? tot[0][mt][h] / floor_max(rz[mt][h], 1e-30f)
                            : 0.f;
          rz[mt][h] = tot[0][mt][h];
          rr[mt][h] = tot[1][mt][h];
        }
      // ---- p = z + beta p; Pm = fm . p ----------------------------------
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row_of(mt, h);
          const bool in = row < nrows;
          const size_t gr = (size_t)(row0 + (in ? row : 0)) * N;
          const float be = beta[mt][h];
#pragma unroll 2
          for (int nt = 0; nt < NW; ++nt) {
            const int col = col0 + nt * 8;
            const bool v0 = in && col < N, v1 = in && col + 1 < N;
            const float2 f = ldg_pair(fm, gr + col, v0, v1);
            const float2 pv = p_s[slot(mt, nt, h)];
            const float2 z = ap_s[slot(mt, nt, h)];
            const float pn0 = v0 ? z.x + be * pv.x : 0.f,
                        pn1 = v1 ? z.y + be * pv.y : 0.f;
            p_s[slot(mt, nt, h)] = make_float2(pn0, pn1);
            *reinterpret_cast<float2*>(pm_s + row * LDA + col) =
                make_float2(f.x * pn0, f.y * pn1);
          }
        }
    }
    it += kChunk;
    go = tc_any_alive<MT>(rr, tol);
  }
  if (wc == 0 && t == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row_of(mt, h);
        if (row < nrows) {
          rr_out[row0 + row] = rr[mt][h];
          if constexpr (COUNT) steps_out[row0 + row] = nstep_s[row];
        }
      }
  }
}

template <int TR, int NT, bool COUNT>
cudaError_t launch_tc(const float* Vt, const float* fm, const float* dinv,
                      const float* B, const float* tol2, float* X, float* R,
                      float* rr, int* steps, int C, int N, int iters,
                      cudaStream_t stream) {
  const size_t smem =
      (Tc<TR, NT>::SMEM_FLOATS + (COUNT ? TR : 0)) * sizeof(float);
  auto kern = cg_rows_tc_kernel<TR, NT, COUNT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  auto aligned = [](const void* q, int bytes) {
    return reinterpret_cast<uintptr_t>(q) % bytes == 0;
  };
  const int vec16 = N % 4 == 0 && aligned(Vt, 16);
  const int grid = (C + TR - 1) / TR;
  kern<<<grid, Tc<TR, NT>::THREADS, smem, stream>>>(
      Vt, fm, dinv, B, tol2, X, R, rr, steps, C, N, iters, vec16);
  return cudaGetLastError();
}

constexpr int kTcMaxN = 1024;

// The tensor-core body's tile: NT the least of 4/8/16 with 64 NT >= N;
// TR the largest of 64/32/16 with TR NT <= 256 whose grid has more than half
// as many blocks as the card has SMs (else 16).
void tc_tile(int C, int N, int sms, int* tr, int* nt) {
  *nt = N <= 256 ? 4 : N <= 512 ? 8 : 16;
  *tr = 256 / *nt > 64 ? 64 : 256 / *nt;
  while (*tr > 16 && (C + *tr - 1) / *tr <= sms / 2) *tr /= 2;
}

cudaError_t run_tc(const float* Vt, const float* fm, const float* dinv,
                   const float* B, const float* tol2, float* X, float* R,
                   float* rr, int* steps, int C, int N, int iters, int sms,
                   cudaStream_t stream) {
  int tr = 0, nt = 0;
  tc_tile(C, N, sms, &tr, &nt);
#define SSQP_TC(TRV, NTV)                                                  \
  if (tr == TRV && nt == NTV)                                              \
    return steps ? launch_tc<TRV, NTV, true>(Vt, fm, dinv, B, tol2, X, R,  \
                                             rr, steps, C, N, iters, stream) \
                 : launch_tc<TRV, NTV, false>(Vt, fm, dinv, B, tol2, X, R, \
                                              rr, steps, C, N, iters, stream);
  SSQP_TC(64, 4) SSQP_TC(32, 4) SSQP_TC(16, 4)
  SSQP_TC(32, 8) SSQP_TC(16, 8)
  SSQP_TC(16, 16)
#undef SSQP_TC
  return cudaErrorInvalidConfiguration;
}

// ---------------------------------------------------------------------------
// Float64, shared V, N <= 512: DMMA body (mma.sync m16n8k8 f64).
// ---------------------------------------------------------------------------

template <int NW>
struct Dm {
  static constexpr int TR = 16;              // rows per tile: one m16 tile
  static constexpr int WARPS = 8;            // each owns 8 NW columns
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int NQ = NW / 2;          // n8-tile pairs per warp
  static constexpr int NP = 8 * NW * WARPS;  // padded columns
  static constexpr int EL = 4 * NW;          // elements per thread
  static constexpr int LDA = NP + 4;         // Pm row stride (doubles)
  static constexpr int DEPTH = 2;            // k8 steps of Vt in flight
  // Pm [TR][LDA] | p, r [EL / 2][THREADS] each (double2) | the row sums
  // [3][WARPS][TR] (doubles) | each row's step count [TR] (ints)
  static constexpr size_t SMEM_BYTES =
      8 * ((size_t)TR * LDA + 2 * (size_t)EL * THREADS + 3 * WARPS * TR) +
      4 * TR;
  static_assert(NW % 2 == 0 && SMEM_BYTES <= 232448, "tile too wide");
};

// d += a b, one m16n8k8 float64 product: IEEE float64 FMAs
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// Vt[k][c], Vt[k][c + 1]; zeros outside the N x N matrix. VEC: N even and
// Vt 16-byte aligned, so the pair is one 16-byte load.
template <bool VEC>
__device__ __forceinline__ double2 dm_ld_vt(const double* __restrict__ Vt,
                                            int N, int k, int c) {
  if (k >= N || c >= N) return make_double2(0.0, 0.0);
  const double* q = Vt + (size_t)k * N + c;
  if constexpr (VEC) return __ldg(reinterpret_cast<const double2*>(q));
  return make_double2(__ldg(q), c + 1 < N ? __ldg(q + 1) : 0.0);
}

// v[m] = row[c + m] for m < 4 where in and c + m < N, else 0 (NC: through
// the read-only data path, for arrays the kernel does not write).
template <bool VEC, bool NC>
__device__ __forceinline__ void dm_ld4(const double* row, int c, int N,
                                       bool in, double (&v)[4]) {
#pragma unroll
  for (int m = 0; m < 4; m += 2) {
    const bool a = in && c + m < N, b = in && c + m + 1 < N;
    if constexpr (VEC) {  // c + m even, N even: a == b
      double2 w = make_double2(0.0, 0.0);
      if (a) {
        const double2* q = reinterpret_cast<const double2*>(row + c + m);
        w = NC ? __ldg(q) : *q;
      }
      v[m] = w.x;
      v[m + 1] = w.y;
    } else {
      v[m] = a ? (NC ? __ldg(row + c + m) : row[c + m]) : 0.0;
      v[m + 1] = b ? (NC ? __ldg(row + c + m + 1) : row[c + m + 1]) : 0.0;
    }
  }
}

// row[c + m] = v[m] for m < 4 where in and c + m < N.
template <bool VEC>
__device__ __forceinline__ void dm_st4(double* row, int c, int N, bool in,
                                       const double (&v)[4]) {
#pragma unroll
  for (int m = 0; m < 4; m += 2) {
    if constexpr (VEC) {
      if (in && c + m < N)
        *reinterpret_cast<double2*>(row + c + m) = make_double2(v[m], v[m + 1]);
    } else {
      if (in && c + m < N) row[c + m] = v[m];
      if (in && c + m + 1 < N) row[c + m + 1] = v[m + 1];
    }
  }
}

// acc = Pm Vt for this warp's 8 NW columns of the tile's 16 rows, over all
// k in steps of 8. Each element of Vt is used by one warp only, so it goes
// from L2 straight into the B fragments, DEPTH steps ahead; Pm, which every
// warp uses, is the A operand in shared memory. The k8 step's B fragment
// of n8-tile 2q + e is column cb + 16 q + e of Vt (cb = 8 NW warp + 2 n, n
// the tile's own column), so that a lane's two columns come in one 16-byte
// load. One accumulation chain in float64.
template <int NW, bool VEC>
__device__ __forceinline__ void dm_matvec(const double* pm_s,
                                          const double* __restrict__ Vt,
                                          int N, double (&acc)[NW][4]) {
  using S = Dm<NW>;
  constexpr int NQ = S::NQ, LDA = S::LDA, D = S::DEPTH;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int cb = (threadIdx.x >> 5) * NW * 8 + 2 * g;  // + 16 q
  const int nk = (N + 7) / 8;
  double2 b[D][NQ][2];
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      b[d][q][0] = dm_ld_vt<VEC>(Vt, N, 8 * d + t, cb + 16 * q);
      b[d][q][1] = dm_ld_vt<VEC>(Vt, N, 8 * d + t + 4, cb + 16 * q);
    }
#pragma unroll
  for (int nt = 0; nt < NW; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = 0.0;
  __syncthreads();  // Pm written
  const double* a = pm_s + g * LDA + t;
#pragma unroll 1
  for (int kb = 0; kb < nk; kb += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (kb + d < nk) {
        const int k0 = 8 * (kb + d), kn = k0 + 8 * D;
        const double af[4] = {a[k0], a[8 * LDA + k0], a[k0 + 4],
                              a[8 * LDA + k0 + 4]};
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const double b0[2] = {b[d][q][0].x, b[d][q][1].x};
          const double b1[2] = {b[d][q][0].y, b[d][q][1].y};
          mma_f64(acc[2 * q], af, b0);
          mma_f64(acc[2 * q + 1], af, b1);
          b[d][q][0] = dm_ld_vt<VEC>(Vt, N, kn + t, cb + 16 * q);
          b[d][q][1] = dm_ld_vt<VEC>(Vt, N, kn + t + 4, cb + 16 * q);
        }
      }
    }
  }
}

// Sums each of NQ per-row partials over the tile's threads: part[q][h]
// belongs to row g + 8h; every thread gets the totals of its two rows. The
// order is fixed: the four lanes of a row, then the warps in turn.
template <int TR, int WARPS, int NQ>
__device__ __forceinline__ void dm_row_sums(double (&part)[NQ][2],
                                            double* red,
                                            double (&out)[NQ][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      double v = part[q][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if ((lane & 3) == 0) red[(q * WARPS + warp) * TR + g + 8 * h] = v;
    }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      double s = 0.0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[(q * WARPS + w) * TR + g + 8 * h];
      out[q][h] = s;
    }
}

__device__ __forceinline__ bool dm_any_alive(const double (&rr)[2],
                                             const double (&tol)[2]) {
  return __syncthreads_or((rr[0] > tol[0]) | (rr[1] > tol[1])) != 0;
}

template <int NW, bool VEC>
__global__ void __launch_bounds__(Dm<NW>::THREADS, 1)
cg_rows_dmma_kernel(const double* __restrict__ Vt,
                    const double* __restrict__ fm,
                    const double* __restrict__ dinv,
                    const double* __restrict__ Bm,
                    const double* __restrict__ tol2, double* __restrict__ X,
                    double* __restrict__ rr_out, int* __restrict__ steps_out,
                    int C, int N, int iters) {
  using S = Dm<NW>;
  constexpr int TR = S::TR, WARPS = S::WARPS, THREADS = S::THREADS,
                LDA = S::LDA, NQ = S::NQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* pm_s = reinterpret_cast<double*>(smem_raw);  // [TR][LDA] fm . p
  double2* p_s = reinterpret_cast<double2*>(pm_s + TR * LDA);  // [EL/2][THREADS]
  double2* r_s = p_s + S::EL / 2 * THREADS;                     // [EL/2][THREADS]
  double* red_s = reinterpret_cast<double*>(r_s + S::EL / 2 * THREADS);
  int* nstep_s = reinterpret_cast<int*>(red_s + 3 * WARPS * TR);  // [TR]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * TR;
  const int nrows = min(TR, C - row0);

  // This thread owns, for q < NW / 2 and h < 2, the four columns c4 + 16 q
  // + m (m < 4) of row g + 8 h: the product's accumulators acc[2 q + (m &
  // 1)][2 h + (m >> 1)], and p and r in its own slots of shared memory
  // (one double2 per two columns); x stays in device memory. Everything
  // outside the launch's rows and columns is zero throughout.
  const int c4 = warp * NW * 8 + 4 * t;
  auto rin = [&](int h) { return g + 8 * h < nrows; };
  auto grow = [&](int h) {
    return (size_t)(row0 + (rin(h) ? g + 8 * h : 0)) * N;
  };
  auto slot = [&](int q, int h, int mp) {
    return ((q * 2 + h) * 2 + mp) * THREADS + tid;
  };
  auto pm_row = [&](int h) { return pm_s + (g + 8 * h) * LDA; };

  // fm is read once: where every value of the tile is 0 or 1 it is kept as
  // one bit per element; otherwise the passes read it from device memory.
  uint32_t fbits = 0;
  int fbin = 1;
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      double f[4];
      dm_ld4<VEC, true>(fm + grow(h), c4 + 16 * q, N, rin(h), f);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        fbin &= f[m] == 1.0 || __double_as_longlong(f[m]) == 0;
        fbits |= (uint32_t)(f[m] == 1.0) << ((q * 2 + h) * 4 + m);
      }
    }
  fbin = __syncthreads_and(fbin);
  auto fget = [&](int q, int h, double (&f)[4]) {
    if (fbin) {
#pragma unroll
      for (int m = 0; m < 4; ++m)
        f[m] = (fbits >> ((q * 2 + h) * 4 + m)) & 1u ? 1.0 : 0.0;
    } else {
      dm_ld4<VEC, true>(fm + grow(h), c4 + 16 * q, N, rin(h), f);
    }
  };
  auto put_pm = [&](int q, int h, const double (&f)[4],
                    const double (&v)[4]) {
    double2* d = reinterpret_cast<double2*>(pm_row(h) + c4 + 16 * q);
    d[0] = make_double2(f[0] * v[0], f[1] * v[1]);
    d[1] = make_double2(f[2] * v[2], f[3] * v[3]);
  };

  // ---- Pm = fm . x0 ---------------------------------------------------------
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      double f[4], x[4];
      fget(q, h, f);
      dm_ld4<VEC, false>(X + grow(h), c4 + 16 * q, N, rin(h), x);
      put_pm(q, h, f, x);
    }
  double tol[2], rz[2], rr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    tol[h] = rin(h) ? tol2[row0 + g + 8 * h] : 0.0;
    if (warp == 0 && t == 0) nstep_s[g + 8 * h] = 0;
  }

  // ---- r = b - vp(x0); z = r . dinv; p = z ----------------------------------
  double acc[NW][4];
  dm_matvec<NW, VEC>(pm_s, Vt, N, acc);
  __syncthreads();  // every warp is done with Pm
  {
    double part[2][2] = {};
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        double f[4], x[4], bv[4], dv[4], r[4], z[4];
        fget(q, h, f);
        dm_ld4<VEC, false>(X + grow(h), c4 + 16 * q, N, rin(h), x);
        dm_ld4<VEC, true>(Bm + grow(h), c4 + 16 * q, N, rin(h), bv);
        dm_ld4<VEC, true>(dinv + grow(h), c4 + 16 * q, N, rin(h), dv);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const double y = acc[2 * q + (m & 1)][2 * h + (m >> 1)];
          r[m] = bv[m] - (f[m] * y + (1.0 - f[m]) * x[m]);
          z[m] = r[m] * dv[m];
          part[0][h] += r[m] * z[m];
          part[1][h] += r[m] * r[m];
        }
        r_s[slot(q, h, 0)] = make_double2(r[0], r[1]);
        r_s[slot(q, h, 1)] = make_double2(r[2], r[3]);
        p_s[slot(q, h, 0)] = make_double2(z[0], z[1]);
        p_s[slot(q, h, 1)] = make_double2(z[2], z[3]);
        put_pm(q, h, f, z);
      }
    double tot[2][2];
    dm_row_sums<TR, WARPS, 2>(part, red_s + WARPS * TR, tot);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rz[h] = tot[0][h];
      rr[h] = tot[1][h];
    }
  }

  int it = 0;
  bool go = dm_any_alive(rr, tol);
  while (it < iters && go) {
    const int n = min(kChunk, iters - it);
    for (int s = 0; s < n; ++s) {
      bool alive[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        alive[h] = rr[h] > tol[h];
        if (warp == 0 && t == 0) nstep_s[g + 8 * h] += alive[h];
      }
      // ---- Ap = vp(p) (in acc), pAp -------------------------------------
      dm_matvec<NW, VEC>(pm_s, Vt, N, acc);
      double pap[1][2] = {};
#pragma unroll
      for (int q = 0; q < NQ; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          double f[4];
          fget(q, h, f);
          const double2 p01 = p_s[slot(q, h, 0)], p23 = p_s[slot(q, h, 1)];
          const double pv[4] = {p01.x, p01.y, p23.x, p23.y};
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            double& y = acc[2 * q + (m & 1)][2 * h + (m >> 1)];
            y = f[m] * y + (1.0 - f[m]) * pv[m];
            pap[0][h] += pv[m] * y;
          }
        }
      double papt[1][2];
      dm_row_sums<TR, WARPS, 1>(pap, red_s, papt);
      double alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        alpha[h] = (alive[h] && papt[0][h] > 0.0)
                       ? rz[h] / floor_max(papt[0][h], 1e-30) : 0.0;
      // ---- x += alpha p; r -= alpha Ap; z = r . dinv (in acc) -------------
      double part[2][2] = {};
#pragma unroll
      for (int q = 0; q < NQ; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const double a = alpha[h];
          double x[4], dv[4];
          dm_ld4<VEC, false>(X + grow(h), c4 + 16 * q, N, rin(h), x);
          dm_ld4<VEC, true>(dinv + grow(h), c4 + 16 * q, N, rin(h), dv);
          const double2 p01 = p_s[slot(q, h, 0)], p23 = p_s[slot(q, h, 1)];
          const double2 r01 = r_s[slot(q, h, 0)], r23 = r_s[slot(q, h, 1)];
          const double pv[4] = {p01.x, p01.y, p23.x, p23.y};
          double r[4] = {r01.x, r01.y, r23.x, r23.y};
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            double& y = acc[2 * q + (m & 1)][2 * h + (m >> 1)];
            x[m] = x[m] + a * pv[m];
            r[m] = r[m] - a * y;
            y = r[m] * dv[m];
            part[0][h] += r[m] * y;
            part[1][h] += r[m] * r[m];
          }
          dm_st4<VEC>(X + grow(h), c4 + 16 * q, N, rin(h), x);
          r_s[slot(q, h, 0)] = make_double2(r[0], r[1]);
          r_s[slot(q, h, 1)] = make_double2(r[2], r[3]);
        }
      double tot[2][2];
      dm_row_sums<TR, WARPS, 2>(part, red_s + WARPS * TR, tot);
      double beta[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        beta[h] = alive[h] ? tot[0][h] / floor_max(rz[h], 1e-30) : 0.0;
        rz[h] = tot[0][h];
        rr[h] = tot[1][h];
      }
      // ---- p = z + beta p; Pm = fm . p ------------------------------------
#pragma unroll
      for (int q = 0; q < NQ; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          double f[4], pn[4];
          fget(q, h, f);
          const double2 p01 = p_s[slot(q, h, 0)], p23 = p_s[slot(q, h, 1)];
          const double pv[4] = {p01.x, p01.y, p23.x, p23.y};
#pragma unroll
          for (int m = 0; m < 4; ++m)
            pn[m] = acc[2 * q + (m & 1)][2 * h + (m >> 1)] + beta[h] * pv[m];
          p_s[slot(q, h, 0)] = make_double2(pn[0], pn[1]);
          p_s[slot(q, h, 1)] = make_double2(pn[2], pn[3]);
          put_pm(q, h, f, pn);
        }
    }
    it += kChunk;
    go = dm_any_alive(rr, tol);
  }
  if (warp == 0 && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = g + 8 * h;
      if (row < nrows) {
        rr_out[row0 + row] = rr[h];
        if (steps_out != nullptr) steps_out[row0 + row] = nstep_s[row];
      }
    }
  }
}

template <int NW, bool VEC>
cudaError_t launch_dmma(const double* Vt, const double* fm,
                        const double* dinv, const double* B,
                        const double* tol2, double* X, double* rr,
                        int* steps, int C, int N, int iters,
                        cudaStream_t stream) {
  using S = Dm<NW>;
  auto kern = cg_rows_dmma_kernel<NW, VEC>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM_BYTES);
  if (e != cudaSuccess) return e;
  const int grid = (C + S::TR - 1) / S::TR;
  kern<<<grid, S::THREADS, S::SMEM_BYTES, stream>>>(
      Vt, fm, dinv, B, tol2, X, rr, steps, C, N, iters);
  return cudaGetLastError();
}

// The widest tile whose Pm, p and r fit a block's shared memory.
constexpr int kDmMaxN = 512;

// Whether a float64 solve with one shared V of width N runs the DMMA body:
// the rule's one owner, read by run_cg and ssqp_cg_body_f64. The DMMA body
// measured faster than the first body at every C from 3 to 28,416 rows, so
// C does not enter.
inline bool dmma_takes(int N) { return N > 0 && N <= kDmMaxN; }

// The DMMA body's instantiation: 64 NW >= N columns (NW = 2, 4, 8); VEC
// where every row of the arrays is 16-byte aligned.
template <bool VEC>
cudaError_t run_dmma_vec(const double* Vt, const double* fm,
                         const double* dinv, const double* B,
                         const double* tol2, double* X, double* rr,
                         int* steps, int C, int N, int iters,
                         cudaStream_t stream) {
  if (N <= 128)
    return launch_dmma<2, VEC>(Vt, fm, dinv, B, tol2, X, rr, steps, C, N,
                               iters, stream);
  if (N <= 256)
    return launch_dmma<4, VEC>(Vt, fm, dinv, B, tol2, X, rr, steps, C, N,
                               iters, stream);
  return launch_dmma<8, VEC>(Vt, fm, dinv, B, tol2, X, rr, steps, C, N,
                             iters, stream);
}

cudaError_t run_dmma(const double* Vt, const double* fm, const double* dinv,
                     const double* B, const double* tol2, double* X,
                     double* rr, int* steps, int C, int N, int iters,
                     cudaStream_t stream) {
  auto a16 = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  if (N % 2 == 0 && a16(Vt) && a16(fm) && a16(dinv) && a16(B) && a16(X))
    return run_dmma_vec<true>(Vt, fm, dinv, B, tol2, X, rr, steps, C, N,
                              iters, stream);
  return run_dmma_vec<false>(Vt, fm, dinv, B, tol2, X, rr, steps, C, N,
                             iters, stream);
}

template <typename T>
int run_cg(const T* Vt, long long vstride, const int* inst, const T* fm,
           const T* dinv, const T* B, const T* tol2, T* X, T* R, T* rr,
           int* steps, int C, int N, int iters, void* stream_ptr) {
  if (C <= 0) return 0;
  if (N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int dev = 0, optin = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if constexpr (sizeof(T) == sizeof(float)) {
    if (inst == nullptr && N <= kTcMaxN) {
      if (R == nullptr) return (int)cudaErrorInvalidValue;
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return (int)e;
      return (int)run_tc(Vt, fm, dinv, B, tol2, X, R, rr, steps, C, N, iters,
                         sms, stream);
    }
  } else if (inst == nullptr && dmma_takes(N)) {
    return (int)run_dmma(Vt, fm, dinv, B, tol2, X, rr, steps, C, N, iters,
                         stream);
  }
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  // Largest row tile whose state fits the block's shared memory.
  const size_t lim = (size_t)optin;
#define SSQP_TRY_TILE(TRV)                                                   \
  if (smem_elems<T, TRV>(N) * sizeof(T) <= lim)                              \
    return (int)launch_shared_or_not<T, TRV>(Vt, vstride, inst, fm, dinv, B, \
                                             tol2, X, rr, steps, C, N, iters,  \
                                             stream);
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

// Rows per block that a float32 shared-V solve of C rows of width N runs
// with on the current device (0: not the tensor-core body), or -1 on a
// CUDA error.
int ssqp_cg_tile_rows_f32(int C, int N) {
  if (N <= 0 || N > kTcMaxN) return 0;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  int tr = 0, nt = 0;
  tc_tile(C, N, sms, &tr, &nt);
  return tr;
}

// 1 where a float64 shared-V solve of width N runs the DMMA body, 0 where
// it runs the first body.
int ssqp_cg_body_f64(int N) { return dmma_takes(N) ? 1 : 0; }

// R: (C, N) scratch for the residual, used by the tensor-core body (float32,
// shared V, N <= 1024) and ignored otherwise (may then be null). steps: (C,)
// ints, each row's count of steps that started with the row alive (rr >
// tol2), written once at the end in both bodies; null writes nothing.
int ssqp_cg_rows_f32(const float* Vt, long long vstride, const int* inst,
                     const float* fm, const float* dinv, const float* B,
                     const float* tol2, float* X, float* R, float* rr,
                     int* steps, int C, int N, int iters, void* stream) {
  return run_cg<float>(Vt, vstride, inst, fm, dinv, B, tol2, X, R, rr, steps,
                       C, N, iters, stream);
}

int ssqp_cg_rows_f64(const double* Vt, long long vstride, const int* inst,
                     const double* fm, const double* dinv, const double* B,
                     const double* tol2, double* X, double* R, double* rr,
                     int* steps, int C, int N, int iters, void* stream) {
  return run_cg<double>(Vt, vstride, inst, fm, dinv, B, tol2, X, R, rr, steps,
                        C, N, iters, stream);
}

}  // extern "C"
