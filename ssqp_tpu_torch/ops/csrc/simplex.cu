// The bounded-variable primal simplex's whole iteration loop, one block per
// LP instance, for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs this loop on its device as
// a per-instance lax.while_loop under vmap (ssqp_tpu/solvers/simplex.py::
// bounded_simplex). The port's host loop (ssqp_tpu_torch/solvers/simplex.py::
// bounded_simplex_loop) runs one step of every live instance per trip: ~700
// small PyTorch operations, a gather of the live rows, a nonzero and a
// scatter back, ~4 ms of host for ~0.4 ms of device work, and each phase
// runs to its slowest instance. Here each block runs its instance's
// `while (!done && it < max_iter)` loop to its own end, so a phase is one
// launch and no host trip, sync, gather or scatter is left per step.
//
// One step, in the order of solvers/simplex.py::_simplex_step under the
// Dantzig rule:
//   refresh   invB <- invB (2I - A_B invB), then the drift gate
//             max |A_B invB - I| > sqrt(tol) on the refreshed inverse;
//   duals     w = invB' c_B, h = c - A' w;
//   values    qv = invB (b - A x_N), the basic entries of x2;
//   pricing   eligible: nonbasic, real, u - d > 0; candidate: eligible with
//             ht > tol (ht = -h at DN, h else); the entering k is the
//             largest ht / |A_k| (the first index on ties), Bland's least
//             candidate index once it > Nt; "infinitely many" (2) where an
//             eligible |ht| < tol;
//   ratio     p = invB A_k; the two-sided test over the basic rows: argmin
//             (entering at DN) or argmax (at UP) of the bound distances,
//             the first index on ties and a NaN ahead of every number, as
//             torch.argmin and torch.argmax order them;
//   exchange  a bound flip when the entering variable reaches its other
//             bound first, else a pivot with the product-form rank-1 update
//             of invB; unbounded (3) where no bound stops it; -1 where w,
//             qv, invB or p is not finite or the drift gate trips.
// Status codes: 1, 2, 3, -1; -max_iter where the iteration limit ends it;
// a pre_done instance returns status 1 untouched. `it` is counted before the
// step, as the host loop counts it.
//
// What bounds it on this card. At config 2's LP shape (R = 25 rows, Nt = 245
// columns, float32) a step is ~62K FMA: the refresh's and the drift's three
// R x R x R products (47K), A' w and A x_N over R x Nt (12K) and the R x R
// products of w, qv and p. 256 instances x ~175 steps are ~5.6 GFLOP a
// request, 0.16 ms at the card's float64 rate outside the tensor cores (the
// arithmetic below); A is read from device memory once per launch (6.3 MB,
// 2 us). The bound is neither: each step is a chain of six dependent phases,
// one block barrier after each, with two block-wide reductions (the drift
// and the pricing's argmax), and a launch lasts as long as its longest
// instance's steps.
//
// Design. The block loads its instance's A (R x Nt, row-major as the
// caller's), c, d, u, x, |A_k|, the statuses and the real mask into shared
// memory once; A_B, the basis, the inverse (two buffers, swapped each
// refresh and each pivot), the product scratch and the small vectors stay
// there for the whole loop, and only status, x, B, S and it are written back
// at its exit. A pivot replaces A_B's column l by A's column k. What shortens
// a step's chain of latencies:
//  * the R x R products give each thread a 2 x 2 register tile: four
//    independent sums whose loads overlap, four loads for four FMAs;
//  * A x_N and p = invB A_k give each warp four rows at once, its lanes the
//    terms and a shuffle the sum; A' w gives each thread whole columns, which
//    it prices at once, so the argmax is a warp shuffle and one pass over the
//    warps' slots;
//  * w and qv, one R-term sum per row, run on the block's last threads,
//    which have the fewest tiles and columns;
//  * p's row owners also form the rows' bound distances, so every warp can
//    take the ratio test and the decision at once (the same numbers in the
//    same order: the same decision) and go on to the exchange with no
//    barrier between them.
// The arithmetic is float64 for both data types: the inverse, its refresh
// and every sum of the step; A and the vectors stay in the data's type, and
// x comes back in it. In float32 a pivot on a small element (|p_l| near
// 1e-4 of its column's scale) leaves an inverse whose float32 drift reads
// above sqrt(tol) = 2^-8, and the step exits -1: on lp-mixed256 about one
// instance in a million did so, in the kernel and in the float32 host loop
// alike (the CPU's host loop on one of the two instances found), and a
// window of ~1M instances met one. With a float64 inverse the gate reads
// the float64 inverse's error: it still trips on a singular or non-finite
// basis, and no longer on float32 rounding. No fast math: divisions are
// IEEE. The starting inverse comes from the caller (torch.linalg.inv_ex: a
// singular start gives non-finite entries and exits -1 at the first step).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// the statuses of ssqp_tpu_torch/types.py
constexpr signed char kIn = 0, kDn = 1, kUp = 2;

template <typename T>
__device__ __forceinline__ T inf_t();
template <>
__device__ __forceinline__ float inf_t<float>() {
  return __int_as_float(0x7f800000);
}
template <>
__device__ __forceinline__ double inf_t<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// |v| with a NaN kept (the comparisons below see it as torch does)
template <typename T>
__device__ __forceinline__ T abs_t(T v) {
  return v < T(0) ? -v : v;
}

// neither infinite nor NaN
template <typename T>
__device__ __forceinline__ bool finite_t(T v) {
  return abs_t(v) < inf_t<T>();
}

// (a, ia) before (b, ib) in torch.argmax's order: the larger value, a NaN
// above every number, the first index on ties.
template <typename T>
__device__ __forceinline__ bool before_max(T a, int ia, T b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

// The same in torch.argmin's order: the smaller value first.
template <typename T>
__device__ __forceinline__ bool before_min(T a, int ia, T b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && (!nb || ia < ib);
  return a < b || (a == b && ia < ib);
}

// Every lane of the warp ends with the warp's first (value, index) in the
// order above.
template <bool kMax, typename T>
__device__ __forceinline__ void warp_arg(T& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const T ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    if (kMax ? before_max(ov, oi, v, i) : before_min(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// The larger of two drift readings, a NaN kept (torch's amax).
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a) ? a : ((b != b || b > a) ? b : a);
}

// The arithmetic's type: float64 for both data types (the inverse and
// every sum of the step), so a float32 instance's drift gate reads the
// float64 inverse's error.
using W = double;

// The block's shared memory: W words, T words, ints, bytes
// (ops/simplex.py's smem_bytes is the same sum).
template <typename T>
size_t simplex_smem_bytes(int R, int Nt) {
  const size_t r = (size_t)R, n = (size_t)Nt;
  const size_t wide = 3 * r * r + 5 * r + 2 * kWarps;
  const size_t words = r * n + 5 * n + r * r + r;
  const size_t ints = r + 5 * kWarps;
  return sizeof(W) * wide + sizeof(T) * words + sizeof(int) * ints + 3 * n;
}

// f(e, i, j, sum_r X_ir Y_rj) for the entries e = i R + j of an R x R
// product, summed in W, each thread a 2 x 2 tile of them (four independent
// sums, each in the order r = 0, 1, ...): a tile's two rows of X and two
// columns of Y are read once a step of r. A tile's entries outside the
// matrix are computed on a repeated index and not passed on.
template <typename TX, typename TY, typename F>
__device__ __forceinline__ void rr_product(const TX* X, const TY* Y, int R,
                                           F f) {
  const int h = (R + 1) >> 1;
  for (int t = threadIdx.x; t < h * h; t += kThreads) {
    const int ti = t / h, tj = t - ti * h;
    const int i0 = 2 * ti, j0 = 2 * tj;
    const int i1 = min(i0 + 1, R - 1), j1 = min(j0 + 1, R - 1);
    const TX* x0 = X + i0 * R;
    const TX* x1 = X + i1 * R;
    W s00 = W(0), s01 = W(0), s10 = W(0), s11 = W(0);
    for (int r = 0; r < R; ++r) {
      const W a0 = x0[r], a1 = x1[r];
      const W b0 = Y[r * R + j0], b1 = Y[r * R + j1];
      s00 += a0 * b0;
      s01 += a0 * b1;
      s10 += a1 * b0;
      s11 += a1 * b1;
    }
    f(i0 * R + j0, i0, j0, s00);
    if (j0 + 1 < R) f(i0 * R + j0 + 1, i0, j0 + 1, s01);
    if (i0 + 1 < R) {
      f((i0 + 1) * R + j0, i0 + 1, j0, s10);
      if (j0 + 1 < R) f((i0 + 1) * R + j0 + 1, i0 + 1, j0 + 1, s11);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    simplex_kernel(const T* __restrict__ gc, const T* __restrict__ gA,
                   const T* __restrict__ gb, const T* __restrict__ gd,
                   const T* __restrict__ gu,
                   const unsigned char* __restrict__ greal,
                   const T* __restrict__ gcA, const T* __restrict__ ginv,
                   const unsigned char* __restrict__ gpre,
                   long long* __restrict__ gB, signed char* __restrict__ gS,
                   T* __restrict__ gx, int* __restrict__ gstatus,
                   int* __restrict__ git, int R, int Nt, T tol, T drift_tol,
                   int max_iter) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t inst = blockIdx.x;
  if (gpre[inst]) {  // the caller discards it: done, status 1, untouched
    if (tid == 0) {
      gstatus[inst] = 1;
      git[inst] = 0;
    }
    return;
  }
  const int RR = R * R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* inv = reinterpret_cast<W*>(smem_raw);  // the current inverse, R x R
  W* alt = inv + RR;  // the other inverse buffer
  W* sM = alt + RR;  // 2I - A_B invB
  W* sw = sM + RR;
  W* sqv = sw + R;
  W* sres = sqv + R;  // b - A x_N
  W* sp = sres + R;  // invB A_k
  W* sg = sp + R;  // each basic row's bound distance in the ratio test
  W* red_drift = sg + R;  // per warp
  W* red_score = red_drift + kWarps;  // per warp
  T* sA = reinterpret_cast<T*>(red_score + kWarps);  // R x Nt
  T* sc = sA + (size_t)R * Nt;
  T* sd = sc + Nt;
  T* su = sd + Nt;
  T* sx = su + Nt;
  T* scA = sx + Nt;  // |A_j|, 1 where 0
  T* sAB = scA + Nt;  // A_B, R x R: column r is A's column B_r
  T* sb = sAB + RR;
  int* sB = reinterpret_cast<int*>(sb + R);  // the basis, R
  int* red_k = sB + R;  // per warp: the best score's column
  int* red_first = red_k + kWarps;  // per warp: the least candidate
  int* red_inv = red_first + kWarps;  // per warp: invB not finite
  int* red_flags = red_inv + kWarps;  // per warp: 1 ms, 2 w or qv bad
  int* red_p = red_flags + kWarps;  // per warp: p not finite
  signed char* sS = reinterpret_cast<signed char*>(red_p + kWarps);
  unsigned char* sReal = reinterpret_cast<unsigned char*>(sS + Nt);
  unsigned char* sInB = sReal + Nt;

  // ---- load the instance ---------------------------------------------------
  {
    const T* A = gA + inst * R * Nt;
    for (int e = tid; e < R * Nt; e += kThreads) sA[e] = A[e];
    const size_t o = inst * Nt;
    for (int j = tid; j < Nt; j += kThreads) {
      sc[j] = gc[o + j];
      sd[j] = gd[o + j];
      su[j] = gu[o + j];
      sx[j] = gx[o + j];
      scA[j] = gcA[o + j];
      sS[j] = gS[o + j];
      sReal[j] = greal[o + j];
      sInB[j] = 0;
    }
    const T* iv = ginv + inst * RR;
    for (int e = tid; e < RR; e += kThreads) inv[e] = W(iv[e]);
    for (int r = tid; r < R; r += kThreads) {
      sb[r] = gb[inst * R + r];
      sB[r] = (int)gB[inst * R + r];
    }
  }
  __syncthreads();
  for (int r = tid; r < R; r += kThreads) sInB[sB[r]] = 1;
  for (int e = tid; e < RR; e += kThreads) {
    const int i = e / R, r = e - i * R;
    sAB[e] = sA[(size_t)i * Nt + sB[r]];
  }
  __syncthreads();

  const W inf = inf_t<W>();
  const W wtol = tol;
  // the R-vector loops of one thread each run on the block's last threads,
  // which have the fewest product tiles and columns
  const int hi = kThreads - 1 - tid;
  int it = 0, status = 0;
  bool done = false;
  while (!done && it < max_iter) {
    ++it;
    // ---- the Newton refresh: M = 2I - A_B invB, then invB M --------------
    rr_product(sAB, inv, R, [&](int e, int i, int j, W s) {
      sM[e] = (i == j ? W(2) : W(0)) - s;
    });
    __syncthreads();
    rr_product(inv, sM, R, [&](int e, int, int, W s) { alt[e] = s; });
    __syncthreads();
    {
      W* t = inv;
      inv = alt;
      alt = t;
    }

    // ---- the drift of the refreshed inverse, w, b - A x_N ----------------
    {
      W dmax = W(0);
      bool bad = false;
      rr_product(sAB, inv, R, [&](int e, int i, int j, W s) {
        dmax = nan_max(dmax, abs_t(s - (i == j ? W(1) : W(0))));
        bad |= !finite_t(inv[e]);
      });
      // four rows a warp at a time, each lane its columns, a shuffle sum
      for (int i0 = warp; i0 < R; i0 += 4 * kWarps) {
        W s[4] = {W(0), W(0), W(0), W(0)};
        const T* Ai = sA + (size_t)i0 * Nt;
        const size_t step = (size_t)kWarps * Nt;
        for (int j = lane; j < Nt; j += 32) {
          if (sInB[j]) continue;
          const W xj = sx[j];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (i0 + q * kWarps < R) s[q] += W(Ai[q * step + j]) * xj;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          for (int o = 16; o > 0; o >>= 1)
            s[q] += __shfl_xor_sync(kFull, s[q], o);
          const int i = i0 + q * kWarps;
          if (lane == 0 && i < R) sres[i] = W(sb[i]) - s[q];
        }
      }
      for (int i = hi; i < R; i += kThreads) {
        W s = W(0);
        for (int r = 0; r < R; ++r) s += inv[r * R + i] * W(sc[sB[r]]);
        sw[i] = s;
      }
      for (int o = 16; o > 0; o >>= 1)
        dmax = nan_max(dmax, __shfl_xor_sync(kFull, dmax, o));
      bad = __any_sync(kFull, bad);
      if (lane == 0) {
        red_drift[warp] = dmax;
        red_inv[warp] = bad;
      }
    }
    __syncthreads();

    // ---- qv = invB (b - A x_N); h = c - A' w and the pricing -------------
    {
      bool vbad = false;
      for (int i = hi; i < R; i += kThreads) {
        W s = W(0);
        for (int r = 0; r < R; ++r) s += inv[i * R + r] * sres[r];
        sqv[i] = s;
        vbad |= !finite_t(s) || !finite_t(sw[i]);
      }
      W best = -inf;
      int kbest = Nt, first = Nt;
      bool ms = false;
      for (int j = tid; j < Nt; j += kThreads) {
        W s = W(0);
        for (int i = 0; i < R; ++i) s += W(sA[(size_t)i * Nt + j]) * sw[i];
        const W h = W(sc[j]) - s;
        const W ht = sS[j] == kDn ? -h : h;
        if (!sInB[j] && sReal[j] && su[j] - sd[j] > T(0)) {
          if (ht > wtol) {
            const W score = ht / W(scA[j]);
            if (before_max(score, j, best, kbest)) {
              best = score;
              kbest = j;
            }
            if (j < first) first = j;
          }
          if (abs_t(ht) < wtol) ms = true;
        }
      }
      warp_arg<true>(best, kbest);
      for (int o = 16; o > 0; o >>= 1)
        first = min(first, __shfl_xor_sync(kFull, first, o));
      ms = __any_sync(kFull, ms);
      vbad = __any_sync(kFull, vbad);
      if (lane == 0) {
        red_score[warp] = best;
        red_k[warp] = kbest;
        red_first[warp] = first;
        red_flags[warp] = (ms ? 1 : 0) | (vbad ? 2 : 0);
      }
    }
    __syncthreads();

    // ---- every thread: the entering column; p = invB A_k and each basic
    // row's bound distance (four rows a warp, each lane its terms) ---------
    W best = red_score[0], dmax = red_drift[0];
    int kbest = red_k[0], first = red_first[0];
    int flags = red_flags[0] | (red_inv[0] ? 2 : 0);
    for (int v = 1; v < kWarps; ++v) {
      if (before_max(red_score[v], red_k[v], best, kbest)) {
        best = red_score[v];
        kbest = red_k[v];
      }
      first = min(first, red_first[v]);
      flags |= red_flags[v] | (red_inv[v] ? 2 : 0);
      dmax = nan_max(dmax, red_drift[v]);
    }
    const bool anyc = first < Nt;
    // no candidate: k is unused (torch's argmax of all -inf gives 0)
    const int k = !anyc ? 0 : (it > Nt ? first : kbest);
    const bool kd = sS[k] == kDn;
    {
      bool pbad = false;
      for (int i0 = warp; i0 < R; i0 += 4 * kWarps) {
        W s[4] = {W(0), W(0), W(0), W(0)};
        for (int r = lane; r < R; r += 32) {
          const W ak = sA[(size_t)r * Nt + k];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (i0 + q * kWarps < R)
              s[q] += inv[(i0 + q * kWarps) * R + r] * ak;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          for (int o = 16; o > 0; o >>= 1)
            s[q] += __shfl_xor_sync(kFull, s[q], o);
          const int i = i0 + q * kWarps;
          if (lane == 0 && i < R) {
            const W pi = s[q];
            sp[i] = pi;
            pbad |= !finite_t(pi);
            const bool pos = pi > wtol, neg = pi < -wtol;
            const W ps = pi == W(0) ? W(1) : pi;
            const int bi = sB[i];
            const W lo = (sqv[i] - W(sd[bi])) / ps;
            const W hi_g = (sqv[i] - W(su[bi])) / ps;
            sg[i] = kd ? (pos ? lo : (neg ? hi_g : inf))
                       : (pos ? hi_g : (neg ? lo : -inf));
          }
        }
      }
      if (lane == 0) red_p[warp] = pbad;
    }
    __syncthreads();

    // ---- every thread: the leaving row and the decision (each warp the
    // same), then the exchange: x2 with the leaving bound, S, B, invB -------
    {
      W gl = kd ? inf : -inf;
      int l = R;
      for (int i = lane; i < R; i += 32) {
        const W g = sg[i];
        if (kd ? before_min(g, i, gl, l) : before_max(g, i, gl, l)) {
          gl = g;
          l = i;
        }
      }
      if (kd)
        warp_arg<false>(gl, l);
      else
        warp_arg<true>(gl, l);
      bool pbad = false;
      for (int v = 0; v < kWarps; ++v) pbad |= red_p[v] != 0;
      const T dk = sd[k], uk = su[k];
      const bool fuk = finite_t(uk);
      const bool flip = kd ? (fuk && gl >= W(uk - dk)) : (gl <= W(dk - uk));
      const bool unbounded = anyc && kd && !fuk && !finite_t(gl);
      const bool numbad =
          (flags & 2) != 0 || (anyc && pbad) || dmax > W(drift_tol);
      const bool go = anyc && !numbad && !unbounded;
      const bool pivot = go && !flip, bflip = go && flip;
      done = numbad || !anyc || unbounded;
      status = numbad ? -1
               : !anyc ? ((flags & 1) ? 2 : 1)
               : unbounded ? 3
                           : 0;
      const W yl = sp[l];
      const bool pos_l = yl > wtol;
      const signed char Sl = kd ? (pos_l ? kDn : kUp) : (pos_l ? kUp : kDn);
      // each basic row's thread owns its column's x, S, in-basis flag and B
      for (int r = tid; r < R; r += kThreads) {
        const int bi = sB[r];
        if (pivot && r == l) {
          sx[bi] = Sl == kDn ? sd[bi] : su[bi];
          sS[bi] = Sl;
          sInB[bi] = 0;
          sB[r] = k;
          sS[k] = kIn;
          sInB[k] = 1;
        } else {
          sx[bi] = T(sqv[r]);
        }
      }
      if (bflip && tid == 0) {
        sx[k] = kd ? su[k] : sd[k];
        sS[k] = kd ? kUp : kDn;
      }
      if (pivot) {
        const W y = abs_t(yl) > W(0) ? yl : W(1);
        const W* rl = inv + l * R;
        for (int e = tid; e < RR; e += kThreads) {
          const int i = e / R, j = e - i * R;
          const W f = (sp[i] - (i == l ? W(1) : W(0))) / y;
          alt[e] = inv[e] - f * rl[j];
        }
        // A_B's column l is now A's column k
        for (int i = tid; i < R; i += kThreads)
          sAB[i * R + l] = sA[(size_t)i * Nt + k];
      }
      __syncthreads();
      if (pivot) {
        W* t = inv;
        inv = alt;
        alt = t;
      }
    }
  }

  // ---- write back ----------------------------------------------------------
  const size_t o = inst * Nt;
  for (int j = tid; j < Nt; j += kThreads) {
    gx[o + j] = sx[j];
    gS[o + j] = sS[j];
  }
  for (int r = tid; r < R; r += kThreads) gB[inst * R + r] = sB[r];
  if (tid == 0) {
    gstatus[inst] = done ? status : -max_iter;
    git[inst] = it;
  }
}

cudaError_t optin_smem(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev);
}

template <typename T>
int run_simplex(const T* c, const T* A, const T* b, const T* d, const T* u,
                const unsigned char* real, const T* cA, const T* invB,
                const unsigned char* pre_done, long long* B, signed char* S,
                T* x, int* status, int* it, int Bn, int R, int Nt, double tol,
                double drift_tol, int max_iter, void* stream_ptr) {
  if (Bn <= 0) return 0;
  if (R <= 0 || Nt <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t bytes = simplex_smem_bytes<T>(R, Nt);
  int optin = 0;
  cudaError_t e = optin_smem(&optin);
  if (e != cudaSuccess) return (int)e;
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  auto kern = simplex_kernel<T>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kern,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  kern<<<Bn, kThreads, bytes, stream>>>(c, A, b, d, u, real, cA, invB,
                                        pre_done, B, S, x, status, it, R, Nt,
                                        (T)tol, (T)drift_tol, max_iter);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The block's shared memory for one instance of R rows and Nt columns
// (f64: 0 float32, 1 float64); ops/simplex.py::smem_bytes is the same sum.
long long ssqp_simplex_smem_bytes(int R, int Nt, int f64) {
  return (long long)(f64 ? simplex_smem_bytes<double>(R, Nt)
                         : simplex_smem_bytes<float>(R, Nt));
}

// c, d, u, x, cA (Bn, Nt); A (Bn, R, Nt); b (Bn, R); invB (Bn, R, R); real,
// pre_done bytes (Bn, Nt) and (Bn,); B int64 (Bn, R), S int8 (Bn, Nt), all
// contiguous. B, S and x are the start, overwritten with the exit; status
// and it (Bn,) int32 receive the exit codes and the steps. Returns the first
// CUDA error of the launch (cudaErrorInvalidValue where the instance's state
// does not fit a block's shared memory), else cudaGetLastError() after it.
int ssqp_simplex_f32(const float* c, const float* A, const float* b,
                     const float* d, const float* u, const unsigned char* real,
                     const float* cA, const float* invB,
                     const unsigned char* pre_done, long long* B,
                     signed char* S, float* x, int* status, int* it, int Bn,
                     int R, int Nt, double tol, double drift_tol, int max_iter,
                     void* stream) {
  return run_simplex<float>(c, A, b, d, u, real, cA, invB, pre_done, B, S, x,
                            status, it, Bn, R, Nt, tol, drift_tol, max_iter,
                            stream);
}

int ssqp_simplex_f64(const double* c, const double* A, const double* b,
                     const double* d, const double* u,
                     const unsigned char* real, const double* cA,
                     const double* invB, const unsigned char* pre_done,
                     long long* B, signed char* S, double* x, int* status,
                     int* it, int Bn, int R, int Nt, double tol,
                     double drift_tol, int max_iter, void* stream) {
  return run_simplex<double>(c, A, b, d, u, real, cA, invB, pre_done, B, S, x,
                             status, it, Bn, R, Nt, tol, drift_tol, max_iter,
                             stream);
}

}  // extern "C"
