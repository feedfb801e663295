"""At-scale checks of the PyTorch/CUDA port (ssqp_tpu_torch) on one NVIDIA
GPU, and the hand-written kernels' table: each kernel against its plain
version, its device time beside the plain version's, a library yardstick
(where one exists) and its bound, and ptxas's registers and spills.

    python3 chip_smoke.py

End-to-end speed is the benchmark's (gpubench/run.py, its --trace 1
breakdown, gpubench/program.py); nothing here times a solve.

Phases (one line each; any failure raises and the exit code is not 0):

  1. device     — requires CUDA; prints the card's name and power limit;
  2. build      — compiles the CUDA kernels from ssqp_tpu_torch/ops/csrc
                  (one nvcc per source, started together);
  3. kernel     — the fused CG kernel against its plain PyTorch version on
                  the card (f32 and f64; shared V at N=256, odd shapes,
                  per-instance V; the main paths' row counts, config 8's
                  at N=512 and 1024 and config 7's one-instance launches
                  at N=14 and N=263, f64 there and at config 8's audit),
                  what a tile's shared exit costs at the ineq shape, and
                  the kernel's, the plain version's and one float32
                  matmul's times at the five timed shapes (config 8's at
                  N=1024 among them) with the FFMA- and 3xTF32-route
                  bounds, and the float64 bodies' at N=1024 and at config
                  4's widths (N=512, 111 rows an instance: the DMMA body
                  where the rule takes it) with the DMMA bound (the card's
                  higher float64 rate; DFMA beside it) and the first
                  body's times kept in PERF.md §6;
  4. chol       — the batched Cholesky kernel against its plain version on
                  the card (f32, at the ineq path's and the LP path's
                  shapes, the blocked body's panel edges, the direct N x N
                  solve, non-PD instances), and the times of the kernel, of
                  the plain version and of the library pair (cholesky_ex +
                  cholesky_solve) at the ineq path's five shapes and the
                  LP path's two;
  5. simplex    — the simplex kernel (ops/csrc/simplex.cu) against the
                  host loop on the same card tensors at lp-mixed256's shape
                  (config 2's mixed batch, B=256, R=25, Nt=245), Phase 1 and
                  Phase 2 of four batches in float32 and in float64; its
                  launches through solve_lp_batch_auto (one a phase) and
                  the registry's simplex.launches record; the times of one
                  batch's two launches (CUDA events), of the host loop
                  (host clock) and the bound from the FMA count;
  6. main       — the frontier-QP path through solve_qp_batch_auto at
                  N=256, float32, on each route the JAX rule picks: B=2048
                  (plain), B=8192 (waves=8, checked) and B=4096 (PDAS
                  compaction (2, 4, 8), checked), and the B=8192 batch
                  through solve_qp_batch_c2f (coarse=8), with the kernels'
                  launch counts per route, the S-iterations per wave and
                  the instances the waves' rescue re-solved;
  7. audit      — 256 instances each of the B=2048 (plain) and B=8192
                  (waves) batches re-solved in float64 on the card;
                  objective gap and ||x - z||_inf quantiles, max gap < 1e-6;
  8. ineq       — the general-inequality path at BASELINE config 4's widths
                  (N=512, M=10, J=100, float32, B_INEQ instances with shared
                  V, A, b, G, g, d, u and varying q) through
                  solve_qp_batch_auto, which takes the plain protocol and the
                  tail refinement; feasibility, launch counts, S-iterations
                  and how many instances the tail refined;
  9. ineq-audit — 32 of those instances re-solved in float64 on the card;
                  objective gap and ||x - z||_inf quantiles, max gap < 1e-6;
 10. refined    — the frontier problem in float64 at N=512, B=256 through
                  solve_qp_batch_refined (float32 search) with method "cg"
                  and "lu": within 1e-9 of the plain float64 solve on the
                  card where the search labeled as float64 does, objective
                  gap < 1e-6 everywhere, the tiers within 1e-9 of each
                  other; one solve_qp_refined_dd at N=32;
 11. lp         — BASELINE config 2's LP routes (bench_suite.py::config2's
                  generators, float32): the mixed batch (c, b, g per
                  instance) at B=256 and 4096 through solve_lp_batch_auto
                  (plain), the c-grid (waves=8) and the rhs grid (dual
                  waves=8) at B=256, and criss-cross at N=40, B=256 through
                  solve_lp_batch_cclp_rescued; per route the status
                  histogram and the kernels' launches; every instance
                  status 1/2 or the float64 solve's status, optima feasible,
                  float32 within 5e-5 of the port's float64 solve on the
                  card, and 32 instances of that within 1e-7 of scipy's
                  HiGHS;
 12. outer      — the outer layers on bench.py's frontier problem and the
                  BASELINE configs, float32 unless said: (a) the five
                  frontier sweeps (batch B=2048, waves=8 B=8192, warm over
                  128 points, mu B=2048 and mu warm over 128 points, the mu
                  grids inside the returns the batch sweep reached): every
                  point solved, ret and risk as x gives them, 1'x = 1 and
                  r'x = mu within the float32 tolerance 2^-16, 256 points
                  per sweep (all 128 of a warm one) re-solved in float64 on
                  the card at the grid's values within 1e-6 objective
                  gap; (b) solve_qp_diff on 256 frontier points in
                  float64 and float32 with a backward pass of sum(w x) in
                  q, b and u: the envelope identity (1e-8), central
                  differences along 4 random directions on 8 instances
                  (1e-5 relative), an infeasible instance's gradient exactly
                  0; (c) config 4 (N=512, M=10,
                  J=100) through the Model API in float32 and float64,
                  optimize -> write_mps -> read_mps -> optimize (the same
                  status, arrays identical, objective within 1e-6 of the
                  direct solve_qp and of float64; the Cholesky kernel in
                  float32), config 2's LP through the Model and solve_mps
                  (OPTIMAL, within 5e-5 of float64, the Cholesky kernel),
                  kkt_report on config 4 and the batch sweep, trace() around
                  one batch sweep; (d) a world-size-1 NCCL group:
                  solve_qp_sharded at B=8192 identical to
                  solve_qp_batch_auto with 8192 solved, solve_lp_sharded on
                  config 2's mixed batch at B=256 identical to
                  solve_lp_batch_auto; (e) warmup(((256, 1, 0),), batch=256).
                  Every phase-11 QP route launches the CG kernel;
 13. pdas       — the PDAS rounds' variants (Settings.pdas_pcg, the W-PCG,
                  and Settings.pdas_cheb, the Chebyshev semi-iteration)
                  against the default rounds on the frontier at N=256,
                  B=2048, float32, through solve_qp_batch_auto (plain):
                  shared_jacobi_bounds with and without W around the
                  Jacobi-scaled spectrum (float64 eigvalsh on the card);
                  per flag all solved, the PDAS rounds and their widths,
                  the inner solve's iterations per round, CG launches by
                  body, S against the default's (where it differs, within
                  1e-6 objective gap of the float64 solve);
 14. config7    — bench_suite.py::config7 on the port's ungil_like (N=14,
                  M=2, J=2, shortable) and sp500_like (N=263, condition
                  ~1e6-1e8) from ssqp_tpu_torch/utils/problems.py: the
                  coarse warm L-sweep (64 points), the coarse warm mu sweep
                  and its segments, the fine warm mu sweep (16 points per
                  segment, subsampled or padded to 256), the fine warm L
                  sweep (256 geometric points), each run once with every
                  point solved, S-iterations and CG launches; 96 points of
                  the fine mu sweep refined in float64 (refine_result, LU)
                  and audited against the port's float64 solve on the card:
                  objective gap and ||x - z||_inf quantiles, refined max gap
                  < 1e-6;
 15. config8    — bench_suite.py::config8's frontier at N=512 and N=1024,
                  B=8192, float32, through solve_qp_batch_auto (waves=8
                  and the N >= 512 tail): all solved, the tail's passes
                  and accepted corrections, CG launches by body, 256
                  instances audited against float64 on the card (max gap
                  < 1e-6 after the tail; the gap before it printed).

Each phase's host wall time is printed as a [wall] line. Then one JSON
line with the refined phase's numbers, the LP routes', the outer layers',
phases 13-15's and the wall times (``wall_s``),
one JSON line with the kernel table (each kernel's launches on each route, for the Cholesky kernel also by (B, n, K) with the body each shape
takes, its worst error against the plain version, its time, the plain
version's, the library call's, the bound and ptxas's registers and spills),
the nvidia-smi line, and, last,
``{"ok": true, "device": {...}}``. The frontier problem is the headline
benchmark's (bench.py): seed 7, V = HH'/N + 0.5 I, mu ~ U(0, 0.2),
0 <= x <= 4/N. The ineq problem is bench_suite.py::config4's generator, seed
4: V = HH'/N + 0.5 I, b = A x0, g = G x0 + U(0.1, 1), d = x0 - 2, u = x0 + 2,
q ~ N(0, 1) per instance.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

N_MAIN = 256
B_AUTO = 2048
B_MID = 4096
B_BIG = 8192
N_REF, B_REF = 512, 256  # the refined tier's frontier, float64 data
N_DD = 32
F32_TOL = 5e-4  # kernel vs plain, max |dX| (tests/test_pallas_cg.py's bound)
F64_TOL = 1e-9
# Cholesky kernel vs plain version: max |dX| <= CHOL_TOL * max |X| on SPD
# batches of condition number 100 (one float32 recurrence, two summation
# orders)
CHOL_TOL = 1e-4
N_INEQ, M_INEQ, J_INEQ = 512, 10, 100
B_INEQ = 256
INEQ_SHARED = ("V", "A", "G", "b", "g", "d", "u")
FEAS_TOL = 1e-4  # ineq primal feasibility, scaled by 1 + |b|, |g|, |d|, |u|
# H100 SXM data sheet: float32 outside the tensor cores, TF32 on them, HBM3
# bandwidth. The card's power limit is printed beside.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12  # dense, tensor cores
PEAK_F64_FLOPS = 34e12  # outside the tensor cores (the CG kernel's DFMA)
PEAK_F64_TC_FLOPS = 67e12  # on the tensor cores (DMMA, as cuBLAS's DGEMM)
PEAK_BYTES = 3.35e12
SPIN_CYCLES = 10_000_000  # cuda_time's lead: ~5 ms at the H100's clocks
# bench_suite.py::config8: the frontier at N=512 and 1024, B=8192, and the
# float64 audit's instances
C8_N, C8_B, C8_AUDIT = (512, 1024), 8192, 256


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cg_problem(torch, rng, N, K, batch, dtype, per_instance=False):
    """Random SPD systems in the kernel's batch layout (CPU numpy -> card)."""
    def spd():
        H = rng.standard_normal((N, N))
        return H @ H.T / N + 0.5 * np.eye(N)
    V = np.stack([spd() for _ in range(batch)]) if per_instance else spd()
    FM = (rng.uniform(size=(batch, N)) < 0.7).astype(np.float64)
    diagV = np.diagonal(V, axis1=-2, axis2=-1)
    DINV = 1.0 / (FM * diagV + (1.0 - FM))
    B = rng.standard_normal((batch, N, K))
    TOL2 = 1e-10 * np.maximum((B * B).sum(1), 1e-30)
    if dtype == torch.float64:
        TOL2 = 1e-24 * np.maximum((B * B).sum(1), 1e-30)
    dev = torch.device("cuda")
    t = lambda a: torch.tensor(a, dtype=dtype, device=dev)
    return t(V), t(FM), t(B), t(DINV), t(TOL2), torch.zeros((batch, N, K),
                                                            dtype=dtype,
                                                            device=dev)


def cuda_time(torch, fn, reps=5):
    """Device time of one call of ``fn`` in ms, the mean over ``reps`` calls
    after one warm-up. A spin kernel (~5 ms) runs first, so that the calls
    queue up behind it and run back to back: a call shorter than its host
    overhead is timed on the device, not at the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# The fused CG kernel's timed shapes: (label, rows C, N, cold steps). The
# frontier's rows at B=2048 and B=8192 (K=2), and the ineq path's 256
# instances x 111 columns at the tail sweep's 96 steps.
CG_TIMED = (("frontier C=4096", 2 * B_AUTO, N_MAIN, 64),
            ("frontier C=16384", 2 * B_BIG, N_MAIN, 64),
            ("ineq C=28416", B_INEQ * (1 + M_INEQ + J_INEQ), N_INEQ, 96),
            # config 8 at the tensor-core body's edge: the batch's rows and
            # a tail pass's (B/4 instances, the correction's 96 steps)
            ("config8 C=16384", 2 * C8_B, 1024, 64),
            ("config8 tail C=4096", 2 * C8_B // 4, 1024, 96))
# The float64 body at N=1024: the float64 audit's rows and the tail pass's
# rows (on the card the tail corrects in float32; float64 data on a CPU
# tensor would correct at this shape in float64)
CG_TIMED_F64 = (("config8 audit C=512 f64", 2 * C8_AUDIT, 1024, 64),
                ("config8 tail shape C=4096 f64", 2 * C8_B // 4, 1024, 64))
# Config 4's float64 launches (111 rows an instance at N=512): the batch of
# 256 at 64 steps and at float64's 128-step CG budget, a quarter batch, one
# instance (the single-problem search's rows)
K_C4 = 1 + M_INEQ + J_INEQ
CG_TIMED_C4 = (("config4 C=28416 f64", B_INEQ * K_C4, N_INEQ, 64),
               ("config4 C=28416 f64 128", B_INEQ * K_C4, N_INEQ, 128),
               ("config4 C=7104 f64", B_INEQ // 4 * K_C4, N_INEQ, 64),
               ("config4 single C=111 f64", K_C4, N_INEQ, 64))
# The first body's times at these shapes as PERF.md §6 keeps them (ms, the
# midpoint of the runs there; the same tol2 = 0 launches on an H100 80GB
# HBM3 at 700 W), printed beside this run's
FIRST_BODY_MS = {"config8 audit C=512 f64": 16.16,
                 "config8 tail shape C=4096 f64": 121.05,
                 "config4 C=28416 f64": 115.1,
                 "config4 C=28416 f64 128": 226.3,
                 "config4 C=7104 f64": 29.5,
                 "config4 single C=111 f64": 4.27}


def phase_kernel(torch):
    from ssqp_tpu_torch.ops import cg

    rng = np.random.default_rng(11)
    worst = 0.0
    cases = [("N=256 K=2 batch=2048 shared V", 256, 2, 2048, False, 200),
             ("N=13 K=3 batch=5 shared V", 13, 3, 5, False, 300),
             ("N=256 K=2 batch=64 per-instance V", 256, 2, 64, True, 200)]
    # the main paths' other row counts in float32: the frontier at B=8192
    # (C=16384); the ineq path's 1+R = 111 columns at N=512 for its tail
    # passes of 64 instances (C=7104) and its whole batch (C=28416), at the
    # tail sweep's 96 steps
    K_INEQ = 1 + M_INEQ + J_INEQ
    main_rows = [("N=256 K=2 batch=8192 shared V", N_MAIN, 2, B_BIG, False,
                  200)] + [
        (f"N={N_INEQ} K={K_INEQ} batch={b} shared V", N_INEQ, K_INEQ, b,
         False, 96) for b in (B_INEQ // 4, B_INEQ)] + [
        # config 8 (phase 15): the batch at N=512 and 1024 and a tail pass
        (f"N={n} K=2 batch={C8_B} shared V", n, 2, C8_B, False, 64)
        for n in C8_N] + [
        (f"N=1024 K=2 batch={C8_B // 4} shared V", 1024, 2, C8_B // 4,
         False, 96)]
    # config 7 (phase 14): one instance's rows, 1+R = 6 at ungil's N=14 and
    # 3 at sp500's N=263 (the tensor-core body's 8-wide tile, ragged k-tail)
    c7_rows = [("N=14 K=6 batch=1 shared V", 14, 6, 1, False, 200),
               ("N=263 K=3 batch=1 shared V", 263, 3, 1, False, 200)]
    main_rows += c7_rows
    # config 8's float64 audit at N=1024, config 7's float64 references and
    # config 4's float64 rows (the batch, a quarter of it, one instance)
    f64_rows = [(f"N=1024 K=2 batch={C8_AUDIT} shared V", 1024, 2, C8_AUDIT,
                 False, 64)] + c7_rows + [
        (f"N={N_INEQ} K={K_INEQ} batch={b} shared V", N_INEQ, K_INEQ, b,
         False, 128) for b in (B_INEQ, B_INEQ // 4, 1)]
    for dtype, tol, extra in ((torch.float32, F32_TOL, main_rows),
                              (torch.float64, F64_TOL, f64_rows)):
        for name, N, K, batch, per, iters in cases + extra:
            V, FM, B, DINV, TOL2, X0 = cg_problem(torch, rng, N, K, batch,
                                                  dtype, per)
            Xk, rrk = cg.cg_padded_batch(V, FM, B, DINV, TOL2, iters, X0)
            Br, X0r, fmr, dinvr, tol2r = cg._rows(B, FM, DINV, TOL2, X0)
            inst = None
            if per:
                inst = torch.arange(batch, dtype=torch.int32,
                                    device=B.device).repeat_interleave(K)
            Xp, rrp = cg.cg_rows_reference(V, fmr, dinvr, Br, tol2r, iters,
                                           X0r, inst)
            torch.cuda.synchronize()
            Xp = Xp.reshape(batch, K, N).transpose(1, 2)
            err = float((Xk - Xp).abs().max())
            conv = rrp.reshape(batch, K) <= TOL2
            rr_ok = bool((rrk[conv] <= 1.01 * TOL2[conv] + 1e-30).all())
            n_conv = int(conv.sum())
            log("kernel", f"{str(dtype)[6:]} {name} "
                f"({cg.body(batch * K, N, dtype, not per)} body): max|dX| "
                f"{err:.3e} (tol {tol:g}), converged rows {n_conv}/"
                f"{batch * K} rr<=1.01*tol2 {rr_ok}")
            if not (err <= tol and rr_ok and np.isfinite(err)):
                raise RuntimeError(f"kernel disagrees with plain version: {name}")
            worst = max(worst, err)

    exits = tile_exit_cost(torch, cg, rng)

    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmul is on: gemm_ms would not be float32")
    times = {}
    for label, C, N, steps in CG_TIMED:
        V, FM, B, DINV, TOL2, X0 = cg_problem(torch, rng, N, 1, C,
                                              torch.float32)
        TOL2 = torch.zeros_like(TOL2)  # never converges: exactly `steps`
        Br, X0r, fmr, dinvr, tol2r = cg._rows(B, FM, DINV, TOL2, X0)
        kern = lambda: cg.cg_padded_rows(V, fmr, dinvr, Br, tol2r, steps,
                                         X0r)
        plain = lambda: cg.cg_rows_reference(V, fmr, dinvr, Br, tol2r, steps,
                                             X0r)
        # one step's product as one float32 library call (TF32 off), the
        # yardstick of the matvec's cost; the port never calls it
        gemm = lambda: torch.matmul(Br, V.T)
        tk1, tp1, tg1 = (cuda_time(torch, kern), cuda_time(torch, plain),
                         cuda_time(torch, gemm))
        tg2, tp2, tk2 = (cuda_time(torch, gemm), cuda_time(torch, plain),
                         cuda_time(torch, kern))
        b_ffma, by_ffma = cg_bound(C, N, steps)
        b_tc, by_tc = cg_bound_3xtf32(C, N, steps)
        t = {"ms": min(tk1, tk2), "plain_ms": min(tp1, tp2),
             "gemm_ms": steps * min(tg1, tg2),
             "bound_ffma_ms": b_ffma, "bound_ffma_by": by_ffma,
             "bound_3xtf32_ms": b_tc, "bound_3xtf32_by": by_tc}
        times[label] = t
        log("kernel", f"f32 {label} N={N} {steps} cold steps: kernel "
            f"{t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, gemm x steps "
            f"{t['gemm_ms']:.3f} ms, bound FFMA {b_ffma:.3f} ms "
            f"({100 * b_ffma / t['ms']:.1f}%), bound 3xTF32 {b_tc:.3f} ms "
            f"({100 * b_tc / t['ms']:.1f}%) (runs {tk1:.3f}/{tk2:.3f}, "
            f"{tp1:.3f}/{tp2:.3f}, {tg1:.4f}/{tg2:.4f})")
    for label, C, N, steps in CG_TIMED_F64 + CG_TIMED_C4:
        V, FM, B, DINV, TOL2, X0 = cg_problem(torch, rng, N, 1, C,
                                              torch.float64)
        TOL2 = torch.zeros_like(TOL2)
        Br, X0r, fmr, dinvr, tol2r = cg._rows(B, FM, DINV, TOL2, X0)
        kern = lambda: cg.cg_padded_rows(V, fmr, dinvr, Br, tol2r, steps,
                                         X0r)
        plain = lambda: cg.cg_rows_reference(V, fmr, dinvr, Br, tol2r, steps,
                                             X0r)
        tk1, tp1 = cuda_time(torch, kern), cuda_time(torch, plain)
        tp2, tk2 = cuda_time(torch, plain), cuda_time(torch, kern)
        b, by = cg_bound(C, N, steps, torch.float64)
        b_dfma, by_dfma = cg_bound(C, N, steps, torch.float64,
                                   PEAK_F64_FLOPS)
        t = {"ms": min(tk1, tk2), "plain_ms": min(tp1, tp2), "bound_ms": b,
             "bound_by": by, "bound_dfma_ms": b_dfma,
             "bound_dfma_by": by_dfma, "dtype": "f64",
             "body": cg.body(C, N, torch.float64, True)}
        times[label] = t
        log("kernel", f"f64 {label} N={N} {steps} cold steps ({t['body']} "
            f"body): kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, "
            f"bound DMMA {b:.3f} ms ({100 * b / t['ms']:.1f}%), bound DFMA "
            f"{b_dfma:.3f} ms ({100 * b_dfma / t['ms']:.1f}%) (runs "
            f"{tk1:.3f}/{tk2:.3f}, {tp1:.3f}/{tp2:.3f}); the first body's "
            f"time kept in PERF.md, not measured here: "
            f"{FIRST_BODY_MS[label]:.2f} ms")
    return worst, times, exits


def tile_exit_cost(torch, cg, rng):
    """What a tile's shared exit costs at the ineq path's shape (N=512, 111
    columns x 256 instances): a tile runs until its last row converges
    (checked every 8 steps), so its frozen rows ride along. From the
    kernel's own converged flags after 8, 16, ..., 96 steps: the row-steps
    the tiles run over the row-steps each row needs (at the 8-step check),
    for this launch's tile and for 16-row tiles, with the smoke's tolerance
    (rtol 1e-5) and with tolerances spread over 1e-5 .. 1e-1."""
    N, K, batch = N_INEQ, 1 + M_INEQ + J_INEQ, B_INEQ
    V, FM, B, DINV, TOL2, X0 = cg_problem(torch, rng, N, K, batch,
                                          torch.float32)
    Br, X0r, fmr, dinvr, tol2r = cg._rows(B, FM, DINV, TOL2, X0)
    C = Br.shape[0]
    spread = torch.tensor(10.0 ** rng.uniform(-5, -1, (C, 1)),
                          dtype=torch.float32, device=Br.device)
    out = {}
    for label, tol in (("rtol 1e-5", tol2r),
                       ("rtol 1e-5..1e-1", spread * spread
                        * (Br * Br).sum(1, keepdim=True))):
        chunks = list(range(8, 97, 8))
        conv = torch.stack([
            (cg.cg_padded_rows(V, fmr, dinvr, Br, tol, it, X0r)[1] <= tol)
            .squeeze(1) for it in chunks], 1)  # (C, 12)
        # steps a row needs at the 8-step check: the first converged chunk
        first = torch.where(conv.any(1), conv.float().argmax(1),
                            torch.full((C,), len(chunks) - 1,
                                       device=conv.device))
        row_steps = (first + 1) * 8
        res = {}
        for tr in (cg.tile_rows(C, N), 16):
            pad = (-C) % tr
            rs = torch.cat([row_steps, row_steps.new_zeros(pad)])
            tile_steps = rs.view(-1, tr).max(1).values
            res[tr] = float(tile_steps.sum() * tr) / float(row_steps.sum())
        out[label] = {"row_steps_mean": float(row_steps.float().mean()),
                      "row_steps_max": int(row_steps.max()),
                      "tile_over_row": res}
        log("kernel", f"tile exit, N={N} C={C} {label}: rows need "
            f"{out[label]['row_steps_mean']:.1f} steps on average (max "
            f"{out[label]['row_steps_max']}); tiles run "
            + ", ".join(f"{v:.4f}x at {k} rows" for k, v in res.items())
            + " of that")
    return out


def ptxas_summary(text):
    """[(kernel, registers, spill stores, spill loads, shared bytes)] from
    ptxas's -v report."""
    import re

    rows, name, spill = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            rows.append((name, int(m.group(1)), spill[0], spill[1],
                         int(m.group(2) or 0)))
            name, spill = None, (0, 0)
    return rows


def bound(flops, nbytes, peak=PEAK_F32_FLOPS):
    """(least time in ms, what bounds it) against the card's published
    float32 (or ``peak``) and memory peaks."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def cg_bound(C, N, iters, dtype=None, peak=None):
    """One fused CG solve of C rows for ``iters`` steps (every row runs all
    of them here): per row and step the V matvec (2 N^2) and the vector
    updates and sums (~14 N); V, fm, dinv, B, X0 and tol2 read once, X and
    rr written once; float32, or float64 (8-byte words) when ``dtype`` is
    float64, at ``peak`` (by default the card's float32 rate outside the
    tensor cores, and for float64 its tensor-core DMMA rate, the higher of
    the card's two float64 rates)."""
    f64 = dtype is not None and dtype.itemsize == 8
    if peak is None:
        peak = PEAK_F64_TC_FLOPS if f64 else PEAK_F32_FLOPS
    return bound(iters * C * (2 * N * N + 14 * N),
                 (8 if f64 else 4) * (N * N + 5 * C * N + 2 * C), peak)


def cg_bound_3xtf32(C, N, iters):
    """The same solve with the V matvec as three TF32 tensor-core products
    (3 x 2 N^2 per row and step at 495 TFLOP/s) and the vector work at the
    float32 rate; the bytes as in :func:`cg_bound`."""
    t_ops = (3 * 2 * N * N * C * iters / PEAK_TF32_FLOPS
             + 14 * N * C * iters / PEAK_F32_FLOPS)
    t_bytes = 4 * (N * N + 5 * C * N + 2 * C) / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def chol_bound(B, n, K):
    """One factor-and-solve of B instances: n^3/3 FLOPs for the factor and
    2 n^2 K for the two substitutions; the upper triangle of A (n (n + 1) / 2
    words, all that the function reads of it) and RHS read once, X written
    once, float32."""
    return bound(B * (n**3 / 3 + 2 * n * n * K),
                 4 * B * (n * (n + 1) // 2 + 2 * n * K))


def spd_batch(rng, B, n, kappa=100.0):
    """SPD batch with eigenvalues log-spaced in [1, kappa]."""
    Qm, _ = np.linalg.qr(rng.standard_normal((B, n, n)))
    A = (Qm * np.logspace(0.0, np.log10(kappa), n)) @ Qm.transpose(0, 2, 1)
    return (A + A.transpose(0, 2, 1)) / 2


# The Cholesky kernel's timed shapes (B, n, K): the ineq path's batch and
# tail-pass widths at its n = R = 110 with the Schur and dual-recovery
# (K = 1), QR-purge (K = R) and dropped-row (K = J) right-hand sides; the
# LP path's dual recovery at config 2's n = M + J = 25 (B = 256 and 4096).
CHOL_TIMED = ((256, 110, 1), (256, 110, 110), (256, 110, 100), (64, 110, 1),
              (64, 110, 110), (256, 25, 1), (4096, 25, 1))
# Checked only: the direct N x N solve (the rank-1 body in device memory)
# and the panel edges of the blocked body (n = 16 k - 1, 16 k, 16 k + 1, the
# largest n that fits at K = 1).
CHOL_CHECKED = ((8, 512, 111), (64, 37, 3), (8, 16, 1), (8, 17, 3),
                (8, 31, 100), (8, 32, 1), (8, 33, 110), (8, 47, 4),
                (8, 111, 111), (8, 224, 1))


def phase_chol(torch):
    from ssqp_tpu_torch.ops import chol

    rng = np.random.default_rng(13)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda")
    data = {}
    worst = 0.0
    for B, n, K in CHOL_TIMED + CHOL_CHECKED:
        A, R = t(spd_batch(rng, B, n)), t(rng.standard_normal((B, n, K)))
        data[B, n, K] = (A, R)
        Xk = chol.chol_solve_batch(A, R)
        Xp = chol.chol_solve_reference(A, R)
        torch.cuda.synchronize()
        err = float((Xk - Xp).abs().max())
        tol = CHOL_TOL * float(Xp.abs().max())
        log("chol", f"f32 (B, n, K) = ({B}, {n}, {K}), {chol.body(n, K)} "
            f"body: max|dX| {err:.3e} (tol {tol:.3e})")
        if not err <= tol:
            raise RuntimeError(f"chol kernel disagrees with plain version at "
                               f"{(B, n, K)}")
        worst = max(worst, err)
    # a negative pivot inside a panel (instance 0), one on a panel boundary
    # (1), a NaN on the diagonal (2): no fault, no solution there, the other
    # instances as the plain version
    A = spd_batch(rng, 6, 110)
    A[0, 40, 40] = A[1, 48, 48] = -1.0
    A[2, 70, 70] = np.nan
    R = rng.standard_normal((6, 110, 1))
    Xk = chol.chol_solve_batch(t(A), t(R))
    Xp = chol.chol_solve_reference(t(A), t(R))
    Xn = Xk.double().cpu().numpy()
    bad = [not np.isfinite(Xn[b]).all()
           or np.abs(A[b] @ Xn[b] - R[b]).max() > 1e-2 for b in range(3)]
    err = float((Xk[3:] - Xp[3:]).abs().max())
    log("chol", f"non-PD instances: kernel returns no solution {bad}; the "
        f"other three max|dX| {err:.3e}")
    if not (all(bad) and err <= CHOL_TOL * float(Xp[3:].abs().max())):
        raise RuntimeError("chol kernel on non-PD input")

    times = {}
    for shape in CHOL_TIMED:
        A, R = data[shape]
        kern = lambda: chol.chol_solve_batch(A, R)
        plain = lambda: chol.chol_solve_reference(A, R)
        lib = lambda: torch.cholesky_solve(R, torch.linalg.cholesky_ex(A)[0])
        fns = {"ms": (kern, 20), "plain_ms": (plain, 5),
               "library_ms": (lib, 20)}
        runs = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]):  # each in turn, then back
            for k in order:
                runs[k].append(cuda_time(torch, *fns[k]))
        times[shape] = {k: min(v) for k, v in runs.items()}
        tm = times[shape]
        b, by = chol_bound(*shape)
        log("chol", f"f32 (B, n, K) = {shape}: kernel ({chol.body(*shape[1:])}"
            f") {tm['ms']:.4f} ms; plain {tm['plain_ms']:.3f} ms; library "
            f"{tm['library_ms']:.4f} ms; bound {b:.5f} ms ({by}, kernel at "
            f"{100 * b / tm['ms']:.1f}%) (runs " + ", ".join(
                f"{k} " + "/".join(f"{x:.4f}" for x in v)
                for k, v in runs.items()) + ")")
    return worst, times


# The simplex kernel at lp-mixed256's shape: config 2's mixed batch of
# B_LP = 256 (R = 25, Nt = 245), float32, four batches (phase 11's seeds),
# and the same LPs cast to float64
SIMPLEX_BATCHES = 4
SIMPLEX_AGREE = 0.99  # float32: share of instances with B, S and it equal
SIMPLEX_OBJ_REL = 1e-6  # float32: objective, kernel against the host loop


def simplex_bound(its, R, Nt, B, peak=PEAK_F32_FLOPS):
    """One launch of the simplex kernel for B instances that take ``its``
    steps in all: per step 3 R^3 FMA (the Newton refresh's two products
    and the drift's), 2 R Nt (A' w, A x_N) and 3 R^2 (w, qv, p), two FLOPs
    each, at ``peak`` (by default the card's float32 rate, the data's type,
    which equals its float64 tensor-core rate); A, c, d, u, x, the column
    norms, invB, b, B, S and the real mask read once, x, B, S, status and
    it written once, float32."""
    flops = 2 * its * (3 * R**3 + 2 * R * Nt + 3 * R * R)
    nbytes = B * (4 * (R * Nt + 5 * Nt + R * R + R) + 8 * R + 2 * Nt + 1) \
        + B * (4 * Nt + 8 * R + Nt + 8)
    return bound(flops, nbytes, peak)


def phase_simplex(torch):
    """The simplex kernel (ops/csrc/simplex.cu) against the host loop on the
    same card tensors at lp-mixed256's shape, Phase 1 and Phase 2 of each
    batch: float32 statuses equal, B, S and it equal on >= 99% of
    instances, objectives within 1e-6 relative where optimal; float64 all
    equal, x within 1e-9. Then one batch's launches through
    solve_lp_batch_auto (two, one a phase; the registry's record), and the
    times of one batch's Phase-1 and Phase-2 launches (CUDA events), the
    host loop's (host clock, it syncs every trip) and the bound at the
    float32 rate, with the float64 rate outside the tensor cores (the
    kernel's arithmetic, DFMA) beside."""
    from ssqp_tpu_torch import Settings
    from ssqp_tpu_torch.ops import simplex as ks
    from ssqp_tpu_torch.parallel.batch import solve_lp_batch_auto
    from ssqp_tpu_torch.solvers import lp as tlp
    from ssqp_tpu_torch.solvers import simplex as ts
    from ssqp_tpu_torch.utils import diagnostics

    def phases(P, st):
        prep = tlp._lp_prep(P.A, P.G, P.b, P.g, P.d, P.u, st, B_LP)
        A1, std = prep.A1, prep.std
        Bn, R, Nt = A1.shape
        z = lambda n, v: torch.full((Bn, n), v, dtype=A1.dtype,
                                    device=A1.device)
        c1 = torch.cat([z(Nt - R, 0.0), z(R, 1.0)], 1)
        start = tlp._lp_phase1(prep, st)
        u2, real2 = tlp._phase2_bounds(prep)
        c0 = tlp._lp_cost(prep, P.c, P.N, P.J, True)
        return ((c1, A1, prep.b0p, std.d1, std.u1, std.B0, std.S0, std.d1,
                 std.real),
                (c0, A1, prep.b0p, std.d1, u2, start.B, start.S, start.x,
                 real2))

    rows_eq = lambda a, b: (a == b).reshape(a.shape[0], -1).all(1)
    checks = []
    for i in range(SIMPLEX_BATCHES):
        P32, _ = lp_problem(torch, torch.float32, "mixed", i, B_LP)
        for P in (P32, P32.astype(torch.float64)):
            st = Settings.for_dtype(P.c.dtype)
            for ph, args in zip((1, 2), phases(P, st)):
                n0 = ks.LAUNCHES
                k = ts.bounded_simplex(*args, tol=st.tol,
                                       max_iter=st.max_iter)
                h = ts.bounded_simplex_loop(*args, tol=st.tol,
                                            max_iter=st.max_iter)
                torch.cuda.synchronize()
                if ks.LAUNCHES != n0 + 1:
                    raise RuntimeError("simplex: the kernel did not launch")
                agree = {n: float(rows_eq(k[j], h[j]).float().mean())
                         for n, j in (("B", 2), ("S", 3), ("it", 4))}
                fk = (args[0].double() * k[1].double()).sum(1)
                fh = (args[0].double() * h[1].double()).sum(1)
                opt = (h[0] == 1) | (h[0] == 2)
                rel = float(((fk - fh).abs() / fh.abs().clamp(min=1.0))[opt]
                            .max()) if bool(opt.any()) else 0.0
                dx = float((k[1].double() - h[1].double()).abs().max())
                f64 = P.c.dtype == torch.float64
                c = {"batch": i, "phase": ph, "dtype": str(P.c.dtype)[6:],
                     "status_equal": bool(torch.equal(k[0], h[0])),
                     "agree": agree, "max_obj_rel": rel, "max_dx": dx,
                     "optimal": int(opt.sum()),
                     "steps_mean": float(k[4].float().mean()),
                     "steps_max": int(k[4].max())}
                checks.append(c)
                log("simplex", f"batch {i} phase {ph} {c['dtype']}: statuses "
                    f"equal {c['status_equal']}, agree {agree}, objective "
                    f"{rel:.2e}, max|dx| {dx:.2e}, optimal {c['optimal']}/"
                    f"{B_LP}, steps mean {c['steps_mean']:.1f} max "
                    f"{c['steps_max']}")
                ok = c["status_equal"] and c["optimal"] == B_LP and (
                    (min(agree.values()) == 1.0 and dx <= F64_TOL) if f64
                    else (min(agree.values()) >= SIMPLEX_AGREE
                          and rel <= SIMPLEX_OBJ_REL))
                if not ok:
                    raise RuntimeError(f"simplex kernel disagrees with the "
                                       f"host loop: {c}")

    # launches per LP batch, and the registry's record while a profiler runs
    P, sh = lp_problem(torch, torch.float32, "mixed", 0, B_LP)
    s32 = Settings.for_dtype(torch.float32)
    _, launches = counted(torch, lambda: solve_lp_batch_auto(P, s32, sh))
    diagnostics.clear_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        solve_lp_batch_auto(P, s32, sh)
        rec = diagnostics.counters()
    diagnostics.clear_counters()
    key = (B_LP, R_LP, NT_LP, "float32")
    if launches["simplex"] != 2 or rec.get("simplex.launches") != {key: 2} \
            or rec.get("simplex_step") != 2:
        raise RuntimeError(f"simplex: launches {launches}, registry "
                           f"{rec.get('simplex.launches')}, trips "
                           f"{rec.get('simplex_step')}")
    log("simplex", f"solve_lp_batch_auto B={B_LP}: launches {launches}; "
        f"registry simplex.launches {rec['simplex.launches']}, "
        f"simplex_step {rec['simplex_step']}")

    # times of batch 0's two phases, float32
    times = {}
    for ph in (1, 2):
        P32, _ = lp_problem(torch, torch.float32, "mixed", 0, B_LP)
        args = phases(P32, s32)[ph - 1]
        c, A, b, d, u, B0, S0, x0, real = args
        Bn, R, Nt = A.shape
        cA_safe, B, invB = ts._start(A, B0)
        # the kernel overwrites the basis it is given: each call its copy
        kern = lambda: ks.simplex_run(c, A, b, d, u, real, cA_safe, invB,
                                      B.clone(), S0, x0, None, tol=s32.tol,
                                      max_iter=s32.max_iter)
        its = int(kern()[4].sum())
        plain = []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ts.bounded_simplex_loop(*args, tol=s32.tol, max_iter=s32.max_iter)
            torch.cuda.synchronize()
            plain.append(1e3 * (time.perf_counter() - t))
        runs = [cuda_time(torch, kern) for _ in range(2)]
        b_ms, b_by = simplex_bound(its, R, Nt, Bn)
        b_dfma, by_dfma = simplex_bound(its, R, Nt, Bn, PEAK_F64_FLOPS)
        tm = {"ms": min(runs), "plain_ms": min(plain), "bound_ms": b_ms,
              "bound_by": b_by, "bound_dfma_ms": b_dfma,
              "bound_dfma_by": by_dfma, "steps": its}
        times[f"phase {ph}"] = tm
        log("simplex", f"f32 (B, R, Nt) = ({Bn}, {R}, {Nt}) phase {ph}, "
            f"{its} instance steps: kernel {tm['ms']:.4f} ms (CUDA events; "
            f"runs {runs[0]:.4f}/{runs[1]:.4f}), host loop "
            f"{tm['plain_ms']:.1f} ms (host clock; runs {plain[0]:.1f}/"
            f"{plain[1]:.1f}), bound {b_ms:.5f} ms ({b_by}, kernel at "
            f"{100 * b_ms / tm['ms']:.2f}%; DFMA {b_dfma:.5f} ms, "
            f"{100 * b_dfma / tm['ms']:.2f}%)")
    return checks, times, launches


def bench_problem(torch, dtype, N=N_MAIN):
    from ssqp_tpu_torch import make_qp

    rng = np.random.default_rng(7)
    H = rng.standard_normal((N, N))
    V = H @ H.T / N + 0.5 * np.eye(N)
    mu = rng.uniform(0.0, 0.2, N)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    Q = make_qp(np.asarray(V, npdt), np.asarray(mu, npdt),
                u=np.full(N, 4.0 / N, npdt), dtype=npdt, device="cuda")
    return Q, V, mu


def grid(torch, i, B, dtype=None):
    dtype = dtype or torch.float32
    return torch.linspace(0.001 * i, 2.0 + 0.001 * i, B, dtype=dtype,
                          device="cuda")


def check_solution(torch, res, Qb, B, tag):
    x, status = res.x, res.status
    if tuple(x.shape) != (B, Qb.N) or not bool(torch.isfinite(x).all()):
        raise RuntimeError(f"{tag}: solution not finite or wrong shape")
    solved = int((status > 0).sum())
    if solved != B:
        raise RuntimeError(f"{tag}: solved {solved}/{B}")
    budget = float((x.double().sum(1) - 1.0).abs().max())
    box = float(torch.maximum(Qb.d - x, x - Qb.u).max())
    if budget > 1e-4 or box > 1e-5:
        raise RuntimeError(f"{tag}: infeasible (budget {budget}, box {box})")
    return solved, budget, box


class Spy:
    """Records the calls of ``module.name`` (``record(args, kwargs)``, by
    default the keyword arguments) while the wrapped function runs as
    before, or through ``run(real, args, kwargs)`` where that is given (to
    keep its result or count inside it); ``undo`` restores it."""

    def __init__(self, module, name, record=None, run=None):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.calls = []
        record = record or (lambda a, k: k)
        run = run or (lambda real, a, k: real(*a, **k))

        def wrapped(*a, **k):
            self.calls.append(record(a, k))
            return run(self.real, a, k)
        setattr(module, name, wrapped)

    def undo(self):
        setattr(self.module, self.name, self.real)


def counted(torch, fn):
    """(result, launches) of one call with every kernel count set to 0
    just before and read just after: the launches as the kernel modules
    count them (``cg.LAUNCHES``, ``chol.LAUNCHES``, ``simplex.LAUNCHES``),
    by CG body (the
    library's rule, ``cg.body``, on each launch's rows, width, dtype and
    V) and by Cholesky (B, n, K), from spies on the two launch wrappers.
    No profiler records, so the call runs the instances users run."""
    from collections import Counter

    from ssqp_tpu_torch.ops import cg, chol, kkt
    from ssqp_tpu_torch.ops import simplex as ks

    cg_keys, chol_keys = Counter(), Counter()

    def cg_run(real, a, k):
        out = real(*a, **k)
        V, Br = a[0], a[3]
        C, N = Br.shape
        if Br.is_cuda and C and N:
            cg_keys[(C, N, Br.dtype, V.dim() == 2)] += 1
        return out

    def chol_run(real, a, k):
        out = real(*a, **k)
        B, n, _ = a[0].shape
        K = a[1].shape[2]
        if a[0].is_cuda and B and n and K:
            chol_keys[(B, n, K)] += 1
        return out

    spies = (Spy(cg, "cg_padded_rows", run=cg_run),
             Spy(kkt, "chol_solve_batch", run=chol_run))
    torch.cuda.synchronize()
    cg.LAUNCHES = chol.LAUNCHES = ks.LAUNCHES = 0
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        for spy in spies:
            spy.undo()
    by_body = Counter()
    for key, n in cg_keys.items():
        by_body[cg.body(*key)] += n
    if (sum(cg_keys.values()), sum(chol_keys.values())) != (
            cg.LAUNCHES, chol.LAUNCHES):
        raise RuntimeError(f"the spies saw {sum(cg_keys.values())} CG and "
                           f"{sum(chol_keys.values())} Cholesky launches "
                           f"of {cg.LAUNCHES} and {chol.LAUNCHES}")
    return out, {"cg_rows": cg.LAUNCHES, "cg_by_body": dict(by_body),
                 "chol_solve": chol.LAUNCHES,
                 "chol_by_shape": dict(chol_keys), "simplex": ks.LAUNCHES}


def run_route(torch, fn, Qb, B, tag, counters):
    """One batch through ``fn`` with every kernel count set to 0 just
    before and read just after; checks the solution."""
    res, launches = counted(torch, lambda: fn(Qb))
    if launches["cg_rows"] <= 0:
        raise RuntimeError(f"{tag}: no CG kernel launch")
    counters[tag] = launches
    solved, budget, box = check_solution(torch, res, Qb, B, tag)
    st = res.status.float()
    log("main", f"{tag} N={Qb.N} B={B} f32: solved {solved}/{B}, launches "
        f"{launches}, S-iterations med {float(st.median()):.0f} max "
        f"{float(st.max()):.0f}, budget err {budget:.1e}, box err {box:.1e}")
    return res


def phase_main(torch):
    """The frontier through solve_qp_batch_auto at the three batch sizes
    whose routes differ (B=2048 plain, B=8192 waves=8, B=4096 compaction
    (2, 4, 8)), each route checked, and the B=8192 batch through
    solve_qp_batch_c2f (coarse=8)."""
    from ssqp_tpu_torch import Settings
    from ssqp_tpu_torch.parallel import batch
    from ssqp_tpu_torch.parallel.batch import (
        frontier_batch, solve_qp_batch_auto, solve_qp_batch_c2f)

    settings = Settings.for_dtype(torch.float32)
    Q, V, mu = bench_problem(torch, torch.float32)
    auto = lambda Qg, sh: solve_qp_batch_auto(Qg, settings, sh)
    counters = {}

    Qb, shared = frontier_batch(Q, grid(torch, 0, B_AUTO))
    res_auto = run_route(torch, lambda Qg: auto(Qg, shared), Qb, B_AUTO,
                         "auto B=2048 (plain)", counters)

    # B=8192: the wave route, with what the waves carried and rescued
    waves = Spy(batch, "solve_qp_batch_waves")
    compact = Spy(batch, "solve_qp_batch_compact")
    rescue = Spy(batch, "_rescue_and_attach", lambda a, k: (
        int((a[1].status <= 0).sum()), int(k["force"].sum())))
    QbB, sharedB = frontier_batch(Q, grid(torch, 0, B_BIG))
    res_big = run_route(torch, lambda Qg: auto(Qg, sharedB), QbB, B_BIG,
                        "auto B=8192 (waves=8)", counters)
    if waves.calls != [dict(waves=8)] or compact.calls:
        raise RuntimeError(f"B={B_BIG}: route waves {waves.calls}, compact "
                           f"{compact.calls}; the rule picks waves=8")
    failed, forced = rescue.calls[0]
    W = 8
    st = res_big.status.reshape(B_BIG // W, W).float()
    per_wave = [(float(st[:, k].median()), int(st[:, k].max()))
                for k in range(W)]
    log("main", f"waves=8 at B={B_BIG}: S-iterations per wave (median, max) "
        f"{per_wave}; failed before the rescue {failed}, forced {forced}")
    waves.calls.clear()

    QbC, sharedC = frontier_batch(Q, grid(torch, 0, B_MID))
    run_route(torch, lambda Qg: auto(Qg, sharedC), QbC, B_MID,
              "auto B=4096 (compact)", counters)
    if compact.calls != [dict(shared=sharedC, compact=(2, 4, 8))] \
            or waves.calls:
        raise RuntimeError(f"B={B_MID}: route compact {compact.calls}, waves "
                           f"{waves.calls}; the rule picks (2, 4, 8)")
    for spy in (waves, compact, rescue):
        spy.undo()

    # the coarse-to-fine protocol, which no rule picks, on the same batch
    run_route(torch, lambda Qg: solve_qp_batch_c2f(Qg, settings, sharedB,
                                                   coarse=8),
              QbB, B_BIG, "c2f(8) B=8192", counters)
    return res_auto, res_big, counters


def phase_audit(torch, res, B, tag="audit"):
    """256 instances of the grid-0 batch of size B re-solved in float64 on
    the card; max objective gap < 1e-6."""
    from ssqp_tpu_torch import Settings
    from ssqp_tpu_torch.parallel.batch import frontier_batch, solve_qp_batch

    Q64, V, mu = bench_problem(torch, torch.float64)
    idx = np.linspace(0, B - 1, 256).astype(int)
    lams = grid(torch, 0, B).double().cpu().numpy()[idx]
    Qb64, sh = frontier_batch(Q64, torch.tensor(lams, device="cuda"))
    r64 = solve_qp_batch(Qb64, Settings(), shared=sh)
    x64 = r64.x.cpu().numpy()
    ok64 = r64.status.cpu().numpy() > 0
    if ok64.sum() != len(idx):
        raise RuntimeError(f"f64 audit solved {int(ok64.sum())}/{len(idx)}")
    x32 = res.x.double().cpu().numpy()[idx]
    qs = -lams[:, None] * mu[None, :]
    f32v = 0.5 * np.einsum("bi,ij,bj->b", x32, V, x32) + (qs * x32).sum(1)
    f64v = 0.5 * np.einsum("bi,ij,bj->b", x64, V, x64) + (qs * x64).sum(1)
    gaps = np.abs(f32v - f64v) / np.maximum(1.0, np.abs(f64v))
    xinf = np.abs(x32 - x64).max(axis=1)
    log(tag, f"B={B}: f64 on card ({int(ok64.sum())}/{len(idx)} refs): "
        f"objgap {quantiles(gaps)} xinf {quantiles(xinf)}")
    if not gaps.max() < 1e-6:
        raise RuntimeError(f"{tag} B={B}: objective gap {gaps.max():.3e} "
                           ">= 1e-6")
    return float(gaps.max())


def objgap(Q, x, x64):
    """|f(x) - f(x64)| / max(1, |f(x64)|) per instance, in float64."""
    V, q = Q.V.double(), Q.q.double()
    f = lambda z: 0.5 * (z * (z @ V.T)).sum(1) + (q * z).sum(1)
    f64 = f(x64.double())
    return (f(x.double()) - f64).abs() / f64.abs().clamp(min=1.0)


def phase_refined(torch):
    """The refined tier on the frontier problem in float64 at N=512, B=256:
    float32 search, refinement against the float64 data (CG and LU), each
    against the plain float64 solve on the card: max |x - x64| < 1e-9 where
    the search's labels are the float64 solve's, objective gap < 1e-6 on
    every instance, and the two tiers within 1e-9 of each other; one
    double-double continuation at N=32."""
    from ssqp_tpu_torch import Settings
    from ssqp_tpu_torch.parallel.batch import (
        frontier_batch, solve_qp_batch, solve_qp_batch_refined)
    from ssqp_tpu_torch.solvers.refine import solve_qp_refined_dd

    Q, _, _ = bench_problem(torch, torch.float64, N=N_REF)
    Qb, sh = frontier_batch(Q, grid(torch, 0, B_REF, torch.float64))
    r64 = solve_qp_batch(Qb, Settings(), shared=sh)
    if int((r64.status > 0).sum()) != B_REF:
        raise RuntimeError("refined: the plain float64 solve failed")
    out, counters, xs = {}, {}, {}
    for method in ("cg", "lu"):
        r, counters[method] = counted(torch, lambda: solve_qp_batch_refined(
            Qb, search_dtype=torch.float32, shared=sh, method=method))
        # the refinement solves the search's labeled active set: it meets
        # the float64 solve's x to 1e-9 where the float32 search labeled as
        # float64 does; where the search's polish pinned a variable within
        # its tolerance (2^-16) of a bound that float64 keeps free, it is
        # that set's optimum (the JAX package's refined tier does the same)
        same = (r.S == r64.S).all(1)
        dx = (r.x - r64.x).abs().amax(1)
        gap = objgap(Qb, r.x, r64.x)
        solved = int((r.status > 0).sum())
        o = {"solved": solved, "labels_as_f64": int(same.sum()),
             "max_abs_dx_same_labels": float(dx[same].max()),
             "max_abs_dx_other_labels": float(dx[~same].max())
             if bool((~same).any()) else 0.0,
             "max_objgap": float(gap.max())}
        out[method], xs[method] = o, r.x
        log("refined", f"solve_qp_batch_refined({method}) N={N_REF} "
            f"B={B_REF} f64 data, f32 search: solved {solved}/{B_REF}; "
            f"labels as the f64 solve's on {o['labels_as_f64']}, there "
            f"max|x - x64| {o['max_abs_dx_same_labels']:.3e} (bar 1e-9); "
            f"elsewhere {o['max_abs_dx_other_labels']:.3e}; max objective "
            f"gap {o['max_objgap']:.3e}; launches {counters[method]}")
        if (solved != B_REF or not o["max_abs_dx_same_labels"] < 1e-9
                or not o["max_objgap"] < 1e-6
                or counters[method]["cg_rows"] <= 0):
            raise RuntimeError(f"refined {method}: {o}")
    agree = float((xs["cg"] - xs["lu"]).abs().max())
    out["max_abs_dx_cg_lu"] = agree
    log("refined", f"CG and LU tiers agree to {agree:.3e} (bar 1e-9)")
    if not agree < 1e-9:
        raise RuntimeError(f"refined: CG and LU differ by {agree:.3e}")

    Qd, _, _ = bench_problem(torch, torch.float64, N=N_DD)
    rd, lo = solve_qp_refined_dd(dataclasses.replace(Qd, q=-0.5 * Qd.q))
    ok = (int(rd.status) > 0 and bool(torch.isfinite(rd.x).all())
          and bool(torch.isfinite(lo).all()) and bool((lo != 0).any()))
    log("refined", f"solve_qp_refined_dd N={N_DD} on the card: status "
        f"{int(rd.status)}, max|x_lo| {float(lo.abs().max()):.3e}, "
        f"accepted {ok}")
    if not ok:
        raise RuntimeError("refined dd: not finite, not solved or rejected")
    return out, counters


def ineq_problem(torch, dtype, q_seed, B):
    """bench_suite.py::config4's problem (seed 4) with a batch of B linear
    terms q_i ~ N(0, 1) drawn from ``q_seed``, on the card."""
    import dataclasses

    from ssqp_tpu_torch import make_qp

    N, M, J = N_INEQ, M_INEQ, J_INEQ
    rng = np.random.default_rng(4)
    H = rng.standard_normal((N, N))
    V = H @ H.T / N + 0.5 * np.eye(N)
    A = rng.standard_normal((M, N))
    x0 = rng.uniform(0.0, 1.0, N)
    G = rng.standard_normal((J, N))
    g = G @ x0 + rng.uniform(0.1, 1.0, J)
    q = np.random.default_rng(q_seed).standard_normal((B, N))
    npdt = np.float32 if dtype == torch.float32 else np.float64
    Q = make_qp(V, np.zeros(N), A, A @ x0, G=G, g=g, d=x0 - 2.0, u=x0 + 2.0,
                dtype=npdt, device="cuda")
    return dataclasses.replace(Q, q=torch.tensor(q, dtype=dtype,
                                                 device="cuda"))


def check_ineq(torch, res, Q, B, tag):
    x, status = res.x, res.status
    if tuple(x.shape) != (B, N_INEQ) or not bool(torch.isfinite(x).all()):
        raise RuntimeError(f"{tag}: solution not finite or wrong shape")
    solved = int((status > 0).sum())
    if solved != B:
        raise RuntimeError(f"{tag}: solved {solved}/{B}")
    xd = x.double()
    A, b, G, g, d, u = (t.double() for t in (Q.A, Q.b, Q.G, Q.g, Q.d, Q.u))
    eq = float(((xd @ A.T - b).abs() / (1.0 + b.abs())).max())
    ineq = float(((xd @ G.T - g) / (1.0 + g.abs())).max())
    box = float((torch.maximum(d - xd, xd - u)
                 / (1.0 + torch.maximum(d.abs(), u.abs()))).max())
    if max(eq, ineq, box) > FEAS_TOL:
        raise RuntimeError(f"{tag}: infeasible (eq {eq:.2e}, ineq {ineq:.2e}"
                           f", box {box:.2e})")
    return eq, ineq, box


def phase_ineq(torch):
    from ssqp_tpu_torch import Settings
    from ssqp_tpu_torch.parallel.batch import (
        _tail_resid_bound, batch_kkt_resid, solve_qp_batch,
        solve_qp_batch_auto)
    from ssqp_tpu_torch.types import EO, IN

    settings = Settings.for_dtype(torch.float32)
    B = B_INEQ
    Q = ineq_problem(torch, torch.float32, 4, B)
    # solve_qp_batch_auto's rule: the tail route (tail=4) at N >= 512 outside
    # float64
    if not (Q.N >= 512 and Q.V.dtype == torch.float32):
        raise RuntimeError("ineq problem is outside the tail route's rule")
    res, launches = counted(
        torch, lambda: solve_qp_batch_auto(Q, settings, INEQ_SHARED))
    if min(launches["cg_rows"], launches["chol_solve"]) <= 0:
        raise RuntimeError(f"ineq path missed a kernel: launches {launches}")
    eq, ineq, box = check_ineq(torch, res, Q, B, "ineq")
    # the search alone, for what the tail had to refine: the instances
    # above the residual bound, and those whose x the tail changed
    plain = solve_qp_batch(Q, settings, shared=INEQ_SHARED)
    above = int((batch_kkt_resid(Q, plain) > _tail_resid_bound(Q.N)).sum())
    changed = int((res.x != plain.x).any(1).sum())
    # the search's working set against the rows that bind at its x
    eo = (res.S[:, N_INEQ:] == EO).sum(1)
    slack = res.x.double() @ Q.G.double().T - Q.g.double()
    binding = (slack > -1e-4 * (1.0 + Q.g.double().abs())).sum(1)
    gam_free = float(res.gamma.abs()[res.S[:, :N_INEQ] == IN].max())
    st = res.status.float()
    log("ineq", f"solve_qp_batch_auto N={N_INEQ} M={M_INEQ} J={J_INEQ} B={B} "
        f"f32 (plain protocol + tail=4): solved {B}/{B}; launches "
        f"{launches}; S-iterations med {float(st.median()):.0f} max "
        f"{float(st.max()):.0f}; tail: {above} instances above the "
        f"residual bound, x changed on {changed}; inequality rows EO "
        f"{int(eo.min())}-{int(eo.max())}, binding {int(binding.min())}-"
        f"{int(binding.max())}, max |gamma| on free x {gam_free:.3f}; "
        f"feasibility eq {eq:.1e} ineq {ineq:.1e} box {box:.1e}")
    return res, launches


def phase_ineq_audit(torch, res):
    from ssqp_tpu_torch import Settings
    from ssqp_tpu_torch.parallel.batch import solve_qp_batch

    idx = np.linspace(0, B_INEQ - 1, 32).astype(int)
    Q64 = ineq_problem(torch, torch.float64, 4, B_INEQ)
    Q64 = Q64.take(torch.tensor(idx, device="cuda"))
    r64 = solve_qp_batch(Q64, Settings(), shared=INEQ_SHARED)
    ok64 = r64.status.cpu().numpy() > 0
    if ok64.sum() != len(idx):
        raise RuntimeError(f"ineq f64 audit solved {int(ok64.sum())}/"
                           f"{len(idx)}")
    V = Q64.V.cpu().numpy()
    qs = Q64.q.cpu().numpy()
    x64 = r64.x.cpu().numpy()
    x32 = res.x.double().cpu().numpy()[idx]
    f32v = 0.5 * np.einsum("bi,ij,bj->b", x32, V, x32) + (qs * x32).sum(1)
    f64v = 0.5 * np.einsum("bi,ij,bj->b", x64, V, x64) + (qs * x64).sum(1)
    gaps = np.abs(f32v - f64v) / np.maximum(1.0, np.abs(f64v))
    xinf = np.abs(x32 - x64).max(axis=1)
    log("ineq-audit", f"f64 on card ({int(ok64.sum())}/{len(idx)} refs): "
        f"objgap {quantiles(gaps)} xinf {quantiles(xinf)}")
    if not gaps.max() < 1e-6:
        raise RuntimeError(f"ineq objective gap {gaps.max():.3e} >= 1e-6")
    return float(gaps.max())


# BASELINE config 2 (bench_suite.py::config2): the LP path, N=100, M=5
# equalities, J=20 inequalities, 0 <= x <= 2; its criss-cross column runs
# N=40, M=4, J=8
N_LP, M_LP, J_LP = 100, 5, 20
R_LP = M_LP + J_LP  # the standardized rows and columns (lp-mixed256's)
NT_LP = 2 * N_LP + J_LP + R_LP
N_CC, M_CC, J_CC = 40, 4, 8
B_LP, B_LP_BIG = 256, 4096
LP_F32_REL = 5e-5  # float32 vs float64 objective (tests/test_lp.py:205)
LP_HIGHS_REL = 1e-7  # float64 vs HiGHS objective
LP_N_HIGHS = 32  # instances per route held against HiGHS
LP_FEAS_TOL = 1e-4  # primal feasibility, scaled by 1 + max(|b|, |g|)


def lp_problem(torch, dtype, route, i, B):
    """One batch of bench_suite.py::config2's generators on the card, made
    in float32 (``dtype`` float64 casts the same numbers up), with the
    shared fields of its family:

    * ``mixed``: A, G from seed 99; c, b, g per instance from 1000 + i;
    * ``cgrid``: seed 7, c = c0 + t dc, t = linspace(0.001 i, 1 + 0.001 i);
    * ``rhs``: seed 17, b and g along x0 + t (x1 - x0), t as above;
    * ``cclp``: N=40, M=4, J=8, A, G from seed 7; c, b, g from 2000 + i."""
    import dataclasses

    from ssqp_tpu_torch import make_lp

    f = np.float32
    ts = np.linspace(0.001 * i, 1.0 + 0.001 * i, B).astype(f)
    if route == "cclp":
        N, M, J = N_CC, M_CC, J_CC
    else:
        N, M, J = N_LP, M_LP, J_LP
    if route in ("mixed", "cclp"):
        rng = np.random.default_rng(99 if route == "mixed" else 7)
        A = rng.standard_normal((M, N)).astype(f)
        G = rng.standard_normal((J, N)).astype(f)
        rl = np.random.default_rng((1000 if route == "mixed" else 2000) + i)
        X0 = rl.uniform(0.1, 1.0, (B, N)).astype(f)
        c = rl.standard_normal((B, N)).astype(f)
        b = (X0 @ A.T).astype(f)
        g = (X0 @ G.T + rl.uniform(0.1, 1.0, (B, J))).astype(f)
        batched, shared = dict(c=c, b=b, g=g), ("A", "G", "d", "u")
    elif route == "cgrid":
        rng = np.random.default_rng(7)
        x0 = rng.uniform(0.1, 1.0, N).astype(f)
        A = rng.standard_normal((M, N)).astype(f)
        G = rng.standard_normal((J, N)).astype(f)
        b = A @ x0
        g = G @ x0 + rng.uniform(0.1, 1.0, J).astype(f)
        c0 = rng.standard_normal(N).astype(f)
        dc = rng.standard_normal(N).astype(f) * 0.5
        c = c0
        batched = dict(c=c0[None, :] + ts[:, None] * dc[None, :])
        shared = ("A", "b", "G", "g", "d", "u")
    else:
        rng = np.random.default_rng(17)
        A = rng.standard_normal((M, N)).astype(f)
        G = rng.standard_normal((J, N)).astype(f)
        c = rng.standard_normal(N).astype(f)
        x0 = rng.uniform(0.1, 1.0, N).astype(f)
        x1 = rng.uniform(0.1, 1.0, N).astype(f)
        slack = rng.uniform(0.1, 1.0, J).astype(f)
        Xc = x0[None, :] + ts[:, None] * (x1 - x0)[None, :]
        b, g = A @ x0, G @ x0 + slack
        batched = dict(b=(Xc @ A.T).astype(f),
                       g=(Xc @ G.T + slack[None, :]).astype(f))
        shared = ("c", "A", "G", "d", "u")
    npdt = f if dtype == torch.float32 else np.float64
    one = lambda a: a[0] if a.ndim == 2 and a.shape[0] == B else a
    P = make_lp(one(c), A, one(b), G=G, g=one(g), d=np.zeros(N, f),
                u=np.full(N, 2.0, f), dtype=npdt, device="cuda")
    return dataclasses.replace(P, **{
        k: torch.tensor(v, dtype=dtype, device="cuda")
        for k, v in batched.items()}), shared


def lp_entry(route):
    """The entry point a user calls for ``route``, (P, settings, shared)."""
    from ssqp_tpu_torch.parallel.batch import (
        solve_lp_batch_auto, solve_lp_batch_cclp_rescued)

    if route == "cclp":
        return lambda P, s, sh: solve_lp_batch_cclp_rescued(P, s, sh)
    return lambda P, s, sh: solve_lp_batch_auto(P, s, sh)


def lp_objective(P, x):
    """c'x per instance, in float64."""
    return (P.c.double() * x.double()).sum(-1)


def lp_feasibility(torch, P, x):
    """Per instance max(|Ax - b|, (Gx - g)+, box violation) / (1 + max(|b|,
    |g|)), in float64."""
    xd = x.double()
    A, b, G, g, d, u = (t.double() for t in (P.A, P.b, P.G, P.g, P.d, P.u))
    eq = (xd @ A.T - b).abs().amax(-1)
    ineq = (xd @ G.T - g).clamp(min=0).amax(-1)
    box = torch.maximum(d - xd, xd - u).clamp(min=0).amax(-1)
    scale = 1.0 + torch.maximum(b.abs().amax(-1), g.abs().amax(-1))
    return torch.maximum(torch.maximum(eq, ineq), box) / scale


def highs_check(P, res64, idx):
    """The port's float64 objective against scipy's HiGHS on instances
    ``idx``; returns the largest relative difference."""
    from scipy.optimize import linprog

    worst = 0.0
    for i in idx:
        c, A, b, G, g = ((getattr(P, f)[i] if P.is_batched(f)
                          else getattr(P, f)).double().cpu().numpy()
                         for f in ("c", "A", "b", "G", "g"))
        ref = linprog(c, A_ub=G, b_ub=g, A_eq=A, b_eq=b,
                      bounds=list(zip(P.d.double().cpu().numpy(),
                                      P.u.double().cpu().numpy())),
                      method="highs")
        st = int(res64.status[i])
        if not ref.success or st not in (1, 2):
            raise RuntimeError(f"HiGHS check, instance {i}: HiGHS "
                               f"{ref.status} ({ref.message}), port status "
                               f"{st}")
        f = float(c @ res64.x[i].cpu().numpy())
        rel = abs(f - ref.fun) / max(1.0, abs(ref.fun))
        if not rel <= LP_HIGHS_REL:
            raise RuntimeError(f"HiGHS check, instance {i}: port {f!r}, "
                               f"HiGHS {ref.fun!r} (rel {rel:.2e})")
        worst = max(worst, rel)
    return worst


def check_lp(torch, tag, P, res, P64, res64):
    """The LP checks of one route: statuses, feasibility, float32 against
    float64 objectives. Returns the status histogram."""
    st = res.status.cpu().numpy()
    st64 = res64.status.cpu().numpy()
    B = st.shape[0]
    if tuple(res.x.shape) != (B, P.N) or not bool(torch.isfinite(res.x)
                                                  .all()):
        raise RuntimeError(f"{tag}: solution not finite or wrong shape")
    bad = ~np.isin(st, (1, 2)) & (st != st64)
    if bad.any():
        raise RuntimeError(f"{tag}: statuses {st[bad][:8]} where the "
                           f"float64 solve gives {st64[bad][:8]}")
    opt = np.isin(st, (1, 2))
    feas = lp_feasibility(torch, P, res.x).cpu().numpy()
    if opt.any() and not feas[opt].max() <= LP_FEAS_TOL:
        raise RuntimeError(f"{tag}: infeasible optimum ({feas[opt].max():.2e}"
                           f" > {LP_FEAS_TOL})")
    both = opt & np.isin(st64, (1, 2))
    f32 = lp_objective(P, res.x).cpu().numpy()
    f64 = lp_objective(P64, res64.x).cpu().numpy()
    rel = np.abs(f32 - f64) / np.maximum(1.0, np.abs(f64))
    if both.any() and not rel[both].max() <= LP_F32_REL:
        raise RuntimeError(f"{tag}: float32 objective {rel[both].max():.2e} "
                           f"from float64 (bar {LP_F32_REL})")
    hist = {int(k): int(v) for k, v in zip(*np.unique(st, return_counts=True))}
    return hist, float(rel[both].max()) if both.any() else 0.0, \
        float(feas[opt].max()) if opt.any() else 0.0


# route label -> (problem, batch, the protocol function the rule must call)
LP_ROUTES = (("mixed B=256 (plain)", "mixed", B_LP, "solve_lp_batch"),
             ("mixed B=4096 (plain)", "mixed", B_LP_BIG, "solve_lp_batch"),
             ("c-grid B=256 (waves=8)", "cgrid", B_LP,
              "solve_lp_batch_waves"),
             ("rhs grid B=256 (dual waves=8)", "rhs", B_LP,
              "solve_lp_batch_waves_rhs"),
             ("criss-cross N=40 B=256 (rescued)", "cclp", B_LP,
              "solve_lp_batch_cclp"))


def phase_lp(torch):
    """BASELINE config 2's LP routes on the card (module docstring)."""
    from ssqp_tpu_torch import Settings
    from ssqp_tpu_torch.parallel import batch

    s32 = Settings.for_dtype(torch.float32)
    s64 = Settings()
    counters, out = {}, {}
    for tag, route, B, proto in LP_ROUTES:
        fn = lp_entry(route)
        P, sh = lp_problem(torch, torch.float32, route, 0, B)
        spies = {n: Spy(batch, n, lambda a, k: True) for n in (
            "solve_lp_batch", "solve_lp_batch_waves",
            "solve_lp_batch_waves_rhs", "solve_lp_batch_cclp")}
        res, launches = counted(torch, lambda: fn(P, s32, sh))
        called = [n for n, sp in spies.items() if sp.calls]
        for sp in spies.values():
            sp.undo()
        if proto not in called or (proto != "solve_lp_batch_cclp"
                                   and len(called) != 1):
            raise RuntimeError(f"{tag}: the rule called {called}, not "
                               f"{proto}")
        R = P.M + P.J
        if R >= 16 and launches["chol_by_shape"].get((B, R, 1), 0) <= 0:
            raise RuntimeError(f"{tag}: no Cholesky kernel launch at "
                               f"({B}, {R}, 1): {launches}")
        counters[tag] = launches
        P64 = P.astype(torch.float64)
        res64 = fn(P64, s64, sh)
        hist, rel, feas = check_lp(torch, tag, P, res, P64, res64)
        idx = np.linspace(0, B - 1, LP_N_HIGHS).astype(int)
        highs = highs_check(P64, res64, idx)
        out[tag] = {"B": B,
                    "solved": int(np.isin(res.status.cpu().numpy(),
                                          (1, 2)).sum()),
                    "status_hist": hist,
                    "launches": {k: v for k, v in launches.items()
                                 if k != "chol_by_shape"},
                    "max_rel_f32_f64": rel, "max_feas": feas,
                    "max_rel_highs": highs}
        log("lp", f"{tag} f32: solved {out[tag]['solved']}/{B}, statuses "
            f"{hist}, launches {launches}; f32 vs f64 objective {rel:.2e} "
            f"(bar {LP_F32_REL}), feasibility {feas:.1e}, f64 vs HiGHS "
            f"{highs:.2e} on {len(idx)} (bar {LP_HIGHS_REL})")
    return out, counters


# phase 12: the outer layers (frontier sweeps, diff, Model and MPS,
# diagnostics, the sharded solves, warm-up)
B_SWEEP, B_WAVES_SWEEP, N_WARM = 2048, 8192, 128
N_AUDIT = 256
B_DIFF, N_FD, FD_DIRS, FD_H = 256, 8, 4, 1e-6


def frontier_objective(V, rets, x, lam=None):
    """1/2 x'Vx - lam r'x per row of x, in float64 on the card (lam None:
    the mu sweeps' objective 1/2 x'Vx)."""
    x = x.double()
    f = 0.5 * (x * (x @ V.double().T)).sum(1)
    return f if lam is None else f - lam.double() * (x @ rets.double())


def audit_sweep(torch, tag, fr, V, rets, grid, mu, idx):
    """Points ``idx`` of a float32 sweep re-solved in float64 on the card at
    the grid's own values (budget 1, the grid's L or mu); returns the max
    objective gap."""
    from ssqp_tpu_torch import Settings
    from ssqp_tpu_torch.models import frontier as tf

    Q64, _, _ = bench_problem(torch, torch.float64)
    g64 = grid.double()[idx]
    lam = None if mu else g64
    ref = (tf.frontier_mu_sweep if mu else tf.frontier_batch_sweep)(
        Q64, rets.double(), g64, Settings())
    if not bool((ref.status > 0).all()):
        raise RuntimeError(f"{tag}: the float64 audit solve failed")
    f32 = frontier_objective(V, rets, fr.x[idx], lam)
    f64 = frontier_objective(V, rets, ref.x, lam)
    return float(((f32 - f64).abs() / f64.abs().clamp(min=1.0)).max())


def phase_outer_sweeps(torch):
    """11a: the five frontier sweeps on bench.py's problem in float32."""
    from ssqp_tpu_torch import Settings
    from ssqp_tpu_torch.models import frontier as tf

    s32 = Settings.for_dtype(torch.float32)
    Q, _, _ = bench_problem(torch, torch.float32)
    rets = Q.q
    V = Q.V
    dev = "cuda"
    lgrid = lambda i, B: torch.linspace(0.001 * i, 2.0 + 0.001 * i, B,
                                        device=dev)
    out, counters, results = {}, {}, {}
    ret_span = None
    sweeps = (("batch", tf.frontier_batch_sweep, B_SWEEP, {}),
              ("waves=8", tf.frontier_waves_sweep, B_WAVES_SWEEP,
               dict(waves=8)),
              ("warm", tf.frontier_warm_sweep, N_WARM, {}),
              ("mu", tf.frontier_mu_sweep, B_SWEEP, {}),
              ("mu warm", tf.frontier_mu_warm_sweep, N_WARM, {}))
    for name, fn, B, kw in sweeps:
        mu = name.startswith("mu")
        if mu:  # inside the returns the L-sweep reached
            lo, hi = ret_span
            pad = 0.02 * (hi - lo)
            mgrid = lambda i, B: torch.linspace(lo + pad + 1e-5 * i,
                                                hi - pad + 1e-5 * i, B,
                                                device=dev)
            make = mgrid
        else:
            make = lgrid
        g0 = make(0, B)
        fr, launches = counted(torch, lambda: fn(Q, rets, g0, s32, **kw))
        tag = f"sweep {name} N={N_MAIN} B={B}"
        solved = int((fr.status > 0).sum())
        if solved != B or launches["cg_rows"] <= 0:
            raise RuntimeError(f"{tag}: solved {solved}/{B}, launches "
                               f"{launches}")
        x = fr.x.double()
        ret_err = float((fr.ret.double() - x @ rets.double()).abs().max())
        risk = (x * (x @ V.double().T)).sum(1).clamp(min=0).sqrt()
        risk_err = float((fr.risk.double() - risk).abs().max())
        if not (ret_err < 1e-5 and risk_err < 1e-5):
            raise RuntimeError(f"{tag}: ret/risk disagree with x "
                               f"({ret_err:.2e}, {risk_err:.2e})")
        row_err = (float((fr.ret.double() - g0.double()).abs().max())
                   if mu else None)
        budget_err = float((x.sum(1) - 1.0).abs().max())
        if not max(budget_err, row_err or 0.0) < s32.tol:
            raise RuntimeError(f"{tag}: 1'x - 1 = {budget_err:.2e}, r'x - mu"
                               f" = {row_err}, tier tolerance {s32.tol:.2e}")
        if name == "batch":
            ret_span = (float(fr.ret.min()), float(fr.ret.max()))
        idx = (torch.arange(B, device=dev) if B <= N_AUDIT else
               torch.linspace(0, B - 1, N_AUDIT, device=dev).long())
        gap = audit_sweep(torch, tag, fr, V, rets, g0, mu, idx)
        if not gap < 1e-6:
            raise RuntimeError(f"{tag}: objective gap {gap:.3e} >= 1e-6")
        st = fr.status.float()
        o = {"B": B, "cg_launches": launches["cg_rows"],
             "audited": int(idx.numel()), "max_objgap": gap,
             "max_ret_err": ret_err, "max_risk_err": risk_err,
             "s_iters_median": float(st.median()),
             "s_iters_max": float(st.max()),
             "max_budget_err": budget_err}
        if mu:
            o["max_row_err"] = row_err
        out[name], counters[tag], results[name] = o, launches, (fr, g0)
        log("outer", f"{tag} f32: solved {solved}/{B}, CG launches "
            f"{launches['cg_rows']}, S-iterations med {o['s_iters_median']:.0f}"
            f" max {o['s_iters_max']:.0f}, f64 audit on {o['audited']}: "
            f"max objgap {gap:.3e}; 1'x - 1 {budget_err:.1e}; ret/risk vs x "
            f"{ret_err:.1e}/"
            f"{risk_err:.1e}" + (f", r'x - mu {row_err:.1e}" if mu else ""))
    return out, counters, results


def phase_outer_diff(torch):
    """11b: solve_qp_diff on 256 frontier points at N=256, backward of
    sum(w x) with respect to q, b and u."""
    from ssqp_tpu_torch.parallel.batch import frontier_batch
    from ssqp_tpu_torch.solvers.diff import qp_value, solve_qp_diff

    out, counters = {}, {}
    gen = torch.Generator(device="cuda").manual_seed(11)
    for dtype in (torch.float64, torch.float32):
        dn = "f64" if dtype == torch.float64 else "f32"
        Q, _, _ = bench_problem(torch, dtype)
        Qb, _ = frontier_batch(Q, grid(torch, 0, B_DIFF, dtype))
        w = torch.randn(B_DIFF, N_MAIN, generator=gen, device="cuda",
                        dtype=dtype)

        def leaves():
            return {"q": Qb.q.clone().requires_grad_(True),
                    "b": Qb.b.expand(B_DIFF, 1).clone().requires_grad_(True),
                    "u": Qb.u.expand(B_DIFF, N_MAIN).clone()
                    .requires_grad_(True)}

        lv = leaves()
        Ql = dataclasses.replace(Qb, **lv)
        r, launches = counted(torch, lambda: solve_qp_diff(Ql))
        solved = int((r.status > 0).sum())
        if solved != B_DIFF or launches["cg_rows"] <= 0:
            raise RuntimeError(f"diff {dn}: solved {solved}, {launches}")
        (w * r.x).sum().backward()
        grads = {k: t.grad for k, t in lv.items()}
        if not all(bool(torch.isfinite(g).all()) for g in grads.values()):
            raise RuntimeError(f"diff {dn}: non-finite gradient")
        o = {"B": B_DIFF, "cg_launches": launches["cg_rows"]}
        counters[f"diff {dn} B={B_DIFF}"] = launches
        if dtype == torch.float64:
            # the envelope identity: grad_q of the optimal value is x*
            q = Qb.q.clone().requires_grad_(True)
            Qv = dataclasses.replace(Qb, q=q)
            rv = solve_qp_diff(Qv)
            qp_value(Qv, rv.x).sum().backward()
            env = float((q.grad - rv.x.detach()).abs().max())
            if not env < 1e-8:
                raise RuntimeError(f"diff: envelope error {env:.3e}")
            # central differences of sum(w x*) over full re-solves along
            # random directions in (q, b, u) on 8 instances
            sub = torch.arange(N_FD, device="cuda") * (B_DIFF // N_FD)
            base = {k: t.detach()[sub] for k, t in lv.items()}
            Qs = dataclasses.replace(Qb, q=base["q"], b=base["b"],
                                     u=base["u"])
            ws = w[sub]

            def loss(step):
                with torch.no_grad():
                    rr = solve_qp_diff(dataclasses.replace(
                        Qs, **{k: base[k] + step[k] for k in base}))
                if not bool((rr.status > 0).all()):
                    raise RuntimeError("diff FD: a re-solve failed")
                return (ws * rr.x).sum(1)

            worst = 0.0
            for _ in range(FD_DIRS):
                d = {k: torch.randn(t.shape, generator=gen, device="cuda",
                                    dtype=dtype) * (t.abs().mean() + 1e-3)
                     for k, t in base.items()}
                fd = (loss({k: FD_H * v for k, v in d.items()})
                      - loss({k: -FD_H * v for k, v in d.items()})) \
                    / (2 * FD_H)
                ad = sum((grads[k][sub] * d[k]).sum(1) for k in d)
                rel = ((fd - ad).abs() / ad.abs().clamp(min=1e-8)).max()
                worst = max(worst, float(rel))
            if not worst < 1e-5:
                raise RuntimeError(f"diff: FD relative error {worst:.3e}")
            # one infeasible instance: status 0, its gradient exactly zero
            b8 = torch.ones(N_FD, 1, dtype=dtype, device="cuda")
            b8[3] = 50.0
            q8 = Qb.q[sub].clone().requires_grad_(True)
            b8.requires_grad_(True)
            r8 = solve_qp_diff(dataclasses.replace(Qb, q=q8, b=b8))
            (r8.x ** 2).sum().backward()
            zero_ok = (int(r8.status[3]) == 0
                       and bool((r8.status[torch.arange(N_FD, device="cuda")
                                           != 3] > 0).all())
                       and bool(torch.isfinite(q8.grad).all())
                       and bool((q8.grad[3] == 0).all())
                       and bool((b8.grad[3] == 0).all()))
            if not zero_ok:
                raise RuntimeError("diff: the failed instance's gradient is "
                                   "not an exact zero")
            o.update(envelope_err=env, fd_max_rel=worst,
                     failed_instance_zero_grad=zero_ok)
        out[dn] = o
        log("outer", f"solve_qp_diff N={N_MAIN} B={B_DIFF} {dn}: solved "
            f"{solved}/{B_DIFF}, CG launches {launches['cg_rows']}, "
            f"gradients finite" + (
                f"; envelope {o['envelope_err']:.2e} (bar 1e-8), FD over "
                f"{FD_DIRS} directions on {N_FD} instances "
                f"{o['fd_max_rel']:.2e} (bar 1e-5), failed instance's "
                f"gradient exactly 0" if "envelope_err" in o else ""))
    return out, counters


def config4_model(dtype):
    """bench_suite.py::config4's problem (seed 4: V, A, b, G, g, d, u and
    one q) through the Model API on the card; also the raw arrays."""
    from ssqp_tpu_torch import Model

    N, M, J = N_INEQ, M_INEQ, J_INEQ
    rng = np.random.default_rng(4)
    H = rng.standard_normal((N, N))
    V = H @ H.T / N + 0.5 * np.eye(N)
    A = rng.standard_normal((M, N))
    x0 = rng.uniform(0.0, 1.0, N)
    b = A @ x0
    G = rng.standard_normal((J, N))
    g = G @ x0 + rng.uniform(0.1, 1.0, J)
    q = rng.standard_normal(N)
    d, u = x0 - 2.0, x0 + 2.0
    m = Model(dtype=dtype)
    for i in range(N):
        m.add_variable(d[i], u[i])
    for r in range(M):
        m.add_eq(A[r], b[r])
    for r in range(J):
        m.add_le(G[r], g[r])
    m.set_objective(quad=V, lin=q)
    return m, dict(V=V, q=q, A=A, b=b, G=G, g=g, d=d, u=u)


def config2_model(dtype):
    """bench_suite.py::config2's first single LP (seed 20) through the
    Model API on the card."""
    from ssqp_tpu_torch import Model

    N, M, J = N_LP, M_LP, J_LP
    f = np.float32
    rng = np.random.default_rng(20)
    A = rng.standard_normal((M, N)).astype(f)
    x0 = rng.uniform(0.1, 1.0, N).astype(f)
    b = A @ x0
    G = rng.standard_normal((J, N)).astype(f)
    g = G @ x0 + rng.uniform(0.1, 1.0, J).astype(f)
    c = rng.standard_normal(N).astype(f)
    m = Model(dtype=dtype)
    m.add_variables(N, lb=0.0, ub=2.0)
    for r in range(M):
        m.add_eq(A[r], b[r])
    for r in range(J):
        m.add_le(G[r], g[r])
    m.set_objective(lin=c)
    return m


def same_arrays(torch, P1, P2):
    return all(torch.equal(a, b) for a, b in zip(P1.leaves().values(),
                                                P2.leaves().values()))


def phase_outer_model(torch, sweep_results):
    """11c: config 4 and config 2 through the Model API and the MPS round
    trip; kkt_report; trace()."""
    from ssqp_tpu_torch import Settings, make_qp, solve_qp
    from ssqp_tpu_torch.parallel.batch import frontier_batch
    from ssqp_tpu_torch.types import Result
    from ssqp_tpu_torch.utils.diagnostics import kkt_report, trace
    from ssqp_tpu_torch.utils.mps import read_mps, solve_mps, write_mps

    out, counters = {}, {}
    objs = {}
    for dt in (np.float32, np.float64):
        dn = "f32" if dt == np.float32 else "f64"
        m, raw = config4_model(dt)
        term, launches = counted(torch, lambda: m.optimize())
        text = write_mps(m)
        m2 = read_mps(text, dtype=dt)
        term2, launches2 = counted(torch, lambda: m2.optimize())
        Qd = make_qp(raw["V"], raw["q"], raw["A"], raw["b"], G=raw["G"],
                     g=raw["g"], d=raw["d"], u=raw["u"], dtype=dt)
        rd = solve_qp(Qd)
        fd = float(frontier_objective(Qd.V, None, rd.x[None], None)[0]
                   + (Qd.q.double() * rd.x.double()).sum())
        f1, f2 = m.objective_value(), m2.objective_value()
        rel = abs(f1 - fd) / max(1.0, abs(fd))
        rel2 = abs(f2 - f1) / max(1.0, abs(f1))
        identical = same_arrays(torch, m.to_problem(), m2.to_problem())
        tag = f"model config4 {dn}"
        if (term != "OPTIMAL" or term2 != term or not rel < 1e-6
                or not rel2 < 1e-6 or not identical
                or launches["cg_rows"] <= 0 or launches2["cg_rows"] <= 0):
            raise RuntimeError(f"{tag}: {term}/{term2}, vs solve_qp {rel:.2e},"
                               f" round trip {rel2:.2e}, identical "
                               f"{identical}, launches {launches} "
                               f"{launches2}")
        if dt == np.float32 and launches["chol_solve"] <= 0:
            raise RuntimeError(f"{tag}: no Cholesky kernel launch")
        rep = kkt_report(Qd, rd)
        objs[dn] = f1
        counters[tag] = launches
        counters[f"mps config4 {dn} (read back)"] = launches2
        out[tag] = {"termination": term, "objective": f1,
                    "rel_vs_solve_qp": rel, "rel_round_trip": rel2,
                    "arrays_identical": identical, "mps_bytes": len(text),
                    "kkt_report": {k: float(v) for k, v in
                                   rep._asdict().items()}}
        log("outer", f"{tag}: {term}, objective {f1:.9g}, vs solve_qp "
            f"{rel:.2e}, after write_mps/read_mps {term2} {rel2:.2e} "
            f"(arrays identical {identical}; {len(text)} bytes of MPS), "
            f"launches {launches}; kkt_report {out[tag]['kkt_report']}")
    gap = abs(objs["f32"] - objs["f64"]) / max(1.0, abs(objs["f64"]))
    out["config4 f32 vs f64 objgap"] = gap
    if not gap < 1e-6:
        raise RuntimeError(f"model config4: f32 vs f64 gap {gap:.3e}")

    lp = {}
    for dt in (np.float32, np.float64):
        m = config2_model(dt)
        term, launches = counted(torch, lambda: m.optimize())
        lp[dt] = (m, term, launches)
    m32, term32, l32 = lp[np.float32]
    m64, term64, _ = lp[np.float64]
    text = write_mps(m32)
    mr, lr = counted(torch, lambda: solve_mps(text, dtype=np.float32))
    f32, f64, fr = (m32.objective_value(), m64.objective_value(),
                    mr.objective_value())
    rel = abs(f32 - f64) / max(1.0, abs(f64))
    if (term32 != "OPTIMAL" or term64 != "OPTIMAL"
            or mr.termination_status() != "OPTIMAL" or not rel < 5e-5
            or not abs(fr - f32) <= 1e-6 * max(1.0, abs(f32))
            or l32["chol_solve"] <= 0
            or lr["chol_solve"] <= 0):
        raise RuntimeError(f"model config2 LP: {term32}/{term64}, f32 vs "
                           f"f64 {rel:.2e}, solve_mps {fr} vs {f32}, "
                           f"launches {l32} {lr}")
    counters["model config2 LP f32"] = l32
    counters["solve_mps config2 LP f32"] = lr
    out["model config2 LP f32"] = {"termination": term32, "objective": f32,
                                   "rel_vs_f64": rel,
                                   "solve_mps_objective": fr}
    log("outer", f"model config2 LP f32: {term32}, objective {f32:.7g}, vs "
        f"f64 {rel:.2e} (bar 5e-5), solve_mps read-back {fr:.7g}; "
        f"launches {l32}, solve_mps {lr}")

    # kkt_report on the batch sweep's results, and a trace of one sweep
    from ssqp_tpu_torch.models import frontier as tf

    fr_b, g0 = sweep_results["batch"]
    Q, _, _ = bench_problem(torch, torch.float32)
    Qb, _ = frontier_batch(Q, g0)
    rep = kkt_report(Qb, Result(fr_b.x, fr_b.S, fr_b.status), batched=True)
    out["kkt_report batch sweep (max)"] = {
        k: float(v.float().max()) for k, v in rep._asdict().items()}
    log("outer", f"kkt_report over the batch sweep's {B_SWEEP} points (max):"
        f" {out['kkt_report batch sweep (max)']}")
    logdir = _build_root() / "traces"
    before = set(logdir.glob("*.json")) if logdir.exists() else set()
    s32 = Settings.for_dtype(torch.float32)
    with trace(str(logdir)):
        tf.frontier_batch_sweep(Q, Q.q, g0, s32)
        torch.cuda.synchronize()
    new = sorted(set(logdir.glob("*.json")) - before)
    size = new[0].stat().st_size if new else 0
    if len(new) != 1 or size <= 0:
        raise RuntimeError(f"trace: wrote {new} ({size} bytes)")
    events = json.loads(new[0].read_text()).get("traceEvents", [])
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    out["trace"] = {"bytes": size, "events": len(events),
                    "kernel_events": kernels}
    log("outer", f"trace(): {new[0].name}, {size} bytes, {len(events)} "
        f"events, {kernels} kernel events")
    return out, counters


def _build_root():
    from ssqp_tpu_torch.ops import _build

    return _build.build_dir()


def phase_outer_sharded(torch):
    """11d: a world-size-1 NCCL group (file store under build/): the sharded
    QP solve of config 5's per-card batch equals solve_qp_batch_auto, and the
    sharded LP solve of config 2's mixed batch equals solve_lp_batch_auto."""
    import torch.distributed as dist

    from ssqp_tpu_torch import Settings
    from ssqp_tpu_torch.parallel.batch import (
        frontier_batch, solve_lp_batch_auto, solve_qp_batch_auto)
    from ssqp_tpu_torch.parallel.sharded import (
        solve_lp_sharded, solve_qp_sharded)

    store = _build_root() / f"nccl_store_{time.time_ns()}"
    store.parent.mkdir(parents=True, exist_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=1, rank=0)
    out, counters = {}, {}
    try:
        s32 = Settings.for_dtype(torch.float32)
        Q, _, _ = bench_problem(torch, torch.float32)
        Qb, sh = frontier_batch(Q, grid(torch, 0, B_BIG))
        (res, stats), launches = counted(
            torch, lambda: solve_qp_sharded(Qb, s32, shared=sh))
        ref = solve_qp_batch_auto(Qb, s32, sh)
        same = (torch.equal(res.x, ref.x) and torch.equal(res.S, ref.S)
                and torch.equal(res.status, ref.status))
        st = {k: int(v) for k, v in stats.items()}
        if not same or st["solved"] != B_BIG or launches["cg_rows"] <= 0:
            raise RuntimeError(f"sharded QP: identical {same}, stats {st}, "
                               f"launches {launches}")
        counters[f"sharded QP world=1 B={B_BIG}"] = launches
        out["qp"] = {"B": B_BIG, "stats": st, "identical": same}
        P, shp = lp_problem(torch, torch.float32, "mixed", 0, B_LP)
        (rl, sl), ll = counted(torch, lambda: solve_lp_sharded(P, s32,
                                                               shared=shp))
        refl = solve_lp_batch_auto(P, s32, shp)
        samel = (torch.equal(rl.x, refl.x)
                 and torch.equal(rl.status, refl.status))
        stl = {k: int(v) for k, v in sl.items()}
        if not samel or stl["solved"] != B_LP:
            raise RuntimeError(f"sharded LP: identical {samel}, stats {stl}")
        counters[f"sharded LP world=1 B={B_LP}"] = ll
        out["lp"] = {"B": B_LP, "stats": stl, "identical": samel}
        log("outer", f"solve_qp_sharded (NCCL, world 1) N={N_MAIN} "
            f"B={B_BIG}: identical to solve_qp_batch_auto {same}, stats {st},"
            f" launches {launches}; solve_lp_sharded config2 mixed "
            f"B={B_LP}: identical {samel}, stats {stl}, launches {ll}")
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    return out, counters


def phase_outer_warmup(torch):
    """11e: utils/aot.py::warmup at (256, 1, 0) with batch=256."""
    from ssqp_tpu_torch.utils.aot import enable_compilation_cache, warmup

    path = enable_compilation_cache()
    n, launches = counted(torch, lambda: warmup(((256, 1, 0),), batch=256))
    if n != 2 or launches["cg_rows"] <= 0:
        raise RuntimeError(f"warmup: {n} entry points, launches {launches}")
    log("outer", f"warmup(((256, 1, 0),), batch=256): {n} entry points, "
        f"launches {launches}, kernel cache {path}")
    return {"entry_points": n}, {
        "warmup (256, 1, 0) batch=256": launches}


def phase_outer(torch):
    """Phase 11: the outer layers on the card (module docstring)."""
    sweeps, c1, results = phase_outer_sweeps(torch)
    diff, c2 = phase_outer_diff(torch)
    model, c3 = phase_outer_model(torch, results)
    sharded, c4 = phase_outer_sharded(torch)
    warm, c5 = phase_outer_warmup(torch)
    counters = {**c1, **c2, **c3, **c4, **c5}
    for route, c in counters.items():
        qp_route = not route.startswith(("model config2", "solve_mps config2",
                                         "sharded LP"))
        if qp_route and c["cg_rows"] <= 0:
            raise RuntimeError(f"outer {route}: no CG kernel launch")
    return {"sweeps": sweeps, "diff": diff, "model": model,
            "sharded": sharded, "warmup": warm}, counters


# ---- phase 13: the PDAS variants --------------------------------------

PDAS_FLAGS = ("default", "pdas_pcg", "pdas_cheb")


def phase_pdas(torch):
    """Phase 12: the frontier (N=256, B=2048, float32) through
    solve_qp_batch_auto (its plain route) with the default PDAS rounds, the
    W-PCG rounds and the Chebyshev rounds; the Chebyshev interval against
    the spectrum on the card."""
    from ssqp_tpu_torch import Settings
    from ssqp_tpu_torch.ops import kkt
    from ssqp_tpu_torch.ops.kkt import shared_jacobi_bounds
    from ssqp_tpu_torch.parallel.batch import (
        frontier_batch, solve_qp_batch, solve_qp_batch_auto)
    from ssqp_tpu_torch.solvers import ssqp

    s32 = Settings.for_dtype(torch.float32)
    flags = {f: s32 if f == "default" else dataclasses.replace(s32,
                                                               **{f: True})
             for f in PDAS_FLAGS}
    Q, V, mu = bench_problem(torch, torch.float32)
    out, counters = {"bounds": {}}, {}

    W, _ = ssqp._pdas_shared_W(Q.V, s32)
    s = torch.diagonal(Q.V).double().rsqrt()
    ev = torch.linalg.eigvalsh(s[:, None] * Q.V.double() * s[None, :])
    ev_lo, ev_hi = float(ev.min()), float(ev.max())
    for tag, Wb in (("with W", W), ("without W", None)):
        lo, hi = (float(t) for t in shared_jacobi_bounds(Q.V, Wb))
        out["bounds"][tag] = {"lo": lo, "hi": hi}
        log("pdas", f"shared_jacobi_bounds {tag}, N={N_MAIN} f32 on the "
            f"card: [{lo:.6g}, {hi:.6g}] around the Jacobi-scaled spectrum "
            f"[{ev_lo:.6g}, {ev_hi:.6g}] (float64 eigvalsh)")
        if not (lo <= ev_lo and hi >= ev_hi):
            raise RuntimeError(f"pdas: the interval {tag} misses the "
                               "spectrum")
    out["bounds"]["spectrum"] = {"lo": ev_lo, "hi": ev_hi}

    Qb, sh = frontier_batch(Q, grid(torch, 0, B_AUTO))
    lams = grid(torch, 0, B_AUTO).double()
    results = {}
    for name, st in flags.items():
        rounds = Spy(ssqp, "_pdas_round", lambda a, k: int(a[2].shape[0]))
        # each Chebyshev or PCG iteration (ops/kkt.py _vp_cheb, _vp_pcg)
        # applies the padded operator once (_vp_apply), the starting
        # residual once more
        applies, per_call = Spy(kkt, "_vp_apply", lambda a, k: None), []

        def inner(real, a, k, per_call=per_call):
            n0 = len(applies.calls)
            out = real(*a, **k)
            per_call.append(len(applies.calls) - n0 - 1)
            return out

        spies = [rounds, applies] + [Spy(kkt, n, run=inner)
                                     for n in ("_vp_cheb", "_vp_pcg")]
        try:
            res, launches = counted(
                torch, lambda: solve_qp_batch_auto(Qb, st, sh))
        finally:
            for spy in reversed(spies):
                spy.undo()
        tag = f"pdas {name} N={N_MAIN} B={B_AUTO}"
        check_solution(torch, res, Qb, B_AUTO, tag)
        if launches["cg_rows"] <= 0 or bool(per_call) != (
                name != "default"):
            raise RuntimeError(f"{tag}: CG launches {launches}, inner "
                               f"solves {per_call}")
        results[name], counters[tag] = res, launches
        st_f = res.status.float()
        out[name] = {"pdas_rounds": len(rounds.calls),
                     "round_widths": rounds.calls,
                     "inner_iters_per_round": per_call,
                     "cg_launches": launches["cg_rows"],
                     "s_iters_median": float(st_f.median()),
                     "s_iters_max": float(st_f.max())}
        log("pdas", f"{tag} f32: solved {B_AUTO}/{B_AUTO}; PDAS rounds "
            f"{len(rounds.calls)} on {rounds.calls} instances; "
            + (f"{name[5:]} iterations per round {per_call}; "
               if per_call else "")
            + f"CG kernel launches {launches['cg_rows']} "
            f"{launches['cg_by_body']}; S-iterations med "
            f"{float(st_f.median()):.0f} max {float(st_f.max()):.0f}")

    Q64, _, _ = bench_problem(torch, torch.float64)
    S0 = results["default"].S
    for name in PDAS_FLAGS[1:]:
        diff = (results[name].S != S0).any(1).nonzero().squeeze(1)
        gap = 0.0
        if diff.numel():
            Qd, shd = frontier_batch(Q64, lams[diff])
            r64 = solve_qp_batch(Qd, Settings(), shared=shd)
            if not bool((r64.status > 0).all()):
                raise RuntimeError(f"pdas {name}: the float64 solve failed")
            gap = float(objgap(Qd, results[name].x[diff], r64.x).max())
        out[name]["S_differs"] = int(diff.numel())
        out[name]["max_objgap_where_S_differs"] = gap
        log("pdas", f"{name}: S differs from the default's on "
            f"{diff.numel()}/{B_AUTO} instances; there max objective gap "
            f"to float64 {gap:.3e} (bar 1e-6)")
        if not gap < 1e-6:
            raise RuntimeError(f"pdas {name}: gap {gap:.3e} where S "
                               "differs")
    return out, counters


# ---- phase 14: bench_suite.py::config7 --------------------------------

C7_PTS, C7_FINE, C7_COARSE, C7_AUDIT = 16, 256, 64, 96


def config7_datasets():
    """bench_suite.py::config7's two datasets from the port's problem
    library: (name, E, V, constraint arrays, L range)."""
    from ssqp_tpu_torch.utils.problems import sp500_like, ungil_like

    E1, V1, A1, b1, G1, g1, d1, u1 = ungil_like()
    E2, V2, u2 = sp500_like()
    return (("ungil_n14", E1, V1, dict(A=A1, b=b1, G=G1, g=g1, d=d1, u=u1),
             (1e-3, 50.0)),
            ("sp500_n263", E2, V2, dict(u=u2), (1e-3, 3.0)))


def fine_mu_grid(S, mus_c):
    """config7's fine grid: 16 points per segment of the coarse mu sweep
    (a segment ends where the active set changes), subsampled or padded to
    C7_FINE points. Returns (grid, segments, points before the cut)."""
    brk = np.nonzero(np.any(S[1:] != S[:-1], axis=1))[0]
    edges = np.unique(np.concatenate([[0], brk + 1, [len(mus_c) - 1]]))
    n_seg = len(edges) - 1
    fine = np.concatenate([
        np.linspace(mus_c[edges[k]], mus_c[edges[k + 1]], C7_PTS,
                    endpoint=False) for k in range(n_seg)]
        + [[mus_c[edges[-1]]]])
    n_true = len(fine)
    if n_true > C7_FINE:
        fine = fine[np.linspace(0, n_true - 1, C7_FINE).astype(int)]
    else:
        fine = np.concatenate([fine, np.full(C7_FINE - n_true, fine[-1])])
    return fine, n_seg, n_true


def phase_config7(torch):
    """Phase 13: bench_suite.py::config7 on the card (module docstring)."""
    from ssqp_tpu_torch import Result, Settings, make_qp
    from ssqp_tpu_torch.models import frontier as tf
    from ssqp_tpu_torch.solvers.refine import refine_result

    s32, s64 = Settings.for_dtype(torch.float32), Settings()
    out, counters = {}, {}
    for name, E, V, kw, (lam_lo, lam_hi) in config7_datasets():
        N = len(E)
        f32 = lambda a: np.asarray(a, np.float32)
        Q32 = make_qp(f32(V), np.zeros(N, np.float32), dtype=np.float32,
                      device="cuda", **{k: f32(v) for k, v in kw.items()})
        Q64 = make_qp(V, np.zeros(N), device="cuda", **kw)
        rets = torch.tensor(E, dtype=torch.float32, device="cuda")
        t32 = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda")
        geo = lambda n: np.concatenate([[0.0], np.geomspace(lam_lo, lam_hi,
                                                            n - 1)])
        o = {"N": N}

        def sweep(tag, fn, grid_):
            fr, launches = counted(torch, lambda: fn(Q32, rets, t32(grid_),
                                                     s32))
            n = len(grid_)
            solved = int((fr.status > 0).sum())
            st = fr.status.float()
            o[tag] = {"points": n, "solved": solved,
                      "s_iters": int(fr.status.clamp(min=0).sum()),
                      "s_iters_median": float(st.median()),
                      "s_iters_max": float(st.max()),
                      "cg_launches": launches["cg_rows"]}
            counters[f"config7 {name} {tag}"] = launches
            log("config7", f"{name} {tag}: solved {solved}/{n}, S-iterations "
                f"{o[tag]['s_iters']} (med {float(st.median()):.0f}, max "
                f"{float(st.max()):.0f}), CG launches {launches['cg_rows']}")
            if solved != n or launches["cg_rows"] <= 0:
                raise RuntimeError(f"config7 {name} {tag}: solved "
                                   f"{solved}/{n}, launches {launches}")
            return fr

        fl = sweep("coarse L warm", tf.frontier_warm_sweep, geo(C7_COARSE))
        ret_c = fl.ret.double().cpu().numpy()
        rmin, rmax = float(ret_c.min()), float(ret_c.max())
        span = rmax - rmin
        mus_c = np.linspace(rmin + 0.01 * span, rmax - 0.01 * span,
                            C7_COARSE)
        fmc = sweep("coarse mu warm", tf.frontier_mu_warm_sweep, mus_c)
        fine, n_seg, n_true = fine_mu_grid(fmc.S.cpu().numpy(), mus_c)
        o.update(segments=n_seg, fine_points=n_true)
        log("config7", f"{name}: {n_seg} segments x {C7_PTS} = {n_true} "
            f"points, " + (f"subsampled to {C7_FINE}" if n_true > C7_FINE
                           else f"padded to {C7_FINE}"))
        fm = sweep("fine mu warm", tf.frontier_mu_warm_sweep, fine)
        sweep("fine L warm", tf.frontier_warm_sweep, geo(C7_FINE))

        # the audit: C7_AUDIT points of the fine mu grid, the float32 sweep
        # and its float64 refinement on its labels (solvers/refine.py,
        # LU) against the port's float64 solve on the card
        idx = np.linspace(0, C7_FINE - 1, C7_AUDIT).astype(int)
        rets64 = torch.tensor(E, device="cuda")
        mus_a = torch.tensor(fine[idx], device="cuda")
        ref = tf.frontier_mu_sweep(Q64, rets64, mus_a, s64)
        if not bool((ref.status > 0).all()):
            raise RuntimeError(f"config7 {name}: the float64 solve failed")
        ti = torch.tensor(idx, device="cuda")
        res_in = Result(fm.x[ti].double(), fm.S[ti], fm.status[ti])
        Qmu = tf._with_mu_row(Q64, rets64, mus_a)
        rr = refine_result(Qmu, res_in, s64, 2, with_duals=False)
        Vd = Q64.V
        fobj = lambda X: 0.5 * (X * (X @ Vd)).sum(1)
        fz = fobj(ref.x)
        for tag, X in (("f32", res_in.x), ("refined", rr.x)):
            gaps = ((fobj(X) - fz).abs() / fz.abs().clamp(min=1.0))
            xinf = (X - ref.x).abs().amax(1)
            o[f"{tag}_objgap"] = quantiles(gaps.cpu().numpy())
            o[f"{tag}_xinf"] = quantiles(xinf.cpu().numpy())
            log("config7", f"{name} {tag} ({C7_AUDIT} f64 refs on the "
                f"card): objgap {o[f'{tag}_objgap']} xinf "
                f"{o[f'{tag}_xinf']}")
        if not o["refined_objgap"]["max"] < 1e-6:
            raise RuntimeError(f"config7 {name}: refined gap "
                               f"{o['refined_objgap']['max']:.3e} >= 1e-6")
        out[name] = o
    return out, counters


# ---- phase 15: bench_suite.py::config8 --------------------------------


def phase_config8(torch):
    """Phase 14: bench_suite.py::config8's frontier at N=512 and 1024,
    B=8192, float32, through solve_qp_batch_auto (module docstring)."""
    from ssqp_tpu_torch import Settings
    from ssqp_tpu_torch.parallel import batch
    from ssqp_tpu_torch.parallel.batch import (
        frontier_batch, solve_qp_batch, solve_qp_batch_auto)
    from ssqp_tpu_torch.solvers import refine

    s32 = Settings.for_dtype(torch.float32)
    out, counters = {}, {}
    for N in C8_N:
        Q, V, mu = bench_problem(torch, torch.float32, N=N)
        B = C8_B
        Qb, sh = frontier_batch(Q, grid(torch, 0, B))
        # the tail's raw search result (the waves protocol's) and each
        # refinement pass's width
        raw = []

        def search(real, a, k):
            raw.append(real(*a, **k))
            return raw[-1]

        spies = (Spy(batch, "solve_qp_batch_waves", run=search),
                 Spy(refine, "refine_result_cg",
                     lambda a, k: int(a[1].x.shape[0])))
        try:
            res, launches = counted(
                torch, lambda: solve_qp_batch_auto(Qb, s32, sh))
        finally:
            for spy in spies:
                spy.undo()
        passes = spies[1].calls
        tag = f"config8 N={N} B={B}"
        check_solution(torch, res, Qb, B, tag)
        if len(raw) != 1 or launches["cg_rows"] <= 0:
            raise RuntimeError(f"{tag}: route searches {len(raw)}, "
                               f"launches {launches}; the rule takes waves=8"
                               " and the tail")
        raw = raw[0]
        changed = int((res.x != raw.x).any(1).sum())
        o = {"route": "waves=8 + tail (4)", "tail_passes": passes,
             "tail_instances": sum(passes),
             "tail_accepted": changed, "cg_launches": launches["cg_rows"],
             "cg_by_body": launches["cg_by_body"]}
        counters[tag] = launches
        log("config8", f"{tag} f32 through solve_qp_batch_auto: waves=8 + "
            f"the tail; solved {B}/{B}; tail passes (instances) "
            f"{passes}, accepted corrections {changed}; CG launches "
            f"{launches['cg_rows']} by body {launches['cg_by_body']}")

        # the audit: C8_AUDIT instances of grid 0 in float64 on the card
        Q64, _, _ = bench_problem(torch, torch.float64, N=N)
        idx = torch.linspace(0, B - 1, C8_AUDIT, device="cuda").long()
        Qa, sha = frontier_batch(Q64, grid(torch, 0, B).double()[idx])
        r64 = solve_qp_batch(Qa, Settings(), shared=sha)
        if not bool((r64.status > 0).all()):
            raise RuntimeError(f"{tag}: the float64 audit solve failed")
        gaps = objgap(Qa, res.x[idx], r64.x).cpu().numpy()
        raw_gaps = objgap(Qa, raw.x[idx], r64.x).cpu().numpy()
        o.update(audit_objgap=quantiles(gaps),
                 audit_objgap_before_tail=quantiles(raw_gaps))
        log("config8", f"{tag}: f64 on the card ({C8_AUDIT} refs): objgap "
            f"after the tail {quantiles(gaps)}; before it "
            f"{quantiles(raw_gaps)}")
        if not gaps.max() < 1e-6:
            raise RuntimeError(f"{tag}: objective gap {gaps.max():.3e} >= "
                               "1e-6")
        out[f"N={N}"] = o
    return out, counters


def quantiles(a):
    return {k: float(np.quantile(a, p)) for k, p in
            (("q01", 0.01), ("median", 0.5), ("q99", 0.99), ("max", 1.0))}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    from ssqp_tpu_torch.ops import _build, chol

    card = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    log("device", f"{name}; nvidia-smi: {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.load()
    log("build", f"CUDA kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    ptxas = ptxas_summary(_build.ptxas_report())
    for kname, regs, st, ld, smem in ptxas:
        log("build", f"ptxas {kname}: {regs} registers, spill stores {st} "
            f"B, spill loads {ld} B, static shared {smem} B")

    walls = {}

    def wall(phase, *args):
        """``phase(torch, *args)``, its host wall time logged and summed
        by phase."""
        t = time.perf_counter()
        out = phase(torch, *args)
        dt = time.perf_counter() - t
        walls[phase.__name__] = walls.get(phase.__name__, 0.0) + dt
        log("wall", f"{phase.__name__}: {dt:.1f} s")
        return out

    worst, ktimes, exits = wall(phase_kernel)
    chol_worst, ctimes = wall(phase_chol)
    sx_checks, sx_times, sx_launches = wall(phase_simplex)
    res_auto, res_big, main_launches = wall(phase_main)
    wall(phase_audit, res_auto, B_AUTO)
    wall(phase_audit, res_big, B_BIG)
    res_ineq, ineq_launches = wall(phase_ineq)
    wall(phase_ineq_audit, res_ineq)
    refined, ref_launches = wall(phase_refined)
    lp, lp_launches = wall(phase_lp)
    outer, outer_launches = wall(phase_outer)
    pdas, pdas_launches = wall(phase_pdas)
    c7, c7_launches = wall(phase_config7)
    c8, c8_launches = wall(phase_config8)

    routes = dict(main_launches)
    routes["ineq auto B=256 (plain + tail)"] = ineq_launches
    routes.update({f"refined {m} B={B_REF} N={N_REF}": c
                   for m, c in ref_launches.items()})
    routes.update({f"lp {tag}": c for tag, c in lp_launches.items()})
    routes.update({f"outer {tag}": c for tag, c in outer_launches.items()})
    for launches in (pdas_launches, c7_launches, c8_launches):
        routes.update(launches)
    routes["simplex B=256 (solve_lp_batch_auto)"] = sx_launches
    paths = {k: {route: c[k] for route, c in routes.items()}
             for k in ("cg_rows", "chol_solve", "simplex")}
    by_body = {route: c["cg_by_body"] for route, c in routes.items()
               if c.get("cg_by_body")}
    print(json.dumps({"refined": refined, "lp": lp,
                      "outer": outer, "pdas": pdas, "config7": c7,
                      "config8": c8, "wall_s": walls}))
    head = ktimes[CG_TIMED[0][0]]
    ch = ctimes[CHOL_TIMED[0]]
    ch_b, ch_by = chol_bound(*CHOL_TIMED[0])
    fmt = lambda sh: "(%d, %d, %d)" % sh
    by_shape = {p: {fmt(sh): c for sh, c in sorted(launches["chol_by_shape"]
                                                   .items())}
                for p, launches in routes.items() if "chol_by_shape" in
                launches}
    shapes_run = set().union(*(c.get("chol_by_shape", {})
                               for c in routes.values()))
    print(json.dumps({"kernels": [{
        "name": "cg_rows",
        "route": "cuda",
        "source": "ssqp_tpu_torch/ops/csrc/cg.cu",
        "replaces": "ssqp_tpu/ops/pallas_cg.py:56",
        "launches": sum(paths["cg_rows"].values()),
        "launches_by_path": paths["cg_rows"],
        "launches_by_body": by_body,
        "max_abs_err": worst,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        # the least time on the card: the matvec as three TF32 products,
        # the kernel's route; "shapes" also give the FFMA-route bound
        "bound_ms": head["bound_3xtf32_ms"],
        "bound_by": head["bound_3xtf32_by"],
        "bound_route": "3xTF32 tensor cores",
        "library_ms": None,
        "shape": f"{CG_TIMED[0][0]}, N={CG_TIMED[0][2]}, "
                 f"{CG_TIMED[0][3]} steps, f32",
        "shapes": [dict(shape=f"{label}, N={N}, {steps} steps, f32",
                        **ktimes[label])
                   for label, C, N, steps in CG_TIMED]
        + [dict(shape=f"{label}, N={N}, {steps} steps", **ktimes[label])
           for label, C, N, steps in CG_TIMED_F64 + CG_TIMED_C4],
        "ptxas": [{"kernel": k, "registers": r, "spill_stores": st,
                   "spill_loads": ld} for k, r, st, ld, _ in ptxas
                  if "cg_" in k],
        "tile_exit": exits,
    }, {
        "name": "chol_solve",
        "route": "cuda",
        "source": "ssqp_tpu_torch/ops/csrc/chol.cu",
        "replaces": "ssqp_tpu/ops/pallas_chol.py:43",
        "launches": sum(paths["chol_solve"].values()),
        "launches_by_path": paths["chol_solve"],
        "launches_by_shape": by_shape,
        "body_by_shape": {fmt(sh): chol.body(sh[1], sh[2])
                          for sh in sorted(shapes_run | set(CHOL_TIMED))},
        "max_abs_err": chol_worst,
        **ch,  # ms, plain_ms, library_ms
        "bound_ms": ch_b,
        "bound_by": ch_by,
        "shape": "(B, n, K) = %s, f32" % fmt(CHOL_TIMED[0]),
        "other_shapes": [dict(shape="(B, n, K) = %s, f32" % fmt(sh),
                              **ctimes[sh], bound_ms=chol_bound(*sh)[0],
                              bound_by=chol_bound(*sh)[1])
                         for sh in CHOL_TIMED[1:]],
        "ptxas": [{"kernel": k, "registers": r, "spill_stores": st,
                   "spill_loads": ld} for k, r, st, ld, _ in ptxas
                  if "chol_" in k],
    }, {
        "name": "simplex",
        "route": "cuda",
        "source": "ssqp_tpu_torch/ops/csrc/simplex.cu",
        "replaces": "none: the host loop of solvers/simplex.py (the JAX "
                    "package's lax.while_loop under vmap)",
        "launches": sum(paths["simplex"].values()),
        "launches_by_path": paths["simplex"],
        "checks": sx_checks,
        "shape": "(B, R, Nt) = (%d, %d, %d), f32, one request's phases"
                 % (B_LP, R_LP, NT_LP),
        "phases": sx_times,
        "ms": sum(t["ms"] for t in sx_times.values()),
        "plain_ms": sum(t["plain_ms"] for t in sx_times.values()),
        "bound_ms": sum(t["bound_ms"] for t in sx_times.values()),
        "bound_dfma_ms": sum(t["bound_dfma_ms"] for t in sx_times.values()),
        "library_ms": None,
        "ptxas": [{"kernel": k, "registers": r, "spill_stores": st,
                   "spill_loads": ld} for k, r, st, ld, _ in ptxas
                  if "simplex" in k],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
