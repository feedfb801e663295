"""Smoke run of the PyTorch/CUDA port (ssqp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each; any failure raises and the exit code is not 0):

  1. device     — requires CUDA; prints the card's name and power limit;
  2. build      — compiles the CUDA kernels from ssqp_tpu_torch/ops/csrc
                  (one nvcc per source, started together);
  3. kernel     — the fused CG kernel against its plain PyTorch version on
                  the card (f32 and f64; shared V at N=256, odd shapes,
                  per-instance V) and both times at the main path's shapes;
  4. chol       — the batched Cholesky kernel against its plain version on
                  the card (f32, at the ineq path's shapes, an odd n, a
                  non-PD instance), and the times of the kernel, the plain
                  version and the library pair (cholesky_ex + cholesky_solve);
  5. main       — the frontier-QP path through the port's entry points at
                  N=256 (solve_qp_batch_auto at B=2048, solve_qp_batch at
                  B=8192, float32), with the kernels' launch counts and QP/s;
  6. audit      — 256 of the B=2048 instances re-solved in float64 on the
                  card; objective gap and ||x - z||_inf quantiles, max gap
                  < 1e-6;
  7. ineq       — the general-inequality path at BASELINE config 4's widths
                  (N=512, M=10, J=100, float32, B_INEQ instances with shared
                  V, A, b, G, g, d, u and varying q) through
                  solve_qp_batch_auto, which takes the plain protocol and the
                  tail refinement; feasibility, launch counts, S-iterations,
                  how many instances the tail refined, and QP/s;
  8. ineq-audit — 32 of those instances re-solved in float64 on the card;
                  objective gap and ||x - z||_inf quantiles, max gap < 1e-6.

Then one JSON line with the kernel table (each kernel's launches on the two
paths, its worst error against the plain version, its time, the plain
version's, the library call's and the bound), the nvidia-smi line, and, last,
``{"ok": true, "device": {...}}``. The frontier problem is the headline
benchmark's (bench.py): seed 7, V = HH'/N + 0.5 I, mu ~ U(0, 0.2),
0 <= x <= 4/N. The ineq problem is bench_suite.py::config4's generator, seed
4: V = HH'/N + 0.5 I, b = A x0, g = G x0 + U(0.1, 1), d = x0 - 2, u = x0 + 2,
q ~ N(0, 1) per instance.
"""

import json
import subprocess
import sys
import time

import numpy as np

N_MAIN = 256
B_AUTO = 2048
B_BIG = 8192
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
# H100 SXM data sheet: float32 outside the
# tensor cores, HBM3 bandwidth. The card's power limit is printed beside.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


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
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel(torch):
    from ssqp_tpu_torch.ops import cg

    rng = np.random.default_rng(11)
    worst = 0.0
    cases = [("N=256 K=2 batch=2048 shared V", 256, 2, 2048, False, 200),
             ("N=13 K=3 batch=5 shared V", 13, 3, 5, False, 300),
             ("N=256 K=2 batch=64 per-instance V", 256, 2, 64, True, 200)]
    # the ineq path's shape: N=512, shared V, 1+R = 111 columns for each of
    # B_INEQ instances, the tail sweep's 96 steps
    ineq = [(f"N={N_INEQ} K={1 + M_INEQ + J_INEQ} batch={B_INEQ} shared V",
             N_INEQ, 1 + M_INEQ + J_INEQ, B_INEQ, False, 96)]
    for dtype, tol, extra in ((torch.float32, F32_TOL, ineq),
                              (torch.float64, F64_TOL, [])):
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
            log("kernel", f"{str(dtype)[6:]} {name}: max|dX| {err:.3e} "
                f"(tol {tol:g}), converged rows {n_conv}/{batch * K} "
                f"rr<=1.01*tol2 {rr_ok}")
            if not (err <= tol and rr_ok and np.isfinite(err)):
                raise RuntimeError(f"kernel disagrees with plain version: {name}")
            worst = max(worst, err)

    times = {}
    for batch in (B_AUTO, B_BIG):
        V, FM, B, DINV, TOL2, X0 = cg_problem(torch, rng, N_MAIN, 2, batch,
                                              torch.float32)
        TOL2 = torch.zeros_like(TOL2)  # never converges: exactly 64 steps
        Br, X0r, fmr, dinvr, tol2r = cg._rows(B, FM, DINV, TOL2, X0)
        kern = lambda: cg.cg_padded_rows(V, fmr, dinvr, Br, tol2r, 64, X0r)
        plain = lambda: cg.cg_rows_reference(V, fmr, dinvr, Br, tol2r, 64,
                                             X0r)
        t_k1, t_p1 = cuda_time(torch, kern), cuda_time(torch, plain)
        t_k2, t_p2 = cuda_time(torch, kern), cuda_time(torch, plain)
        tk, tp = min(t_k1, t_k2), min(t_p1, t_p2)
        times[batch] = (tk, tp)
        log("kernel", f"f32 N={N_MAIN} C={2 * batch} rows, 64 cold steps: "
            f"kernel {tk:.3f} ms, plain {tp:.3f} ms "
            f"(runs {t_k1:.3f}/{t_k2:.3f} vs {t_p1:.3f}/{t_p2:.3f})")
    return worst, times


def bound(flops, nbytes):
    """(least time in ms, what bounds it) against the card's published
    float32 and memory peaks."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def cg_bound(C, N, iters):
    """One fused CG solve of C rows for ``iters`` steps (every row runs all
    of them here): per row and step the V matvec (2 N^2) and the vector
    updates and sums (~14 N); V, fm, dinv, B, X0 and tol2 read once, X and
    rr written once, float32."""
    return bound(iters * C * (2 * N * N + 14 * N),
                 4 * (N * N + 5 * C * N + 2 * C))


def chol_bound(B, n, K):
    """One factor-and-solve of B instances: n^3/3 FLOPs for the factor and
    2 n^2 K for the two substitutions; A and RHS read once, X written once,
    float32."""
    return bound(B * (n**3 / 3 + 2 * n * n * K), 4 * B * (n * n + 2 * n * K))


def spd_batch(rng, B, n, kappa=100.0):
    """SPD batch with eigenvalues log-spaced in [1, kappa]."""
    Qm, _ = np.linalg.qr(rng.standard_normal((B, n, n)))
    A = (Qm * np.logspace(0.0, np.log10(kappa), n)) @ Qm.transpose(0, 2, 1)
    return (A + A.transpose(0, 2, 1)) / 2


CHOL_TIMED = ((256, 110, 1), (256, 110, 110))


def phase_chol(torch):
    from ssqp_tpu_torch.ops import chol

    rng = np.random.default_rng(13)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda")
    data = {}
    worst = 0.0
    for B, n, K in ((256, 110, 1), (256, 110, 110), (256, 110, 100),
                    (8, 512, 111), (64, 37, 3)):
        A, R = t(spd_batch(rng, B, n)), t(rng.standard_normal((B, n, K)))
        data[B, n, K] = (A, R)
        Xk = chol.chol_solve_batch(A, R)
        Xp = chol.chol_solve_reference(A, R)
        torch.cuda.synchronize()
        err = float((Xk - Xp).abs().max())
        tol = CHOL_TOL * float(Xp.abs().max())
        log("chol", f"f32 (B, n, K) = ({B}, {n}, {K}): max|dX| {err:.3e} "
            f"(tol {tol:.3e})")
        if not err <= tol:
            raise RuntimeError(f"chol kernel disagrees with plain version at "
                               f"{(B, n, K)}")
        worst = max(worst, err)
    # a negative pivot in instance 0: no fault, no solution there, the
    # other instances as the plain version
    A = spd_batch(rng, 4, 110)
    A[0, 40, 40] = -1.0
    R = rng.standard_normal((4, 110, 1))
    Xk = chol.chol_solve_batch(t(A), t(R))
    Xp = chol.chol_solve_reference(t(A), t(R))
    Xn = Xk.double().cpu().numpy()
    bad = (not np.isfinite(Xn[0]).all()
           or np.abs(A[0] @ Xn[0] - R[0]).max() > 1e-2)
    err = float((Xk[1:] - Xp[1:]).abs().max())
    log("chol", f"non-PD instance: kernel returns no solution {bad}; the "
        f"other three max|dX| {err:.3e}")
    if not (bad and err <= CHOL_TOL * float(Xp[1:].abs().max())):
        raise RuntimeError("chol kernel on non-PD input")

    times = {}
    for shape in CHOL_TIMED:
        A, R = data[shape]
        kern = lambda: chol.chol_solve_batch(A, R)
        plain = lambda: chol.chol_solve_reference(A, R)
        lib = lambda: torch.cholesky_solve(R, torch.linalg.cholesky_ex(A)[0])
        tk1, tp1, tl1 = (cuda_time(torch, kern), cuda_time(torch, plain),
                         cuda_time(torch, lib))
        tl2, tp2, tk2 = (cuda_time(torch, lib), cuda_time(torch, plain),
                         cuda_time(torch, kern))
        times[shape] = (min(tk1, tk2), min(tp1, tp2), min(tl1, tl2))
        log("chol", f"f32 (B, n, K) = {shape}: kernel {times[shape][0]:.4f} "
            f"ms, plain {times[shape][1]:.3f} ms, library "
            f"{times[shape][2]:.4f} ms, bound {chol_bound(*shape)[0]:.5f} ms "
            f"(runs {tk1:.4f}/{tk2:.4f}, {tp1:.3f}/{tp2:.3f}, "
            f"{tl1:.4f}/{tl2:.4f})")
    return worst, times


def bench_problem(torch, dtype):
    from ssqp_tpu_torch import make_qp

    N = N_MAIN
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
    if tuple(x.shape) != (B, N_MAIN) or not bool(torch.isfinite(x).all()):
        raise RuntimeError(f"{tag}: solution not finite or wrong shape")
    solved = int((status > 0).sum())
    if solved != B:
        raise RuntimeError(f"{tag}: solved {solved}/{B}")
    budget = float((x.sum(1) - 1.0).abs().max())
    box = float(torch.maximum(Qb.d - x, x - Qb.u).max())
    if budget > 1e-4 or box > 1e-5:
        raise RuntimeError(f"{tag}: infeasible (budget {budget}, box {box})")
    return solved, budget, box


def phase_main(torch, card):
    from ssqp_tpu_torch import Settings
    from ssqp_tpu_torch.ops import cg, chol
    from ssqp_tpu_torch.parallel.batch import (
        frontier_batch, solve_qp_batch, solve_qp_batch_auto)

    settings = Settings.for_dtype(torch.float32)
    Q, V, mu = bench_problem(torch, torch.float32)

    Qb, shared = frontier_batch(Q, grid(torch, 0, B_AUTO))
    torch.cuda.synchronize()
    cg.LAUNCHES = chol.LAUNCHES = 0
    res_auto = solve_qp_batch_auto(Qb, settings, shared)
    torch.cuda.synchronize()
    launches = {"cg_rows": cg.LAUNCHES, "chol_solve": chol.LAUNCHES}
    if launches["cg_rows"] <= 0:
        raise RuntimeError("main path ran no CG kernel launch")
    solved, budget, box = check_solution(torch, res_auto, Qb, B_AUTO, "auto")
    st = res_auto.status.float()
    log("main", f"solve_qp_batch_auto N={N_MAIN} B={B_AUTO} f32: solved "
        f"{solved}/{B_AUTO}, launches {launches}, S-iterations med "
        f"{float(st.median()):.0f} max {float(st.max()):.0f}, "
        f"budget err {budget:.1e}, box err {box:.1e}")

    QbB, sharedB = frontier_batch(Q, grid(torch, 0, B_BIG))
    res_big = solve_qp_batch(QbB, settings, shared=sharedB)
    solved, budget, box = check_solution(torch, res_big, QbB, B_BIG, "batch")
    log("main", f"solve_qp_batch N={N_MAIN} B={B_BIG} f32: solved "
        f"{solved}/{B_BIG}, budget err {budget:.1e}, box err {box:.1e}")

    rates = {}
    for B, fn in ((B_AUTO, lambda Qg, sh: solve_qp_batch_auto(Qg, settings, sh)),
                  (B_BIG, lambda Qg, sh: solve_qp_batch(Qg, settings, shared=sh))):
        ms = []
        for rep in range(1, 4):
            Qg, sh = frontier_batch(Q, grid(torch, rep, B))
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            r = fn(Qg, sh)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            check_solution(torch, r, Qg, B, f"timed B={B}")
        best = min(ms)
        rates[B] = (B / (best / 1e3), ms)
        log("main", f"N={N_MAIN} B={B} f32: best {best:.1f} ms/batch = "
            f"{rates[B][0]:.1f} QP/s (runs {', '.join(f'{m:.1f}' for m in ms)}"
            f" ms) on {card}")
    return res_auto, launches, rates


def phase_audit(torch, res_auto):
    from ssqp_tpu_torch import Settings
    from ssqp_tpu_torch.parallel.batch import frontier_batch, solve_qp_batch

    Q64, V, mu = bench_problem(torch, torch.float64)
    idx = np.linspace(0, B_AUTO - 1, 256).astype(int)
    lams = grid(torch, 0, B_AUTO).double().cpu().numpy()[idx]
    Qb64, sh = frontier_batch(Q64, torch.tensor(lams, device="cuda"))
    r64 = solve_qp_batch(Qb64, Settings(), shared=sh)
    x64 = r64.x.cpu().numpy()
    ok64 = r64.status.cpu().numpy() > 0
    if ok64.sum() != len(idx):
        raise RuntimeError(f"f64 audit solved {int(ok64.sum())}/{len(idx)}")
    x32 = res_auto.x.double().cpu().numpy()[idx]
    qs = -lams[:, None] * mu[None, :]
    f32v = 0.5 * np.einsum("bi,ij,bj->b", x32, V, x32) + (qs * x32).sum(1)
    f64v = 0.5 * np.einsum("bi,ij,bj->b", x64, V, x64) + (qs * x64).sum(1)
    gaps = np.abs(f32v - f64v) / np.maximum(1.0, np.abs(f64v))
    xinf = np.abs(x32 - x64).max(axis=1)
    log("audit", f"f64 on card ({int(ok64.sum())}/{len(idx)} refs): objgap "
        f"{quantiles(gaps)} xinf {quantiles(xinf)}")
    if not gaps.max() < 1e-6:
        raise RuntimeError(f"objective gap {gaps.max():.3e} >= 1e-6")
    return float(gaps.max())


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


def phase_ineq(torch, card):
    from ssqp_tpu_torch import Settings
    from ssqp_tpu_torch.ops import cg, chol
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
    torch.cuda.synchronize()
    cg.LAUNCHES = chol.LAUNCHES = 0
    t0 = time.perf_counter()
    res = solve_qp_batch_auto(Q, settings, INEQ_SHARED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"cg_rows": cg.LAUNCHES, "chol_solve": chol.LAUNCHES}
    if min(launches.values()) <= 0:
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
        f"feasibility eq {eq:.1e} ineq {ineq:.1e} box {box:.1e}; first "
        f"batch {wall:.2f} s host wall")
    # each fresh grid through the entry point, then its search alone
    # (solve_qp_batch): the difference is the tail's cost
    ms, search_ms = [], []
    for seed in (5, 6, 7):
        Qg = ineq_problem(torch, torch.float32, seed, B)
        for fn, out in (
                (lambda: solve_qp_batch_auto(Qg, settings, INEQ_SHARED), ms),
                (lambda: solve_qp_batch(Qg, settings, shared=INEQ_SHARED),
                 search_ms)):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            r = fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
            check_ineq(torch, r, Qg, B, f"timed q seed {seed}")
    best = min(ms)
    rate = B / (best / 1e3)
    log("ineq", f"N={N_INEQ} J={J_INEQ} B={B} f32: best {best:.1f} ms/batch "
        f"= {rate:.1f} QP/s (runs {', '.join(f'{m:.1f}' for m in ms)} ms; "
        f"search alone {', '.join(f'{m:.1f}' for m in search_ms)} ms) "
        f"on {card}")
    return res, launches, rate


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


def quantiles(a):
    return {k: float(np.quantile(a, p)) for k, p in
            (("q01", 0.01), ("median", 0.5), ("q99", 0.99), ("max", 1.0))}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    from ssqp_tpu_torch.ops import _build

    card = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    log("device", f"{name}; nvidia-smi: {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.load()
    log("build", f"CUDA kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    worst, ktimes = phase_kernel(torch)
    chol_worst, ctimes = phase_chol(torch)
    res_auto, main_launches, rates = phase_main(torch, card)
    phase_audit(torch, res_auto)
    res_ineq, ineq_launches, ineq_rate = phase_ineq(torch, card)
    phase_ineq_audit(torch, res_ineq)

    paths = {"cg_rows": {"frontier": main_launches["cg_rows"],
                         "ineq": ineq_launches["cg_rows"]},
             "chol_solve": {"frontier": main_launches["chol_solve"],
                            "ineq": ineq_launches["chol_solve"]}}
    tk, tp = ktimes[B_AUTO]
    cg_b, cg_by = cg_bound(2 * B_AUTO, N_MAIN, 64)
    ck, cp, cl = ctimes[CHOL_TIMED[0]]
    ch_b, ch_by = chol_bound(*CHOL_TIMED[0])
    print(json.dumps({"kernels": [{
        "name": "cg_rows",
        "route": "cuda",
        "source": "ssqp_tpu_torch/ops/csrc/cg.cu",
        "replaces": "ssqp_tpu/ops/pallas_cg.py:56",
        "launches": sum(paths["cg_rows"].values()),
        "launches_by_path": paths["cg_rows"],
        "max_abs_err": worst,
        "ms": tk,
        "plain_ms": tp,
        "bound_ms": cg_b,
        "bound_by": cg_by,
        "library_ms": None,
        "shape": f"C={2 * B_AUTO} rows, N={N_MAIN}, 64 steps, f32",
    }, {
        "name": "chol_solve",
        "route": "cuda",
        "source": "ssqp_tpu_torch/ops/csrc/chol.cu",
        "replaces": "ssqp_tpu/ops/pallas_chol.py:43",
        "launches": sum(paths["chol_solve"].values()),
        "launches_by_path": paths["chol_solve"],
        "max_abs_err": chol_worst,
        "ms": ck,
        "plain_ms": cp,
        "bound_ms": ch_b,
        "bound_by": ch_by,
        "library_ms": cl,
        "shape": "(B, n, K) = (%d, %d, %d), f32" % CHOL_TIMED[0],
        "other_shapes": [{
            "shape": "(B, n, K) = (%d, %d, %d), f32" % sh,
            "ms": ctimes[sh][0], "plain_ms": ctimes[sh][1],
            "library_ms": ctimes[sh][2], "bound_ms": chol_bound(*sh)[0],
            "bound_by": chol_bound(*sh)[1]} for sh in CHOL_TIMED[1:]],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
