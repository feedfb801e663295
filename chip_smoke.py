"""Smoke run of the PyTorch/CUDA port (ssqp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each; any failure raises and the exit code is not 0):

  1. device   — requires CUDA; prints the card's name and power limit;
  2. build    — compiles the CUDA kernels from ssqp_tpu_torch/ops/csrc;
  3. kernel   — the fused CG kernel against its plain PyTorch version on the
                card (f32 and f64; shared V at N=256, odd shapes, per-instance
                V) and both times at the main path's shapes;
  4. main     — the frontier-QP main path through the port's entry points at
                N=256 (solve_qp_batch_auto at B=2048, solve_qp_batch at
                B=8192, float32), with the kernel's launch count and QP/s;
  5. audit    — 256 of the B=2048 instances re-solved in float64 on the card;
                objective gap and ||x - z||_inf quantiles, max gap < 1e-6.

Then one JSON line with the kernel table, the nvidia-smi line, and, last,
``{"ok": true, "device": {...}}``. The problem is the headline benchmark's
(bench.py): seed 7, V = HH'/N + 0.5 I, mu ~ U(0, 0.2), 0 <= x <= 4/N.
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
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        for name, N, K, batch, per, iters in cases:
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
    from ssqp_tpu_torch.ops import cg
    from ssqp_tpu_torch.parallel.batch import (
        frontier_batch, solve_qp_batch, solve_qp_batch_auto)

    settings = Settings.for_dtype(torch.float32)
    Q, V, mu = bench_problem(torch, torch.float32)

    Qb, shared = frontier_batch(Q, grid(torch, 0, B_AUTO))
    torch.cuda.synchronize()
    cg.LAUNCHES = 0
    res_auto = solve_qp_batch_auto(Qb, settings, shared)
    torch.cuda.synchronize()
    launches = cg.LAUNCHES
    if launches <= 0:
        raise RuntimeError("main path ran no CG kernel launch")
    solved, budget, box = check_solution(torch, res_auto, Qb, B_AUTO, "auto")
    st = res_auto.status.float()
    log("main", f"solve_qp_batch_auto N={N_MAIN} B={B_AUTO} f32: solved "
        f"{solved}/{B_AUTO}, cg launches {launches}, S-iterations med "
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
    qt = lambda a: {k: float(np.quantile(a, p)) for k, p in
                    (("q01", 0.01), ("median", 0.5), ("q99", 0.99),
                     ("max", 1.0))}
    log("audit", f"f64 on card ({int(ok64.sum())}/{len(idx)} refs): objgap "
        f"{qt(gaps)} xinf {qt(xinf)}")
    if not gaps.max() < 1e-6:
        raise RuntimeError(f"objective gap {gaps.max():.3e} >= 1e-6")
    return float(gaps.max())


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
    res_auto, launches, rates = phase_main(torch, card)
    phase_audit(torch, res_auto)

    tk, tp = ktimes[B_AUTO]
    print(json.dumps({"kernels": [{
        "name": "cg_rows",
        "route": "cuda",
        "source": "ssqp_tpu_torch/ops/csrc/cg.cu",
        "replaces": "ssqp_tpu/ops/pallas_cg.py:56",
        "launches": launches,
        "max_abs_err": worst,
        "ms": tk,
        "plain_ms": tp,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
