"""Where the time goes in one batch of the PyTorch/CUDA port, on one GPU.

    python3 profile_port.py [ineq|frontier|waves|compact|lp|outer|pdas|
                             datasets|scale ...]
    python3 profile_port.py protocols [N,B ...]

For each named path (default: frontier and ineq) it builds the problem of
chip_smoke.py (frontier: N=256, B=2048 through solve_qp_batch_auto, the
plain route; waves: B=8192, the waves=8 route; compact: B=4096, the
compaction route; ineq: config 4's widths; lp: BASELINE config 2's four
LP routes, one trace each: the mixed batch at B=256 through
solve_lp_batch_auto (plain), the c-grid (waves=8) and the rhs grid (dual
waves=8) at B=256, and criss-cross at N=40, B=256 through
solve_lp_batch_cclp_rescued; outer: the frontier's warm L-sweep and warm
mu sweep over 128 points (models/frontier.py, float32) and solve_qp_diff
at B=256 in float64, forward and backward, chip_smoke.py phase 11's;
pdas: the frontier at N=256, B=2048 with the W-PCG and with the Chebyshev
PDAS rounds, phase 12's; datasets: the fine warm L-sweep (256 geometric
points) of config 7's ungil_like and sp500_like, phase 13's; scale: the
frontier at N=512 and N=1024, B=8192 through solve_qp_batch_auto (waves=8
and the tail), phase 14's),
runs two warm-up batches, times three unprofiled batches on fresh data with
CUDA events, then runs one more batch under ``torch.profiler`` and prints
one JSON line: the unprofiled times, the device time of every CUDA kernel
summed and split into groups (the CG kernel, the Cholesky kernel, the
library QR, the library Cholesky, matrix products, copies and fills,
the library LU and inverse, everything else: elementwise, reductions,
indexing), the
busy share (kernel time over the best unprofiled wall time), launch and
operator counts, and the host synchronisations. The card's nvidia-smi line
is printed first. Needs CUDA; writes no file.

``protocols`` times the plain protocol (solve_qp_batch), waves=8
(solve_qp_batch_waves) and coarse-to-fine (solve_qp_batch_c2f, coarse=8) on
the frontier problem (float32) at each (N, B) cell given, by default the
cells of auto_protocol's docstring in the JAX package: one warm-up batch
each, then three fresh grids with the three protocols in turn, CUDA events
around each call; one JSON line per cell with every run, the best, QP/s
and the solved counts. Then the PDAS profile of the plain protocol at
N=256, B=4096 and 8192: how many instances each identification round ran
on (the still-changing ones), one JSON line each.
"""

import dataclasses
import json
import re
import sys
import time
from collections import defaultdict

import numpy as np

GROUPS = (  # first match wins; matched against the kernel's name
    ("cg_kernel", re.compile(r"cg_rows_(tc_)?kernel")),
    # before library_cholesky, whose "chol" also matches the port's kernels
    ("chol_kernel", re.compile(r"chol_solve_(blocked_)?kernel")),
    ("library_qr", re.compile(r"geqr|larf|orgqr|householder", re.I)),
    ("library_lu", re.compile(r"getr[fis]|laswp|batch_lu|lu_factor", re.I)),
    ("library_cholesky", re.compile(r"potr|trsm|trsv|chol", re.I)),
    ("matmul", re.compile(r"gemm|gemv|cutlass|sm90_xmma|ampere_", re.I)),
    ("memcpy_memset", re.compile(r"memcpy|memset", re.I)),
)


def paths(torch):
    import chip_smoke as cs
    from ssqp_tpu_torch import Settings
    from ssqp_tpu_torch.parallel.batch import (
        frontier_batch, solve_qp_batch_auto)

    s32 = Settings.for_dtype(torch.float32)
    Qf, _, _ = cs.bench_problem(torch, torch.float32)

    def frontier(i):
        Qb, sh = frontier_batch(Qf, cs.grid(torch, i, cs.B_AUTO))
        return lambda: solve_qp_batch_auto(Qb, s32, sh)

    def ineq(i):
        Q = cs.ineq_problem(torch, torch.float32, 5 + i, cs.B_INEQ)
        return lambda: solve_qp_batch_auto(Q, s32, cs.INEQ_SHARED)

    def auto_at(B):
        def make(i):
            Qb, sh = frontier_batch(Qf, cs.grid(torch, i, B))
            return lambda: solve_qp_batch_auto(Qb, s32, sh)
        return make

    def lp(route, B=cs.B_LP):
        s = s32

        def make(i):
            P, sh = cs.lp_problem(torch, torch.float32, route, i, B)
            fn = cs.lp_entry(route)
            return lambda: fn(P, s, sh)
        return make

    def warm(mu):
        from ssqp_tpu_torch.models import frontier as tf

        span = []

        def make(i):
            if not mu:
                g = torch.linspace(0.001 * i, 2.0 + 0.001 * i, cs.N_WARM,
                                   device="cuda")
                return lambda: tf.frontier_warm_sweep(Qf, Qf.q, g, s32)
            if not span:  # the returns the batch sweep reaches
                fr = tf.frontier_batch_sweep(Qf, Qf.q, cs.grid(
                    torch, 0, cs.B_SWEEP), s32)
                span.extend((float(fr.ret.min()), float(fr.ret.max())))
            lo, hi = span
            pad = 0.02 * (hi - lo)
            g = torch.linspace(lo + pad + 1e-5 * i, hi - pad + 1e-5 * i,
                               cs.N_WARM, device="cuda")
            return lambda: tf.frontier_mu_warm_sweep(Qf, Qf.q, g, s32)
        return make

    def diff(i):
        from ssqp_tpu_torch.solvers.diff import solve_qp_diff

        Q64, _, _ = cs.bench_problem(torch, torch.float64)
        Qb, _ = frontier_batch(Q64, cs.grid(torch, i, cs.B_DIFF,
                                            torch.float64))
        q = Qb.q.clone().requires_grad_(True)
        return lambda: solve_qp_diff(dataclasses.replace(Qb, q=q)).x.sum() \
            .backward()

    def pdas(flag):
        st = dataclasses.replace(s32, **{flag: True})
        return lambda i: (lambda Qb, sh: lambda: solve_qp_batch_auto(
            Qb, st, sh))(*frontier_batch(Qf, cs.grid(torch, i, cs.B_AUTO)))

    def dataset(k):
        from ssqp_tpu_torch import make_qp
        from ssqp_tpu_torch.models import frontier as tf

        name, E, V, kw, (lo, hi) = cs.config7_datasets()[k]
        f32 = lambda a: np.asarray(a, np.float32)
        Q = make_qp(f32(V), np.zeros(len(E), np.float32), dtype=np.float32,
                    device="cuda", **{k: f32(v) for k, v in kw.items()})
        rets = torch.tensor(E, dtype=torch.float32, device="cuda")
        lams = np.concatenate([[0.0], np.geomspace(lo, hi, cs.C7_FINE - 1)])

        def make(i):
            g = torch.tensor(lams * (1.0 + 1e-4 * i), dtype=torch.float32,
                             device="cuda")
            return lambda: tf.frontier_warm_sweep(Q, rets, g, s32)
        return make

    def scale(N):
        Qn, _, _ = cs.bench_problem(torch, torch.float32, N=N)

        def make(i):
            Qb, sh = frontier_batch(Qn, cs.grid(torch, i, cs.C8_B))
            return lambda: solve_qp_batch_auto(Qb, s32, sh)
        return make

    return {"pdas-pcg": (pdas("pdas_pcg"), f"pdas_pcg N={cs.N_MAIN} "
                                           f"B={cs.B_AUTO}"),
            "pdas-cheb": (pdas("pdas_cheb"), f"pdas_cheb N={cs.N_MAIN} "
                                             f"B={cs.B_AUTO}"),
            "c7-ungil": (dataset(0), f"config 7 ungil_n14 warm L-sweep, "
                                     f"{cs.C7_FINE} points"),
            "c7-sp500": (dataset(1), f"config 7 sp500_n263 warm L-sweep, "
                                     f"{cs.C7_FINE} points"),
            "scale-512": (scale(512), f"config 8 N=512 B={cs.C8_B}"),
            "scale-1024": (scale(1024), f"config 8 N=1024 B={cs.C8_B}"),
            "lp-mixed": (lp("mixed"), f"config 2 mixed B={cs.B_LP}"),
            "warm": (warm(False), f"warm L-sweep N={cs.N_MAIN}, "
                                  f"{cs.N_WARM} points"),
            "mu-warm": (warm(True), f"warm mu sweep N={cs.N_MAIN}, "
                                    f"{cs.N_WARM} points"),
            "diff": (diff, f"solve_qp_diff N={cs.N_MAIN} B={cs.B_DIFF} "
                           "f64, forward + backward"),
            "lp-cgrid": (lp("cgrid"), f"config 2 c-grid B={cs.B_LP}"),
            "lp-rhs": (lp("rhs"), f"config 2 rhs grid B={cs.B_LP}"),
            "lp-cclp": (lp("cclp"), f"config 2 criss-cross N={cs.N_CC} "
                                    f"B={cs.B_LP}"),
            "frontier": (frontier, f"N={cs.N_MAIN} B={cs.B_AUTO}"),
            "waves": (auto_at(cs.B_BIG), f"N={cs.N_MAIN} B={cs.B_BIG} "
                                         "(waves=8)"),
            "compact": (auto_at(cs.B_MID), f"N={cs.N_MAIN} B={cs.B_MID} "
                                           "(compact)"),
            "ineq": (ineq, f"N={cs.N_INEQ} M={cs.M_INEQ} J={cs.J_INEQ} "
                           f"B={cs.B_INEQ}")}


# auto_protocol's measured cells in the JAX package's docstring
# (ssqp_tpu/parallel/batch.py), (N, B)
PROTOCOL_CELLS = ((128, 1024), (256, 2048), (512, 2048), (1024, 1024),
                  (1024, 2048), (128, 8192), (256, 8192), (512, 8192),
                  (1024, 8192))


def protocols(torch, cells):
    import chip_smoke as cs
    from ssqp_tpu_torch import Settings
    from ssqp_tpu_torch.parallel.batch import (
        auto_protocol, frontier_batch, solve_qp_batch, solve_qp_batch_c2f,
        solve_qp_batch_waves)

    s32 = Settings.for_dtype(torch.float32)
    protos = {
        "plain": lambda Q, sh: solve_qp_batch(Q, s32, shared=sh),
        "waves=8": lambda Q, sh: solve_qp_batch_waves(Q, s32, sh, waves=8),
        "c2f(8)": lambda Q, sh: solve_qp_batch_c2f(Q, s32, sh, coarse=8)}
    for N, B in cells:
        Qf, _, _ = cs.bench_problem(torch, torch.float32, N=N)
        runs = {k: [] for k in protos}
        solved = {k: [] for k in protos}
        for rep in range(4):  # rep 0 is the warm-up
            Qb, sh = frontier_batch(Qf, cs.grid(torch, 10 * (rep == 0) + rep,
                                                B))
            for name, fn in protos.items():
                ms, r = cs.timed(torch, lambda: fn(Qb, sh))
                if rep:
                    runs[name].append(ms)
                    solved[name].append(int((r.status > 0).sum()))
        best = {k: min(v) for k, v in runs.items()}
        print(json.dumps({
            "cell": {"N": N, "B": B}, "rule": auto_protocol(N, B, True),
            "runs_ms": runs, "best_ms": best,
            "qp_per_s": {k: B / (v / 1e3) for k, v in best.items()},
            "solved": solved,
            "winner": min(best, key=best.get)}), flush=True)


def pdas_profile(torch, B):
    """The instances each PDAS identification round ran on (round 1, the
    closed form through the shared W, runs on all B and is not counted)."""
    import chip_smoke as cs
    from ssqp_tpu_torch import Settings
    from ssqp_tpu_torch.parallel.batch import frontier_batch, solve_qp_batch
    from ssqp_tpu_torch.solvers import ssqp

    Qf, _, _ = cs.bench_problem(torch, torch.float32)
    Qb, sh = frontier_batch(Qf, cs.grid(torch, 0, B))
    widths = []
    real = ssqp._pdas_round

    def counted(Q, settings, Sx, *a):
        widths.append(Sx.shape[0])
        return real(Q, settings, Sx, *a)

    ssqp._pdas_round = counted
    try:
        solve_qp_batch(Qb, Settings.for_dtype(torch.float32), shared=sh)
    finally:
        ssqp._pdas_round = real
    print(json.dumps({"pdas_profile": {"N": cs.N_MAIN, "B": B},
                      "instances_per_round": widths,
                      "share_per_round": [w / B for w in widths]}),
          flush=True)


def profile_path(torch, make, label):
    from torch.profiler import ProfilerActivity, profile

    for i in range(2):
        make(10 + i)()
    torch.cuda.synchronize()
    walls = []
    for i in range(3):
        run = make(i)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        walls.append(start.elapsed_time(end))
    run = make(20)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        prof_wall = 1e3 * (time.perf_counter() - t0)
    groups = defaultdict(lambda: [0.0, 0])
    kernels = aten = 0
    syncs = defaultdict(int)
    for e in prof.events():
        dev = getattr(e, "device_type", None)
        if dev is not None and "CUDA" in str(dev):
            kernels += 1
            name = e.name
            g = next((k for k, rx in GROUPS if rx.search(name)), "other")
            groups[g][0] += e.time_range.elapsed_us() / 1e3
            groups[g][1] += 1
        else:
            if e.name.startswith("aten::"):
                aten += 1
            if e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                          "cudaEventSynchronize", "aten::nonzero",
                          "aten::_local_scalar_dense", "aten::item"):
                syncs[e.name] += 1
    total = sum(v[0] for v in groups.values())
    best = min(walls)
    return {
        "path": label,
        "unprofiled_ms": walls,
        "profiled_wall_ms": prof_wall,
        "kernel_ms": total,
        "busy_share": total / best,
        "groups_ms": {k: round(v[0], 4) for k, v in sorted(groups.items())},
        "groups_launches": {k: v[1] for k, v in sorted(groups.items())},
        "kernels_launched": kernels,
        "aten_ops": aten,
        "host_syncs": dict(syncs),
    }


def main():
    import torch

    if not torch.cuda.is_available():
        print("profile_port: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    import chip_smoke as cs

    print(cs.nvidia_smi_line(), flush=True)
    if sys.argv[1:2] == ["protocols"]:
        cells = [tuple(int(v) for v in c.split(",")) for c in sys.argv[2:]]
        protocols(torch, cells or PROTOCOL_CELLS)
        for B in (cs.B_MID, cs.B_BIG):
            pdas_profile(torch, B)
        return
    wanted = sys.argv[1:] or ["frontier", "ineq"]
    for group, names in (("lp", ["lp-mixed", "lp-cgrid", "lp-rhs",
                                 "lp-cclp"]),
                         ("outer", ["warm", "mu-warm", "diff"]),
                         ("pdas", ["pdas-pcg", "pdas-cheb"]),
                         ("datasets", ["c7-ungil", "c7-sp500"]),
                         ("scale", ["scale-512", "scale-1024"])):
        if group in wanted:
            i = wanted.index(group)
            wanted[i:i + 1] = names
    table = paths(torch)
    for name in wanted:
        make, label = table[name]
        out = profile_path(torch, make, f"{name} {label}")
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
