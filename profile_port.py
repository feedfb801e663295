"""Where the time goes in one batch of the PyTorch/CUDA port, on one GPU.

    python3 profile_port.py [ineq|frontier ...]

For each named path (default: both) it builds the problem of chip_smoke.py,
runs two warm-up batches, times three unprofiled batches on fresh data with
CUDA events, then runs one more batch under ``torch.profiler`` and prints
one JSON line: the unprofiled times, the device time of every CUDA kernel
summed and split into groups (the CG kernel, the Cholesky kernel, the
library QR, the library Cholesky, matrix products, copies and fills,
everything else: elementwise, reductions, indexing), the
busy share (kernel time over the best unprofiled wall time), launch and
operator counts, and the host synchronisations. The card's nvidia-smi line
is printed first. Needs CUDA; writes no file.
"""

import json
import re
import sys
import time
from collections import defaultdict

GROUPS = (  # first match wins; matched against the kernel's name
    ("cg_kernel", re.compile(r"cg_rows_kernel")),
    ("chol_kernel", re.compile(r"chol_solve_kernel")),
    ("library_qr", re.compile(r"geqr|larf|orgqr|householder", re.I)),
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

    return {"frontier": (frontier, f"N={cs.N_MAIN} B={cs.B_AUTO}"),
            "ineq": (ineq, f"N={cs.N_INEQ} M={cs.M_INEQ} J={cs.J_INEQ} "
                           f"B={cs.B_INEQ}")}


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
    wanted = sys.argv[1:] or ["frontier", "ineq"]
    table = paths(torch)
    for name in wanted:
        make, label = table[name]
        out = profile_path(torch, make, f"{name} {label}")
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
