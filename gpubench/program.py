"""What the program records about itself in a traced window: its counters
and launch records (``ssqp_tpu_torch/utils/diagnostics.py``), which the
per-layer metrics read, and its own ``ssqp.`` ranges in the profiler's
records, reduced here.

    python3 gpubench/program.py --workload <cell> --seed <n> [--seconds 8]

runs one traced window of a cell as ``run.py --trace 1`` does (set-up and
warm-up first, the same spans installed, no check) and prints one JSON
line: the per-layer metrics; ``program``, each ``ssqp.`` range's count,
merged host seconds and the device seconds launched inside it; the
program's counters; the breakdown of ``trace.summarize``; and
``idle_gaps_by_span``, each idle gap of the device inside an entry call
named by the innermost ``ssqp.`` range open at its middle (an exact
interval search), or ``(outside program spans)``. A program that records
nothing leaves ``program`` and the counters empty and every gap outside.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

SPAN_PREFIX = "ssqp."
OUTSIDE = "(outside program spans)"
PEAK_TF32_FLOPS = 495e12  # the tensor cores' TF32 rate, dense


def registry() -> dict:
    """The program's counters of the traced window (the registry is empty
    before it: nothing records outside a profiler), or {} where the
    program keeps none."""
    try:
        from ssqp_tpu_torch.utils.diagnostics import counters
    except ImportError:
        return {}
    return counters()


def cg_least_s(key, rec) -> float:
    """The least time of the CG launches of one record (key (C, N, dtype,
    shared V, body)): the larger of their operations at the precision's
    tightest route (float32: the products as three TF32 products at 495
    TFLOP/s and the vector work at 67; float64: DMMA, 67) and their bytes
    at 3.35 TB/s. Operations: (2 N^2 + 12 N) per row and step run. Bytes:
    V once a launch (a per-instance V: each matrix once), each row's fm,
    dinv, b and x0 and its tol2 read once, x and rr written once."""
    from gpubench import peaks

    C, N, dtype, _, _ = key
    word = 8 if dtype == "float64" else 4
    steps = rec["row_steps"]
    if word == 8:
        t_ops = steps * (2 * N * N + 12 * N) / peaks.PEAK_F64_TC_FLOPS
    else:
        t_ops = steps * (3 * 2 * N * N / PEAK_TF32_FLOPS
                         + 12 * N / peaks.PEAK_F32_FLOPS)
    nbytes = word * (rec["matrices"] * N * N
                     + rec["launches"] * (5 * C * N + 2 * C))
    return max(t_ops, nbytes / peaks.PEAK_BYTES)


def _records(prof):
    """(host ops, device ops) of the profiler's records: host ops as
    (correlation, start, end, name), device ops as (start, end, launch)
    with launch the host time of the call that launched them (by CUPTI
    correlation, else the start of the linked frontend op; -1 unknown),
    the ranges' own projections onto the device timeline left out."""
    from torch.autograd import DeviceType

    from gpubench import trace

    host, dev, runtime = [], [], {}
    for e in prof.profiler.kineto_results.events():
        dt, name = e.device_type(), e.name()
        if dt == DeviceType.CUDA:
            if not name.startswith((trace.PREFIX, SPAN_PREFIX)):
                dev.append((e.start_ns(), e.end_ns(), e.correlation_id(),
                            e.linked_correlation_id()))
        elif dt == DeviceType.CPU:
            if name.startswith("cu"):
                runtime[e.correlation_id()] = e.start_ns()
            else:
                host.append((e.correlation_id(), e.start_ns(), e.end_ns(),
                             name))
    first = {}
    for corr, s, _, _ in host:
        first.setdefault(corr, s)
    out = []
    for s, e, corr, link in dev:
        launch = runtime.get(corr, -1)
        if launch < 0 and link > 0:
            launch = first.get(link, -1)
        out.append((s, e, launch))
    return host, out


def program_ranges(prof) -> dict:
    """Each ``ssqp.`` range name (without the prefix) to its count, merged
    host seconds and the device seconds launched inside its ranges."""
    from gpubench import trace

    host, dev = _records(prof)
    ranges = defaultdict(list)
    for _, s, e, name in host:
        if name.startswith(SPAN_PREFIX):
            ranges[name[len(SPAN_PREFIX):]].append((s, e))
    launch = np.array([d[2] for d in dev], np.int64)
    dur = np.array([d[1] - d[0] for d in dev], np.float64) / 1e9
    out = {}
    for name, iv in sorted(ranges.items()):
        m = trace._merge(iv)
        inside = (launch >= 0) & trace._inside(launch, m)
        out[name] = {"count": len(iv),
                     "host_s": float((m[1] - m[0]).sum() / 1e9),
                     "device_s": float(dur[inside].sum())}
    return out


def idle_gaps_by_span(prof, top: int = 12) -> list:
    """[(innermost ``ssqp.`` range at the gap's middle, seconds)], longest
    first, over the device's idle gaps in the traced window whose middle
    lies inside an entry call."""
    from gpubench import trace

    host, dev = _records(prof)
    win = [(s, e) for _, s, e, n in host if n == trace.WINDOW]
    entry = trace._merge([(s, e) for _, s, e, n in host if n == trace.ENTRY])
    if not win:
        raise RuntimeError("program: the traced window left no record")
    w0, w1 = win[0]
    bs, be = trace._merge([(max(s, w0), min(e, w1)) for s, e, _ in dev
                           if e > w0 and s < w1])
    gap_s = np.concatenate([[w0], be])
    gap_e = np.concatenate([bs, [w1]])
    mid = (gap_s + gap_e) // 2
    keep = (gap_e > gap_s) & trace._inside(mid, entry)
    glen = (gap_e - gap_s)[keep].astype(np.float64) / 1e9
    mid = mid[keep]
    # the program's ranges nest on its one thread: sorted by start, each
    # one's parent is the latest earlier range still open at its start
    sp = sorted((s, -e, n[len(SPAN_PREFIX):]) for _, s, e, n in host
                if n.startswith(SPAN_PREFIX))
    starts = np.array([s for s, _, _ in sp], np.int64)
    ends = [-e for _, e, _ in sp]
    names = [n for _, _, n in sp]
    parent, stack = [], []
    for i, s in enumerate(starts):
        while stack and ends[stack[-1]] < s:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    sums = defaultdict(float)
    for m, t in zip(mid, glen):
        j = int(np.searchsorted(starts, m, side="right")) - 1
        while j >= 0 and ends[j] < m:
            j = parent[j]
        sums[names[j] if j >= 0 else OUTSIDE] += float(t)
    return sorted(sums.items(), key=lambda kv: -kv[1])[:top]


def main(argv=None) -> int:
    import argparse
    import json
    import sys
    import time
    from pathlib import Path

    t_start = time.perf_counter()
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from gpubench import core, trace
    from ssqp_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("program: no CUDA device", file=sys.stderr)
        return 2
    _build.set_build_dir(root / "build")
    cell = core.Cell(args.workload, core.load_json(root / "BENCHMARK.json"))
    device = torch.device("cuda:0")
    p, settings, traffic = core.prepare(cell, args.seed, device)
    core.loop(cell, p, settings, traffic, args.seed, device,
              requests=cell.spec.get("warm_requests", 2))
    setup_s = time.perf_counter() - t_start
    metrics = cell.metrics("per_layer")
    installed = trace.Spans([sp for _, mod in metrics
                             for sp in getattr(mod, "SPANS", ())])
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(trace.WINDOW):
                w = core.loop(cell, p, settings, traffic, args.seed, device,
                              seconds=args.seconds)
    finally:
        installed.undo()
    s = trace.summarize(prof, installed.calls)
    ctx = type("Ctx", (), dict(
        cell=cell.name, latencies_s=w.latencies_s, attempted=w.attempted,
        solved=w.attempted - w.unsolved, window_s=w.window_s,
        setup_s=setup_s, requests=w.requests, s_iters_sum=w.s_iters_sum,
        trace=s))
    values = {m["name"]: mod.read(ctx) for m, mod in metrics}
    counters = {k: v for k, v in registry().items()
                if not isinstance(v, dict)}
    launches = {",".join(map(str, k)): v for k, v in
                registry().get("cg.launches", {}).items()}
    print(json.dumps({
        "cell": cell.name, "seed": args.seed, "requests": s.requests,
        "window_s": s.window_s, "busy_s": s.busy_s,
        "device": torch.cuda.get_device_name(device), "metrics": values,
        "program": program_ranges(prof), "counters": counters,
        "cg_launches": launches,
        "breakdown": {"device_ops": [[k[:160], v] for k, v in s.device_ops],
                      "idle_gaps": [[k[:160], v] for k, v in s.idle_gaps],
                      "idle_gaps_by_span": idle_gaps_by_span(prof)}}),
        flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
