"""The readings that a cell's limits are set from, in one process:

    python3 gpubench/calibrate.py --workload <cell> [--seeds 12]
        [--controls 3] [--requests 8] [--first-seed 3000000000]

For each of ``--seeds`` seeds it builds the cell's problem, sends
``--requests`` requests through the cell's entry (after one warm-up
request) and computes the compared numbers of ``check.py`` against the
float64 reference, as a run does (the lower readings). For the first
``--controls`` seeds it then puts the reference itself in the program's
place, one precision step below the cell's (``control`` in the cell's
JSON: TF32 for a float32 cell, float32 for a float64 one), on the same
sampled instances, and computes the same numbers (the upper readings).
Prints one JSON line per reading and a summary line: per number the
largest program reading and the smallest control reading. Needs a CUDA
device unless ``--device cpu`` is given (with small sizes in
``--override``, for a rehearsal).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def readings(cell, seed, device, requests, controls: bool):
    import torch

    from gpubench import check, core

    p, settings, traffic = core.prepare(cell, seed, device)
    cell.entry.run(p, traffic.request(0), settings)
    w = core.loop(cell, p, settings, traffic, seed, device,
                  requests=requests)
    rows = core.sample_rows(w.kept, cell.spec["sample"]["max"], seed)
    D, q = cell.kind.reference(p, rows["param"])
    from gpubench.reference import qp as ref

    sol = ref.solve(D, q)
    out = {"program": check.numbers(p, D, q, rows, w.unsolved, sol=sol),
           "requests": w.requests, "sampled": int(rows["x"].shape[0]),
           "s_iters_mean": w.s_iters_sum / max(1, w.attempted - w.unsolved)}
    if controls:
        crow = check.control_rows(p, D, q, rows["param"],
                                  cell.spec["control"], "ret" in rows)
        out["control"] = check.numbers(p, D, q, crow, 0, sol=sol)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--override", default="",
                    help="JSON overrides of the cell's files, e.g. a larger "
                    "sample per request, or small sizes for a CPU rehearsal")
    args = ap.parse_args(argv)

    import torch

    from gpubench import core

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    bench = core.load_json(ROOT / "BENCHMARK.json")
    cell = core.Cell(args.workload, bench,
                     overrides=json.loads(args.override) if args.override
                     else None)
    prog, ctrl = {}, {}
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        r = readings(cell, seed, device, args.requests, i < args.controls)
        r.update(seed=seed, seconds=time.perf_counter() - t0)
        print(json.dumps(r), flush=True)
        for k, v in r["program"].items():
            prog[k] = max(prog.get(k, 0.0), v) if v == v else float("nan")
        for k, v in r.get("control", {}).items():
            ctrl[k] = min(ctrl.get(k, float("inf")), v) if v == v else \
                ctrl.get(k, float("inf"))
    print(json.dumps({"workload": args.workload, "program_max": prog,
                      "control_min": ctrl}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
