"""Run one benchmark cell once on the card:

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It builds the cell's problem from the seed,
warms up the cell's own shapes (set-up), runs a closed loop with one
client for ``--seconds`` (with ``--trace 1`` a traced window of at most
``core.TRACE_SECONDS``), checks a sample of the answers against the plain
float64 reference, and prints one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each compared number beside its limit. It exits non-zero
and prints no result without a CUDA device, or when a module of JAX or of
the JAX package was loaded. Build and kernel caches stay under the
checkout's ``build/``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build"
# every cache the program or its libraries may keep, at fixed paths inside
# the checkout (the kernel library itself goes to build/, ops/_build.py)
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from gpubench import core

    if not torch.cuda.is_available():
        print("gpubench: no CUDA device", file=sys.stderr)
        return 2
    bench = core.load_json(ROOT / "BENCHMARK.json")
    cell = core.Cell(args.workload, bench)
    spec = next(w for w in bench["workloads"] if w["name"] == args.workload)
    if torch.cuda.device_count() < spec["chips"]:
        print(f"gpubench: {spec['chips']} devices needed, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    from ssqp_tpu_torch.ops import _build

    _build.set_build_dir(CACHE)
    result = core.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda:0", T_START)
    bad = core.forbidden_modules()
    if bad:
        print(f"gpubench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
