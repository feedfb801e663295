"""Efficient-frontier sweep on the PyTorch/CUDA port (``ssqp_tpu_torch``),
the twin of examples/frontier_sweep.py.

Traces a 256-point efficient frontier four ways and compares:
  * batched cold solves (guess-started) — maximum parallelism;
  * warm-started walk along the grid — the reference's sequential trick;
  * wave-parallel warm sweep — both at once;
  * sharded over a torch.distributed process group (here a group of one
    process: NCCL on the card, gloo on the CPU) with all-reduced counts.

Run: python examples/torch_frontier_sweep.py          (on the card)
     python examples/torch_frontier_sweep.py --cpu    (on the CPU)
"""

import argparse
import pathlib
import socket
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch
import torch.distributed as dist

import ssqp_tpu_torch as ssqp
from ssqp_tpu_torch.models.frontier import (
    frontier_batch_sweep, frontier_waves_sweep, frontier_warm_sweep)
from ssqp_tpu_torch.parallel.batch import frontier_batch
from ssqp_tpu_torch.parallel.sharded import solve_qp_sharded


def device_arg(argv, doc):
    """'cpu' under --cpu, else 'cuda'."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    return "cpu" if ap.parse_args(argv).cpu else "cuda"


def sync(dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    dev = device_arg(argv, __doc__)
    rng = np.random.default_rng(1)
    N, points = 64, 256
    H = rng.standard_normal((N, N))
    V = (H @ H.T / N + 0.5 * np.eye(N)).astype(np.float32)
    rets = rng.uniform(0.0, 0.25, N).astype(np.float32)

    settings = ssqp.Settings.for_dtype(torch.float32)
    Q = ssqp.make_qp(V, np.zeros(N, np.float32),
                     u=np.full(N, 8.0 / N, np.float32), dtype=np.float32,
                     device=dev)
    r = torch.tensor(rets, device=dev)
    lams = torch.linspace(0.0, 2.0, points, device=dev)

    solved = {}
    for name, fn in [
        ("batched cold", lambda: frontier_batch_sweep(Q, r, lams, settings)),
        ("warm walk   ", lambda: frontier_warm_sweep(Q, r, lams, settings)),
        ("wave-warm   ", lambda: frontier_waves_sweep(Q, r, lams, settings,
                                                      waves=8)),
    ]:
        sync(dev)
        t0 = time.perf_counter()
        f = fn()
        sync(dev)
        dt = time.perf_counter() - t0
        solved[name.strip()] = ok = int((f.status > 0).sum())
        print(f"{name}: {ok}/{points} solved in {dt * 1e3:.1f} ms "
              f"(risk range {float(f.risk.min()):.4f}-"
              f"{float(f.risk.max()):.4f})")

    # sharded over a process group of one (the same code runs one process
    # per card with torchrun)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl" if dev == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        Qb, shared = frontier_batch(ssqp.make_qp(
            V, rets, u=np.full(N, 8.0 / N, np.float32), dtype=np.float32,
            device=dev), lams)
        res, stats = solve_qp_sharded(Qb, settings, shared=shared,
                                      device=dev)
        print(f"sharded over {dist.get_world_size()} process(es): "
              f"solved={int(stats['solved'])}/{points} "
              f"max_iters={int(stats['iters_max'])}")
        solved["sharded"] = int(stats["solved"])
    finally:
        dist.destroy_process_group()
    return solved


if __name__ == "__main__":
    main()
