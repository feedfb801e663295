"""Warm-wave LP grids on the PyTorch/CUDA port (``ssqp_tpu_torch``), the
twin of examples/lp_grid.py: solve a c-parametric LP family.

A parametric cost sweep (a price scan over a fixed feasible region) is the
LP analogue of the QP efficient frontier. The two-phase simplex splits into
a cost-independent part (standardization, row purge, Phase-1) and a
Phase-2 that depends on c. ``solve_lp_batch_waves`` computes the shared
part once per family and solves the sorted cost grid in warm waves, each
slot starting Phase-2 from its grid neighbour's optimal basis (any basis
stays feasible when only c varies). Reference analogue: the warm-startable
simplex kernels of Simplex.jl:426-445, one problem at a time.

Run: python examples/torch_lp_grid.py          (on the card)
     python examples/torch_lp_grid.py --cpu    (on the CPU)
"""

import argparse
import dataclasses
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from ssqp_tpu_torch import Settings, make_lp
from ssqp_tpu_torch.parallel.batch import solve_lp_batch, solve_lp_batch_waves


def device_arg(argv, doc):
    """'cpu' under --cpu, else 'cuda'."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    return "cpu" if ap.parse_args(argv).cpu else "cuda"


def timed(dev, fn):
    if dev == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    if dev == "cuda":
        torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def main(argv=None):
    dev = device_arg(argv, __doc__)
    # float32 with the float32 tier's Settings, as the JAX example
    N, M, J, B = 60, 4, 12, 64
    rng = np.random.default_rng(3)
    x0 = rng.uniform(0.1, 1.0, N).astype(np.float32)
    A = rng.standard_normal((M, N)).astype(np.float32)
    G = rng.standard_normal((J, N)).astype(np.float32)
    b = A @ x0
    g = (G @ x0 + rng.uniform(0.1, 1.0, J)).astype(np.float32)

    # sorted cost grid: c(t) = c0 + t * dc, t in [0, 1]
    c0 = rng.standard_normal(N).astype(np.float32)
    dc = (rng.standard_normal(N) * 0.5).astype(np.float32)
    ts = np.linspace(0.0, 1.0, B).astype(np.float32)
    C = torch.tensor(c0[None, :] + ts[:, None] * dc[None, :], device=dev)

    P = make_lp(c0, A, b, G=G, g=g, d=np.zeros(N, np.float32),
                u=np.full(N, 2.0, np.float32), dtype=np.float32, device=dev)
    Pb = dataclasses.replace(P, c=C)
    shared = ("A", "b", "G", "g", "d", "u")
    s = Settings.for_dtype(torch.float32)

    r_plain, t_plain = timed(dev, lambda: solve_lp_batch(Pb, s,
                                                         shared=shared))
    r_waves, t_waves = timed(dev, lambda: solve_lp_batch_waves(
        Pb, s, shared, waves=8))

    f_plain = (C * r_plain.x).sum(dim=1).cpu().numpy()
    f_waves = (C * r_waves.x).sum(dim=1).cpu().numpy()
    n_plain = int((r_plain.status >= 1).sum())
    n_waves = int((r_waves.status >= 1).sum())
    print(f"grid of {B} LPs (N={N}, M={M}, J={J}):")
    print(f"  plain two-phase batch: {t_plain:.3f}s ({n_plain}/{B} solved)")
    print(f"  warm waves (shared Phase-1): {t_waves:.3f}s "
          f"({n_waves}/{B} solved)")
    diff = float(np.abs(f_plain - f_waves).max())
    print(f"  max objective difference: {diff:.2e}")
    print(f"  optimal value along the sweep: {f_waves[0]:.4f} (t=0) "
          f"-> {f_waves[-1]:.4f} (t=1)")
    return dict(plain=n_plain, waves=n_waves, max_diff=diff, B=B)


if __name__ == "__main__":
    main()
