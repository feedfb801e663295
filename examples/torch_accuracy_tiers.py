"""Accuracy tiers on the PyTorch/CUDA port (``ssqp_tpu_torch``), the twin
of examples/accuracy_tiers.py (reference: Settings{BigFloat},
types.jl:410-417). The reference's arbitrary-precision story is
type-genericity; the ladder here:

  1. float32 search + float64 refinement (solve_qp_refined)
  2. the plain float64 solve (float64 runs natively on the card)
  3. float64 search + double-double residual sweeps (solve_qp_refined_dd)
     — the solution comes back as an unevaluated float64 PAIR (x, x_lo)
     carrying ~32 significant digits

each held against the exact optimum computed in rational arithmetic.

Run: python examples/torch_accuracy_tiers.py          (on the card)
     python examples/torch_accuracy_tiers.py --cpu    (on the CPU)
"""

import argparse
import pathlib
import sys
from fractions import Fraction

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

import ssqp_tpu_torch as ssqp


def device_arg(argv, doc):
    """'cpu' under --cpu, else 'cuda'."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    return "cpu" if ap.parse_args(argv).cpu else "cuda"


def main(argv=None):
    dev = device_arg(argv, __doc__)
    rng = np.random.default_rng(7)
    N = 12
    H = rng.standard_normal((N, N))
    V = H @ H.T / N + 0.5 * np.eye(N)
    q = rng.standard_normal(N)
    Q = ssqp.make_qp(V, q, d=np.full(N, -10.0), u=np.full(N, 10.0),
                     dtype=np.float64, device=dev)
    Vx, qx = Q.V.cpu().numpy(), Q.q.cpu().numpy()  # make_qp symmetrizes

    # exact optimum via rational arithmetic (floats ARE rationals)
    n = N + 1
    K = np.zeros((n, n))
    K[:N, :N] = Vx
    K[:N, N] = 1.0
    K[N, :N] = 1.0
    rhs = np.concatenate([-qx, [1.0]])
    A = [[Fraction(K[i, j]) for j in range(n)] + [Fraction(rhs[i])]
         for i in range(n)]
    for c in range(n):
        p = max(range(c, n), key=lambda r: abs(A[r][c]))
        A[c], A[p] = A[p], A[c]
        inv = 1 / A[c][c]
        A[c] = [v * inv for v in A[c]]
        for r in range(n):
            if r != c and A[r][c] != 0:
                f = A[r][c]
                A[r] = [vr - f * vc for vr, vc in zip(A[r], A[c])]
    x_star = [A[r][n] for r in range(N)]

    def err(pairs):
        return max(abs(float(p - e)) for p, e in zip(pairs, x_star))

    errs = {}
    r32 = ssqp.solve_qp_refined(Q, search_dtype=torch.float32)
    errs["refined"] = err([Fraction(float(v)) for v in r32.x.cpu()])
    print(f"tier 1 (f32 search + f64 refine): ||x-x*||_inf = "
          f"{errs['refined']:.2e}")

    r64 = ssqp.solve_qp(Q)
    errs["f64"] = err([Fraction(float(v)) for v in r64.x.cpu()])
    print(f"plain f64 solve:                  ||x-x*||_inf = "
          f"{errs['f64']:.2e}")

    rdd, xlo = ssqp.solve_qp_refined_dd(Q)
    errs["dd"] = err([Fraction(float(a)) + Fraction(float(b))
                      for a, b in zip(rdd.x.cpu(), np.asarray(xlo).ravel())])
    print(f"tier 3 (double-double pair):      ||x-x*||_inf = "
          f"{errs['dd']:.2e}")
    return errs


if __name__ == "__main__":
    main()
