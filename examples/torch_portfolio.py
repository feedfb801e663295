"""Portfolio selection walkthrough on the PyTorch/CUDA port
(``ssqp_tpu_torch``), the twin of examples/portfolio.py.

Solves the reference's default portfolio problem and its variants through
every API layer: direct solve, warm start, frontier constructors, the
modeling API, and the high-accuracy refined solve.

Run: python examples/torch_portfolio.py          (on the card)
     python examples/torch_portfolio.py --cpu    (on the CPU)
"""

import argparse
import pathlib
import sys

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
    rng = np.random.default_rng(0)
    N = 16
    H = rng.standard_normal((N, N))
    V = H @ H.T / N + 0.25 * np.eye(N)  # covariance
    rets = rng.uniform(0.02, 0.25, N)  # expected returns
    risk = lambda x: float(np.sqrt(x @ V @ x))

    # 1. The reference's default problem: min 1/2 x'Vx s.t. 1'x = 1, x >= 0
    Q = ssqp.make_qp(V, device=dev)
    res = ssqp.solve_qp(Q).numpy()
    print(f"min-variance portfolio: status={int(res.status)} "
          f"risk={risk(res.x):.4f}")

    # 2. Risk/return tradeoff via the L-parameterized frontier constructor
    Qr = ssqp.make_qp(V, rets, device=dev)  # q holds expected returns
    QL = ssqp.qp_frontier_L(Qr, 1.0)
    resL = ssqp.solve_qp(QL)
    xL = resL.numpy().x
    print(f"L=1 frontier point: ret={xL @ rets:.4f} risk={risk(xL):.4f}")

    # 3. Target-return variant (mu-parameterized)
    Qmu = ssqp.qp_frontier_mu(Qr, float(rets.mean()))
    xmu = ssqp.solve_qp(Qmu).numpy().x
    print(f"mu-target point: ret={xmu @ rets:.4f} "
          f"(target {rets.mean():.4f})")

    # 4. Warm start from a previous solution (the reference's sweep trick)
    res2 = ssqp.solve_qp(QL, S=resL.S, x0=resL.x)
    print(f"warm restart converged in {int(res2.status)} iteration(s)")

    # 5. Modeling API with extra constraints (sector cap)
    m = ssqp.Model(device=dev, dtype=torch.float64)
    xs = m.add_variables(N, lb=0.0, ub=0.3)
    m.add_eq({i: 1.0 for i in xs}, 1.0)
    m.add_le({i: 1.0 for i in xs[: N // 2]}, 0.6)  # sector cap
    m.set_objective(quad={(i, j): V[i, j] for i in xs for j in xs
                          if V[i, j] != 0.0},
                    lin={i: -rets[i] for i in xs})
    print(f"model API: {m.optimize()} objective={m.objective_value():.5f}")

    # 6. High-accuracy tier: float32 active-set search + float64 refinement
    resr = ssqp.solve_qp_refined(Q, search_dtype=torch.float32).numpy()
    print(f"refined solve matches f64 path to "
          f"{np.abs(resr.x - res.x).max():.2e}")
    return dict(status=int(res.status), refined_err=float(
        np.abs(resr.x - res.x).max()), model=m.termination_status())


if __name__ == "__main__":
    main()
