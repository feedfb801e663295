"""Differentiable QP solves on the PyTorch/CUDA port (``ssqp_tpu_torch``),
the twin of examples/differentiable.py: sensitivities and gradient-based
calibration through ``solve_qp_diff`` (solvers/diff.py), which composes
with torch.autograd. Three demos:

  1. frontier sensitivity dx*/dlambda (risk-aversion jacobian) vs finite
     differences;
  2. shadow prices: d(optimal value)/d(budget b) equals -lambda, straight
     from autograd;
  3. calibration: recover the risk aversion that produces a target
     allocation by gradient descent through the solver.

Run: python examples/torch_differentiable.py          (on the card)
     python examples/torch_differentiable.py --cpu    (on the CPU)
"""

import argparse
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

import ssqp_tpu_torch as ssqp
from ssqp_tpu_torch.solvers.diff import qp_value, solve_qp_diff


def device_arg(argv, doc):
    """'cpu' under --cpu, else 'cuda'."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    return "cpu" if ap.parse_args(argv).cpu else "cuda"


def main(argv=None):
    dev = device_arg(argv, __doc__)
    rng = np.random.default_rng(3)
    N = 32
    H = rng.standard_normal((N, N))
    V = (H @ H.T / N + 0.5 * np.eye(N)).astype(np.float32)
    mu = rng.uniform(0.0, 0.25, N).astype(np.float32)
    Q = ssqp.make_qp(V, mu, u=np.full(N, 3.0 / N, np.float32),
                     dtype=np.float32, device=dev)
    mu_t = torch.tensor(mu, device=dev)
    scalar = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)

    # -- 1. frontier sensitivity ------------------------------------------
    def alloc(lam):
        return solve_qp_diff(dataclasses.replace(Q, q=-lam * mu_t)).x

    lam0 = scalar(0.8)
    dx = torch.autograd.functional.jacobian(alloc, lam0)
    h = 1e-2
    fd = (alloc(lam0 + h) - alloc(lam0 - h)) / (2 * h)
    fd_err = float((dx - fd).abs().max())
    print(f"dx*/dlambda: |AD|={float(torch.linalg.norm(dx)):.4f}  "
          f"max|AD-FD|={fd_err:.2e}")

    # -- 2. shadow price of the budget ------------------------------------
    b = Q.b.clone().requires_grad_(True)
    Qi = dataclasses.replace(Q, b=b)
    qp_value(Qi, solve_qp_diff(Qi).x).backward()
    lam_eq = solve_qp_diff(Q).lam[: Q.M]
    print(f"shadow price: dV/db={float(b.grad[0]):+.5f}  "
          f"-lambda_eq={float(-lam_eq[0]):+.5f}")

    # -- 3. calibrate risk aversion to a target allocation ----------------
    with torch.no_grad():
        target = alloc(scalar(1.3))
    lam = scalar(0.4)
    for _ in range(40):
        lam.requires_grad_(True)
        loss = torch.sum((alloc(lam) - target) ** 2)
        (g,) = torch.autograd.grad(loss, lam)
        lam = (lam - 8.0 * g).detach()
    loss = float(torch.sum((alloc(lam) - target) ** 2))
    print(f"calibration: recovered lambda={float(lam):.4f} (true 1.3), "
          f"loss={loss:.2e}")
    return dict(fd_err=fd_err, shadow=(float(b.grad[0]),
                                       float(-lam_eq[0])),
                lam=float(lam), loss=loss)


if __name__ == "__main__":
    main()
