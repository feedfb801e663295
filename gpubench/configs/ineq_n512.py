"""ineq_n512: BASELINE config 4's problem (bench_suite.py::config4,
:442-463; chip_smoke.py::ineq_problem, :851-867), drawn on the device from
the configuration's data seed. Sizes from ``ineq_n512.json``; q comes
with each request."""

import torch

from gpubench.problem import Problem, covariance, generator, make_qp
from gpubench.reference.qp import Data


def build(cfg: dict, dtype, device) -> Problem:
    N, M, J = cfg["N"], cfg["M"], cfg["J"]
    f64 = torch.float64
    # one deployment's data; the run's seed draws only its requests
    gen = generator(cfg["data_seed"], device, 0)
    rand = lambda *s: torch.rand(*s, generator=gen, dtype=f64, device=device)
    randn = lambda *s: torch.randn(*s, generator=gen, dtype=f64,
                                   device=device)
    V = covariance(randn(N, N))
    A = randn(M, N)
    x0 = rand(N)
    G = randn(J, N)
    g = G @ x0 + 0.1 + 0.9 * rand(J)
    leaves = dict(V=V, A=A, b=A @ x0, G=G, g=g, d=x0 - 2.0, u=x0 + 2.0)
    leaves = {k: t.to(dtype) for k, t in leaves.items()}
    qp = make_qp(device, q=torch.zeros(N, dtype=dtype, device=device),
                 **leaves)
    data = Data(**{k: t.double() for k, t in leaves.items()})
    return Problem(qp=qp, data=data, dtype=dtype)
