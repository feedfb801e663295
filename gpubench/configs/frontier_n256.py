"""frontier_n256: the headline frontier problem (bench.py; copied from
chip_smoke.py::bench_problem, :556-566), drawn on the device from the
configuration's data seed. Sizes from ``frontier_n256.json``."""

import torch

from gpubench.problem import Problem, covariance, generator, make_qp
from gpubench.reference.qp import Data


def build(cfg: dict, dtype, device) -> Problem:
    N = cfg["N"]
    f64 = torch.float64
    # one deployment's data; the run's seed draws only its requests
    gen = generator(cfg["data_seed"], device, 0)
    H = torch.randn(N, N, generator=gen, dtype=f64, device=device)
    V = covariance(H).to(dtype)
    mu = (0.2 * torch.rand(N, generator=gen, dtype=f64, device=device)
          ).to(dtype)
    d = torch.zeros(N, dtype=dtype, device=device)
    u = torch.full((N,), 4.0 / N, dtype=dtype, device=device)
    A = torch.ones((1, N), dtype=dtype, device=device)
    b = torch.ones(1, dtype=dtype, device=device)
    qp = make_qp(device, V, mu, A, b, d=d, u=u)
    data = Data(V.double(), A.double(), b.double(),
                torch.zeros((0, N), dtype=f64, device=device),
                torch.zeros(0, dtype=f64, device=device), d.double(),
                u.double())
    return Problem(qp=qp, data=data, dtype=dtype, rets=mu)
