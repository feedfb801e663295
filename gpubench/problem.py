"""What every configuration builder shares: the seeded generator on the
device, the covariance of the repository's problem generators, and the
container a builder returns."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from gpubench.reference.qp import Data

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A torch.Generator on ``device`` for one stream of ``seed``: the same
    (seed, stream) gives the same numbers, every stream others."""
    state = np.random.SeedSequence([int(seed), int(stream)]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state))
    return gen


def covariance(H: torch.Tensor) -> torch.Tensor:
    """V = H H'/N + 0.5 I, made exactly symmetric (bench.py's and
    bench_suite.py's covariance; chip_smoke.py::bench_problem, :556-566)."""
    N = H.shape[0]
    V = H @ H.T / N
    V = (V + V.T) / 2
    return V + 0.5 * torch.eye(N, dtype=H.dtype, device=H.device)


@dataclasses.dataclass
class Problem:
    """A configuration as built for one run.

    ``qp`` is the program's problem (its q a template), ``data`` the
    float64 copy of the very inputs handed to the program (for the
    reference), ``rets`` the expected returns in the program's dtype where
    the configuration has them (the L-frontier's q is -lambda rets)."""

    qp: Any
    data: Data
    dtype: torch.dtype
    rets: Optional[torch.Tensor] = None


def make_qp(device, V, q, A=None, b=None, G=None, g=None, d=None, u=None):
    """The program's validated constructor, fed the benchmark's tensors (in
    their own dtype)."""
    from ssqp_tpu_torch import make_qp as program_make_qp

    host = lambda t: None if t is None else t.cpu().numpy()
    return program_make_qp(host(V), host(q), host(A), host(b), G=host(G),
                           g=host(g), d=host(d), u=host(u),
                           dtype=host(V).dtype, device=device)
