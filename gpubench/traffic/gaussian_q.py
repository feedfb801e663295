"""Traffic kind ``gaussian_q``: request r is ``batch`` linear terms
q ~ N(0, 1) drawn on the device (bench_suite.py::config4; batch 0: one
unbatched problem). An instance's parameter is its q row; the reference
solves it on the configuration's shared data."""

import torch

from gpubench.problem import generator


class Requests:
    def __init__(self, spec: dict, seed: int, p, device):
        self.spec, self.seed, self.device = spec, int(seed), device
        self.N, self.dtype = p.data.V.shape[0], p.dtype

    def request(self, r: int) -> dict:
        gen = generator(self.seed, self.device, 1000 + r)
        b = self.spec["batch"]
        q = torch.randn((b, self.N) if b else (self.N,), generator=gen,
                        dtype=torch.float64, device=self.device)
        return {"q": q.to(self.dtype)}

    def param(self, req: dict) -> torch.Tensor:
        return req["q"].reshape(-1, self.N)


def reference(p, param: torch.Tensor):
    """The float64 data and linear terms of the instances of ``param``."""
    return p.data, param.double()
