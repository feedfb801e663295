"""Traffic kind ``lambda_grid``: request r is the grid ``linspace(delta_r,
span + delta_r, points)`` of risk tolerances, delta_r = step (r + offset)
with the offset in [0, 100) drawn from the seed (chip_smoke.py::grid,
:569-572). An instance's parameter is its lambda; the reference solves it
with q = -lambda rets on the configuration's shared data."""

import numpy as np
import torch


class Requests:
    def __init__(self, spec: dict, seed: int, p, device):
        self.spec, self.dtype, self.device = spec, p.dtype, device
        ss = np.random.SeedSequence([int(seed), 1])
        self.offset = int(ss.generate_state(1, np.uint64)[0] % 100)

    def request(self, r: int) -> dict:
        s = self.spec
        delta = s["step"] * (r + self.offset)
        return {"lams": torch.linspace(delta, s["span"] + delta, s["points"],
                                       dtype=self.dtype, device=self.device)}

    def param(self, req: dict) -> torch.Tensor:
        return req["lams"].unsqueeze(1)


def reference(p, param: torch.Tensor):
    """The float64 data and linear terms of the instances of ``param``."""
    return p.data, -param.double() * p.rets.double()
