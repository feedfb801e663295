"""The port's wave-parallel frontier sweep (ssqp_tpu_torch/models/
frontier.py ``frontier_waves_sweep``, on ``solve_qp_batch_waves``) against
the JAX package on the CPU in float64 (its JAX reference compiles for
~12 s here, so it has a file of its own; the other sweeps are in
tests/test_torch_frontier*.py).

Problem: tests/test_frontier.py's market (N=12, seed 3, V = HH'/N + 0.5 I,
r ~ U(0, 0.25), budget row, 0 <= x <= 0.4), L grid linspace(0, 2, 16),
waves=4.

Tolerances: status and S equal, x, ret and risk within 1e-9; a grid not
divisible by the wave count is refused.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssqp_tpu.models import frontier as jf
from ssqp_tpu.types import Settings as JSettings
from ssqp_tpu_torch import Settings as TSettings
from ssqp_tpu_torch.models import frontier as tf

from test_torch_frontier import _same, market  # noqa: F401 (fixture)


def test_waves_sweep_matches_jax(market):
    V, r, Qj, Qt = market
    lams = np.linspace(0.0, 2.0, 16)
    fj = jf.frontier_waves_sweep(Qj, jnp.asarray(r), jnp.asarray(lams),
                                 JSettings(), waves=4)
    ft = tf.frontier_waves_sweep(Qt, torch.tensor(r), torch.tensor(lams),
                                 TSettings(), waves=4)
    assert (ft.status > 0).all()
    _same(ft, fj)
    with pytest.raises(ValueError):
        tf.frontier_waves_sweep(Qt, r, lams[:15], TSettings(), waves=4)
