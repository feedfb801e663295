"""The port's frontier constructors and batch sweeps (ssqp_tpu_torch/types.py
``qp_frontier_L``/``qp_frontier_mu``, models/frontier.py
``frontier_batch_sweep``) against the JAX package on the CPU in float64.
The waves sweep is in tests/test_torch_frontier_waves.py, the warm L-sweep
and the simpler Phase-1 in tests/test_torch_frontier_warm.py, the mu
sweeps in tests/test_torch_frontier_mu.py: each JAX sweep compiles for
3-13 s here, so the five do not fit one file's 30 s.

Problem: tests/test_frontier.py's market (N=12, seed 3, V = HH'/N + 0.5 I,
r ~ U(0, 0.25), budget row, 0 <= x <= 0.4), L grid linspace(0, 2, 16).

Tolerances: constructors bit for bit; status and S equal, x, ret and risk
within 1e-9.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssqp_tpu.models import frontier as jf
from ssqp_tpu.types import Settings as JSettings
from ssqp_tpu.types import make_qp as jmake_qp
from ssqp_tpu.types import qp_frontier_L as jL
from ssqp_tpu.types import qp_frontier_mu as jmu
from ssqp_tpu_torch import make_qp, qp_frontier_L, qp_frontier_mu
from ssqp_tpu_torch import Settings as TSettings
from ssqp_tpu_torch.models import frontier as tf

FIELDS = ("V", "A", "G", "q", "b", "g", "d", "u")
N = 12


def _market(N=N, seed=3):
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((N, N))
    return H @ H.T / N + 0.5 * np.eye(N), rng.uniform(0.0, 0.25, N)


@pytest.fixture(scope="module")
def market():
    V, r = _market()
    Qj = jmake_qp(V, np.zeros(N), u=np.full(N, 0.4))
    Qt = make_qp(V, np.zeros(N), u=np.full(N, 0.4), device="cpu")
    return V, r, Qj, Qt


def _same(ft, fj):
    np.testing.assert_array_equal(ft.status.numpy(), np.asarray(fj.status))
    np.testing.assert_array_equal(ft.S.numpy(), np.asarray(fj.S))
    for k in ("x", "ret", "risk"):
        np.testing.assert_allclose(getattr(ft, k).numpy(),
                                   np.asarray(getattr(fj, k)), rtol=0,
                                   atol=1e-9)


def test_frontier_constructors_match_jax(market):
    V, r, _, _ = market
    Qj = jmake_qp(V, r, u=np.full(N, 0.4))
    Qt = make_qp(V, r, u=np.full(N, 0.4), device="cpu")
    for Pt, Pj in ((qp_frontier_L(Qt, 1.5), jL(Qj, 1.5)),
                   (qp_frontier_mu(Qt, 0.12), jmu(Qj, 0.12))):
        assert (Pt.N, Pt.M, Pt.J, Pt.mc) == (Pj.N, Pj.M, Pj.J, Pj.mc)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(Pt, f).numpy(),
                                          np.asarray(getattr(Pj, f)))
    assert qp_frontier_mu(Qt, 0.12).M == Qt.M + 1


def test_batch_sweep_matches_jax(market):
    V, r, Qj, Qt = market
    lams = np.linspace(0.0, 2.0, 16)
    fj = jf.frontier_batch_sweep(Qj, jnp.asarray(r), jnp.asarray(lams),
                                 JSettings())
    ft = tf.frontier_batch_sweep(Qt, torch.tensor(r), torch.tensor(lams),
                                 TSettings())
    assert (ft.status > 0).all()
    _same(ft, fj)
    # ret and risk agree with x
    x = ft.x.numpy()
    np.testing.assert_allclose(ft.ret.numpy(), x @ r, rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        ft.risk.numpy(), np.sqrt(np.einsum("bi,ij,bj->b", x, V, x)), rtol=0,
        atol=1e-12)
