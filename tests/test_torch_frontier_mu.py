"""The port's mu-parameterized frontier sweeps (ssqp_tpu_torch/models/
frontier.py ``frontier_mu_sweep``, ``frontier_mu_warm_sweep``) against the
JAX package on the CPU in float64.

Problem: tests/test_frontier.py's market (N=12, seed 3, V = HH'/N + 0.5 I,
r ~ U(0, 0.25), budget row, 0 <= x <= 0.4), the mu grid 12 points inside
[min r + 0.02, max r - 0.02]. Cases whose cold re-solve fires: an
unachievable mu in the middle (status 0, the carry keeps the last good
state and the sweep moves on; its warm loop runs to the S-iteration
budget in both packages, so the warm cases run with a budget of 100), and
an unachievable first mu (its Phase-1 status gates every warm step, so
every point is re-solved cold).

Tolerances: status and S equal, x, ret and risk within 1e-9; the return
row r'x = mu within 1e-9 on every solved point.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssqp_tpu.models import frontier as jf
from ssqp_tpu.types import Settings as JSettings
from ssqp_tpu.types import make_qp as jmake_qp
from ssqp_tpu_torch import make_qp
from ssqp_tpu_torch import Settings as TSettings
from ssqp_tpu_torch.models import frontier as tf

N = 12


@pytest.fixture(scope="module")
def market():
    rng = np.random.default_rng(3)
    H = rng.standard_normal((N, N))
    V, r = H @ H.T / N + 0.5 * np.eye(N), rng.uniform(0.0, 0.25, N)
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

def _sweep(name, market, grid, max_iter=None):
    V, r, Qj, Qt = market
    kw = {} if max_iter is None else dict(max_iter=max_iter)
    fj = getattr(jf, name)(Qj, jnp.asarray(r), jnp.asarray(grid),
                           JSettings(**kw))
    ft = getattr(tf, name)(Qt, torch.tensor(r), torch.tensor(grid),
                           TSettings(**kw))
    return ft, fj

class _CountCold:
    """Counts the cold re-solves a warm sweep makes."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = tf.solve_qp_auto_core

        def spy(*a, **k):
            self.calls += 1
            return real(*a, **k)
        monkeypatch.setattr(tf, "solve_qp_auto_core", spy)


def _mus(r):
    return np.linspace(r.min() + 0.02, r.max() - 0.02, 12)


def test_mu_sweep_matches_jax(market):
    V, r, Qj, Qt = market
    ft, fj = _sweep("frontier_mu_sweep", market, _mus(r))
    assert (ft.status > 0).all()
    _same(ft, fj)
    np.testing.assert_allclose(ft.ret.numpy(), _mus(r), rtol=0, atol=1e-9)


@pytest.mark.parametrize("case", ["plain", "unachievable middle",
                                  "unachievable first"])
def test_mu_warm_sweep_matches_jax(market, monkeypatch, case):
    V, r, Qj, Qt = market
    mus = _mus(r)
    bad = []
    if case == "unachievable middle":
        mus[4] = r.max() + 0.5
        bad = [4]
    elif case == "unachievable first":
        mus[0], mus[6] = r.max() + 0.5, r.min() - 0.3
        bad = [0, 6]
    cold = _CountCold(monkeypatch)
    # an unachievable point's warm S-loop runs to max_iter in both
    # packages: a budget of 100 (every solvable point here takes at most
    # 16) keeps the port's CPU loop short, and the JAX sweep compiles once
    ft, fj = _sweep("frontier_mu_warm_sweep", market, mus, max_iter=100)
    _same(ft, fj)
    st = ft.status.numpy()
    assert (st[bad] == 0).all() and (np.delete(st, bad) > 0).all()
    good = np.delete(np.arange(12), bad)
    np.testing.assert_allclose(ft.ret.numpy()[good], mus[good], rtol=0,
                               atol=1e-9)
    assert cold.calls == {"plain": 0, "unachievable middle": 1,
                          "unachievable first": 12}[case]
