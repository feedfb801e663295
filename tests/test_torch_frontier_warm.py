"""The port's warm L-sweep (ssqp_tpu_torch/models/frontier.py
``frontier_warm_sweep``) and its simpler Phase-1 (solvers/phase1.py
``init_ssqp_traced``, ``init_qp``) against the JAX package on the CPU in
float64. The batch sweeps are in tests/test_torch_frontier.py, the mu
sweeps in tests/test_torch_frontier_mu.py.

Problem: tests/test_frontier.py's market (N=12, seed 3, V = HH'/N + 0.5 I,
r ~ U(0, 0.25), budget row, 0 <= x <= 0.4), the L grid linspace(0, 2, 16).
The case whose cold re-solve fires keeps those shapes, so the JAX sweep
compiles once: a NaN L point (the warm S-loop and its cold re-solve both
fail, the carry keeps the last good state). Phase-1: the constructed-optimum
generator at N=8, M=2, J=2.

Tolerances: status and S equal, x, ret and risk within 1e-9; Phase-1
statuses equal, x0 within 1e-9.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssqp_tpu.models import frontier as jf
from ssqp_tpu.solvers import phase1 as jp
from ssqp_tpu.types import Settings as JSettings
from ssqp_tpu.types import make_qp as jmake_qp
from ssqp_tpu.utils.problems import generate_qp_known_opt
from ssqp_tpu_torch import QP, make_qp
from ssqp_tpu_torch import Settings as TSettings
from ssqp_tpu_torch.models import frontier as tf
from ssqp_tpu_torch.solvers import phase1 as tp
from ssqp_tpu_torch.solvers import ssqp as ts

FIELDS = ("V", "A", "G", "q", "b", "g", "d", "u")
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


def _sweep(name, market, grid):
    V, r, Qj, Qt = market
    fj = getattr(jf, name)(Qj, jnp.asarray(r), jnp.asarray(grid),
                           JSettings())
    ft = getattr(tf, name)(Qt, torch.tensor(r), torch.tensor(grid),
                           TSettings())
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


@pytest.mark.parametrize("case", ["plain", "nan point"])
def test_warm_sweep_matches_jax(market, monkeypatch, case):
    lams = np.linspace(0.0, 2.0, 16)
    if case == "nan point":
        lams[5] = np.nan
    cold = _CountCold(monkeypatch)
    ft, fj = _sweep("frontier_warm_sweep", market, lams)
    _same(ft, fj)
    st = ft.status.numpy()
    if case == "plain":
        assert (st > 0).all() and cold.calls == 0
    else:  # the failed point was re-solved cold, the rest went on warm
        assert st[5] <= 0 and (np.delete(st, 5) > 0).all()
        assert cold.calls == 1


def test_warm_sweep_agrees_with_the_batch_sweep(market):
    V, r, Qj, Qt = market
    lams = torch.linspace(0.0, 2.0, 16, dtype=torch.float64)
    fw = tf.frontier_warm_sweep(Qt, torch.tensor(r), lams, TSettings())
    fb = tf.frontier_batch_sweep(Qt, torch.tensor(r), lams, TSettings())
    np.testing.assert_allclose(fw.x.numpy(), fb.x.numpy(), rtol=0,
                               atol=1e-9)
    assert np.all(np.diff(fw.risk.numpy()) > -1e-8)
    assert np.all(np.diff(fw.ret.numpy()) > -1e-8)


def test_warm_step_builds_each_point_without_replicating_v(market,
                                                           monkeypatch):
    """Each warm step solves a batch of one whose V is the template's own
    tensor (shared, never copied per point)."""
    V, r, Qj, Qt = market
    seen = []
    real = tf.solve_qp_loop

    def spy(Q, *a, **k):
        seen.append((Q.V.data_ptr(), Q.q.shape, Q.is_batched("V")))
        return real(Q, *a, **k)
    monkeypatch.setattr(tf, "solve_qp_loop", spy)
    tf.frontier_warm_sweep(Qt, torch.tensor(r),
                           torch.linspace(0.0, 2.0, 4, dtype=torch.float64),
                           TSettings())
    assert seen == [(Qt.V.data_ptr(), (1, N), False)] * 4
    assert ts.solve_qp_loop is real


def _port(Q):
    P = QP.from_numpy(*(np.asarray(getattr(Q, f)) for f in FIELDS),
                      Q.N, Q.M, Q.J, Q.mc, device="cpu")
    return dataclasses.replace(P, q=P.q.unsqueeze(0))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_init_ssqp_traced_matches_jax(seed):
    """The simpler Phase-1 (finite lower bounds, no free split): the same
    start point, statuses and verdict, instance by instance; an infeasible
    instance (seed 3: the budget row asks for more than the box allows)
    reports 0 in both."""
    gp = generate_qp_known_opt(seed, N=8, M=2, J=2)
    b = gp.b if seed < 3 else gp.b + 100.0
    Qj = jmake_qp(gp.V, gp.q, gp.A, b, G=gp.G, g=gp.g, d=gp.d, u=gp.u)
    rj = jp.init_ssqp_traced(Qj, JSettings())
    rt = tp.init_ssqp_traced(_port(Qj), TSettings())
    np.testing.assert_allclose(rt[0][0].numpy(), np.asarray(rj[0]), rtol=0,
                               atol=1e-9)
    for a, b_ in zip(rt[1:], rj[1:]):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b_))
    assert int(rt[3][0]) == (1 if seed < 3 else 0)


def test_init_ssqp_traced_without_rows_starts_at_the_lower_bounds():
    Qt = make_qp(np.eye(3), np.ones(3), A=np.zeros((0, 3)), b=np.zeros(0),
                 d=np.array([0.0, 1.0, -1.0]), u=np.full(3, 2.0),
                 device="cpu")
    x0, Sx, Se, st = tp.init_ssqp_traced(
        dataclasses.replace(Qt, q=Qt.q.unsqueeze(0)), TSettings())
    np.testing.assert_array_equal(x0[0].numpy(), [0.0, 1.0, -1.0])
    assert (Sx == 1).all() and Se.shape == (1, 0) and int(st[0]) == 1


def test_init_qp_takes_one_problem_or_a_batch():
    gp = generate_qp_known_opt(5, N=8, M=2, J=2)
    Qj = jmake_qp(gp.V, gp.q, gp.A, gp.b, G=gp.G, g=gp.g, d=gp.d, u=gp.u)
    one = tp.init_qp(QP.from_numpy(*(np.asarray(getattr(Qj, f))
                                     for f in FIELDS), Qj.N, Qj.M, Qj.J,
                                   device="cpu"), TSettings())
    batch = tp.init_qp(_port(Qj), TSettings())
    assert one[0].shape == (8,) and batch[0].shape == (1, 8)
    for a, b in zip(one, batch):
        np.testing.assert_array_equal(a.numpy(), b[0].numpy())
    assert int(one[3]) == 1
