"""The port's Phase-1 (ssqp_tpu_torch/solvers/phase1.py on the batched
bounded simplex) against the JAX package's ``init_qp_traced``, on the
tests/test_phase1.py cases and constructed-optimum problems.

Tolerance: float64, x0 within 1e-10 (the same pivot sequence on the same
data; the maintained inverse differs by summation order only); statuses and
the Phase-1 status exactly equal."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssqp_tpu import Settings as JSettings
from ssqp_tpu import make_qp as jmake_qp
from ssqp_tpu.solvers.phase1 import init_qp_traced as jinit
from ssqp_tpu.solvers.phase1 import standardize_bounded as jstd
from ssqp_tpu.solvers.simplex import bounded_simplex as jbs
from ssqp_tpu.utils.problems import generate_qp_known_opt
from ssqp_tpu_torch import QP
from ssqp_tpu_torch import Settings as TSettings
from ssqp_tpu_torch.parallel.batch import stack_qps
from ssqp_tpu_torch.solvers.phase1 import init_qp_traced as tinit
from ssqp_tpu_torch.solvers.simplex import _all_ratio
from ssqp_tpu_torch.solvers.simplex import bounded_simplex as tbs
from ssqp_tpu_torch.types import DN

FIELDS = ("V", "A", "G", "q", "b", "g", "d", "u")


def _port(Q):
    return QP.from_numpy(*(np.asarray(getattr(Q, f)) for f in FIELDS),
                         Q.N, Q.M, Q.J, Q.mc, device="cpu")


def _port1(Q):
    """The port's batch of one for a single JAX QP."""
    Qt = _port(Q)
    return dataclasses.replace(Qt, q=Qt.q.unsqueeze(0))


def _kw_cases():
    N = 5
    G1 = np.zeros((1, N))
    G1[0, 0] = 1.0
    cases = {
        "portfolio": dict(V=np.eye(3), u=np.array([0.7, np.inf, 0.7])),
        "infeasible": dict(V=np.eye(2), d=np.array([2.0, 2.0])),
        "free_with_inequality": dict(V=np.eye(N), G=G1, g=[10.0],
                                     d=np.full(N, -np.inf),
                                     u=np.full(N, np.inf)),
        "flipped": dict(V=np.eye(4), d=np.full(4, -np.inf), u=np.full(4, 0.3)),
        "flipped_active": dict(V=np.eye(4), d=np.full(4, -np.inf),
                               u=np.array([0.2, 0.2, np.inf, np.inf])),
    }
    for seed in range(3):
        gp = generate_qp_known_opt(300 + seed, N=10, M=2, J=4, n_dn=2,
                                   n_up=1, j_act=2)
        cases[f"known_opt_{seed}"] = dict(V=gp.V, q=gp.q, A=gp.A, b=gp.b,
                                          G=gp.G, g=gp.g, d=gp.d, u=gp.u)
    return cases


def _compare(Qj, Qt, rule="dantzig", skip=None):
    xj, Sxj, Sej, stj = jinit(Qj, JSettings(rule=rule))
    xt, Sxt, Set, stt = tinit(Qt, TSettings(rule=rule), skip=skip)
    return (np.asarray(xj), np.asarray(Sxj), np.asarray(Sej), int(stj)), \
        (xt.numpy(), Sxt.numpy(), Set.numpy(), stt.numpy())


@pytest.mark.parametrize("name", sorted(_kw_cases()))
def test_init_qp_matches_jax(name):
    Qj = jmake_qp(**_kw_cases()[name])
    (xj, Sxj, Sej, stj), (xt, Sxt, Set, stt) = _compare(Qj, _port1(Qj))
    assert stt[0] == stj
    np.testing.assert_array_equal(Sxt[0], Sxj)
    np.testing.assert_array_equal(Set[0], Sej)
    np.testing.assert_allclose(xt[0], xj, rtol=0, atol=1e-10)
    if name == "infeasible":
        assert stj == 0


@pytest.mark.parametrize("rule", ["dantzig", "steepest_edge"])
def test_pivot_rules_match_jax(rule):
    gp = generate_qp_known_opt(55, N=8, M=2, J=2, n_dn=1, n_up=1, j_act=1)
    Qj = jmake_qp(gp.V, gp.q, gp.A, gp.b, G=gp.G, g=gp.g, d=gp.d, u=gp.u)
    (xj, Sxj, Sej, stj), (xt, Sxt, Set, stt) = _compare(Qj, _port1(Qj), rule)
    assert stt[0] == stj == 1
    np.testing.assert_array_equal(Sxt[0], Sxj)
    np.testing.assert_allclose(xt[0], xj, rtol=0, atol=1e-10)


def _entering_scores(std, c, Bb, Sv, x, tol):
    """max_improvement scores |ht * theta| at a basis (fresh inverse)."""
    A, d, u = (np.asarray(a, np.float64) for a in (std.A1, std.d1, std.u1))
    w = np.linalg.solve(A[:, Bb].T, c[Bb])
    h = c - A.T @ w
    ht = np.where(Sv == DN, -h, h)
    invB = np.linalg.inv(A[:, Bb])
    xn = np.where(np.isin(np.arange(A.shape[1]), Bb), 0.0, x)
    qv = invB @ (np.asarray(std.b0) - A @ xn)
    t = lambda a: torch.tensor(a)[None]
    theta = _all_ratio(t(invB @ A), t(qv), t(Sv), t(d[Bb]), t(u[Bb]),
                       t(u - d), t(np.isfinite(u)), tol)[0].numpy()
    cand = (~np.isin(np.arange(A.shape[1]), Bb)) & np.asarray(std.real) \
        & (u - d > 0) & (ht > tol)
    with np.errstate(invalid="ignore"):  # 0 * inf off the candidate set
        return np.where(cand, np.abs(ht * theta), -np.inf)


@pytest.mark.parametrize("seed", [55, 61])
def test_max_improvement_matches_jax_up_to_score_ties(seed):
    """max_improvement meets exact score ties on Phase-1 LPs (several
    columns reach the same |h theta|); an argmax over tied scores may pick
    another column under a different summation order. The walks must agree
    pivot for pivot until the first divergence, which must be such a tie
    (relative 1e-12), and both must end feasible."""
    gp = generate_qp_known_opt(seed, N=8, M=2, J=2, n_dn=1, n_up=1, j_act=1)
    Qj = jmake_qp(gp.V, gp.q, gp.A, gp.b, G=gp.G, g=gp.g, d=gp.d, u=gp.u)
    std = jstd(Qj.A, Qj.G, Qj.b, Qj.g, Qj.d, Qj.u)
    N0, R, tol = 2 * Qj.N + Qj.J, Qj.M + Qj.J, 2.0 ** -26
    c = np.r_[np.zeros(N0), np.ones(R)]
    t = lambda a: torch.tensor(np.asarray(a))[None]
    prev = None
    for k in range(1, 40):
        sj = jbs(jnp.asarray(c), std.A1, std.b0, std.d1, std.u1, std.B0,
                 std.S0, std.d1, std.real, tol=tol, max_iter=k,
                 rule="max_improvement")
        st = tbs(t(c), t(std.A1), t(std.b0), t(std.d1), t(std.u1),
                 t(std.B0), t(std.S0), t(std.d1), t(std.real), tol=tol,
                 max_iter=k, rule="max_improvement")
        Bj, Bt = np.asarray(sj[2]), st[2][0].numpy()
        if not np.array_equal(Bj, Bt):
            sc = _entering_scores(std, c, *prev, tol)
            kj, kt = set(Bj) - set(prev[0]), set(Bt) - set(prev[0])
            for col in kj | kt:
                assert sc[col] >= sc.max() * (1 - 1e-12), (col, sc)
            break
        assert int(sj[0]) == int(st[0][0])
        if int(sj[0]) > 0:
            break
        prev = (Bt, st[3][0].numpy(), st[1][0].numpy())
    (xj, _, _, stj), (xt, _, _, stt) = _compare(Qj, _port1(Qj),
                                                "max_improvement")
    assert stj == stt[0] == 1
    for x in (xj, xt[0]):
        assert np.abs(gp.A @ x - gp.b).max() < 1e-9
        assert (gp.G @ x <= gp.g + 1e-9).all()
        assert (x >= gp.d - 1e-12).all() and (x <= gp.u + 1e-12).all()


def test_batched_per_instance_problems_with_skip():
    """A stacked batch of different problems: each instance matches its own
    JAX Phase-1, and skipped instances neither run nor disturb the rest."""
    gps = [generate_qp_known_opt(400 + s, N=8, M=1, J=3, n_dn=2, n_up=1,
                                 j_act=1) for s in range(4)]
    Qjs = [jmake_qp(gp.V, gp.q, gp.A, gp.b, G=gp.G, g=gp.g, d=gp.d, u=gp.u)
           for gp in gps]
    Qt = stack_qps([_port(Q) for Q in Qjs])
    skip = torch.tensor([False, True, False, False])
    xt, Sxt, Set, stt = tinit(Qt, TSettings(), skip=skip)
    for i, Qj in enumerate(Qjs):
        if skip[i]:
            assert stt[i] == 1  # pre-done: the caller discards it
            continue
        xj, Sxj, Sej, stj = jinit(Qj, JSettings())
        assert int(stt[i]) == int(stj) == 1
        np.testing.assert_array_equal(Sxt[i].numpy(), np.asarray(Sxj))
        np.testing.assert_array_equal(Set[i].numpy(), np.asarray(Sej))
        np.testing.assert_allclose(xt[i].numpy(), np.asarray(xj), rtol=0,
                                   atol=1e-10)
