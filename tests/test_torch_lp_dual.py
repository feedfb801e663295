"""The port's dual simplex (solvers/simplex.py::dual_simplex_bounded, reached
through solvers/lp.py::_lp_phase2_dual), its dual-feasibility measures, the
batched warm restart (simplex_lp_warm) and the dual-simplex waves of
rhs-parametric grids (parallel/batch.py::solve_lp_batch_waves_rhs) against
the JAX package on the CPU.

Problems: tests/test_lp.py's rhs family (N=20, M=3, J=5, 0 <= x <= 2, b and g
along x0 + t (x1 - x0), t on a grid of B = 32), its b-only variant and its
infeasible member (a duplicated budget row whose copy disagrees). The dual
simplex starts from the JAX package's own optimal basis of grid point 0, so
both packages get the same start.

Tolerances, float64: status equal on every instance; x within 1e-9, S and
the basis equal where the status is 1; objective within 1e-9 max(1, |f|);
lam and gamma within 1e-8; the violation measures within 1e-12.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssqp_tpu import Settings as JSettings
from ssqp_tpu import make_lp as jmake_lp
from ssqp_tpu.parallel import batch as jb
from ssqp_tpu.solvers import lp as jlp
from ssqp_tpu.solvers import simplex as jsx
from ssqp_tpu_torch import LP
from ssqp_tpu_torch import Settings as TSettings
from ssqp_tpu_torch.parallel import batch as tb
from ssqp_tpu_torch.solvers import lp as tlp
from ssqp_tpu_torch.solvers import simplex as tsx

FIELDS = ("c", "A", "b", "G", "g", "d", "u")
S64 = JSettings()
T64 = TSettings()
N, M, J, B = 20, 3, 5, 32


def port(P):
    return LP.from_numpy(*(np.asarray(getattr(P, f)) for f in FIELDS),
                         P.N, P.M, P.J, P.mc, device="cpu")


def rhs_family(seed=12):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, N))
    G = rng.standard_normal((J, N))
    c = rng.standard_normal(N)
    x0 = rng.uniform(0.2, 0.9, N)
    x1 = rng.uniform(0.2, 0.9, N)
    ts = np.linspace(0.0, 1.0, B)
    Xc = x0[None, :] + ts[:, None] * (x1 - x0)[None, :]
    bB = Xc @ A.T
    gB = Xc @ G.T + rng.uniform(0.1, 1.0, J)[None, :]
    P = jmake_lp(c, A, bB[0], G=G, g=gB[0], d=np.zeros(N),
                 u=np.full(N, 2.0))
    return P, bB, gB


P0, BB, GB = rhs_family()


def assert_batch(rj, rt, c, lam=True):
    sj, st = np.asarray(rj.status), rt.status.numpy()
    np.testing.assert_array_equal(st, sj)
    xj, xt = np.asarray(rj.x), rt.x.numpy()
    c = np.broadcast_to(np.asarray(c), xj.shape)
    fj, ft = (c * xj).sum(1), (c * xt).sum(1)
    assert (np.abs(ft - fj) <= 1e-9 * np.maximum(1.0, np.abs(fj))).all()
    u = sj == 1
    np.testing.assert_array_equal(rt.S.numpy()[u], np.asarray(rj.S)[u])
    np.testing.assert_allclose(xt[u], xj[u], rtol=0, atol=1e-9)
    if lam:
        np.testing.assert_allclose(rt.lam.numpy(), np.asarray(rj.lam),
                                   rtol=0, atol=1e-8)
    np.testing.assert_allclose(rt.gamma.numpy(), np.asarray(rj.gamma),
                               rtol=0, atol=1e-8)


# ---- the dual simplex from a neighbour's optimal basis -------------------------


@jax.jit
def jax_start(P):
    """The JAX package's prep, cost and optimal Phase-2 exit of P."""
    prep = jlp._lp_prep(P.A, P.G, P.b, P.g, P.d, P.u, S64)
    start = jlp._lp_phase1(prep, S64)
    c0 = jlp._lp_cost(prep, P.c, P.N, P.J, True)
    return prep, c0, jlp._lp_phase2(prep, c0, start.B, start.S, start.x,
                                    S64)


@jax.jit
def jax_dual(prep, c0, b0p, Bb, Sb, xb):
    return jlp._lp_phase2_dual(prep, c0, b0p, Bb, Sb, xb, S64)


def test_dual_simplex_matches_jax():
    """From grid point 0's optimal basis: the rhs of points 1, 8 and 31 (a
    few pivots to many), a rhs that makes the problem infeasible (status
    0), a changed cost row (rejected at the entry gate: -1), a pre-done
    instance; and a two-step budget (-2)."""
    prep, c0, (st, x2, B3, S3) = jax_start(P0)
    assert int(st) == 1
    rm = np.asarray(prep.keep_rows, np.float64)
    rhs = [np.concatenate([BB[i], GB[i]]) * rm for i in (1, 8, 31)]
    rhs.append(np.concatenate([BB[8], GB[8] - 40.0]) * rm)
    c0n = np.asarray(c0)
    costs = [c0n] * 4 + [c0n + np.random.default_rng(1).normal(size=len(c0n))]
    rhs.append(rhs[0])
    cases = list(zip(rhs, costs))
    out_j = [jax_dual(prep, jnp.asarray(cc), jnp.asarray(r), B3, S3, x2)
             for r, cc in cases]
    # the port: one batch of the five, plus a pre-done copy of the first
    n = len(cases) + 1
    tprep = tlp._bcast(tlp._map(prep, lambda a: torch.tensor(np.asarray(a))
                                .unsqueeze(0)), n)
    b0p = torch.tensor(np.stack([r for r, _ in cases] + [rhs[0]]))
    cc = torch.tensor(np.stack([c for _, c in cases] + [c0n]))
    rep = lambda a, dt=None: torch.tensor(np.asarray(a)).unsqueeze(0) \
        .expand(n, *np.asarray(a).shape).to(dt)
    pd = torch.zeros(n, dtype=torch.bool)
    pd[-1] = True
    st_t, x_t, B_t, S_t = tlp._lp_phase2_dual(
        tprep, cc, b0p, rep(B3, torch.int64), rep(S3, torch.int8),
        rep(x2, torch.float64), T64, pre_done=pd)
    expect = [0, 0, 0, 0, -1]
    for i, (sj, xj, Bj, Sj) in enumerate(out_j):
        assert int(st_t[i]) == int(sj)
        if i < 4:
            assert int(sj) in (1, 2, 0)
        np.testing.assert_array_equal(B_t[i].numpy(), np.asarray(Bj))
        np.testing.assert_array_equal(S_t[i].numpy(), np.asarray(Sj))
        np.testing.assert_allclose(x_t[i].numpy(), np.asarray(xj), rtol=0,
                                   atol=1e-9)
    assert [int(s) for s in st_t[3:5]] == [expect[3], expect[4]]
    assert int(st_t[-1]) == 1  # pre-done: untouched, status 1
    np.testing.assert_array_equal(B_t[-1].numpy(), np.asarray(B3))
    # a budget of two steps on point 31's rhs (more pivots than that): the
    # iteration-limit code -2
    st2 = tlp._lp_phase2_dual(
        tlp._take(tprep, torch.tensor([2])), cc[2:3], b0p[2:3],
        rep(B3, torch.int64)[:1], rep(S3, torch.int8)[:1],
        rep(x2, torch.float64)[:1], dataclasses.replace(T64, max_iter=2))[0]
    assert int(st2[0]) == -2


def test_dual_feasibility_measures_match_jax():
    prep, c0, (st, x2, B3, S3) = jax_start(P0)
    A1 = np.asarray(prep.A1)
    Bv = np.asarray(B3)
    w = np.linalg.solve(A1[:, Bv].T, np.asarray(c0)[Bv])
    nb = np.ones(A1.shape[1], bool)
    nb[Bv] = False
    real = np.asarray(prep.std.real)
    ud = np.asarray(prep.std.u1 - prep.std.d1)
    rng = np.random.default_rng(3)
    for c in (np.asarray(c0), np.asarray(c0) + rng.normal(size=len(nb))):
        vj = jsx.dual_feasibility_violation(
            jnp.asarray(c), jnp.asarray(A1), jnp.asarray(w), S3,
            jnp.asarray(nb), jnp.asarray(real), jnp.asarray(ud))
        t = lambda a: torch.tensor(np.asarray(a)).unsqueeze(0)
        vt = tsx.dual_feasibility_violation(t(c), t(A1), t(w), t(S3), t(nb),
                                            t(real), t(ud))
        assert abs(float(vt[0]) - float(vj)) <= 1e-12
        gj = jsx.dual_gate_tol(jnp.asarray(c), jnp.asarray(S64.tol))
        assert abs(float(tsx.dual_gate_tol(t(c), T64.tol)[0]) - float(gj)) \
            <= 1e-15


# ---- the rhs waves and the batched warm restart ------------------------------


@pytest.fixture(scope="module")
def family():
    Pb = dataclasses.replace(P0, b=jnp.asarray(BB), g=jnp.asarray(GB))
    return Pb, port(Pb)


def test_waves_rhs_matches_jax():
    """W = 8 over both b and g: wave 0 two-phase, waves 1-7 dual restarts,
    the strided order held instance by instance. A's third row is a copy
    of its first, so the family's purge drops it; member 6, whose copy of
    the rhs disagrees, is invisible to the purged system, and the rescue
    and the original-row guard give it status 0."""
    A = np.asarray(P0.A).copy()
    A[2] = A[0]
    bB = BB.copy()
    bB[:, 2] = bB[:, 0]
    bB[6, 2] += 1.0
    Pj = dataclasses.replace(P0, A=jnp.asarray(A), b=jnp.asarray(bB),
                             g=jnp.asarray(GB))
    sh = ("c", "A", "G", "d", "u")
    rj = jb.solve_lp_batch_waves_rhs(Pj, S64, sh, waves=8)
    rt = tb.solve_lp_batch_waves_rhs(port(Pj), T64, sh, waves=8)
    assert int(rt.status[6]) == 0
    assert (np.delete(rt.status.numpy(), 6) >= 1).all()
    # dependent rows: the multipliers are compared through [A; G]'
    AG = np.vstack([A, np.asarray(P0.G)])
    np.testing.assert_allclose(rt.lam.numpy() @ AG, np.asarray(rj.lam) @ AG,
                               rtol=0, atol=1e-8)
    assert_batch(rj, rt, np.asarray(Pj.c), lam=False)


def test_waves_rhs_b_only_matches_plain(family):
    """g shared, only b varies (W = 4): the same optima as the plain
    two-phase batch (the JAX package's own check, tests/test_lp.py), whose
    parity with the JAX package is tests/test_torch_lp_batch.py's."""
    _, Pt = family
    Pb = dataclasses.replace(Pt, g=Pt.g[0])
    sh = ("c", "A", "G", "g", "d", "u")
    rw = tb.solve_lp_batch_waves_rhs(Pb, T64, sh, waves=4)
    rp = tb.solve_lp_batch(Pb, T64, sh)
    assert (rw.status >= 1).all()
    assert_batch(rp.numpy(), rw, Pb.c.numpy())


def test_simplex_lp_warm_batch_matches_jax(family):
    """The batched warm restart, each grid point from its neighbour's
    optimum (point i - 1's; point 0 from point 31's), three of them from
    another cost row's optimum, so their rows take the cold fallback:
    against the JAX package's simplex_lp_warm, one instance at a time, on
    eight instances."""
    Pj, Pt = family
    sh = ("c", "A", "G", "d", "u")
    prior = tb.solve_lp_batch(Pt, T64, sh)
    other = tb.solve_lp_batch(Pt, T64, sh, minimize=False)
    order = np.roll(np.arange(B), 1)
    Sp, xp = prior.S.numpy()[order], prior.x.numpy()[order]
    for i in (3, 17, 30):
        Sp[i], xp[i] = other.S[i].numpy(), other.x[i].numpy()
    rt = tlp.simplex_lp_warm(Pt, torch.tensor(Sp), torch.tensor(xp), T64)
    one = jax.jit(lambda p, s, x: jlp.simplex_lp_warm(p, s, x, S64, True))
    idx = [0, 1, 3, 9, 17, 22, 30, 31]
    rj = [one(dataclasses.replace(Pj, b=Pj.b[i], g=Pj.g[i]),
              jnp.asarray(Sp[i]), jnp.asarray(xp[i])) for i in idx]
    stack = lambda f: np.stack([np.asarray(getattr(r, f)) for r in rj])
    from ssqp_tpu.types import Result as JResult

    rj = JResult(*(stack(f) for f in ("x", "S", "status", "lam", "gamma")))
    sub = tb.Result(*(getattr(rt, f)[idx] for f in
                      ("x", "S", "status", "lam", "gamma")))
    assert (rj.status >= 1).all()
    assert_batch(rj, sub, np.asarray(Pj.c))
