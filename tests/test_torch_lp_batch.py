"""The port's LP batch protocols (ssqp_tpu_torch/parallel/batch.py): the plain
two-phase batch, the warm waves of c-parametric grids and the routing of
solve_lp_batch_auto, against the JAX package on the CPU.

Problems (bench_suite.py::config2's generators, cut in width):
  * a mixed batch (c, b, g per instance; A, G, d, u shared) at N=32, M=4,
    J=12, so R = M + J = 16 and the float32 dual recovery takes the
    Cholesky kernel's route (its plain version on the CPU), B = 16;
  * tests/test_lp.py's c-grid (N=24, M=3, J=6, 0 <= x <= 2, c = c0 + t dc
    on a sorted grid of B = 32), maximized, through waves=8;
  * the JAX package's own wave edge cases (an infeasible family, an
    unbounded slot).

Tolerances: float64, status equal on every instance, S equal and x within
1e-9 where the status is 1, objective within 1e-9 max(1, |f|), lam and
gamma within 1e-8; float32, status equal and objective within 5e-5
max(1, |f|), lam and gamma within 1e-3 max(1, |.|) (two Cholesky
factorizations of the same float32 normal equations).
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssqp_tpu import Settings as JSettings
from ssqp_tpu import make_lp as jmake_lp
from ssqp_tpu.parallel import batch as jb
from ssqp_tpu_torch import LP
from ssqp_tpu_torch import Settings as TSettings
from ssqp_tpu_torch.ops import chol
from ssqp_tpu_torch.parallel import batch as tb

FIELDS = ("c", "A", "b", "G", "g", "d", "u")


def port(P):
    return LP.from_numpy(*(np.asarray(getattr(P, f)) for f in FIELDS),
                         P.N, P.M, P.J, P.mc, device="cpu")


def objective(P, r):
    c = np.broadcast_to(np.asarray(P.c, np.float64), np.shape(r.x))
    return (c * np.asarray(r.x, np.float64)).sum(1)


def assert_batch(Pj, rj, rt, dtype=np.float64):
    sj, st = np.asarray(rj.status), rt.status.numpy()
    np.testing.assert_array_equal(st, sj)
    fj, ft = objective(Pj, rj), objective(Pj, rt.numpy())
    tol = 1e-9 if dtype == np.float64 else 5e-5
    assert (np.abs(ft - fj) <= tol * np.maximum(1.0, np.abs(fj))).all()
    lj, lt = np.asarray(rj.lam, np.float64), rt.lam.double().numpy()
    gj, gt = np.asarray(rj.gamma, np.float64), rt.gamma.double().numpy()
    if dtype == np.float64:
        u = sj == 1
        np.testing.assert_array_equal(rt.S.numpy()[u], np.asarray(rj.S)[u])
        np.testing.assert_allclose(rt.x.numpy()[u], np.asarray(rj.x)[u],
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-8)
        np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-8)
    else:
        assert (np.abs(lt - lj) <= 1e-3 * np.maximum(1.0, np.abs(lj))).all()
        assert (np.abs(gt - gj) <= 1e-3 * np.maximum(1.0, np.abs(gj))).all()


def mixed_batch(dtype, N=32, M=4, J=12, B=16, seed=99):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, N))
    G = rng.standard_normal((J, N))
    rl = np.random.default_rng(seed + 1)
    X0 = rl.uniform(0.1, 1.0, (B, N))
    c = rl.standard_normal((B, N))
    b = X0 @ A.T
    g = X0 @ G.T + rl.uniform(0.1, 1.0, (B, J))
    P = jmake_lp(c[0], A, b[0], G=G, g=g[0], d=np.zeros(N),
                 u=np.full(N, 2.0), dtype=dtype)
    return dataclasses.replace(P, c=jnp.asarray(c, dtype),
                               b=jnp.asarray(b, dtype),
                               g=jnp.asarray(g, dtype)), ("A", "G", "d", "u")


def c_grid(N=24, M=3, J=6, B=32, seed=4):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, N))
    x0 = rng.uniform(0.1, 1.0, N)
    G = rng.standard_normal((J, N))
    g = G @ x0 + rng.uniform(0.1, 1.0, J)
    c0 = rng.standard_normal(N)
    dc = rng.standard_normal(N) * 0.5
    C = c0[None, :] + np.linspace(0.0, 1.0, B)[:, None] * dc[None, :]
    P = jmake_lp(c0, A, A @ x0, G=G, g=g, d=np.zeros(N), u=np.full(N, 2.0))
    return dataclasses.replace(P, c=jnp.asarray(C)), \
        ("A", "b", "G", "g", "d", "u")


def test_plain_batch_float32_at_16_rows_matches_jax():
    """Every instance's own Phase-1 and Phase-2 in float32; the dual
    recovery's (16, 16) normal equations go through ops/kkt.py::spd_solve
    to the Cholesky kernel's route (its plain version here)."""
    Pj, sh = mixed_batch(np.float32)
    s32 = TSettings.for_dtype(torch.float32)
    seen = []
    real = chol.chol_solve_reference

    def spy(A, R):
        seen.append(tuple(R.shape))
        return real(A, R)

    with mock.patch.object(chol, "chol_solve_reference", spy):
        rt = tb.solve_lp_batch(port(Pj), s32, sh)
    assert seen == [(16, 16, 1)]
    rj = jb.solve_lp_batch(Pj, JSettings.for_dtype(jnp.float32), sh)
    assert np.isin(np.asarray(rj.status), (1, 2)).all()
    assert_batch(Pj, rj, rt, np.float32)


def test_waves_maximize_matches_jax_and_plain():
    """waves=8 on the maximized c-grid: the shared Phase-1, each wave from
    the previous wave's same slot, the strided merge; instance for
    instance as the JAX package's waves, and the same optima as the port's
    plain batch."""
    Pj, sh = c_grid()
    Pt = port(Pj)
    rj = jb.solve_lp_batch_waves(Pj, JSettings(), sh, waves=8,
                                 minimize=False)
    rt = tb.solve_lp_batch_waves(Pt, TSettings(), sh, waves=8,
                                 minimize=False)
    assert (np.asarray(rj.status) >= 1).all()
    assert_batch(Pj, rj, rt)
    rp = tb.solve_lp_batch(Pt, TSettings(), sh, minimize=False)
    assert_batch(Pj, rp.numpy(), rt)


def test_waves_edge_cases():
    """The JAX package's wave edge cases (tests/test_lp.py): an infeasible
    constraint set marks every grid point 0 (Phase-1 is shared); an
    unbounded cost direction comes back 3 and does not poison its
    warm-started neighbours (its wave's carry keeps the last optimum)."""
    N, B = 8, 16
    rng = np.random.default_rng(1)
    C = rng.standard_normal((B, N))
    sh = ("A", "b", "G", "g", "d", "u")
    P = jmake_lp(C[0], np.ones((2, N)), np.array([1.0, 5.0]), d=np.zeros(N),
                 u=np.ones(N))
    Pt = port(dataclasses.replace(P, c=jnp.asarray(C)))
    r = tb.solve_lp_batch_waves(Pt, TSettings(), sh, waves=4)
    assert (r.status == 0).all()
    N = 4
    C = np.tile(np.ones(N), (B, 1))
    C[5] = np.array([-1.0, 0.0, 1.0, 1.0])  # the ray (1, 1, 0, 0) improves
    P = jmake_lp(C[0], np.zeros((0, N)), np.zeros(0),
                 G=np.array([[1.0, -1.0, 0.0, 0.0]]), g=np.array([1.0]),
                 d=np.zeros(N), u=np.full(N, np.inf))
    Pt = port(dataclasses.replace(P, c=jnp.asarray(C)))
    st = tb.solve_lp_batch_waves(Pt, TSettings(), sh, waves=4).status
    assert int(st[5]) == 3
    ok = np.delete(st.numpy(), 5)
    assert (ok >= 1).all() and (ok != 3).all()


def test_auto_rule_matches_jax():
    """solve_lp_batch_auto picks the protocol the JAX package's rule picks,
    with the same waves, on each branch: a c-grid (waves=8), an rhs grid
    over b alone and over b and g (dual waves=8), a mixed batch (plain),
    waves=0 (plain), a width of 24 (24/8 < 4: plain), and an explicit
    waves=4."""
    P = jmake_lp(np.zeros(4), np.ones((1, 4)), np.ones(1), G=np.ones((1, 4)),
                 g=np.ones(1), d=np.zeros(4), u=np.ones(4))
    rep = lambda **k: dataclasses.replace(P, **k)
    calls = [
        (rep(c=jnp.zeros((32, 4))), ("A", "b", "G", "g", "d", "u"), {}),
        (rep(b=jnp.ones((32, 1))), ("c", "A", "G", "g", "d", "u"), {}),
        (rep(b=jnp.ones((32, 1)), g=jnp.ones((32, 1))),
         ("c", "A", "G", "d", "u"), {}),
        (rep(c=jnp.zeros((32, 4)), b=jnp.ones((32, 1))),
         ("A", "G", "g", "d", "u"), {}),
        (rep(c=jnp.zeros((32, 4))), ("A", "b", "G", "g", "d", "u"),
         dict(waves=0)),
        (rep(c=jnp.zeros((24, 4))), ("A", "b", "G", "g", "d", "u"), {}),
        (rep(b=jnp.ones((32, 1))), ("c", "A", "G", "g", "d", "u"),
         dict(waves=4)),
    ]

    def routes(mod, conv, settings):
        seen = []
        rec = lambda name: (lambda *a, **k: seen.append(
            (name, k.get("waves"))))
        with mock.patch.object(mod, "solve_lp_batch_waves",
                               rec("waves")), \
                mock.patch.object(mod, "solve_lp_batch_waves_rhs",
                                  rec("waves_rhs")), \
                mock.patch.object(mod, "solve_lp_batch", rec("plain")):
            for Pb, sh, kw in calls:
                mod.solve_lp_batch_auto(conv(Pb), settings, sh, **kw)
        return seen

    sj = routes(jb, lambda p: p, JSettings())
    st = routes(tb, port, TSettings())
    assert st == sj
    assert [r[0] for r in st] == ["waves", "waves_rhs", "waves_rhs", "plain",
                                  "plain", "plain", "waves_rhs"]


def test_shared_fields_are_checked():
    """A leaf named shared but batched (or the reverse) is refused, as the
    QP protocols refuse it; the grid protocols refuse a family whose
    structure they cannot use."""
    Pj, sh = c_grid(B=8)
    Pt = port(Pj)
    with pytest.raises(ValueError, match="'c' is batched"):
        tb.solve_lp_batch(Pt, TSettings(), ("c",) + sh)
    with pytest.raises(ValueError, match="'b' is unbatched"):
        tb.solve_lp_batch(Pt, TSettings(), ("A", "G", "g", "d", "u"))
    with pytest.raises(ValueError, match="rhs-only"):
        tb.solve_lp_batch_waves_rhs(Pt, TSettings(), sh, waves=4)
    with pytest.raises(ValueError, match="must divide"):
        tb.solve_lp_batch_waves(Pt, TSettings(), sh, waves=3)
