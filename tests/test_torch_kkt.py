"""The port's KKT layer (ssqp_tpu_torch/ops/kkt.py, ops/masked_gj.py)
against the JAX package on random masked systems, instance by instance
(JAX vmapped, the port batch-first).

Tolerances (float64): solutions and multipliers 1e-9 — both sides solve the
same well-conditioned systems to rtol 1e-12, so they differ by summation
order only; masks and flags must be equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssqp_tpu.ops import kkt as jk
from ssqp_tpu.ops import masked_gj as jg
from ssqp_tpu_torch.ops import kkt as tk
from ssqp_tpu_torch.ops import masked_gj as tg

B, N, M, J = 6, 16, 1, 2
R = M + J


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(21)
    H = rng.standard_normal((N, N))
    V = H @ H.T / N + 0.5 * np.eye(N)
    AG = np.vstack([np.ones((M, N)), rng.standard_normal((J, N))])
    bg = np.r_[np.ones(M), rng.uniform(0.5, 1.0, J)]
    q = rng.standard_normal((B, N))
    z = rng.uniform(0.0, 0.2, (B, N))
    free = rng.uniform(size=(B, N)) < 0.7
    keep = np.c_[np.ones((B, M), bool), rng.uniform(size=(B, J)) < 0.6]
    return V, AG, bg, q, z, free, keep


def _t(*arrs):
    return [torch.tensor(a) for a in arrs]


def _close(a, b, tol=1e-9):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


def test_kkt_solve_cg_matches_jax(system):
    V, AG, bg, q, z, free, keep = system
    x0 = np.random.default_rng(3).standard_normal((B, N, 1 + R)) * 0.1
    f = jax.vmap(lambda q_, z_, f_, k_, x_: jk.kkt_solve_cg(
        jnp.asarray(V), q_, jnp.asarray(AG), jnp.asarray(bg), z_, f_, k_,
        200, 1e-12, ok_rtol=1e-8, ridge=1e-10, x0=x_, return_sol=True))
    rj, solj = f(jnp.asarray(q), jnp.asarray(z), jnp.asarray(free),
                 jnp.asarray(keep), jnp.asarray(x0))
    Vt, AGt, bgt, qt, zt, ft, kt, x0t = _t(V, AG, bg, q, z, free, keep, x0)
    rt, solt = tk.kkt_solve_cg(Vt, qt, AGt, bgt, zt, ft, kt, 200, 1e-12,
                               ok_rtol=1e-8, ridge=1e-10, x0=x0t,
                               return_sol=True)
    for name in ("alpha", "p", "alphaL", "gamma"):
        _close(getattr(rt, name), getattr(rj, name))
    _close(solt, solj)
    np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(rj.ok))
    assert rt.ok.all()


def test_kkt_solve_cg_no_rows(system):
    V, AG, bg, q, z, free, keep = system
    f = jax.vmap(lambda q_, z_, f_: jk.kkt_solve_cg(
        jnp.asarray(V), q_, jnp.zeros((0, N)), jnp.zeros((0,)), z_, f_,
        jnp.zeros((0,), bool), 200, 1e-12))
    rj = f(jnp.asarray(q), jnp.asarray(z), jnp.asarray(free))
    Vt, qt, zt, ft = _t(V, q, z, free)
    rt = tk.kkt_solve_cg(Vt, qt, torch.zeros((0, N), dtype=torch.float64),
                         torch.zeros(0, dtype=torch.float64), zt, ft,
                         torch.zeros((B, 0), dtype=torch.bool), 200, 1e-12)
    for name in ("alpha", "p", "gamma"):
        _close(getattr(rt, name), getattr(rj, name))
    assert rt.alphaL.shape == (B, 0)


def test_kkt_allfree_shared_matches_jax(system):
    V, AG, bg, q, _, _, _ = system
    W = np.linalg.inv(V)
    keep0 = np.r_[np.ones(M, bool), np.zeros(J, bool)]
    f = jax.vmap(lambda q_: jk.kkt_allfree_shared(
        jnp.asarray(V), jnp.asarray(W), q_, jnp.asarray(AG), jnp.asarray(bg),
        jnp.asarray(keep0), 1e-12))
    rj, solj = f(jnp.asarray(q))
    Vt, Wt, qt, AGt, bgt, kt = _t(V, W, q, AG, bg, keep0)
    rt, solt = tk.kkt_allfree_shared(Vt, Wt, qt, AGt, bgt, kt, 1e-12)
    for name in ("alpha", "alphaL", "gamma"):
        _close(getattr(rt, name), getattr(rj, name))
    _close(solt, solj)
    assert rt.ok.all()


def test_kkt_solve_direct_matches_jax(system):
    V, AG, bg, q, z, free, keep = system
    f = jax.vmap(lambda q_, z_, f_, k_: jk.kkt_solve(
        jnp.asarray(V), q_, jnp.asarray(AG), jnp.asarray(bg), z_, f_, k_))
    rj = f(jnp.asarray(q), jnp.asarray(z), jnp.asarray(free),
           jnp.asarray(keep))
    Vt, AGt, bgt, qt, zt, ft, kt = _t(V, AG, bg, q, z, free, keep)
    rt = tk.kkt_solve(Vt, qt, AGt, bgt, zt, ft, kt)
    for name in ("alpha", "p", "alphaL", "gamma"):
        _close(getattr(rt, name), getattr(rj, name))
    np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(rj.ok))


def test_recover_duals_and_dropped_multipliers_match_jax(system):
    V, AG, bg, q, z, free, keep = system
    act = keep | (np.random.default_rng(5).uniform(size=keep.shape) < 0.3)
    f = jax.vmap(lambda q_, z_, f_, a_: jk.recover_duals(
        jnp.asarray(V), q_, jnp.asarray(AG), z_, f_, a_))
    yj, gj = f(jnp.asarray(q), jnp.asarray(z), jnp.asarray(free),
               jnp.asarray(act))
    Vt, AGt, qt, zt, ft, at, kt = _t(V, AG, q, z, free, act, keep)
    yt, gt = tk.recover_duals(Vt, qt, AGt, zt, ft, at)
    _close(yt, yj)
    _close(gt, gj)
    alphaL = np.random.default_rng(6).standard_normal((B, R))
    f2 = jax.vmap(lambda f_, k_, a_, l_: jk.recover_dropped_multipliers(
        jnp.asarray(AG), f_, k_, a_, l_, M))
    dj = f2(jnp.asarray(free), jnp.asarray(keep), jnp.asarray(act),
            jnp.asarray(alphaL))
    dt = tk.recover_dropped_multipliers(AGt, ft, kt, at, torch.tensor(alphaL),
                                        M)
    _close(dt, dj)


def _purge_cases():
    rng = np.random.default_rng(8)
    Bn, Rr, C = 5, 4, 6
    A = rng.standard_normal((Bn, Rr, C))
    b = rng.standard_normal((Bn, Rr))
    A[:, 2] = 2.0 * A[:, 0] - A[:, 1]  # dependent row ...
    b[:3, 2] = 2.0 * b[:3, 0] - b[:3, 1]  # ... consistent on 0..2
    b[3:, 2] += 1.0  # ... inconsistent on 3..4
    A[1, 3], b[1, 3] = 0.0, 0.0  # a zero row (consistent)
    mask = rng.uniform(size=(Bn, Rr)) < 0.85
    mask[:, :3] = True
    return A, b, mask


@pytest.mark.parametrize("flavor", ["masked_gj_purge", "masked_gj_purge_col"])
def test_masked_purge_matches_jax(flavor):
    A, b, mask = _purge_cases()
    tol = 1e-9
    kj, ij, bj = jax.vmap(lambda a, bb, m: getattr(jg, flavor)(a, bb, m, tol))(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(mask))
    kt, it, bt = getattr(tg, flavor)(*_t(A, b, mask), tol)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    assert it.numpy()[3:].all() and not it.numpy()[:3].any()


def test_select_purge_dispatch():
    for pivot, R in (("row", 3), ("row", 15), ("row", 16), ("row", 110),
                     ("col", 40)):
        j, t = jg.select_purge(pivot, R), tg.select_purge(pivot, R)
        assert t is getattr(tg, j.__name__), (pivot, R)
    assert tg.select_purge("row", 16) is tg.masked_purge_qr


def _qr_purge_cases(R, dtype):
    """(B, R, C) stacks with C = 20 columns: dependent rows (consistent and
    inconsistent right-hand sides), a zero row, masked-out rows, and at
    R = 24 more rows than columns (rank-deficient by shape)."""
    rng = np.random.default_rng(R)
    Bn, C = 5, 20
    A = rng.standard_normal((Bn, R, C))
    b = rng.standard_normal((Bn, R))
    A[:, 6] = 2.0 * A[:, 0] - A[:, 3]
    b[:3, 6] = 2.0 * b[:3, 0] - b[:3, 3]
    b[3:, 6] += 0.5
    A[:, 9], b[:, 9] = 0.0, 0.0
    A[1, 11] = A[1, 2]
    b[1, 11] = b[1, 2]
    mask = rng.uniform(size=(Bn, R)) < 0.8
    mask[:, [0, 3, 6, 9]] = True
    return A.astype(dtype), b.astype(dtype), mask


@pytest.mark.parametrize("R", [16, 24])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_masked_purge_qr_matches_jax(R, dtype):
    """keep, inconsistent and bad_rows equal to the JAX package's under
    vmap (tol at the solver's tier: 2^-26 float64, 2^-16 float32)."""
    A, b, mask = _qr_purge_cases(R, dtype)
    tol = 2.0**-26 if dtype == np.float64 else 2.0**-16
    kj, ij, bj = jax.jit(jax.vmap(
        lambda a, bb, m: jg.masked_purge_qr(a, bb, m, tol)))(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(mask))
    kt, it, bt = tg.masked_purge_qr(*_t(A, b, mask), tol)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    # at R = 24 > C the rows past rank 20 are dropped with random b
    assert it.numpy()[3:].all() and it.numpy()[:3].any() == (R > 20)
    assert not kt.numpy()[:, 9].any()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_kkt_solve_rhs_cg_matches_jax(system, dtype):
    """dx, dl and the raw CG solution: float64 within 1e-9; float32 within
    2e-4 (rtol 1e-7 CG in float32 on both sides, other summation orders)."""
    V, AG, bg, q, z, free, keep = system
    rng = np.random.default_rng(13)
    r1, r2 = rng.standard_normal((B, N)), rng.standard_normal((B, R))
    x0 = rng.standard_normal((B, N, 1 + R)) * 0.1
    c = lambda a: a.astype(dtype)
    rtol = 1e-12 if dtype == np.float64 else 1e-7
    f = jax.jit(jax.vmap(lambda f_, k_, a_, b_, x_: jk.kkt_solve_rhs_cg(
        jnp.asarray(c(V)), jnp.asarray(c(AG)), f_, k_, a_, b_, 200, rtol,
        ok_rtol=1e-3, ridge=1e-10, x0=x_, return_sol=True)))
    dxj, dlj, okj, solj = f(jnp.asarray(free), jnp.asarray(keep),
                            jnp.asarray(c(r1)), jnp.asarray(c(r2)),
                            jnp.asarray(c(x0)))
    dxt, dlt, okt, solt = tk.kkt_solve_rhs_cg(
        *_t(c(V), c(AG), free, keep, c(r1), c(r2)), 200, rtol, ok_rtol=1e-3,
        ridge=1e-10, x0=torch.tensor(c(x0)), return_sol=True)
    tol = 1e-9 if dtype == np.float64 else 2e-4
    for a, b_ in ((dxt, dxj), (dlt, dlj), (solt, solj)):
        assert a.dtype == torch.from_numpy(c(r1)).dtype
        _close(a, b_, tol)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert okt.all()


def test_spd_solve_cpu_matches_numpy_and_flags_failure():
    rng = np.random.default_rng(9)
    H = rng.standard_normal((3, 20, 20))
    A = H @ H.transpose(0, 2, 1) + np.eye(20)
    rhs = rng.standard_normal((3, 20))
    for dt in (torch.float32, torch.float64):
        X = tk.spd_solve(torch.tensor(A, dtype=dt), torch.tensor(rhs, dtype=dt))
        ref = np.linalg.solve(A, rhs[..., None])[..., 0]
        tol = 1e-3 if dt == torch.float32 else 1e-10
        np.testing.assert_allclose(X.numpy(), ref, rtol=tol, atol=tol)
    A[1] = -np.eye(20)  # not PD: NaN like XLA's Cholesky
    X = tk.spd_solve(torch.tensor(A), torch.tensor(rhs))
    assert torch.isnan(X[1]).all() and torch.isfinite(X[[0, 2]]).all()
