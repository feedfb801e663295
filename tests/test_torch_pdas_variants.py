"""The PDAS rounds' two inner-solve variants of the port
(ssqp_tpu_torch/ops/kkt.py: ``_vp_pcg``, ``_vp_cheb``,
``shared_jacobi_bounds``; ``Settings.pdas_pcg`` and ``Settings.pdas_cheb``
through solvers/ssqp.py) against the JAX package's on the CPU.

Tolerances: the spectral bounds within 1e-10 relative of JAX's (float64);
the Chebyshev and PCG iterates within 1e-8 of JAX's at the same iteration
counts (tests/test_kkt.py's N=48, K=4 problem, float64), and within 1e-10
instance for instance against the vmapped JAX loop; end to end on
tests/test_kkt.py's float32 frontier (N=32, B=48): status and S equal to
the JAX package's under the same flag, x within 5e-6 (that test's bar), and
S equal to the port's default run. Two JAX solver compiles (one per flag).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssqp_tpu.ops import kkt as jk
from ssqp_tpu.parallel import batch as jb
from ssqp_tpu.types import Settings as JSettings
from ssqp_tpu.types import make_qp as jmake_qp
from ssqp_tpu_torch import QP
from ssqp_tpu_torch import Settings as TSettings
from ssqp_tpu_torch.ops import kkt as tk
from ssqp_tpu_torch.parallel import batch as tb
from ssqp_tpu_torch.solvers import ssqp as ts

FIELDS = ("V", "A", "G", "q", "b", "g", "d", "u")
FLAGS = ("pdas_cheb", "pdas_pcg")


def problem(seed=0, N=48, K=4):
    """tests/test_kkt.py::TestChebyshevSolve's masked operator."""
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((N, N))
    V = H @ H.T / N + 0.5 * np.eye(N)
    fm = (rng.random(N) > 0.4).astype(np.float64)
    B = rng.standard_normal((N, K))
    return V, fm, B


def jacobi_spectrum(V):
    s = 1.0 / np.sqrt(np.diag(V))
    return np.linalg.eigvalsh(s[:, None] * V * s[None, :])


def t1(a):
    """numpy (or JAX) array -> a batch of one, float64 CPU tensor."""
    return torch.tensor(np.asarray(a)).unsqueeze(0)


@pytest.mark.parametrize("seed,inverse", [(s, False) for s in range(5)]
                         + [(2, True), (4, True)])
def test_bounds_match_jax_and_enclose_the_spectrum(seed, inverse):
    V, _, _ = problem(seed)
    W = np.linalg.inv(V) if inverse else None
    lo, hi = jk.shared_jacobi_bounds(
        jnp.asarray(V), None if W is None else jnp.asarray(W))
    tlo, thi = tk.shared_jacobi_bounds(
        torch.tensor(V), None if W is None else torch.tensor(W))
    assert tlo.shape == thi.shape == ()
    np.testing.assert_allclose(float(tlo), float(lo), rtol=1e-10)
    np.testing.assert_allclose(float(thi), float(hi), rtol=1e-10)
    ev = jacobi_spectrum(V)
    assert float(tlo) <= ev.min() + 1e-12
    assert float(thi) >= ev.max() - 1e-12
    assert float(tlo) <= 1.0 <= float(thi)


def test_nan_inverse_gives_no_valid_interval():
    """A failed factorization's NaN W gives a NaN lo in both packages (the
    clip keeps NaN), and the Chebyshev solve on it is rejected by the KKT
    solve's finite gate instead of passing as a solution."""
    V, fm, B = problem(1)
    Wn = np.full_like(V, np.nan)
    lo, hi = jk.shared_jacobi_bounds(jnp.asarray(V), jnp.asarray(Wn))
    tlo, thi = tk.shared_jacobi_bounds(torch.tensor(V), torch.tensor(Wn))
    assert np.isnan(float(lo)) and np.isnan(float(tlo))
    np.testing.assert_allclose(float(thi), float(hi), rtol=1e-10)
    Vt = torch.tensor(V)
    free = torch.tensor(fm > 0).unsqueeze(0)
    q = torch.tensor(B[:, 0]).unsqueeze(0)
    AG = torch.ones((1, V.shape[0]), dtype=torch.float64)
    res = tk.kkt_solve_cg(Vt, q, AG, torch.ones(1, dtype=torch.float64),
                          torch.zeros_like(q), free,
                          torch.ones((1, 1), dtype=torch.bool), 64, 1e-10,
                          cheb=(tlo, thi))
    assert not bool(res.ok[0])
    assert not bool(torch.isfinite(res.alpha).all())


@pytest.mark.parametrize("iters", [7, 40, 600])
@pytest.mark.parametrize("variant", ["cheb", "pcg"])
def test_inner_solve_matches_jax(variant, iters):
    """The same iterate as the JAX loop after ``iters`` iterations, early
    (7), mid-way (40) and converged (600); and the residual it returns is
    the returned iterate's."""
    V, fm, B = problem(1)
    Vj, fmj, Bj = jnp.asarray(V), jnp.asarray(fm), jnp.asarray(B)
    dinv = 1.0 / (fmj * jnp.diag(Vj) + (1.0 - fmj))
    tol2 = 1e-20 * jnp.sum(Bj * Bj, axis=0)
    X0 = jnp.zeros_like(Bj)
    it = jnp.asarray(iters, jnp.int32)
    Vt = torch.tensor(V)
    if variant == "cheb":
        lo, hi = jk.shared_jacobi_bounds(Vj)
        Xj, rrj = jk._vp_cheb_xla(Vj, fmj, Bj, dinv, lo, hi, tol2, it, X0)
        tlo, thi = tk.shared_jacobi_bounds(Vt)
        Xt, rrt = tk._vp_cheb(Vt, t1(fm), t1(B), t1(dinv), tlo, thi,
                              t1(tol2), iters, t1(X0))
    else:
        # a preconditioner that is not the exact inverse, so PCG iterates
        W = 0.9 * np.linalg.inv(V)
        Xj, rrj = jk._vp_pcg_xla(Vj, fmj, Bj, jnp.asarray(W), tol2, it, X0)
        Xt, rrt = tk._vp_pcg(Vt, t1(fm), t1(B), torch.tensor(W), t1(tol2),
                             iters, t1(X0))
    np.testing.assert_allclose(Xt[0].numpy(), np.asarray(Xj), rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(rrt[0].numpy(), np.asarray(rrj), rtol=1e-6,
                               atol=1e-18)
    f = torch.tensor(fm).unsqueeze(-1)
    R = torch.tensor(B) - (f * (Vt @ (Xt[0] * f)) + (1.0 - f) * Xt[0])
    np.testing.assert_allclose(rrt[0].numpy(), (R * R).sum(0).numpy(),
                               rtol=1e-6, atol=1e-18)


@pytest.mark.parametrize("variant", ["cheb", "pcg"])
def test_per_instance_stop_matches_vmapped_jax(variant):
    """Three instances on one shared V, the first with a loose tolerance so
    it stops well before the others: instance for instance the vmapped JAX
    loop's iterates, which a batch that ran the first instance on would
    miss."""
    V, _, _ = problem(2)
    N, K = V.shape[0], 3
    rng = np.random.default_rng(7)
    fm = (rng.random((3, N)) > 0.3).astype(np.float64)
    B = rng.standard_normal((3, N, K))
    rtol = np.array([1e-4, 1e-11, 1e-11])
    tol2 = (rtol[:, None] ** 2) * (B * B).sum(1)
    dinv = 1.0 / (fm * np.diag(V) + (1.0 - fm))
    X0 = np.zeros_like(B)
    Vt = torch.tensor(V)
    t = torch.tensor
    if variant == "cheb":
        lo, hi = jk.shared_jacobi_bounds(jnp.asarray(V))
        fn = lambda f, b, d, tl: jk._vp_cheb_xla(
            jnp.asarray(V), f, b, d, lo, hi, tl, jnp.asarray(300, jnp.int32),
            jnp.zeros_like(b))
        tlo, thi = tk.shared_jacobi_bounds(Vt)
        run = lambda tl: tk._vp_cheb(Vt, t(fm), t(B), t(dinv), tlo, thi,
                                     t(tl), 300, t(X0))
    else:
        W = 0.9 * np.linalg.inv(V)
        fn = lambda f, b, d, tl: jk._vp_pcg_xla(
            jnp.asarray(V), f, b, jnp.asarray(W), tl,
            jnp.asarray(300, jnp.int32), jnp.zeros_like(b))
        run = lambda tl: tk._vp_pcg(Vt, t(fm), t(B), t(W), t(tl), 300,
                                    t(X0))
    Xj, _ = jax.vmap(fn)(jnp.asarray(fm), jnp.asarray(B), jnp.asarray(dinv),
                         jnp.asarray(tol2))
    Xt, rrt = run(tol2)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=0,
                               atol=1e-10)
    assert bool((rrt <= t(tol2)).all())
    # had the first instance run on with the others, its iterate would
    # differ from the vmapped loop's by far more than the tolerance above
    tight = tol2.copy()
    tight[0] = tol2[1:].min()
    X_on, _ = run(tight)
    assert float((X_on[0] - Xt[0]).abs().max()) > 1e-7


def frontier():
    """(JAX batch, port batch, shared): tests/test_kkt.py's float32
    frontier at N=32, B=48."""
    rng = np.random.default_rng(3)
    N, Bn = 32, 48
    H = rng.standard_normal((N, N))
    V = (H @ H.T / N + 0.5 * np.eye(N)).astype(np.float32)
    mu = rng.uniform(0, 0.2, N).astype(np.float32)
    Q = jmake_qp(V, mu, u=np.full(N, 4.0 / N, np.float32), dtype=np.float32)
    lams = np.linspace(0.0, 2.0, Bn).astype(np.float32)
    Qb, shared = jb.frontier_batch(Q, jnp.asarray(lams))
    Qt = QP.from_numpy(*(np.asarray(getattr(Q, f)) for f in FIELDS),
                       Q.N, Q.M, Q.J, Q.mc, device="cpu")
    return Qb, tb.frontier_batch(Qt, torch.tensor(lams))[0], shared


@pytest.fixture(scope="module")
def runs():
    """JAX and port results under each flag (one JAX compile per flag),
    the port's default run, and which inner solves each port run called."""
    Qb, Qt, sh = frontier()
    s_j = JSettings.for_dtype(jnp.float32)
    s_t = TSettings.for_dtype(torch.float32)
    default = tb.solve_qp_batch(Qt, s_t, shared=sh).numpy()
    out = {}
    for flag in FLAGS:
        rj = jb.solve_qp_batch(Qb, dataclasses.replace(s_j, **{flag: True}),
                               shared=sh)
        calls = []
        real = {n: getattr(tk, n) for n in ("_vp_cheb", "_vp_pcg", "_vp_cg")}
        for n, fn in real.items():
            setattr(tk, n, lambda *a, _n=n, _f=fn: (calls.append(_n),
                                                   _f(*a))[1])
        try:
            rt = tb.solve_qp_batch(
                Qt, dataclasses.replace(s_t, **{flag: True}), shared=sh)
        finally:
            for n, fn in real.items():
                setattr(tk, n, fn)
        out[flag] = (jax.tree.map(np.asarray, rj), rt.numpy(), set(calls))
    return Qt, sh, default, out


@pytest.mark.parametrize("flag", FLAGS)
def test_flag_matches_jax_end_to_end(runs, flag):
    _, _, default, out = runs
    rj, rt, calls = out[flag]
    assert (rt.status > 0).all()
    np.testing.assert_array_equal(rt.status, rj.status)
    np.testing.assert_array_equal(rt.S, rj.S)
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=5e-6)
    # the JAX test's contract: the same statuses as the default rounds
    np.testing.assert_array_equal(rt.S, default.S)
    # the PDAS rounds ran the variant; the S-loop stays on Jacobi CG
    want = "_vp_cheb" if flag == "pdas_cheb" else "_vp_pcg"
    assert calls == {want, "_vp_cg"}


@pytest.mark.parametrize("flag", FLAGS)
def test_flag_through_every_entry_point(runs, flag):
    """solve_qp (one problem) and solve_qp_batch_auto take the flag and
    reach the default run's statuses."""
    from ssqp_tpu_torch.solvers.ssqp import solve_qp

    Qt, sh, default, _ = runs
    s = dataclasses.replace(TSettings.for_dtype(torch.float32),
                            **{flag: True})
    ra = tb.solve_qp_batch_auto(Qt, s, sh).numpy()
    np.testing.assert_array_equal(ra.S, default.S)
    assert (ra.status > 0).all()
    i = 17
    Q1 = dataclasses.replace(Qt, q=Qt.q[i])
    r1 = solve_qp(Q1, settings=s).numpy()
    assert r1.status > 0
    np.testing.assert_array_equal(r1.S, default.S[i])
    np.testing.assert_allclose(r1.x, default.x[i], rtol=0, atol=5e-6)


@pytest.mark.parametrize("flag", FLAGS)
def test_per_instance_V_runs_jacobi_rounds(runs, flag, monkeypatch):
    """A per-instance V turns pdas_precond off (settings_for_shared), so
    both variants fall back to Jacobi-CG rounds: the default's result."""
    Qt, _, _, _ = runs
    Q4 = dataclasses.replace(Qt.take(torch.arange(0, 48, 12)),
                             V=Qt.V.expand(4, *Qt.V.shape).clone())
    sh = tuple(f for f in FIELDS if not Q4.is_batched(f))
    s = TSettings.for_dtype(torch.float32)
    r0 = tb.solve_qp_batch(Q4, s, shared=sh).numpy()
    for n in ("_vp_cheb", "_vp_pcg"):
        monkeypatch.setattr(tk, n, None)  # calling either would fail
    r1 = tb.solve_qp_batch(Q4, dataclasses.replace(s, **{flag: True}),
                           shared=sh).numpy()
    np.testing.assert_array_equal(r1.status, r0.status)
    np.testing.assert_array_equal(r1.S, r0.S)
    np.testing.assert_array_equal(r1.x, r0.x)


def test_pdas_shared_W_returns_bounds_only_under_cheb():
    V, _, _ = problem(0)
    Vt = torch.tensor(V)
    W, cheb = ts._pdas_shared_W(Vt, TSettings())
    assert cheb is None
    np.testing.assert_allclose((W @ Vt).numpy(), np.eye(V.shape[0]),
                               atol=1e-9)
    W2, cheb = ts._pdas_shared_W(Vt, TSettings(pdas_cheb=True))
    lo, hi = tk.shared_jacobi_bounds(Vt, W2)
    assert float(cheb[0]) == float(lo) and float(cheb[1]) == float(hi)
