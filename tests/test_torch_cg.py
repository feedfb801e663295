"""The port's fused CG (ssqp_tpu_torch/ops/cg.py and kkt.cg_solve_padded)
against the JAX package: the XLA loop ``_vp_cg_xla`` and the Pallas kernel
``cg_padded_batch`` run in interpret mode, as tests/test_pallas_cg.py runs it.

On the CPU the port runs the kernel's plain PyTorch version, so these tests
hold that version to the reference; the CUDA kernel itself is held to the
plain version on the card (tests/test_torch_cuda.py and chip_smoke.py).

Tolerances on X: float64 1e-9 (both sides converge to the same residual;
the difference is summation order), float32 5e-4 (tests/test_pallas_cg.py's
bound: the two float32 loops may stop one step apart at rtol 1e-5)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssqp_tpu.ops.kkt import _vp_cg_xla
from ssqp_tpu.ops.kkt import cg_solve_padded as jax_cg_solve_padded
from ssqp_tpu.ops.pallas_cg import cg_padded_batch as pallas_cg_padded_batch
from ssqp_tpu_torch.ops import cg
from ssqp_tpu_torch.ops.kkt import _vp_apply, cg_solve_padded

TOL = {np.float32: 5e-4, np.float64: 1e-9}


def _problem(seed, N, K, batch, dtype, per_instance=False, rtol=1e-5):
    rng = np.random.default_rng(seed)

    def spd():
        H = rng.standard_normal((N, N))
        return H @ H.T / N + 0.5 * np.eye(N)

    V = np.stack([spd() for _ in range(batch)]) if per_instance else spd()
    FM = (rng.uniform(size=(batch, N)) < 0.7).astype(np.float64)
    DINV = 1.0 / (FM * np.diagonal(V, axis1=-2, axis2=-1) + (1.0 - FM))
    B = rng.standard_normal((batch, N, K))
    TOL2 = rtol * rtol * np.maximum((B * B).sum(1), 1e-30)
    return [a.astype(dtype) for a in (V, FM, B, DINV, TOL2)]


def _xla(V, FM, B, DINV, TOL2, iters, X0, per_instance):
    f = jax.vmap(_vp_cg_xla, in_axes=(0 if per_instance else None, 0, 0, 0,
                                      0, None, 0))
    X, rr = f(jnp.asarray(V), jnp.asarray(FM), jnp.asarray(B),
              jnp.asarray(DINV), jnp.asarray(TOL2),
              jnp.asarray(iters, jnp.int32), jnp.asarray(X0))
    return np.asarray(X), np.asarray(rr)


def _port(V, FM, B, DINV, TOL2, iters, X0):
    X, rr = cg.cg_padded_batch(*(torch.tensor(a) for a in (V, FM, B, DINV,
                                                           TOL2)),
                               iters, torch.tensor(X0))
    return X.numpy(), rr.numpy()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("per_instance", [False, True])
def test_cold_matches_xla(dtype, per_instance):
    rtol = 1e-5 if dtype == np.float32 else 1e-12
    V, FM, B, DINV, TOL2 = _problem(1, 24, 3, 4, dtype, per_instance, rtol)
    X0 = np.zeros_like(B)
    Xj, rrj = _xla(V, FM, B, DINV, TOL2, 200, X0, per_instance)
    Xt, rrt = _port(V, FM, B, DINV, TOL2, 200, X0)
    np.testing.assert_allclose(Xt, Xj, rtol=0, atol=TOL[dtype])
    assert (rrt <= TOL2 * 1.01).all() and (rrj <= TOL2 * 1.01).all()


@pytest.mark.parametrize("N,K,batch", [(13, 3, 5), (40, 2, 3)])
def test_matches_pallas_interpret(N, K, batch):
    """f32 shared-V batches, odd shapes included (the Pallas kernel pads N
    to 128 lanes; the port takes any N as it is)."""
    V, FM, B, DINV, TOL2 = _problem(N + K, N, K, batch, np.float32)
    X0 = np.zeros_like(B)
    Xp, rrp = pallas_cg_padded_batch(
        jnp.asarray(V), jnp.asarray(FM), jnp.asarray(B), jnp.asarray(DINV),
        jnp.asarray(TOL2), jnp.asarray(300, jnp.int32), jnp.asarray(X0),
        interpret=True)
    Xt, rrt = _port(V, FM, B, DINV, TOL2, 300, X0)
    np.testing.assert_allclose(Xt, np.asarray(Xp), rtol=0, atol=5e-4)
    assert (rrt <= TOL2 * 1.01).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_warm_start_converged_rows_frozen(dtype):
    """A system whose warm start already solves it never moves."""
    V, FM, B, DINV, TOL2 = _problem(3, 16, 2, 3, dtype)
    Vp = [np.outer(f, f) * V + np.diag(1.0 - f) for f in FM.astype(np.float64)]
    X0 = np.stack([np.linalg.solve(vp, b) for vp, b in
                   zip(Vp, B.astype(np.float64))]).astype(dtype)
    Xt, rrt = _port(V, FM, B, DINV, TOL2 * 1e4, 100, X0)
    Xj, _ = _xla(V, FM, B, DINV, TOL2 * 1e4, 100, X0, False)
    np.testing.assert_array_equal(Xt, X0)
    np.testing.assert_array_equal(Xj, X0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("iters", [3, 11])
def test_iteration_cap_unconverged_rows_agree(dtype, iters):
    """With the cap hit (tol2 = 0: no row converges) both run exactly
    ``iters`` steps — 11 checks the chunk clamp at a non-multiple of 8.
    Unconverged iterates agree to summation order: f64 1e-10, f32 1e-4."""
    V, FM, B, DINV, TOL2 = _problem(5, 20, 2, 3, dtype)
    X0 = np.zeros_like(B)
    zero = np.zeros_like(TOL2)
    Xj, rrj = _xla(V, FM, B, DINV, zero, iters, X0, False)
    Xt, rrt = _port(V, FM, B, DINV, zero, iters, X0)
    tol = 1e-10 if dtype == np.float64 else 1e-4
    np.testing.assert_allclose(Xt, Xj, rtol=0, atol=tol)
    # f32 residual entries of ~3e-5 carry ~1e-7 rounding, so their squared
    # sum agrees to ~1e-2 relative; f64 to 1e-8
    np.testing.assert_allclose(rrt, rrj, rtol=2e-2 if dtype == np.float32
                               else 1e-8)
    # the cap is honoured exactly: one step fewer lands farther away
    Xs, _ = _port(V, FM, B, DINV, zero, iters - 1, X0)
    assert np.abs(Xs - Xj).max() > 10 * np.abs(Xt - Xj).max()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cg_solve_padded_zero_rhs_restart(dtype):
    """A zero right-hand-side column restarts at 0 from a stale warm start
    (kkt.py's live mask), and the relative residuals match the JAX wrapper."""
    V, FM, B, _, _ = _problem(7, 16, 3, 2, dtype)
    B[:, :, 1] = 0.0
    X0 = np.random.default_rng(8).standard_normal(B.shape).astype(dtype)
    rtol = 1e-6 if dtype == np.float32 else 1e-12
    f = jax.vmap(lambda fm, b, x0: jax_cg_solve_padded(
        jnp.asarray(V), fm, b, 200, rtol, X0=x0))
    Xj, relj = f(jnp.asarray(FM), jnp.asarray(B), jnp.asarray(X0))
    Xt, relt = cg_solve_padded(torch.tensor(V), torch.tensor(FM),
                               torch.tensor(B), 200, rtol,
                               X0=torch.tensor(X0))
    assert (Xt[:, :, 1] == 0).all()
    res = _vp_apply(torch.tensor(V), torch.tensor(FM), Xt) - torch.tensor(B)
    bn = torch.linalg.vector_norm(torch.tensor(B), dim=1)
    assert (torch.linalg.vector_norm(res, dim=1) <= 1.01 * rtol * bn + 1e-30).all()
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=0,
                               atol=TOL[dtype])
    assert (relt.numpy() <= rtol * 1.01).all()
    assert (np.asarray(relj) <= rtol * 1.01).all()


def test_cpu_tensors_never_launch_the_kernel():
    before = cg.LAUNCHES
    V, FM, B, DINV, TOL2 = _problem(9, 8, 2, 2, np.float64)
    _port(V, FM, B, DINV, TOL2, 50, np.zeros_like(B))
    assert cg.LAUNCHES == before == 0


def test_wrapper_refuses_devices_it_has_no_version_for():
    """Only CPU (plain version) and CUDA (kernel) tensors are taken."""
    dev = torch.device("meta")
    X = torch.empty((4, 8), device=dev)
    with pytest.raises(ValueError):
        cg.cg_padded_rows(torch.empty((8, 8), device=dev), X, X, X,
                          torch.empty((4, 1), device=dev), 10, X)

