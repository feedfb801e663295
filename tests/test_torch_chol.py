"""The port's batched Cholesky factor-and-solve (ssqp_tpu_torch/ops/chol.py)
and the SPD-solve dispatch of ops/kkt.py, against the JAX package on the CPU.

References:
  * ``jax.vmap(ssqp_tpu.ops.kkt._spd_solve_xla)``, the JAX package's CPU
    branch of the batched SPD solve;
  * the Pallas kernel body itself (``_chol_solve_kernel``), run through
    ``pl.pallas_call(..., interpret=True)`` with the JAX package's own
    BlockSpecs, at n = 16 and 32.

Tolerances: SPD batches are generated with condition number KAPPA = 100.
float32 solutions agree to 1e-6 * KAPPA = 1e-4 relative to max|X| (the
recurrence runs in float32 on both sides, in other summation orders);
float64 to 1e-10 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ssqp_tpu.ops import kkt as jk
from ssqp_tpu.ops.pallas_chol import _chol_solve_kernel
from ssqp_tpu_torch.ops import chol
from ssqp_tpu_torch.ops import kkt as tk

KAPPA = 100.0
RTOL = {np.float32: 1e-6 * KAPPA, np.float64: 1e-10}


def _spd(rng, B, n, kappa=KAPPA):
    """SPD batch with eigenvalues log-spaced in [1, kappa]."""
    Qm, _ = np.linalg.qr(rng.standard_normal((B, n, n)))
    eig = np.logspace(0.0, np.log10(kappa), n)
    A = (Qm * eig) @ Qm.transpose(0, 2, 1)
    return (A + A.transpose(0, 2, 1)) / 2


_xla = jax.jit(jax.vmap(jk._spd_solve_xla))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [16, 37, 110])
@pytest.mark.parametrize("kcol", ["1", "3", "n"])
def test_reference_matches_jax_cpu_branch(dtype, n, kcol):
    rng = np.random.default_rng(n)
    K = n if kcol == "n" else int(kcol)
    A = _spd(rng, 3, n).astype(dtype)
    RHS = rng.standard_normal((3, n, K)).astype(dtype)
    Xj = np.asarray(_xla(jnp.asarray(A), jnp.asarray(RHS)))
    Xt = chol.chol_solve_reference(torch.tensor(A), torch.tensor(RHS))
    assert Xt.dtype == torch.from_numpy(A).dtype and Xt.shape == (3, n, K)
    scale = np.abs(Xj).max()
    np.testing.assert_allclose(Xt.numpy(), Xj, rtol=0,
                               atol=RTOL[dtype] * scale)


def _pallas_interpret(A, RHS, tile):
    """The JAX package's kernel body and BlockSpecs (pallas_chol.py:127-149),
    interpreted on the CPU."""
    B, n, _ = A.shape
    K = RHS.shape[2]
    spec = lambda shape: pl.BlockSpec(shape, lambda i: (i, 0, 0),
                                      memory_space=pltpu.VMEM)
    with jax.enable_x64(False):
        out = pl.pallas_call(
            _chol_solve_kernel,
            out_shape=jax.ShapeDtypeStruct((B, K, n), jnp.float32),
            grid=(B // tile,),
            in_specs=[spec((tile, n, n)), spec((tile, K, n))],
            out_specs=spec((tile, K, n)),
            scratch_shapes=[pltpu.VMEM((tile, n, n), jnp.float32),
                            pltpu.VMEM((tile, n, n), jnp.float32),
                            pltpu.VMEM((tile, K, n), jnp.float32)],
            interpret=True,
        )(jnp.asarray(A), jnp.asarray(RHS.transpose(0, 2, 1)))
    return np.asarray(out).transpose(0, 2, 1)


@pytest.mark.parametrize("n,K", [(16, 3), (32, 1)])
def test_reference_matches_pallas_kernel_interpreted(n, K):
    """Same recurrence as the TPU kernel: agreement to float32 roundoff,
    including on a matrix that is not exactly symmetric (both read the
    upper triangle only)."""
    rng = np.random.default_rng(n + K)
    A = _spd(rng, 4, n)
    A[1] += np.tril(1e-3 * rng.standard_normal((n, n)), -1)
    A = A.astype(np.float32)
    RHS = rng.standard_normal((4, n, K)).astype(np.float32)
    Xp = _pallas_interpret(A, RHS, tile=2)
    Xt = chol.chol_solve_reference(torch.tensor(A), torch.tensor(RHS)).numpy()
    np.testing.assert_allclose(Xt, Xp, rtol=0,
                               atol=RTOL[np.float32] * np.abs(Xp).max())


def test_reference_floors_the_pivot_on_non_pd_input():
    """No pivoting and no fault: a negative or zero pivot goes through the
    1e-30 floor and the result is not a solution (non-finite or with a large
    residual), as the TPU kernel's."""
    rng = np.random.default_rng(3)
    A = _spd(rng, 3, 20).astype(np.float32)
    A[0, 5, 5] = -1.0
    A[1, 7, :] = A[1, :, 7] = 0.0
    RHS = rng.standard_normal((3, 20, 2)).astype(np.float32)
    X = chol.chol_solve_reference(torch.tensor(A), torch.tensor(RHS)).numpy()
    Xp = _pallas_interpret(A[:2], RHS[:2], tile=1)
    for b in (0, 1):
        res = np.abs(A[b] @ X[b] - RHS[b]).max() if np.isfinite(X[b]).all() \
            else np.inf
        assert res > 1e-2
        assert np.isfinite(X[b]).all() == np.isfinite(Xp[b]).all()
    np.testing.assert_allclose(A[2] @ X[2], RHS[2], atol=1e-4)


def _schur_case(dtype):
    """kkt_solve_cg at R = 18 >= 16 rows: instances 0-3 are regular; 4 and 5
    keep two copies of one row with no ridge (singular Schur complement)."""
    rng = np.random.default_rng(12)
    B, N, M, J = 6, 24, 2, 16
    H = rng.standard_normal((N, N))
    V = H @ H.T / N + 0.5 * np.eye(N)
    AG = rng.standard_normal((M + J, N))
    AG[M + 3] = AG[M + 1]
    bg = rng.standard_normal(M + J)
    q = rng.standard_normal((B, N))
    z = rng.uniform(0.0, 0.5, (B, N))
    free = rng.uniform(size=(B, N)) < 0.9
    keep = np.c_[np.ones((B, M), bool), rng.uniform(size=(B, J)) < 0.5]
    keep[:4, M + 3] = False
    keep[4:, M + 1] = keep[4:, M + 3] = True
    cast = lambda a: a.astype(dtype) if a.dtype == np.float64 else a
    return [cast(a) for a in (V, q, AG, bg, z, free, keep)]


def test_kkt_solve_cg_rejects_singular_schur_like_jax():
    """The port's ok flag is False wherever the JAX package's is: the
    floored kernel recurrence (the float32 route at R >= 16; JAX's CPU
    branch gives NaN there) trips the finite and residual gates."""
    V, q, AG, bg, z, free, keep = _schur_case(np.float32)
    rj = jax.jit(jax.vmap(lambda q_, z_, f_, k_: jk.kkt_solve_cg(
        jnp.asarray(V), q_, jnp.asarray(AG), jnp.asarray(bg), z_, f_, k_,
        200, 1e-7, ok_rtol=1e-3)))(
        jnp.asarray(q), jnp.asarray(z), jnp.asarray(free), jnp.asarray(keep))
    rt = tk.kkt_solve_cg(*(torch.tensor(a) for a in (V, q, AG, bg, z, free,
                                                      keep)),
                         200, 1e-7, ok_rtol=1e-3)
    okj = np.asarray(rj.ok)
    np.testing.assert_array_equal(rt.ok.numpy(), okj)
    assert okj[:4].all() and not okj[4:].any()


def test_spd_solve_dispatch_on_cpu(monkeypatch):
    """float32 with n >= 16 takes the kernel route, which on a CPU tensor is
    the plain version and launches nothing; float64 or n < 16 take the
    library Cholesky."""
    seen = []
    real = chol.chol_solve_reference
    monkeypatch.setattr(chol, "chol_solve_reference",
                        lambda A, R: seen.append(A.shape[-1]) or real(A, R))
    rng = np.random.default_rng(2)
    before = chol.LAUNCHES
    for n, dtype, routed in ((16, torch.float32, True),
                             (40, torch.float32, True),
                             (15, torch.float32, False),
                             (40, torch.float64, False)):
        A = torch.tensor(_spd(rng, 2, n), dtype=dtype)
        rhs = torch.tensor(rng.standard_normal((2, n)), dtype=dtype)
        seen.clear()
        x = tk.spd_solve(A, rhs)
        assert x.shape == (2, n) and x.dtype == dtype
        assert seen == ([n] if routed else []), (n, dtype)
        ref = np.linalg.solve(A.double().numpy(),
                              rhs.double().numpy()[..., None])[..., 0]
        np.testing.assert_allclose(x.double().numpy(), ref, rtol=0,
                                   atol=1e-4 if dtype == torch.float32
                                   else 1e-12)
    assert chol.LAUNCHES == before


def test_wrapper_refuses_devices_it_has_no_version_for():
    A = torch.empty((2, 16, 16), device="meta")
    with pytest.raises(ValueError, match="only CPU or CUDA"):
        chol.chol_solve_batch(A, torch.empty((2, 16, 1), device="meta"))
