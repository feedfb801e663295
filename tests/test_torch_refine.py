"""The port's refinement layer (ssqp_tpu_torch/solvers/refine.py and
parallel/batch.py::batch_kkt_resid) against the JAX package, starting from
the JAX package's own searched result carried across (Result.from_numpy).

The class: a shared-V/A/G grid of general-inequality QPs with varying q, cut
from BASELINE config 4 (bench_suite.py::config4) to N=32, M=2, J=16, so that
R = M+J = 18 crosses the R >= 16 routes (QR purge, Cholesky kernel route).

Tolerances:
  * batch_kkt_resid: 1e-12 absolute (float64 on both sides, same inputs);
  * refine_result_cg x, lam, gamma: 1e-9 absolute from a float64 search
    (float64 corrections); from a float32 search, 5e-6 after the tail
    recipe's single sweep (one float32 CG correction on each side, whose own
    float32 error, ~1e-6 of x, is not yet corrected).

The searched results come from the JAX package's exact path (multi_free off:
Phase-1 simplex start, then the reference-semantics S-loop), which compiles
in about half the time of the default path; the default path is held
against the JAX package in tests/test_torch_tail.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssqp_tpu import Settings as JSettings
from ssqp_tpu import make_qp as jmake_qp
from ssqp_tpu.parallel import batch as jb
from ssqp_tpu.solvers import refine as jr
from ssqp_tpu.types import Result as JResult
from ssqp_tpu_torch import QP, Result
from ssqp_tpu_torch import Settings as TSettings
from ssqp_tpu_torch.parallel import batch as tb
from ssqp_tpu_torch.solvers import refine as tr

FIELDS = ("V", "A", "G", "q", "b", "g", "d", "u")
SHARED = ("V", "A", "G", "b", "g", "d", "u")
N, M, J, B = 32, 2, 16, 8


def ineq_class(dtype, N=N, M=M, J=J, B=B, seed=4):
    """config4's generator: V = HH'/N + 0.5 I, b = A x0, g = G x0 + U(0.1, 1),
    d = x0 - 2, u = x0 + 2; q ~ N(0, 1) per instance."""
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((N, N))
    V = H @ H.T / N + 0.5 * np.eye(N)
    A = rng.standard_normal((M, N))
    x0 = rng.uniform(0.0, 1.0, N)
    G = rng.standard_normal((J, N))
    g = G @ x0 + rng.uniform(0.1, 1.0, J)
    q = rng.standard_normal((B, N))
    Q = jmake_qp(V, np.zeros(N), A, A @ x0, G=G, g=g, d=x0 - 2.0, u=x0 + 2.0,
                 dtype=dtype)
    return dataclasses.replace(Q, q=jnp.asarray(q.astype(dtype)))


def port(Q):
    return QP.from_numpy(*(np.asarray(getattr(Q, f)) for f in FIELDS),
                         Q.N, Q.M, Q.J, Q.mc, device="cpu")


@pytest.fixture(scope="module")
def searched():
    """The JAX package's searched (duals attached) result per dtype."""
    out = {}
    for dtype in (np.float64, np.float32):
        Q = ineq_class(dtype)
        s = dataclasses.replace(JSettings.for_dtype(dtype), multi_free=False)
        rj = jb.solve_qp_batch(Q, s, shared=SHARED)
        rj = jax.tree.map(np.asarray, rj)
        rt = Result.from_numpy(rj.x, rj.S, rj.status, rj.lam, rj.gamma,
                               device="cpu")
        assert (rj.status > 0).all()
        out[dtype] = (Q, rj, rt)
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_batch_kkt_resid_matches_jax(searched, dtype):
    Q, rj, rt = searched[dtype]
    ej = np.asarray(jb.batch_kkt_resid(Q, rj, shared=SHARED, hi=jnp.float64))
    et = tb.batch_kkt_resid(port(Q), rt)
    assert et.dtype == torch.float64
    np.testing.assert_allclose(et.numpy(), ej, rtol=0, atol=1e-12)
    failed = dataclasses.replace(rt, status=torch.where(
        torch.arange(B) == 2, -1, rt.status).to(torch.int32))
    assert tb.batch_kkt_resid(port(Q), failed)[2] == -np.inf


@pytest.mark.parametrize("dtype,iters,with_duals,exact", [
    (np.float64, 2, True, False),
    (np.float32, 1, False, True),  # the tail recipe
])
def test_refine_result_cg_matches_jax(searched, dtype, iters, with_duals,
                                      exact):
    Q, rj, rt = searched[dtype]
    s = JSettings.for_dtype(dtype)
    ax = jb.qp_axes(Q, SHARED)
    fj = jax.jit(jax.vmap(
        lambda p, r: jr.refine_result_cg(p, r, s, iters, with_duals=with_duals,
                                         exact_sweeps=exact),
        in_axes=(ax, JResult(0, 0, 0))))
    oj = jax.tree.map(np.asarray,
                      fj(Q, JResult(jnp.asarray(rj.x), jnp.asarray(rj.S),
                                    jnp.asarray(rj.status))))
    ot = tr.refine_result_cg(port(Q), Result(rt.x, rt.S, rt.status),
                             TSettings.for_dtype(dtype), iters,
                             with_duals=with_duals, exact_sweeps=exact)
    tol = 1e-9 if dtype == np.float64 else 5e-6
    assert ot.x.dtype == torch.float64 and oj.x.dtype == np.float64
    np.testing.assert_allclose(ot.x.numpy(), oj.x, rtol=0, atol=tol)
    np.testing.assert_array_equal(ot.S.numpy(), oj.S)
    np.testing.assert_array_equal(ot.status.numpy(), oj.status)
    if with_duals:
        np.testing.assert_allclose(ot.lam.numpy(), oj.lam, rtol=0, atol=tol)
        np.testing.assert_allclose(ot.gamma.numpy(), oj.gamma, rtol=0,
                                   atol=tol)
    else:
        assert ot.lam is None and oj.lam is None
    # the refinement moved the point (not a pass-through of the search)
    assert np.abs(ot.x.numpy() - rj.x.astype(np.float64)).max() > 0


@pytest.mark.parametrize("fac", [np.float64, np.float32])
def test_kept_rows_match_jax(searched, fac):
    """The kept-rows decision of every refinement tier (the purge of the
    free-masked working rows in the factor dtype, with the float32
    tolerance floor when downcast) gives the JAX package's masks."""
    Q, rj, rt = searched[np.float64]
    s = JSettings()
    free = rj.S[:, :N] == 0
    kj, aj = jax.jit(jax.vmap(
        lambda p, r, f, z: jr._kept_rows(p, r, s, f, z, fac)[:2],
        in_axes=(jb.qp_axes(Q, SHARED), JResult(0, 0, 0), 0, 0)))(
        Q, JResult(jnp.asarray(rj.x), jnp.asarray(rj.S),
                   jnp.asarray(rj.status)), jnp.asarray(free),
        jnp.asarray(rj.x))
    kt, at, _, _, _ = tr._kept_rows(port(Q), rt, TSettings(),
                                    torch.tensor(free), rt.x,
                                    torch.from_numpy(np.zeros(0, fac)).dtype)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert (kt <= at).all() and at[:, :M].all()
