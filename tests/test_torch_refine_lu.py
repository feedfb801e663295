"""The port's refinement tiers beyond the CG tier (ssqp_tpu_torch/solvers/
refine.py: the assembled KKT system, the LU tier, the refined single solve,
the double-double continuation; parallel/batch.py::solve_qp_batch_refined)
against the JAX package on the CPU.

Problems: four float64 instances of the constructed-optimum generator
(ssqp_tpu/utils/problems.py::generate_qp_known_opt, N=10, M=2, J=4, two
variables at their lower and one at its upper bound, two binding rows),
stacked with every leaf per instance; the float32 search runs on their
downcast copy.

Tolerances:
  * ``_kkt_matrix``: bit for bit (masks and concatenations only);
  * refined x (LU and CG tiers, single and batched): S and status equal,
    x within 1e-9 of the JAX package's (and of the known optimum within
    1e-6), duals within 1e-9 where attached;
  * double-double: x_hi within 1e-12 of the JAX package's and x_lo within
    1e-25 (about eps64^2 times max|x|: both sides factor the same K with the
    same LAPACK routine and run the same numpy sweeps).
"""

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
from ssqp_tpu.utils.problems import generate_qp_known_opt
from ssqp_tpu_torch import QP, Result
from ssqp_tpu_torch import Settings as TSettings
from ssqp_tpu_torch.parallel import batch as tb
from ssqp_tpu_torch.solvers import refine as tr

FIELDS = ("V", "A", "G", "q", "b", "g", "d", "u")
SEEDS = (300, 301, 302, 303)


def port(Q):
    return QP.from_numpy(*(np.asarray(getattr(Q, f)) for f in FIELDS),
                         Q.N, Q.M, Q.J, Q.mc, device="cpu")


@pytest.fixture(scope="module")
def cls():
    gps = [generate_qp_known_opt(s, N=10, M=2, J=4, n_dn=2, n_up=1, j_act=2)
           for s in SEEDS]
    Qjs = [jmake_qp(gp.V, gp.q, gp.A, gp.b, G=gp.G, g=gp.g, d=gp.d, u=gp.u)
           for gp in gps]
    Qj = jb.stack_qps(Qjs)
    Qt = tb.stack_qps([port(Q) for Q in Qjs])
    x_opt = np.stack([gp.x_opt for gp in gps])
    # the search the refinement starts from: the port's float32 search,
    # cast back to float64 (both packages refine the same input)
    rs = tb._solve_qp_batch_nodual(Qt.astype(torch.float32),
                                   TSettings.for_dtype(torch.float32))
    res = Result(rs.x.double(), rs.S, rs.status)
    return Qjs, Qj, Qt, x_opt, res


def _jres(res):
    return JResult(jnp.asarray(res.x.numpy()), jnp.asarray(res.S.numpy()),
                   jnp.asarray(res.status.numpy()))


def test_search_is_solved_but_not_exact(cls):
    Qjs, Qj, Qt, x_opt, res = cls
    assert (res.status > 0).all()
    assert np.abs(res.x.numpy() - x_opt).max() > 1e-9  # room to refine


def test_kkt_matrix_matches_jax_bit_for_bit(cls):
    Qjs, Qj, Qt, x_opt, res = cls
    N = Qt.N
    S = res.S.numpy()
    free = S[:, :N] == 0
    keep = np.ones((4, 6), bool)
    keep[:, 3] = False  # a dropped row: identity block, zero rhs
    z = np.where(free, res.x.numpy(), np.asarray(Qj.d))
    Kj, rj, _, _ = jax.vmap(jr._kkt_matrix)(Qj, jnp.asarray(free),
                                            jnp.asarray(keep),
                                            jnp.asarray(z))
    Kt, rt, _, _ = tr._kkt_matrix(Qt, torch.tensor(free), torch.tensor(keep),
                                  torch.tensor(z))
    np.testing.assert_array_equal(Kt.numpy(), np.asarray(Kj))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    # a shared problem (frontier leaves unbatched) assembles the same rows
    Qs = tb.stack_qps([port(Q) for Q in Qjs[:1]] * 4)
    Q1 = QP(*(getattr(Qs, f)[0] if f != "q" else Qs.q for f in FIELDS),
            Qs.N, Qs.M, Qs.J)
    K1, _, _, _ = tr._kkt_matrix(Q1, torch.tensor(free), torch.tensor(keep),
                                 torch.tensor(z))
    K4, _, _, _ = tr._kkt_matrix(Qs, torch.tensor(free), torch.tensor(keep),
                                 torch.tensor(z))
    np.testing.assert_array_equal(K1.numpy(), K4.numpy())


def test_refine_result_matches_jax(cls):
    Qjs, Qj, Qt, x_opt, res = cls
    s = JSettings()
    rj = jax.jit(jax.vmap(lambda p, r: jr.refine_result(p, r, s, 2)))(
        Qj, _jres(res))
    rt = tr.refine_result(Qt, res, TSettings(), 2).numpy()
    np.testing.assert_array_equal(rt.status, np.asarray(rj.status))
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.x, x_opt, rtol=0, atol=1e-6)
    np.testing.assert_allclose(rt.lam, np.asarray(rj.lam), rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.gamma, np.asarray(rj.gamma), rtol=0,
                               atol=1e-9)
    assert rt.x.dtype == np.float64


def test_refine_result_keeps_a_failed_instance(cls):
    """A failed search keeps its point and gets zero duals; a singular
    system (here: NaN data in one instance) leaves the others alone."""
    Qjs, Qj, Qt, x_opt, res = cls
    status = res.status.clone()
    status[1] = -1
    bad = Result(res.x, res.S, status)
    rt = tr.refine_result(Qt, bad, TSettings(), 2)
    np.testing.assert_array_equal(rt.x[1].numpy(), res.x[1].numpy())
    assert (rt.lam[1] == 0).all() and (rt.gamma[1] == 0).all()
    V = Qt.V.clone()
    V[2] = float("nan")
    rn = tr.refine_result(QP(V, *(getattr(Qt, f) for f in FIELDS[1:]),
                             Qt.N, Qt.M, Qt.J), res, TSettings(), 2,
                          with_duals=False)
    np.testing.assert_array_equal(rn.x[2].numpy(), res.x[2].numpy())
    np.testing.assert_allclose(rn.x[[0, 1, 3]].numpy(), x_opt[[0, 1, 3]],
                               rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def single(cls):
    """solve_qp_refined (float32 search on float64 data) with the CG and the
    LU tier, and the double-double continuation, which reuses the CG tier's
    compiled JAX search, on the first instance."""
    Qjs, Qj, Qt, x_opt, res = cls
    Q0 = Qjs[0]
    out = {}
    for method in ("cg", "lu"):
        rj = jr.solve_qp_refined(Q0, search_dtype=jnp.float32, method=method)
        rt = tr.solve_qp_refined(port(Q0), search_dtype=torch.float32,
                                 method=method)
        out[method] = (jax.tree.map(np.asarray, rj), rt.numpy())
    rj, lj = jr.solve_qp_refined_dd(Q0, search_dtype=jnp.float32)
    rt, lt = tr.solve_qp_refined_dd(port(Q0), search_dtype=torch.float32)
    out["dd"] = (jax.tree.map(np.asarray, rj), np.asarray(lj), rt.numpy(),
                 lt.numpy())
    return out


def test_solve_qp_refined_matches_jax(cls, single):
    x_opt = cls[3][0]
    rj, rt = single["cg"]
    assert int(rt.status) == int(rj.status) > 0
    np.testing.assert_array_equal(rt.S, rj.S)
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.x, x_opt, rtol=0, atol=1e-6)
    np.testing.assert_allclose(rt.lam, rj.lam, rtol=0, atol=1e-9)
    assert rt.x.dtype == np.float64


def test_solve_qp_refined_lu_matches_jax(cls, single):
    """The single-problem LU tier against the JAX function itself."""
    x_opt = cls[3][0]
    rj, rt = single["lu"]
    assert int(rt.status) == int(rj.status) > 0
    np.testing.assert_array_equal(rt.S, rj.S)
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.x, x_opt, rtol=0, atol=1e-6)
    np.testing.assert_allclose(rt.lam, rj.lam, rtol=0, atol=1e-9)
    assert rt.x.dtype == np.float64


def test_solve_qp_refined_dd_matches_jax(cls, single):
    rj, lj, rt, lt = single["dd"]
    assert int(rt.status) == int(rj.status) > 0
    np.testing.assert_array_equal(rt.S, rj.S)
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-12)
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-25)
    assert np.abs(lt).max() > 0  # the continuation carried digits


def test_refined_rejects_an_invalid_model_like_jax():
    Qj = jmake_qp(np.eye(3), d=np.zeros(3), u=np.array([0.0, 1.0, 1.0]))
    rj = jr.solve_qp_refined(Qj)
    rt = tr.solve_qp_refined(port(Qj)).numpy()
    assert Qj.mc <= 0
    assert int(rt.status) == int(rj.status) == -1
    np.testing.assert_array_equal(rt.x, np.asarray(rj.x))
    with pytest.raises(ValueError, match="method"):
        tr.solve_qp_refined(port(Qj), method="qr")


def test_refined_lu_single_is_the_batched_lu(cls):
    """solve_qp_refined(method="lu") on one problem equals the batched LU
    tier on that instance (held to the JAX package below)."""
    Qjs, Qj, Qt, x_opt, res = cls
    r1 = tr.solve_qp_refined(port(Qjs[0]), search_dtype=torch.float32,
                             method="lu").numpy()
    rb = tb.solve_qp_batch_refined(Qt, search_dtype=torch.float32,
                                   method="lu").numpy()
    assert int(r1.status) == int(rb.status[0]) > 0
    np.testing.assert_array_equal(r1.S, rb.S[0])
    np.testing.assert_allclose(r1.x, rb.x[0], rtol=0, atol=1e-12)


@pytest.mark.parametrize("method", ["cg", "lu"])
def test_batch_refined_matches_jax(cls, method):
    """The refined tier, batched: float32 search on the downcast copy, then
    refinement against the float64 data, without duals."""
    Qjs, Qj, Qt, x_opt, res = cls
    rj = jb.solve_qp_batch_refined(Qj, search_dtype=jnp.float32,
                                   method=method)
    rt = tb.solve_qp_batch_refined(Qt, search_dtype=torch.float32,
                                   method=method).numpy()
    np.testing.assert_array_equal(rt.status, np.asarray(rj.status))
    np.testing.assert_array_equal(rt.S, np.asarray(rj.S))
    assert (rt.status > 0).all() and rt.x.dtype == np.float64
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.x, x_opt, rtol=0, atol=1e-6)
    assert rt.lam is None
