"""The port's solver slice (ssqp_tpu_torch/solvers/ssqp.py and
parallel/batch.py) against the JAX package, end to end on the CPU.

Tolerances:
  * float64: ``S`` and ``status`` equal on every instance, x within 1e-9;
  * float32: the same solved count, objective within 1e-5 relative of JAX
    float32, and ``S`` equal on at least 90% of instances (a float32 KKT
    solve may settle a near-tie differently).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from ssqp_tpu import Settings as JSettings
from ssqp_tpu import make_qp as jmake_qp
from ssqp_tpu.parallel import batch as jb
from ssqp_tpu.solvers import ssqp as js
from ssqp_tpu.utils.problems import generate_qp_known_opt
from ssqp_tpu_torch import QP
from ssqp_tpu_torch import Settings as TSettings
from ssqp_tpu_torch.ops import cg
from ssqp_tpu_torch.parallel import batch as tb
from ssqp_tpu_torch.solvers import ssqp as ts

FIELDS = ("V", "A", "G", "q", "b", "g", "d", "u")
N, B = 32, 16


def _port(Q):
    return QP.from_numpy(*(np.asarray(getattr(Q, f)) for f in FIELDS),
                         Q.N, Q.M, Q.J, Q.mc, device="cpu")


def _frontier(dtype):
    rng = np.random.default_rng(7)
    H = rng.standard_normal((N, N))
    V = H @ H.T / N + 0.5 * np.eye(N)
    mu = rng.uniform(0.0, 0.2, N)
    Q = jmake_qp(V.astype(dtype), mu.astype(dtype),
                 u=np.full(N, 4.0 / N, dtype), dtype=dtype)
    return Q, np.linspace(0.001, 2.0, B)


@pytest.fixture(scope="module")
def frontier_runs():
    """JAX and port results for the four (dtype, multi_free) frontier
    configurations, one JAX compile each."""
    out = {}
    for dtype in (np.float64, np.float32):
        Q, lams = _frontier(dtype)
        for mf in (True, False):
            sj = dataclasses.replace(JSettings.for_dtype(dtype), multi_free=mf)
            st = dataclasses.replace(TSettings.for_dtype(dtype), multi_free=mf)
            Qb, sh = jb.frontier_batch(Q, lams)
            rj = jb.solve_qp_batch(Qb, sj, shared=sh)
            Qbt, sht = tb.frontier_batch(_port(Q), lams)
            rt = tb.solve_qp_batch(Qbt, st, shared=sht)
            out[dtype, mf] = (Qb, jax.tree.map(np.asarray, rj), rt.numpy())
    return out


def _obj(Qb, x):
    V, q = np.asarray(Qb.V, np.float64), np.asarray(Qb.q, np.float64)
    x = x.astype(np.float64)
    return 0.5 * np.einsum("bi,ij,bj->b", x, V, x) + (q * x).sum(1)


@pytest.mark.parametrize("mf", [True, False])
def test_frontier_batch_f64_matches_jax(frontier_runs, mf):
    """multi_free on: PDAS guess path; off: Phase-1 + exact S-loop."""
    Qb, rj, rt = frontier_runs[np.float64, mf]
    np.testing.assert_array_equal(rt.status, rj.status)
    np.testing.assert_array_equal(rt.S, rj.S)
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.lam, rj.lam, rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.gamma, rj.gamma, rtol=0, atol=1e-9)
    assert (rt.status > 0).all()
    if not mf:
        assert rt.status.max() > 1  # the S-loop walked from a vertex


@pytest.mark.parametrize("mf", [True, False])
def test_frontier_batch_f32_matches_jax(frontier_runs, mf):
    Qb, rj, rt = frontier_runs[np.float32, mf]
    assert (rt.status > 0).sum() == (rj.status > 0).sum() == B
    fj, ft = _obj(Qb, rj.x), _obj(Qb, rt.x)
    assert (np.abs(ft - fj) <= 1e-5 * np.maximum(1.0, np.abs(fj))).all()
    assert (rt.S == rj.S).all(axis=1).mean() >= 0.9


def test_waterfill_seed_matches_jax():
    Q, lams = _frontier(np.float64)
    Qb, sh = jb.frontier_batch(Q, lams)
    ax = jb.qp_axes(Qb, sh)
    vj, Sxj, zj = jax.vmap(js._waterfill_seed, in_axes=(ax,))(Qb)
    Qbt, _ = tb.frontier_batch(_port(Q), lams)
    vt, Sxt, zt = ts._waterfill_seed(Qbt)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(Sxt.numpy(), np.asarray(Sxj))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0, atol=1e-12)
    assert vt.all()


def test_guess_start_matches_jax():
    Q, lams = _frontier(np.float64)
    Qb, sh = jb.frontier_batch(Q, lams)
    ax = jb.qp_axes(Qb, sh)
    s = JSettings()
    zj, Sxj, Sej, solj = jax.vmap(lambda p: js._guess_start(p, s),
                                  in_axes=(ax,))(Qb)
    Qbt, _ = tb.frontier_batch(_port(Q), lams)
    zt, Sxt, Set, solt = ts._guess_start(Qbt, TSettings())
    np.testing.assert_array_equal(Sxt.numpy(), np.asarray(Sxj))
    np.testing.assert_array_equal(Set.numpy(), np.asarray(Sej))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(solt.numpy(), np.asarray(solj), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("seed,mf", [(300, True), (301, True), (300, False)])
def test_solve_qp_with_inequalities_matches_jax(seed, mf):
    """J > 0, R = 6 < 16: the Gauss-Jordan purge, dropped-row multipliers,
    row ratio test and Phase-1 slack columns."""
    gp = generate_qp_known_opt(seed, N=10, M=2, J=4, n_dn=2, n_up=1, j_act=2)
    Qj = jmake_qp(gp.V, gp.q, gp.A, gp.b, G=gp.G, g=gp.g, d=gp.d, u=gp.u)
    rj = js.solve_qp(Qj, settings=JSettings(multi_free=mf))
    rt = ts.solve_qp(_port(Qj), settings=TSettings(multi_free=mf)).numpy()
    assert int(rt.status) == int(rj.status) > 0
    np.testing.assert_array_equal(rt.S, np.asarray(rj.S))
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.x, gp.x_opt, rtol=0, atol=1e-6)
    np.testing.assert_allclose(rt.lam, np.asarray(rj.lam), rtol=0, atol=1e-9)


@pytest.mark.parametrize("opt", [dict(clip_step=True), dict(pivot="column"),
                                 dict(kkt_cg=False)])
def test_solve_qp_settings_variants_match_jax(opt):
    """The non-default loop paths the port carries: clipped full steps, the
    column-pivoted purge, and direct (Cholesky) KKT solves. A 1-step PDAS
    CG budget spoils the guess, so the S-loop has to walk."""
    opt = dict(opt, pdas_cg_iters=1)
    gp = generate_qp_known_opt(303, N=10, M=2, J=4, n_dn=2, n_up=1, j_act=2)
    Qj = jmake_qp(gp.V, gp.q, gp.A, gp.b, G=gp.G, g=gp.g, d=gp.d, u=gp.u)
    rj = js.solve_qp(Qj, settings=JSettings(**opt))
    rt = ts.solve_qp(_port(Qj), settings=TSettings(**opt)).numpy()
    assert int(rt.status) == int(rj.status) > 1
    np.testing.assert_array_equal(rt.S, np.asarray(rj.S))
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-9)


def test_warm_solve_matches_jax():
    gp = generate_qp_known_opt(302, N=10, M=2, J=4, n_dn=2, n_up=1, j_act=2)
    Qj = jmake_qp(gp.V, gp.q, gp.A, gp.b, G=gp.G, g=gp.g, d=gp.d, u=gp.u)
    r0 = js.solve_qp(Qj)
    rj = js.solve_qp(Qj, np.asarray(r0.S), np.asarray(r0.x))
    rt = ts.solve_qp(_port(Qj), torch.tensor(np.asarray(r0.S)),
                     torch.tensor(np.asarray(r0.x))).numpy()
    assert int(rt.status) == int(rj.status) > 0
    np.testing.assert_array_equal(rt.S, np.asarray(rj.S))
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-9)


@pytest.mark.parametrize("kw", [
    dict(d=np.zeros(3), u=np.array([0.0, 1.0, 1.0])),  # d == u: mc -30
    dict(d=np.full(3, -np.inf), u=np.full(3, np.inf)),  # mc -20
])
def test_invalid_model_rejected_like_jax(kw):
    Qj = jmake_qp(np.eye(3), **kw)
    rj = js.solve_qp(Qj)
    rt = ts.solve_qp(_port(Qj)).numpy()
    assert Qj.mc <= 0
    assert int(rt.status) == int(rj.status) == -1
    np.testing.assert_array_equal(rt.S, np.asarray(rj.S))
    np.testing.assert_array_equal(rt.x, np.asarray(rj.x))


def test_per_instance_batch_matches_jax():
    """Stacked problems with every leaf batched (per-instance V turns the
    PDAS closed-form round 1 off, as the JAX batch entry points do)."""
    gps = [generate_qp_known_opt(500 + s, N=8, M=1, J=0, n_dn=2, n_up=1,
                                 j_act=0) for s in range(3)]
    Qjs = [jmake_qp(gp.V, gp.q, gp.A, gp.b, d=gp.d, u=gp.u) for gp in gps]
    rj = jb.solve_qp_batch(jb.stack_qps(Qjs), JSettings())
    rt = tb.solve_qp_batch(tb.stack_qps([_port(Q) for Q in Qjs]),
                           TSettings()).numpy()
    np.testing.assert_array_equal(rt.status, np.asarray(rj.status))
    np.testing.assert_array_equal(rt.S, np.asarray(rj.S))
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-9)


@pytest.mark.parametrize("n,b,q_only", [(128, 1024, True), (256, 2048, True),
                                        (256, 8192, True), (256, 8192, False),
                                        (512, 8200, True), (1024, 8192, True)])
def test_auto_protocol_is_the_jax_rule(n, b, q_only):
    assert tb.auto_protocol(n, b, q_only) == jb.auto_protocol(n, b, q_only)


def test_batch_auto_plain_route_and_unported_protocols():
    Q, lams = _frontier(np.float64)
    Qbt, sh = tb.frontier_batch(_port(Q), lams)
    ra = tb.solve_qp_batch_auto(Qbt, TSettings(), sh)
    rp = tb.solve_qp_batch(Qbt, TSettings(), shared=sh)
    np.testing.assert_array_equal(ra.x.numpy(), rp.x.numpy())
    big, shb = tb.frontier_batch(_port(Q), np.linspace(0.0, 2.0, 8192))
    with pytest.raises(NotImplementedError, match="wave"):
        tb.solve_qp_batch_auto(big, TSettings(), shb)
    with pytest.raises(NotImplementedError, match="compaction"):
        tb.solve_qp_batch_auto(big, TSettings(), shb, waves=0)
    rt = tb.solve_qp_batch_auto(Qbt, TSettings(), sh, tail=4)
    rr = tb.solve_qp_batch_tail_refined(Qbt, TSettings(), sh, tail=4, iters=1)
    for name in ("x", "S", "status", "lam", "gamma"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      getattr(rr, name).numpy())
    np.testing.assert_array_equal(rt.S.numpy(), rp.S.numpy())
    with pytest.raises(ValueError):
        tb.solve_qp_batch(Qbt, TSettings(), shared=())


def test_cpu_solves_never_launch_the_kernel(frontier_runs):
    assert cg.LAUNCHES == 0
