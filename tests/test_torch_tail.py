"""The port's R >= 16 slice as a whole: the batched solve of a shared-V/A/G
grid of general-inequality QPs, then the residual-thresholded tail
refinement (ssqp_tpu_torch/parallel/batch.py::solve_qp_batch_tail_refined,
and solve_qp_batch_auto's tail route), against the JAX package on the CPU.

The class is BASELINE config 4's generator (bench_suite.py::config4) cut
from N=512, M=10, J=100 to N=32, M=2, J=16, B=8 (R = 18 >= 16), q varying.

Tolerances:
  * float64: S and status equal on every instance, x within 1e-9, lam and
    gamma within 1e-9 (the searched duals; both sides solve the same
    systems to rtol 1e-14, so they differ by summation order only);
  * float32: every status > 0 in both, objective within 1e-6 relative.
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
from ssqp_tpu_torch import QP
from ssqp_tpu_torch import Settings as TSettings
from ssqp_tpu_torch.ops import chol
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


def _obj(Q, x):
    V, q = np.asarray(Q.V, np.float64), np.asarray(Q.q, np.float64)
    x = np.asarray(x, np.float64)
    return 0.5 * np.einsum("bi,ij,bj->b", x, V, x) + (q * x).sum(1)


@pytest.fixture(scope="module")
def runs():
    """float64: the tail refinement with resid_bound=0 (so that passes run:
    B/4 = 2 instances per pass, 4 passes); float32: solve_qp_batch_auto with
    an explicit tail=4. One JAX compile each."""
    Q64 = ineq_class(np.float64)
    rj64 = jb.solve_qp_batch_tail_refined(Q64, JSettings(), SHARED, tail=4,
                                          iters=1, resid_bound=0.0)
    rt64 = tb.solve_qp_batch_tail_refined(port(Q64), TSettings(), SHARED,
                                          tail=4, iters=1, resid_bound=0.0)
    Q32 = ineq_class(np.float32)
    s32 = JSettings.for_dtype(np.float32)
    rj32 = jb.solve_qp_batch_auto(Q32, s32, SHARED, tail=4)
    rt32 = tb.solve_qp_batch_auto(port(Q32), TSettings.for_dtype(np.float32),
                                  SHARED, tail=4)
    as_np = lambda r: jax.tree.map(np.asarray, r)
    return {np.float64: (Q64, as_np(rj64), rt64.numpy()),
            np.float32: (Q32, as_np(rj32), rt32.numpy())}


def test_tail_refined_f64_matches_jax(runs):
    Q, rj, rt = runs[np.float64]
    assert (rj.status > 0).all()
    np.testing.assert_array_equal(rt.status, rj.status)
    np.testing.assert_array_equal(rt.S, rj.S)
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.lam, rj.lam, rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.gamma, rj.gamma, rtol=0, atol=1e-9)
    assert rt.x.dtype == np.float64


def test_batch_auto_tail_f32_matches_jax(runs):
    Q, rj, rt = runs[np.float32]
    assert (rj.status > 0).all() and (rt.status > 0).all()
    assert rt.x.dtype == np.float32
    fj, ft = _obj(Q, rj.x), _obj(Q, rt.x)
    assert (np.abs(ft - fj) <= 1e-6 * np.maximum(1.0, np.abs(fj))).all()


def test_tail_passes_gather_the_worst_and_scatter_back(monkeypatch):
    """With resid_bound=0 every pass refines the B/tail instances of largest
    residual, each exactly once, up to max_passes; the refined x lands in
    its own instance's row."""
    Q = port(ineq_class(np.float64))
    seen = []
    real = tr.refine_result_cg

    def spy(Qk, rk, *a, **k):
        out = real(Qk, rk, *a, **k)
        seen.append((Qk.q.clone(), out.x.clone()))
        return out

    monkeypatch.setattr(tr, "refine_result_cg", spy)
    r = tb.solve_qp_batch_tail_refined(Q, TSettings(), SHARED, tail=4,
                                       iters=1, resid_bound=0.0, max_passes=3)
    assert [q.shape[0] for q, _ in seen] == [2, 2, 2]
    rows = [int((Q.q == qk).all(1).nonzero()) for q, _ in seen for qk in q]
    assert len(set(rows)) == 6
    for (q, x), i in zip(seen, range(0, 6, 2)):
        for k in range(2):
            np.testing.assert_array_equal(r.x[rows[i + k]].numpy(),
                                          x[k].numpy())
    seen.clear()
    tb.solve_qp_batch_tail_refined(Q, TSettings(), SHARED, tail=4, iters=1)
    assert len(seen) <= 4  # passes stop once no residual exceeds the bound


def test_auto_rule_takes_the_tail_at_n512_float32(monkeypatch):
    """The JAX rule: tail=4 with one sweep at N >= 512 outside float64, the
    plain route otherwise; the tail route passes the protocol on (waves=8
    on a q-only grid at B=8192, compaction (2, 4, 8) at B=4096), and the
    tail refinement runs it: the wave protocol or compaction, then its
    passes."""
    calls = []
    monkeypatch.setattr(tb, "solve_qp_batch_tail_refined",
                        lambda Q, s, sh, **k: calls.append(("tail", k)))
    monkeypatch.setattr(tb, "solve_qp_batch",
                        lambda Q, s, shared: calls.append(("plain", {})))
    for n, b, dtype, want in (
            (512, 4, torch.float32, ("tail", dict(
                waves=0, tail=4, iters=1, compact=0))),
            (512, 8192, torch.float32, ("tail", dict(
                waves=8, tail=4, iters=1, compact=0))),
            (512, 4096, torch.float32, ("tail", dict(
                waves=0, tail=4, iters=1, compact=(2, 4, 8)))),
            (512, 4, torch.float64, ("plain", {})),
            (511, 4, torch.float32, ("plain", {}))):
        Q = QP(*(torch.zeros(s, dtype=dtype) for s in
                 ((n, n), (1, n), (0, n), (b, n), (1,), (0,), (n,), (n,))),
               n, 1, 0)
        calls.clear()
        tb.solve_qp_batch_auto(Q, TSettings.for_dtype(dtype), SHARED)
        assert calls == [want], (n, b, dtype)
    monkeypatch.undo()
    # the tail refinement over the wave protocol and over compaction: the
    # protocol's result, then the passes (resid_bound=0: one pass of B/4)
    Qb = port(ineq_class(np.float64))
    seen = []
    for name in ("solve_qp_batch_waves", "solve_qp_batch_compact"):
        real = getattr(tb, name)
        monkeypatch.setattr(tb, name, (lambda name, real: lambda *a, **k: (
            seen.append((name, {key: k[key] for key in ("waves", "compact")
                                if key in k})), real(*a, **k))[1])(name, real))
    rw = tb.solve_qp_batch_tail_refined(Qb, TSettings(), SHARED, waves=4,
                                        tail=4, iters=1, resid_bound=0.0,
                                        max_passes=1)
    rc = tb.solve_qp_batch_tail_refined(Qb, TSettings(), SHARED,
                                        compact=(2, 4, 8), tail=4, iters=1,
                                        resid_bound=0.0, max_passes=1)
    assert seen == [("solve_qp_batch_waves", dict(waves=4, compact=0)),
                    ("solve_qp_batch_compact", dict(compact=(2, 4, 8)))]
    assert (rw.status > 0).all() and (rc.status > 0).all()
    np.testing.assert_array_equal(rw.S.numpy(), rc.S.numpy())
    np.testing.assert_allclose(rw.x.numpy(), rc.x.numpy(), rtol=0, atol=1e-9)


def test_cpu_slice_never_launches_a_kernel(runs):
    assert chol.LAUNCHES == 0
