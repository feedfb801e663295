"""The port's coarse-to-fine grid protocol
(ssqp_tpu_torch/parallel/batch.py::solve_qp_batch_c2f) against the JAX
package's on the CPU: coarse=4 and coarse=8 in float64 at B=32, on
bench.py's frontier generator cut to N=32 (float32 reaches the JAX optima
in tests/test_torch_protocols_f32.py). Two JAX compiles, one per coarse
width.

Tolerance: S and status equal on every instance, x within 1e-9, lam and
gamma within 1e-6 (tests/test_parallel.py's bar for the deferred dual
attachment).
"""

import numpy as np
import pytest

import jax

from ssqp_tpu import Settings as JSettings
from ssqp_tpu import make_qp as jmake_qp
from ssqp_tpu.parallel import batch as jb
from ssqp_tpu_torch import QP
from ssqp_tpu_torch import Settings as TSettings
from ssqp_tpu_torch.parallel import batch as tb

FIELDS = ("V", "A", "G", "q", "b", "g", "d", "u")
N = 32


def frontier(dtype, B):
    """(JAX batch, port batch, shared): tests/test_torch_protocols.py's
    frontier grid."""
    rng = np.random.default_rng(3)
    H = rng.standard_normal((N, N))
    V = (H @ H.T / N + 0.5 * np.eye(N)).astype(dtype)
    mu = rng.uniform(0.0, 0.2, N).astype(dtype)
    Q = jmake_qp(V, mu, u=np.full(N, 4.0 / N, dtype), dtype=dtype)
    Qt = QP.from_numpy(*(np.asarray(getattr(Q, f)) for f in FIELDS),
                       Q.N, Q.M, Q.J, Q.mc, device="cpu")
    lams = np.linspace(0.0, 2.0, B).astype(dtype)
    Qb, sh = jb.frontier_batch(Q, lams)
    return Qb, tb.frontier_batch(Qt, lams)[0], sh


_RUNS = {}


def _runs(coarse):
    """(port batch, shared, JAX result, port result), one JAX compile per
    coarse width."""
    if coarse not in _RUNS:
        Qb, Qt, sh = frontier(np.float64, 32)
        rj = jb.solve_qp_batch_c2f(Qb, JSettings(), sh, coarse=coarse)
        rt = tb.solve_qp_batch_c2f(Qt, TSettings(), sh, coarse=coarse)
        _RUNS[coarse] = (Qt, sh, jax.tree.map(np.asarray, rj), rt.numpy())
    return _RUNS[coarse]


@pytest.fixture(scope="module")
def runs():
    return _runs(4)


def test_c2f_matches_jax(runs):
    _assert_same(runs)


def test_c2f_coarse8_matches_jax():
    """At coarse=8 (4 anchors, 8 points apart) too, status for status."""
    _assert_same(_runs(8))


def _assert_same(runs):
    _, _, rj, rt = runs
    assert (rj.status > 0).all()
    np.testing.assert_array_equal(rt.status, rj.status)
    np.testing.assert_array_equal(rt.S, rj.S)
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.lam, rj.lam, rtol=0, atol=1e-6)
    np.testing.assert_allclose(rt.gamma, rj.gamma, rtol=0, atol=1e-6)
    # points away from their anchor walk: some take more than one step
    assert rt.status.max() > 1


def test_failed_anchor_forces_its_points(runs, monkeypatch):
    """A coarse point that fails forces the points it warm-started (those
    whose nearest anchor it is) through the cold rescue, which solves them:
    the batch then reaches the JAX result's optima."""
    from ssqp_tpu_torch.solvers import ssqp as ts

    Qt, sh, rj, _ = runs
    real_core = ts.solve_qp_auto_core

    def failing_core(Q, *a, **k):
        r = real_core(Q, *a, **k)
        status = r.status.clone()
        status[3] = 0
        return tb.Result(r.x, r.S, status)

    forced = []
    real_rescue = tb._rescue_and_attach
    monkeypatch.setattr(ts, "solve_qp_auto_core", failing_core)
    monkeypatch.setattr(tb, "_rescue_and_attach", lambda Q, m, s, force: (
        forced.append(force.nonzero().squeeze(1).tolist()),
        real_rescue(Q, m, s, force=force))[1])
    rt = tb.solve_qp_batch_c2f(Qt, TSettings(), sh, coarse=4).numpy()
    # anchor 3 is coarse point 12; round(i / 4) == 3 for i = 11 .. 13
    # (10 / 4 and 14 / 4 round half to even: to anchors 2 and 4)
    assert forced == [[11, 12, 13]]
    assert (rt.status > 0).all()
    np.testing.assert_array_equal(rt.S, rj.S)
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-9)
