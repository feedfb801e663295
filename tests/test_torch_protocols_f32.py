"""The port's wave protocol in float32 against the JAX package on the CPU:
waves W=8 (with and without compaction of the cold wave's PDAS rounds, and
with the cold-stage PDAS budget cut to 16 that applies in float32), on
bench.py's frontier generator cut to N=32, B=64. The float64 cases are in
tests/test_torch_protocols.py.

Tolerance: statuses equal on every instance, objective gap to the JAX
result under 1e-6 relative (bench.py's audit bar); a float32 KKT solve may
settle a near-tie differently, so S and x are not compared.
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
N, B = 32, 64
S32 = (JSettings.for_dtype(np.float32), TSettings.for_dtype(np.float32))


def frontier():
    """(JAX batch, port batch, shared): tests/test_torch_protocols.py's
    frontier grid in float32."""
    rng = np.random.default_rng(3)
    H = rng.standard_normal((N, N))
    V = (H @ H.T / N + 0.5 * np.eye(N)).astype(np.float32)
    mu = rng.uniform(0.0, 0.2, N).astype(np.float32)
    Q = jmake_qp(V, mu, u=np.full(N, 4.0 / N, np.float32), dtype=np.float32)
    Qt = QP.from_numpy(*(np.asarray(getattr(Q, f)) for f in FIELDS),
                       Q.N, Q.M, Q.J, Q.mc, device="cpu")
    lams = np.linspace(0.0, 2.0, B).astype(np.float32)
    Qb, sh = jb.frontier_batch(Q, lams)
    return Qb, tb.frontier_batch(Qt, lams)[0], sh


def as_np(r):
    return jax.tree.map(np.asarray, r)


@pytest.fixture(scope="module")
def refs():
    """JAX waves W=8 (the JAX package's waves with compaction equal its
    waves bit for bit, tests/test_compact.py)."""
    Qb, Qt, sh = frontier()
    return {"grid": (Qb, Qt, sh),
            "waves8": as_np(jb.solve_qp_batch_waves(Qb, S32[0], sh,
                                                    waves=8))}


def _obj(Qb, x):
    V, q = np.asarray(Qb.V, np.float64), np.asarray(Qb.q, np.float64)
    x = np.asarray(x, np.float64)
    return 0.5 * np.einsum("bi,ij,bj->b", x, V, x) + (q * x).sum(1)


def _check(Qb, rt, rj):
    np.testing.assert_array_equal(rt.status, rj.status)
    assert (rt.status > 0).all()
    assert rt.x.dtype == np.float32
    fj, ft = _obj(Qb, rj.x), _obj(Qb, rt.x)
    assert (np.abs(ft - fj) <= 1e-6 * np.maximum(1.0, np.abs(fj))).all()


@pytest.mark.parametrize("compact", [0, 4])
def test_waves_f32_matches_jax(refs, compact):
    Qb, Qt, sh = refs["grid"]
    rt = tb.solve_qp_batch_waves(Qt, S32[1], sh, waves=8,
                                 compact=compact).numpy()
    _check(Qb, rt, refs["waves8"])


def test_c2f_f32_reaches_the_jax_optima(refs):
    """c2f coarse=8 in float32: every point solved, at the JAX waves
    result's objective within the audit bar (the statuses, S-iteration
    counts, depend on the anchors; tests/test_torch_c2f.py holds them to
    the JAX package's c2f in float64)."""
    Qb, Qt, sh = refs["grid"]
    rt = tb.solve_qp_batch_c2f(Qt, S32[1], sh, coarse=8).numpy()
    rj = refs["waves8"]
    assert (rt.status > 0).all() and rt.x.dtype == np.float32
    fj, ft = _obj(Qb, rj.x), _obj(Qb, rt.x)
    assert (np.abs(ft - fj) <= 1e-6 * np.maximum(1.0, np.abs(fj))).all()


def test_auto_routes_a_forced_wave_count(refs):
    """solve_qp_batch_auto(waves=8) is the wave protocol, bit for bit."""
    Qb, Qt, sh = refs["grid"]
    ra = tb.solve_qp_batch_auto(Qt, S32[1], sh, waves=8).numpy()
    rw = tb.solve_qp_batch_waves(Qt, S32[1], sh, waves=8).numpy()
    for name in ("x", "S", "status", "lam", "gamma"):
        np.testing.assert_array_equal(getattr(ra, name), getattr(rw, name))
