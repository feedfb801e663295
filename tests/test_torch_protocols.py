"""The port's QP batch protocols (ssqp_tpu_torch/parallel/batch.py: the wave
and coarse-to-fine grid protocols, PDAS compaction and the cold rescue)
and the warm batch solve against the JAX package on the CPU, in float64. The float32 waves are in
tests/test_torch_protocols_f32.py, c2f against the JAX package's c2f in
tests/test_torch_c2f.py.

Problems: bench.py's frontier generator cut to N=32 (V = HH'/N + 0.5 I,
mu ~ U(0, 0.2), 0 <= x <= 4/N) on a sorted lambda grid of B = 32 points,
and tests/test_compact.py's J > 0 q-only class (N=24, J=3, B=32). Each JAX
reference is computed once per module; its compile dominates this file's
time, so every reference serves several cases.

Tolerances:
  * S and status equal on every instance, x within 1e-9, lam and gamma
    within 1e-6 (the JAX package's own bar for the deferred dual
    attachment, tests/test_parallel.py);
  * compaction: bit-identical to the port's plain path (the JAX package
    holds its own compaction to the same, tests/test_compact.py).
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
from ssqp_tpu_torch.parallel import batch as tb
from ssqp_tpu_torch.solvers import ssqp as ts

FIELDS = ("V", "A", "G", "q", "b", "g", "d", "u")
N = 32
S64 = (JSettings(), TSettings())


def port(Q):
    return QP.from_numpy(*(np.asarray(getattr(Q, f)) for f in FIELDS),
                         Q.N, Q.M, Q.J, Q.mc, device="cpu")


def frontier(dtype, B, N=N, seed=3):
    """(JAX batch, port batch, shared) of the frontier grid."""
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((N, N))
    V = H @ H.T / N + 0.5 * np.eye(N)
    mu = rng.uniform(0.0, 0.2, N)
    Q = jmake_qp(V.astype(dtype), mu.astype(dtype),
                 u=np.full(N, 4.0 / N, dtype), dtype=dtype)
    lams = np.linspace(0.0, 2.0, B).astype(dtype)
    Qb, sh = jb.frontier_batch(Q, lams)
    return Qb, tb.frontier_batch(port(Q), lams)[0], sh


def ineq_grid(dtype=np.float64, N=24, J=3, B=32):
    """tests/test_compact.py::test_inequality_rows's class: a frontier grid
    with three shared inequality rows. Returns (port batch, shared)."""
    rng = np.random.default_rng(9)
    H = rng.standard_normal((N, N))
    V = (H @ H.T / N + 0.5 * np.eye(N)).astype(dtype)
    mu = rng.uniform(0, 0.2, N).astype(dtype)
    G = rng.standard_normal((J, N)).astype(dtype)
    g = (np.abs(rng.standard_normal(J)) + 0.2).astype(dtype)
    Q = jmake_qp(V, mu, G=G, g=g, u=np.full(N, 4.0 / N, dtype), dtype=dtype)
    lams = np.linspace(0.0, 2.0, B).astype(dtype)
    return tb.frontier_batch(port(Q), lams)


def as_np(r):
    return jax.tree.map(np.asarray, r)


@pytest.fixture(scope="module")
def refs():
    """The JAX references in float64 at B=32: waves W=4, and the warm batch
    solve from the waves result's statuses and points one grid step behind.
    Each protocol's JAX compile takes 8-13 s on the CPU, so the others sit
    in files of their own, each under 30 s: the float32 waves (W=8) in
    tests/test_torch_protocols_f32.py, c2f in tests/test_torch_c2f.py."""
    Qb, Qt, sh = frontier(np.float64, 32)
    r4 = as_np(jb.solve_qp_batch_waves(Qb, S64[0], sh, waves=4))
    start = (np.roll(r4.S[:, :N], 1, axis=0), np.zeros((32, 0), np.int8),
             np.roll(r4.x, 1, axis=0))
    rw = as_np(jb.solve_qp_batch_warm(Qb, *map(jnp.asarray, start), S64[0],
                                      sh))
    return {"frontier": (Qb, Qt, sh), "waves4": r4, "warm": (start, rw)}


def _obj(Qb, x):
    V, q = np.asarray(Qb.V, np.float64), np.asarray(Qb.q, np.float64)
    x = np.asarray(x, np.float64)
    return 0.5 * np.einsum("bi,ij,bj->b", x, V, x) + (q * x).sum(1)


def _exact(rt, rj):
    np.testing.assert_array_equal(rt.status, rj.status)
    np.testing.assert_array_equal(rt.S, rj.S)
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.lam, rj.lam, rtol=0, atol=1e-6)
    np.testing.assert_allclose(rt.gamma, rj.gamma, rtol=0, atol=1e-6)


def _ref(refs, name):
    return refs["frontier"] + (refs[name],)


@pytest.mark.parametrize("compact", [0, 4, (2, 4, 8)])
def test_waves_matches_jax(refs, compact):
    """Waves with and without compaction of the cold wave's PDAS rounds
    (the JAX package's waves with compaction equal its waves bit for bit,
    tests/test_compact.py)."""
    Qb, Qt, sh, rj = _ref(refs, "waves4")
    rt = tb.solve_qp_batch_waves(Qt, S64[1], sh, waves=4,
                                 compact=compact).numpy()
    assert (rj.status > 0).all()
    _exact(rt, rj)
    # the warm waves really warm-started: a few S-iterations each
    assert rt.status.reshape(8, 4)[:, 1:].max() <= 5


@pytest.mark.parametrize("coarse", [4, 8])
def test_c2f_reaches_the_jax_optima(refs, coarse):
    """Whatever its anchors, c2f reaches the grid's unique optima: S, x and
    duals as the JAX waves reference (the statuses, S-iteration counts,
    depend on the anchors; tests/test_torch_c2f.py holds them to the JAX
    package's c2f)."""
    Qb, Qt, sh, rj = _ref(refs, "waves4")
    rt = tb.solve_qp_batch_c2f(Qt, S64[1], sh, coarse=coarse).numpy()
    assert (rt.status > 0).all()
    np.testing.assert_array_equal(rt.S, rj.S)
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.lam, rj.lam, rtol=0, atol=1e-6)
    np.testing.assert_allclose(rt.gamma, rj.gamma, rtol=0, atol=1e-6)


@pytest.mark.parametrize("grid", ["frontier", "ineq"])
@pytest.mark.parametrize("compact", [2, 4, 8, (2, 4, 8)])
def test_compact_is_the_plain_path_bit_for_bit(refs, grid, compact):
    """Compaction changes the schedule of the PDAS rounds, not their
    result: bit-identical to the port's plain path (as the JAX package's
    is to its own, tests/test_compact.py), on the frontier grid and on the
    J > 0 class, whose inequality statuses ride along. The plain path is
    held against the JAX package in tests/test_torch_ssqp.py and
    tests/test_torch_tail.py."""
    Qt, sh = refs["frontier"][1:] if grid == "frontier" else ineq_grid()
    rt = tb.solve_qp_batch_compact(Qt, S64[1], sh, compact=compact).numpy()
    rp = tb.solve_qp_batch(Qt, S64[1], shared=sh).numpy()
    assert (rt.status > 0).all()
    for name in ("x", "S", "status", "lam", "gamma"):
        np.testing.assert_array_equal(getattr(rt, name), getattr(rp, name))


def test_compact_checks_its_levels(refs):
    Qt, sh = refs["frontier"][1:]
    for bad in (0, (4, 2), ()):
        with pytest.raises(ValueError, match="compact"):
            tb.solve_qp_batch_compact(Qt, S64[1], sh, compact=bad)
    # without multi_free there is no PDAS stage: the plain solve
    s = dataclasses.replace(S64[1], multi_free=False)
    rt = tb.solve_qp_batch_compact(Qt, s, sh, compact=4).numpy()
    rp = tb.solve_qp_batch(Qt, s, shared=sh).numpy()
    np.testing.assert_array_equal(rt.x, rp.x)


def test_warm_batch_matches_jax(refs):
    Qt, sh = refs["frontier"][1:]
    start, rj = refs["warm"]
    rt = tb.solve_qp_batch_warm(Qt, *map(torch.tensor, start), S64[1],
                                sh).numpy()
    assert (rj.status > 0).all()
    _exact(rt, rj)


def test_waves_strided_order(refs, monkeypatch):
    """Wave k holds grid points k, k+W, k+2W, ...: the q each stage sees,
    and the merged result lands on each point's own row (its objective is
    the JAX reference's for that grid point)."""
    Qb, Qt, sh, rj = _ref(refs, "waves4")
    seen = []
    for name in ("solve_qp_auto_core", "solve_qp_warm2"):
        real = getattr(ts, name)
        spy = (lambda real: lambda Q, *a, **k: (seen.append(Q.q.clone()),
                                                real(Q, *a, **k))[1])(real)
        monkeypatch.setattr(ts, name, spy)
    rt = tb.solve_qp_batch_waves(Qt, S64[1], sh, waves=4).numpy()
    # the cold wave, then waves 1..3 (a rejected guess's fallback would
    # call solve_qp_warm2 on fewer rows)
    waves = seen[:1] + [q for q in seen[1:] if q.shape[0] == 8]
    assert len(waves) == 4
    for k, q in enumerate(waves):
        np.testing.assert_array_equal(q.numpy(), Qt.q[k::4].numpy())
    fj, ft = _obj(Qb, rj.x), _obj(Qb, rt.x)
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-12)
    assert len(np.unique(np.round(ft, 9))) == 32


def test_failed_cold_slot_is_rescued_with_its_wave_slots(refs, monkeypatch):
    """A cold slot that fails forces every point it warm-started (slot i of
    every wave: grid points 4i .. 4i+3) through the cold rescue, which
    solves them; the batch then equals the JAX reference."""
    Qb, Qt, sh, rj = _ref(refs, "waves4")
    real_core = ts.solve_qp_auto_core
    rescued = []

    def failing_core(Q, *a, **k):
        r, sol = real_core(Q, *a, **k)
        status = r.status.clone()
        status[2] = -1
        return dataclasses.replace(r, status=status), sol

    real_rescue = tb._rescue_and_attach

    def spy(Q, merged, settings, force=None):
        rescued.append((force.clone(), merged.status.clone()))
        return real_rescue(Q, merged, settings, force=force)

    monkeypatch.setattr(ts, "solve_qp_auto_core", failing_core)
    monkeypatch.setattr(tb, "_rescue_and_attach", spy)
    rt = tb.solve_qp_batch_waves(Qt, S64[1], sh, waves=4).numpy()
    force, status = rescued[0]
    assert force.nonzero().squeeze(1).tolist() == [8, 9, 10, 11]
    assert int(status[8]) == -1
    assert (rt.status > 0).all()
    np.testing.assert_array_equal(rt.S, rj.S)
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.lam, rj.lam, rtol=0, atol=1e-6)


def test_rescue_writes_back_only_what_it_solved(refs):
    """_rescue_and_attach on a merged result with one failed and one forced
    instance re-solves those two cold (their results as the JAX
    reference's), leaves the others' x untouched and attaches duals."""
    Qb, Qt, sh, rj = _ref(refs, "waves4")
    status = torch.tensor(rj.status)
    status[5] = -7777
    merged = tb.Result(torch.tensor(rj.x), torch.tensor(rj.S), status)
    force = torch.zeros(32, dtype=torch.bool)
    force[20] = True
    rt = tb._rescue_and_attach(Qt, merged, S64[1], force=force).numpy()
    assert (rt.status > 0).all()
    others = np.setdiff1d(np.arange(32), [5, 20])
    np.testing.assert_array_equal(rt.status[others], rj.status[others])
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.lam, rj.lam, rtol=0, atol=1e-6)


def test_c2f_anchor_rounds_half_to_even():
    """i / coarse = k + 1/2 goes to the even k, as jnp.round does."""
    for B, coarse in ((32, 4), (64, 8), (24, 3)):
        want = np.clip(np.asarray(jnp.round(jnp.arange(B) / coarse)),
                       0, B // coarse - 1).astype(np.int64)
        got = tb._c2f_anchors(B, coarse).numpy()
        np.testing.assert_array_equal(got, want)
    a = tb._c2f_anchors(32, 4).numpy()
    assert (a[2], a[6], a[10]) == (0, 2, 2)


@pytest.mark.parametrize("dtype,J,iters,want", [
    (np.float32, 0, None, 16),  # the float32 tier's default budget: cut
    (np.float32, 0, 20, 20),  # an explicit budget is honoured
    (np.float64, 0, None, 128),  # float64 keeps its budget
    (np.float32, 3, None, 24),  # J > 0 keeps the deeper budget
])
def test_cold_stage_clamp(monkeypatch, dtype, J, iters, want):
    """The cold wave's PDAS CG budget goes 24 -> 16 only when J == 0,
    float32 and the budget is the float32 tier's default; the warm waves
    keep the caller's settings."""
    Qt, sh = ineq_grid(dtype, B=16) if J else frontier(dtype, 16)[1:]
    s = TSettings.for_dtype(dtype)
    if iters is not None:
        s = dataclasses.replace(s, pdas_cg_iters=iters)
    got = []
    real = ts.solve_qp_auto_core
    monkeypatch.setattr(ts, "solve_qp_auto_core", lambda Q, st, *a, **k: (
        got.append(st.pdas_cg_iters), real(Q, st, *a, **k))[1])
    real_w = ts.solve_qp_warm2
    monkeypatch.setattr(ts, "solve_qp_warm2", lambda Q, s0, s1, x, st, **k: (
        got.append(("warm", st.pdas_cg_iters)), real_w(Q, s0, s1, x, st,
                                                       **k))[1])
    tb.solve_qp_batch_waves(Qt, s, sh, waves=2)
    assert got[0] == want
    assert got[-1] == ("warm", s.pdas_cg_iters)


def test_grid_protocols_check_their_arguments(refs):
    Qb, Qt, sh, rj = _ref(refs, "waves4")
    with pytest.raises(ValueError, match="q-only"):
        tb.solve_qp_batch_waves(Qt, S64[1], ("V", "A", "b"), waves=4)
    with pytest.raises(ValueError, match="divide"):
        tb.solve_qp_batch_waves(Qt, S64[1], sh, waves=5)
    with pytest.raises(ValueError, match="divide"):
        tb.solve_qp_batch_c2f(Qt, S64[1], sh, coarse=5)
