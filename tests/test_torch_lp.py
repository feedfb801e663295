"""The port's LP layer on one problem at a time against the JAX package on
the CPU: the LP container and constructors (ssqp_tpu_torch/types.py), the
closed-form box LP, the standard form and its recovery, the rank helpers
of ops/masked_gj.py, and the two-phase simplex (solvers/lp.py: simplex_lp
cold, maximizing, with ``warm_from``, and simplex_lp_standard).

Problems: random LPs with N=12, M=2, J=4 whose bounds mix boxed, lower-only,
upper-only and free variables (feasible by construction), plus the edge
cases of tests/test_lp.py (infeasible, unbounded, redundant rows). One
shape, so the JAX solver compiles once per engine and sense.

Tolerances, float64: status equal; for a unique optimum (status 1) S equal
and x within 1e-9; objective within 1e-9 max(1, |f|); lam and gamma within
1e-8. Float32: status equal, objective within 5e-5 max(1, |f|) (the JAX
package's float32 LP bar, tests/test_lp.py). The standard form and the rank
helpers are exact computations of the same sweep: within 1e-12, masks equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssqp_tpu import Settings as JSettings
from ssqp_tpu import make_lp as jmake_lp
from ssqp_tpu.ops import masked_gj as jgj
from ssqp_tpu.solvers.boxlp import box_lp as jbox_lp
from ssqp_tpu.solvers.lp import simplex_lp as jsimplex_lp
from ssqp_tpu.solvers.lp import simplex_lp_standard as jsimplex_std
from ssqp_tpu.types import lp_from_qp as jlp_from_qp
from ssqp_tpu.types import make_qp as jmake_qp
from ssqp_tpu.types import qp_from_lp as jqp_from_lp
from ssqp_tpu.utils import standard_form as jsf
from ssqp_tpu_torch import LP, Result, box_lp, make_lp, simplex_lp
from ssqp_tpu_torch import Settings as TSettings
from ssqp_tpu_torch import simplex_lp_standard
from ssqp_tpu_torch.ops import masked_gj as tgj
from ssqp_tpu_torch.parallel.batch import stack_lps
from ssqp_tpu_torch.types import (
    MC_DEGENERATE_BOUNDS, MC_NO_CONSTRAINTS, lp_from_qp, make_qp, qp_from_lp)
from ssqp_tpu_torch.utils import standard_form as tsf

FIELDS = ("c", "A", "b", "G", "g", "d", "u")
INF = np.inf
# jitted references: one compile per shape instead of eager op dispatch
jstandard_form = jax.jit(jsf.standard_form)
jrecover = jax.jit(jsf.recover_solution, static_argnums=(3, 4))


def port(P):
    return LP.from_numpy(*(np.asarray(getattr(P, f)) for f in FIELDS),
                         P.N, P.M, P.J, P.mc, device="cpu")


def rand_kw(seed, N=12, M=2, J=4, n_free=0, n_lo=0, n_up=0):
    """A feasible LP: the first n_free variables free, the next n_lo with a
    lower bound only, the next n_up with an upper bound only, the rest in
    [0, 2]."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, N))
    G = rng.standard_normal((J, N))
    x0 = rng.uniform(0.2, 0.9, N)
    d, u = np.zeros(N), np.full(N, 2.0)
    k = n_free
    d[:k], u[:k] = -INF, INF
    u[k:k + n_lo] = INF
    d[k + n_lo:k + n_lo + n_up] = -INF
    return dict(c=rng.standard_normal(N), A=A, b=A @ x0, G=G,
                g=G @ x0 + rng.uniform(0.1, 1.0, J), d=d, u=u)


def cases():
    out = {f"rand{s}_{nf}{nl}{nu}": rand_kw(s, n_free=nf, n_lo=nl, n_up=nu)
           for s, (nf, nl, nu) in enumerate(
               [(0, 0, 0), (2, 0, 0), (0, 3, 2), (1, 2, 1), (0, 0, 0)])}
    kw = rand_kw(7)
    kw["A"][1] = kw["A"][0]  # a redundant equality row
    kw["b"][1] = kw["b"][0]
    out["redundant"] = kw
    kw = rand_kw(8)
    kw["A"][1] = kw["A"][0]
    kw["b"][1] = kw["b"][0] + 1.0  # inconsistent
    out["inconsistent"] = kw
    kw = rand_kw(9)
    kw["g"] = kw["g"] - 50.0  # G x <= g far below every feasible point
    out["infeasible"] = kw
    kw = rand_kw(10, n_lo=12)  # lower bounds only: unbounded along -c
    kw["c"] = -np.abs(kw["c"])
    kw["G"] = -np.abs(kw["G"])
    kw["A"] = np.zeros_like(kw["A"])
    kw["b"] = np.zeros_like(kw["b"])
    out["unbounded"] = kw
    return out


CASES = cases()


def both(kw, dtype=np.float64):
    Pj = jmake_lp(dtype=dtype, **kw)
    return Pj, port(Pj)


def assert_lp_result(rj, rt, c, dtype=np.float64, duals=True, AG=None):
    st = int(rj.status)
    assert int(rt.status) == st
    xj, xt = np.asarray(rj.x, np.float64), rt.x.double().numpy()
    fj, ft = float(np.dot(c, xj)), float(np.dot(c, xt))
    tol = 1e-9 if dtype == np.float64 else 5e-5
    assert abs(fj - ft) <= tol * max(1.0, abs(fj))
    if dtype != np.float64:
        return
    if st == 1:
        np.testing.assert_array_equal(rt.S.numpy(), np.asarray(rj.S))
        np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-9)
    if duals and rj.lam is not None:
        lj, lt = np.asarray(rj.lam), rt.lam.numpy()
        if AG is not None and np.linalg.matrix_rank(AG) < AG.shape[0]:
            # dependent rows: the least-squares multipliers are unique up
            # to the null space of [A; G]' (a near-singular ridge solve
            # splits them by roundoff); their image is not
            lj, lt = AG.T @ lj, AG.T @ lt
        np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-8)
        np.testing.assert_allclose(rt.gamma.numpy(), np.asarray(rj.gamma),
                                   rtol=0, atol=1e-8)


# ---- containers and constructors ---------------------------------------------


def test_make_lp_matches_jax():
    """Defaults, the bound swap, the mc codes, shapes and dtypes."""
    kws = [dict(c=[1.0, 2.0], A=[[1.0, 1.0]], b=[1.0]),
           dict(c=[1.0, 2.0], G=[[1.0, -1.0]], g=[0.5], d=[1.0, 0.0],
                u=[-1.0, 3.0]),
           dict(c=[1.0, 2.0], A=[[1.0, 1.0]], b=[1.0], d=[1.0, 0.0],
                u=[1.0, 2.0]),
           dict(c=[1.0, 2.0], A=[[1.0, 1.0]], b=[1.0], d=[-INF, -INF],
                u=[INF, INF])]
    for kw in kws:
        Pj = jmake_lp(**kw)
        Pt = make_lp(**kw, device="cpu")
        assert (Pt.N, Pt.M, Pt.J, Pt.mc) == (Pj.N, Pj.M, Pj.J, Pj.mc)
        for f in FIELDS:
            a = getattr(Pt, f)
            assert a.dtype == torch.float64 and a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(),
                                          np.asarray(getattr(Pj, f)))
    assert make_lp(**kws[2], device="cpu").mc == MC_DEGENERATE_BOUNDS
    assert make_lp(**kws[3], device="cpu").mc == MC_NO_CONSTRAINTS
    assert make_lp([1.0], dtype=np.float32, device="cpu").c.dtype == \
        torch.float32
    with pytest.raises(ValueError, match="incompatible"):
        make_lp([1.0, 2.0], A=[[1.0]], b=[1.0], device="cpu")
    with pytest.raises(ValueError, match="tolerance tiers"):
        make_lp([1.0], dtype=np.float16, device="cpu")


def test_lp_builds_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_lp([1.0, 2.0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LP.from_numpy(*(np.asarray(getattr(jmake_lp([1.0]), f))
                        for f in FIELDS), 1, 0, 0)


def test_lp_container_methods():
    """Batching, take, astype, stacking, and the QP/LP conversions."""
    Pj, Pt = both(CASES["rand0_000"])
    assert Pt.batch_size is None and not Pt.is_batched("c")
    Pb = stack_lps([Pt, Pt.astype(torch.float64)])
    assert Pb.batch_size == 2 and all(Pb.is_batched(f) for f in FIELDS)
    Pc = dataclasses.replace(Pt, c=torch.stack([Pt.c, -Pt.c, 2 * Pt.c]))
    sub = Pc.take(torch.tensor([2, 0]))
    assert sub.batch_size == 2 and sub.A is Pt.A
    np.testing.assert_array_equal(sub.c.numpy(), Pc.c[[2, 0]].numpy())
    P32 = Pt.astype(np.float32)
    assert all(getattr(P32, f).dtype == torch.float32 for f in FIELDS)
    assert Pt.to("cpu").device.type == "cpu"
    Qj, Qt = jqp_from_lp(Pj), qp_from_lp(Pt)
    np.testing.assert_array_equal(Qt.V.numpy(), np.asarray(Qj.V))
    np.testing.assert_array_equal(Qt.q.numpy(), np.asarray(Qj.q))
    Qm = jmake_qp(np.eye(3), [1.0, 2.0, 3.0])
    Qmt = make_qp(np.eye(3), [1.0, 2.0, 3.0], device="cpu")
    for c in (None, [3.0, 2.0, 1.0]):
        Lj, Lt = jlp_from_qp(Qm, c), lp_from_qp(Qmt, c)
        assert (Lt.N, Lt.M, Lt.J, Lt.mc) == (Lj.N, Lj.M, Lj.J, Lj.mc)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(Lt, f).numpy(),
                                          np.asarray(getattr(Lj, f)))


@pytest.mark.parametrize("minimize", [True, False])
@pytest.mark.parametrize("kw", [
    dict(c=[1.0, -2.0, 0.0], d=[0.0, 0.0, -1.0], u=[1.0, 3.0, 1.0]),
    dict(c=[1.0, 2.0], d=[0.0, -1.0], u=[1.0, 5.0]),
    dict(c=[1.0, 0.0, 0.0], d=[-INF, -INF, -INF], u=[INF, 1.0, INF]),
    dict(c=[-1.0, 1.0], d=[0.0, 0.0], u=[INF, INF]),
], ids=["mixed", "unique", "zero_cost_infinite", "unbounded"])
def test_box_lp_matches_jax(kw, minimize):
    Pj, Pt = both(kw)
    rj = jbox_lp(Pj, minimize=minimize)
    rt = box_lp(Pt, minimize=minimize)
    assert int(rt.status) == int(rj.status)
    np.testing.assert_array_equal(rt.S.numpy(), np.asarray(rj.S))
    np.testing.assert_array_equal(rt.x.numpy(), np.asarray(rj.x))
    np.testing.assert_array_equal(rt.gamma.numpy(), np.asarray(rj.gamma))
    assert rt.lam.shape == (0,)


# ---- standard form and the rank helpers ---------------------------------------


@pytest.mark.parametrize("name", ["rand1_200", "rand3_121", "redundant",
                                  "inconsistent"])
def test_standard_form_matches_jax(name):
    """Every field of the standard form, and the recovery of a random
    standard-form point and status vector."""
    kw = CASES[name]
    Pj, Pt = both(kw)
    sj = jstandard_form(Pj.c, Pj.A, Pj.b, Pj.G, Pj.g, Pj.d, Pj.u,
                        tol=2.0**-26)
    st = tsf.standard_form(Pt.c, Pt.A, Pt.b, Pt.G, Pt.g, Pt.d, Pt.u, 1,
                           tol=2.0**-26)
    for f in sj._fields:
        a, b = np.asarray(getattr(sj, f)), getattr(st, f)[0].numpy()
        assert a.shape == b.shape, f
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-12, err_msg=f)
    rng = np.random.default_rng(5)
    Nt = sj.c1.shape[0]
    y = rng.uniform(0.0, 1.0, Nt)
    S1 = rng.integers(0, 3, Nt).astype(np.int8)
    xj, Soj, Sej = jrecover(jnp.asarray(y), jnp.asarray(S1), sj, Pj.N,
                            Pj.J)
    xt, Sot, Set = tsf.recover_solution(torch.tensor(y)[None],
                                        torch.tensor(S1)[None], st, Pt.N,
                                        Pt.J)
    np.testing.assert_allclose(xt[0].numpy(), np.asarray(xj), atol=1e-12)
    np.testing.assert_array_equal(Sot[0].numpy(), np.asarray(Soj))
    np.testing.assert_array_equal(Set[0].numpy(), np.asarray(Sej))


def rank_problem(seed, R=8, C=10):
    """Rows with planted dependencies (row 5 = row 1 + row 2, row 7 = 2 row
    3) and a row mask, for the row and column rank helpers."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((R, C))
    A[5] = A[1] + A[2]
    A[7] = 2.0 * A[3]
    mask = np.ones(R, bool)
    mask[4] = False
    return A, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_rank_helpers_match_jax(seed):
    A, mask = rank_problem(seed)
    tol = 1e-9
    At, mt = torch.tensor(A)[None], torch.tensor(mask)[None]
    kj = jgj.independent_rows_gs(jnp.asarray(A), jnp.asarray(mask), tol)
    kt = tgj.independent_rows_gs(At, mt, tol)
    np.testing.assert_array_equal(kt[0].numpy(), np.asarray(kj))
    rj, keepj = jgj.masked_row_rank(jnp.asarray(A), jnp.asarray(mask), tol)
    rt, keept = tgj.masked_row_rank(At, mt, tol)
    assert int(rt[0]) == int(rj) == 5
    np.testing.assert_array_equal(keept[0].numpy(), np.asarray(keepj))
    # columns of the (R, C) matrix's transpose, priorities with ties
    rng = np.random.default_rng(seed + 10)
    Ac = A.T  # (C, R): R columns with the same planted dependencies
    prio = rng.integers(0, 3, Ac.shape[1]).astype(np.float64)
    cmask = np.ones(Ac.shape[1], bool)
    cmask[0] = False
    kcj = jgj.masked_independent_cols(jnp.asarray(Ac), jnp.asarray(cmask),
                                      jnp.asarray(prio), tol)
    kct = tgj.masked_independent_cols(torch.tensor(Ac)[None],
                                      torch.tensor(cmask)[None],
                                      torch.tensor(prio)[None], tol)
    np.testing.assert_array_equal(kct[0].numpy(), np.asarray(kcj))


# ---- the two-phase simplex ----------------------------------------------------


@pytest.mark.parametrize("minimize", [True, False])
@pytest.mark.parametrize("name", sorted(CASES))
def test_simplex_lp_matches_jax(name, minimize):
    kw = CASES[name]
    if not minimize and name == "unbounded":
        kw = dict(kw, c=-kw["c"])  # unbounded in the maximizing sense too
    Pj, Pt = both(kw)
    rj = jsimplex_lp(Pj, minimize=minimize)
    rt = simplex_lp(Pt, minimize=minimize)
    assert rt.x.shape == (Pt.N,) and rt.S.shape == (Pt.N + Pt.J,)
    assert_lp_result(rj, rt, kw["c"], AG=np.vstack([kw["A"], kw["G"]]))


def test_simplex_lp_float32_matches_jax():
    for name in ("rand0_000", "rand2_032", "redundant"):
        kw = CASES[name]
        Pj, Pt = both(kw, np.float32)
        s = JSettings.for_dtype(jnp.float32)
        rj = jsimplex_lp(Pj, settings=s)
        rt = simplex_lp(Pt, settings=TSettings.for_dtype(torch.float32))
        assert rt.x.dtype == torch.float32
        assert_lp_result(rj, rt, kw["c"], np.float32)


@pytest.mark.parametrize("name", ["rand0_000", "rand1_200", "rand3_121"])
def test_simplex_lp_warm_from_matches_jax(name):
    """warm_from a prior optimum of the same problem with the rhs moved
    (the dual restart), and from one with another cost row (rejected at
    the entry gate: the cold fallback); the port's prior is the JAX
    result carried over by Result.from_numpy."""
    kw = CASES[name]
    Pj, Pt = both(kw)
    shifted = dict(kw, b=kw["b"] * 1.02, g=kw["g"] + 0.05)
    prior_j = jsimplex_lp(jmake_lp(**shifted))
    prior_t = Result.from_numpy(*(np.asarray(t) for t in
                                  (prior_j.x, prior_j.S, prior_j.status)),
                                device="cpu")
    assert_lp_result(jsimplex_lp(Pj, warm_from=prior_j),
                     simplex_lp(Pt, warm_from=prior_t), kw["c"])
    other = jsimplex_lp(jmake_lp(**dict(kw, c=-kw["c"])))
    other_t = Result.from_numpy(np.asarray(other.x), np.asarray(other.S),
                                np.asarray(other.status), device="cpu")
    assert_lp_result(jsimplex_lp(Pj, warm_from=other),
                     simplex_lp(Pt, warm_from=other_t), kw["c"])


def test_simplex_lp_standard_and_invalid_match_jax():
    c = np.array([1.0, 2.0, -1.0, 0.5])
    A = np.array([[1.0, 1.0, 1.0, 1.0], [1.0, -1.0, 0.0, 2.0]])
    b = np.array([2.0, 0.5])
    d = np.array([0.0, -INF, 0.0, 0.0])
    u = np.array([1.0, INF, INF, 3.0])
    rj = jsimplex_std(c, A, b, d, u)
    rt = simplex_lp_standard(c, A, b, d, u, device="cpu")
    assert_lp_result(rj, rt, c)
    # d == u is mc=-30: simplex_lp rejects it with -1, as the JAX package
    kw = dict(c=[1.0, 1.0], A=[[1.0, 1.0]], b=[1.0], d=[0.5, 0.0],
              u=[0.5, 1.0])
    rj = jsimplex_lp(jmake_lp(**kw))
    rt = simplex_lp(make_lp(**kw, device="cpu"))
    assert int(rt.status) == int(rj.status) == -1
    np.testing.assert_array_equal(rt.S.numpy(), np.asarray(rj.S))
