"""The port's least-index criss-cross engine (ssqp_tpu_torch/solvers/cclp.py:
solve_lp, the stage-1 loop, the basis repair, the float64 rescue) and its
batch protocols (solve_lp_batch_cclp, solve_lp_batch_cclp_rescued) against
the JAX package on the CPU.

Problems: tests/test_cclp.py's small LPs (N=8, M=2, J=3, boxed and mixed
bounds, free variables) and edge cases; for float32, bench_suite.py's
config-2 criss-cross class (N=40, M=4, J=8, 0 <= x <= 2, seed 7, per-instance
c, b, g from seed 2001), instances 288-303. Instance 294 exits -1 in float32
at its drift gate in both packages (tests/test_cclp.py): it drives the
repair branch (the repair re-enters and exits -1 again) and the float64
rescue, which solves it. No max_iter was lowered to force either.

Criss-cross walks depend on the backend's inverse, so results are compared
by status and objective only: status equal, objective within 1e-9
max(1, |f|) in float64 and 5e-5 max(1, |f|) in float32.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssqp_tpu import Settings as JSettings
from ssqp_tpu import make_lp as jmake_lp
from ssqp_tpu.parallel import batch as jb
from ssqp_tpu.solvers.cclp import solve_lp as jsolve_lp
from ssqp_tpu_torch import LP, box_lp, make_lp, solve_lp
from ssqp_tpu_torch import Settings as TSettings
from ssqp_tpu_torch.parallel import batch as tb
from ssqp_tpu_torch.solvers import cclp as tcc

FIELDS = ("c", "A", "b", "G", "g", "d", "u")
INF = np.inf


def port(P):
    return LP.from_numpy(*(np.asarray(getattr(P, f)) for f in FIELDS),
                         P.N, P.M, P.J, P.mc, device="cpu")


def rand_lp(seed, N=8, M=2, J=3, free=0, oneside=0, boxed=3):
    """tests/test_cclp.py's generator: feasible, mixed bounds."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, N))
    G = rng.standard_normal((J, N))
    x0 = rng.uniform(0.2, 0.8, N)
    d, u = np.zeros(N), np.full(N, INF)
    u[:boxed] = 1.0
    d[boxed:boxed + free], u[boxed:boxed + free] = -INF, INF
    k = boxed + free
    d[k:k + oneside], u[k:k + oneside] = -INF, 1.0
    return dict(c=rng.standard_normal(N), A=A, b=A @ x0, G=G,
                g=G @ x0 + rng.uniform(0.1, 1.0, J), d=d, u=u)


def cases():
    out = {f"boxed{s}": rand_lp(s) for s in range(3)}
    out.update({f"mixed{s}": rand_lp(s, free=2, oneside=1) for s in range(3)})
    kw = rand_lp(11)
    kw["A"][1] = kw["A"][0]
    kw["b"][1] = kw["b"][0]
    out["redundant"] = kw
    kw = rand_lp(12)
    kw["A"][1] = kw["A"][0]
    kw["b"][1] = kw["b"][0] + 0.5
    out["inconsistent"] = kw
    kw = rand_lp(13)
    kw["g"] = kw["g"] - 40.0
    out["infeasible"] = kw
    kw = rand_lp(14, boxed=0)  # x >= 0 only, G x <= g loose along -c
    kw["A"][:] = 0.0
    kw["b"][:] = 0.0
    kw["G"] = -np.abs(kw["G"])
    kw["c"] = -np.abs(kw["c"])
    out["unbounded"] = kw
    kw = rand_lp(15, boxed=8)
    kw["d"][0] = kw["u"][0] = 0.5  # d == u (mc=-30): a fixed variable
    kw["A"][:, 0] = 0.0
    kw["G"][:, 0] = 0.0
    out["d_equals_u"] = kw
    return out


CASES = cases()


def assert_same(sj, st, fj, ft, tol):
    np.testing.assert_array_equal(np.asarray(st), np.asarray(sj))
    fj, ft = np.asarray(fj, np.float64), np.asarray(ft, np.float64)
    assert (np.abs(ft - fj) <= tol * np.maximum(1.0, np.abs(fj))).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_lp_matches_jax(name):
    kw = CASES[name]
    Pj = jmake_lp(**kw)
    Pt = port(Pj)
    rj, rt = jsolve_lp(Pj), solve_lp(Pt)
    c = np.asarray(kw["c"], np.float64)
    assert_same(int(rj.status), int(rt.status), c @ np.asarray(rj.x),
                c @ rt.x.numpy(), 1e-9)
    if int(rj.status) > 0:
        assert rt.lam.shape == (Pt.M + Pt.J,) and rt.gamma.shape == (Pt.N,)


def test_solve_lp_routes_large_instances_to_the_simplex(monkeypatch):
    """route="auto" sends N + J >= 100 to simplex_lp; route="cclp" and
    smaller instances stay with criss-cross (the JAX package's rule); a
    problem without rows takes the closed-form box LP."""
    from ssqp_tpu_torch.solvers import lp as tlp

    calls = []
    monkeypatch.setattr(tlp, "simplex_lp",
                        lambda P, **k: calls.append(P.N) or "simplex")
    big = make_lp(np.ones(100), np.ones((1, 100)), [1.0], u=np.ones(100),
                  device="cpu")
    assert solve_lp(big) == "simplex" and calls == [100]
    assert int(solve_lp(big, route="cclp").status) in (1, 2)
    assert calls == [100]
    box = make_lp([1.0, -1.0, 0.0], u=[1.0, 2.0, 3.0], device="cpu")
    rb, rx = solve_lp(box), box_lp(box)
    assert int(rb.status) == int(rx.status) == 2
    np.testing.assert_array_equal(rb.x.numpy(), rx.x.numpy())


def test_cclp_batch_matches_jax():
    """A float64 batch of 24 mixed-bound problems (c, b, g per instance)."""
    rng = np.random.default_rng(21)
    kw = rand_lp(21, free=2, oneside=1)
    Bn = 24
    x0 = rng.uniform(0.2, 0.8, (Bn, 8))
    C = rng.standard_normal((Bn, 8))
    bB = x0 @ kw["A"].T
    gB = x0 @ kw["G"].T + rng.uniform(0.1, 1.0, (Bn, 3))
    Pj = dataclasses.replace(jmake_lp(**kw), c=jnp.asarray(C),
                             b=jnp.asarray(bB), g=jnp.asarray(gB))
    sh = ("A", "G", "d", "u")
    rj = jb.solve_lp_batch_cclp(Pj, JSettings(), sh)
    rt = tb.solve_lp_batch_cclp(port(Pj), TSettings(), sh)
    assert_same(rj.status, rt.status, (C * np.asarray(rj.x)).sum(1),
                (C * rt.x.numpy()).sum(1), 1e-9)


def config2_window():
    """bench_suite.py::config2's criss-cross class, instances 288-303 of the
    seed-2001 batch, float32."""
    N, M, J = 40, 4, 8
    rng = np.random.default_rng(7)
    A = rng.standard_normal((M, N)).astype(np.float32)
    G = rng.standard_normal((J, N)).astype(np.float32)
    rl = np.random.default_rng(2001)
    X0 = rl.uniform(0.1, 1.0, (512, N)).astype(np.float32)
    cB = rl.standard_normal((512, N)).astype(np.float32)
    bB = (X0 @ A.T).astype(np.float32)
    gB = (X0 @ G.T + rl.uniform(0.1, 1.0, (512, J))).astype(np.float32)
    w = slice(288, 304)
    P = jmake_lp(cB[0], A, bB[0], G=G, g=gB[0], d=np.zeros(N, np.float32),
                 u=np.full(N, 2.0, np.float32), dtype=np.float32)
    return dataclasses.replace(P, c=jnp.asarray(cB[w]), b=jnp.asarray(bB[w]),
                               g=jnp.asarray(gB[w]))


def test_cclp_float32_repair_and_rescue_match_jax(monkeypatch):
    """The float32 batch against the JAX package; the repair runs on
    instance 294 (window slot 6) and the rescue solves it, as in the JAX
    package (tests/test_cclp.py); the single solve_lp of that instance
    takes the same rescue."""
    Pj = config2_window()
    Pt = port(Pj)
    sh = ("A", "G", "d", "u")
    sj, st = JSettings.for_dtype(jnp.float32), TSettings.for_dtype(
        torch.float32)
    repaired, raw = [], []
    real_repair, real_batch = tcc.cclp_repair, tb.solve_lp_batch_cclp

    def spy_repair(c1, A1, b1, s, **k):
        repaired.append((s.status == -1).nonzero().squeeze(1).tolist())
        return real_repair(c1, A1, b1, s, **k)

    def spy_batch(P, *a, **k):  # the rescue's own float32 pass
        raw.append(real_batch(P, *a, **k))
        return raw[-1]

    monkeypatch.setattr(tcc, "cclp_repair", spy_repair)
    monkeypatch.setattr(tb, "solve_lp_batch_cclp", spy_batch)
    C = np.asarray(Pj.c, np.float64)
    obj = lambda r: (C * np.asarray(r.x, np.float64)).sum(1)
    rt = tb.solve_lp_batch_cclp_rescued(Pt, st, sh)
    # the float32 pass, then the float64 pass on slot 6 alone
    assert [r.x.dtype for r in raw] == [torch.float32, torch.float64]
    assert repaired == [[6], []] and int(raw[0].status[6]) == -1
    rj = jb.solve_lp_batch_cclp(Pj, sj, sh)
    assert_same(rj.status, raw[0].status, obj(rj), obj(raw[0].numpy()),
                5e-5)
    # the rescue replaces slot 6 alone, by a float64 optimum (HiGHS's
    # objective), and leaves every other instance bit for bit
    assert rt.x.dtype == torch.float32 and (rt.status > 0).all()
    keep = np.arange(16) != 6
    np.testing.assert_array_equal(rt.x.numpy()[keep], raw[0].x.numpy()[keep])
    np.testing.assert_array_equal(rt.status.numpy()[keep],
                                  raw[0].status.numpy()[keep])
    ref = highs(Pj, 6)
    f6 = float(C[6] @ rt.x[6].double().numpy())
    assert abs(f6 - ref) <= 5e-5 * max(1.0, abs(ref))
    one = dataclasses.replace(Pt, c=Pt.c[6], b=Pt.b[6], g=Pt.g[6])
    r1 = solve_lp(one, settings=st)
    assert int(r1.status) == int(rt.status[6]) > 0
    f1 = float(C[6] @ r1.x.double().numpy())
    assert abs(f1 - ref) <= 5e-5 * max(1.0, abs(ref))


def highs(P, i):
    """scipy's HiGHS objective of instance i of a batch (c, b, g batched)."""
    from scipy.optimize import linprog

    f = lambda a: np.asarray(a, np.float64)
    r = linprog(f(P.c[i]), A_ub=f(P.G), b_ub=f(P.g[i]), A_eq=f(P.A),
                b_eq=f(P.b[i]), bounds=list(zip(f(P.d), f(P.u))),
                method="highs")
    assert r.success
    return r.fun
