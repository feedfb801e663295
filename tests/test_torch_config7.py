"""bench_suite.py::config7's protocol at a small size on the CPU: the
Ungil-structure N=14 market (ssqp_tpu_torch/utils/problems.py::ungil_like:
budget row, a cap equality, two group inequality rows, shortable assets)
through the port's warm mu-sweep over 16 points against the JAX package's,
and the float32 sweep refined in float64 (solvers/refine.py::refine_result)
against the port's float64 sweep.

Tolerances: S equal, x, ret and risk within 1e-9 (float64, as
tests/test_torch_frontier_warm.py); the refined float32 sweep within 1e-6
objective gap of the float64 sweep (config 7's bar), every point solved.
Status (the S-iteration count) is equal wherever the warm S-loop, started
from the previous point, solved the point. The other points may count
differently in the two packages on the way to the same optimum
(ROADMAP.md §3, "Reference behaviours"): the first point starts from a
Phase-1 vertex, and this structure's Phase-1 LP has an exact ratio-test tie
(two basic variables reach their bounds at the same step); at two points
the warm S-loop cycles to its budget in both packages and the point is
re-solved cold, where the PDAS guess cycles through a working set whose CG
solve does not converge within its budget, so its z differs by roundoff
and the guess pass accepts it in one package and falls back to Phase-1 in
the other. The budget is cut to 100 (both packages) to keep the test
short, as tests/test_torch_frontier_mu.py does. One JAX compile (the
float64 warm mu sweep).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssqp_tpu.models import frontier as jf
from ssqp_tpu.types import Settings as JSettings
from ssqp_tpu.types import make_qp as jmake_qp
from ssqp_tpu_torch import Result, make_qp
from ssqp_tpu_torch import Settings as TSettings
from ssqp_tpu_torch.models import frontier as tf
from ssqp_tpu_torch.solvers.refine import refine_result
from ssqp_tpu_torch.utils.problems import ungil_like

POINTS = 16
MAX_ITER = 100


@pytest.fixture(scope="module")
def ungil():
    """(E, V, constraint arrays, port QP in float64, the mu grid): the grid
    spans the returns a coarse port L-sweep reaches, 1% in from each end
    (bench_suite.py::config7's rule)."""
    E, V, A, b, G, g, d, u = ungil_like()
    kw = dict(A=A, b=b, G=G, g=g, d=d, u=u)
    Qt = make_qp(V, np.zeros(14), device="cpu", **kw)
    lams = np.concatenate([[0.0], np.geomspace(1e-3, 50.0, 15)])
    fl = tf.frontier_batch_sweep(Qt, torch.tensor(E), torch.tensor(lams),
                                 TSettings())
    assert bool((fl.status > 0).all())
    rmin, rmax = float(fl.ret.min()), float(fl.ret.max())
    span = rmax - rmin
    mus = np.linspace(rmin + 0.01 * span, rmax - 0.01 * span, POINTS)
    return E, V, kw, Qt, mus


@pytest.fixture(scope="module")
def sweeps(ungil):
    E, V, kw, Qt, mus = ungil
    fj = jf.frontier_mu_warm_sweep(jmake_qp(V, np.zeros(14), **kw),
                                   jnp.asarray(E), jnp.asarray(mus),
                                   JSettings(max_iter=MAX_ITER))
    warm = []  # the warm S-loop's status at each point
    real = tf.solve_qp_loop

    def spy(*a, **k):
        r = real(*a, **k)
        warm.append(int(r.status[0]))
        return r

    tf.solve_qp_loop = spy
    try:
        ft = tf.frontier_mu_warm_sweep(Qt, torch.tensor(E),
                                       torch.tensor(mus),
                                       TSettings(max_iter=MAX_ITER))
    finally:
        tf.solve_qp_loop = real
    return fj, ft, np.array(warm)


def test_warm_mu_sweep_matches_jax(sweeps):
    fj, ft, warm = sweeps
    assert (np.asarray(fj.status) > 0).all()
    np.testing.assert_array_equal(ft.S.numpy(), np.asarray(fj.S))
    # the S-iteration counts agree where the warm start from the previous
    # point solved it (not at the first point nor at the cold re-solves)
    same = warm > 0
    same[0] = False
    assert (warm == -MAX_ITER).sum() <= 2 and same.sum() >= POINTS - 3
    np.testing.assert_array_equal(ft.status.numpy()[same],
                                  np.asarray(fj.status)[same])
    for k in ("x", "ret", "risk"):
        np.testing.assert_allclose(getattr(ft, k).numpy(),
                                   np.asarray(getattr(fj, k)), rtol=0,
                                   atol=1e-9, err_msg=k)
    # the sweep crosses segments: the active set changes along the grid
    S = ft.S.numpy()
    assert (S[1:] != S[:-1]).any(axis=1).sum() >= 2


def test_refined_f32_sweep_within_the_bar(ungil, sweeps):
    """The float32 warm mu sweep, refined on its labels against the float64
    data (config 7's mixed-precision recipe), reaches the float64 sweep's
    objective within 1e-6 at every point."""
    E, V, kw, Qt, mus = ungil
    _, f64, _ = sweeps
    Q32 = make_qp(V.astype(np.float32), np.zeros(14, np.float32),
                  dtype=np.float32, device="cpu",
                  **{k: np.asarray(v, np.float32) for k, v in kw.items()})
    s32 = dataclasses.replace(TSettings.for_dtype(torch.float32),
                              max_iter=MAX_ITER)
    f32 = tf.frontier_mu_warm_sweep(Q32, torch.tensor(E, dtype=torch.float32),
                                    torch.tensor(mus, dtype=torch.float32),
                                    s32)
    assert bool((f32.status > 0).all())
    Qmu = tf._with_mu_row(Qt, torch.tensor(E), torch.tensor(mus))
    res = Result(f32.x.double(), f32.S, f32.status)
    xr = refine_result(Qmu, res, TSettings(), 2, with_duals=False).x
    Vt = torch.tensor(V)
    fobj = lambda X: 0.5 * (X * (X @ Vt)).sum(1)
    fz = fobj(f64.x)
    gap = lambda X: float(((fobj(X) - fz).abs() / fz.abs().clamp(min=1.0))
                          .max())
    assert gap(xr) < 1e-6
    assert gap(xr) <= gap(f32.x.double())
