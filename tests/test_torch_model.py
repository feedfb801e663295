"""The port's modelling front end (ssqp_tpu_torch/model.py ``Model``)
against the JAX package's on the CPU in float64: the LP, analytic-presolve,
round-trip, refined-tier and bookkeeping cases of tests/test_model.py,
each built through both packages' ``Model``. The QP cases are in
tests/test_torch_model_qp.py, the MPS files, ``kkt_report`` and ``trace``
in tests/test_torch_mps.py (the JAX solves compile per shape, 1-9 s each).

Every case: the same termination, primal and dual status strings; the
objective, x and the duals within 1e-9; the assembled problem's arrays
identical; and the case's own expected optimum from tests/test_model.py
(1e-6, the reference's MOI tolerance).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssqp_tpu.model import Model as JModel
from ssqp_tpu_torch import LP, QP
from ssqp_tpu_torch import Model as TModel
from ssqp_tpu_torch.model import (
    INFEASIBLE, INFEASIBLE_OR_UNBOUNDED, OPTIMAL, OPTIMIZE_NOT_CALLED)

ATOL = 1e-6  # the reference's MOI conformance tolerance (testMOI.jl:25-27)
PAR = 1e-9  # port against the JAX package
FIELDS = {QP: ("V", "A", "G", "q", "b", "g", "d", "u"),
          LP: ("c", "A", "b", "G", "g", "d", "u")}


def jmodel(**k):
    return JModel(dtype=np.float64, **k)


def tmodel(**k):
    return TModel(dtype=np.float64, device="cpu", **k)


def same_problem(Pt, Pj):
    assert (Pt.N, Pt.M, Pt.J, Pt.mc) == (Pj.N, Pj.M, Pj.J, Pj.mc)
    for f in FIELDS[type(Pt)]:
        np.testing.assert_array_equal(getattr(Pt, f).numpy(),
                                      np.asarray(getattr(Pj, f)))


def run_pair(build, **opt):
    """Build the case in both packages, optimize both and hold them to each
    other; returns (port model, expected) for the case's own checks."""
    mj, exp = build(jmodel)
    mt, _ = build(tmodel)
    tj, tt = mj.optimize(**opt), mt.optimize(**opt)
    assert tt == tj == exp["term"], (tt, tj)
    assert mt.primal_status() == mj.primal_status()
    assert mt.dual_status() == mj.dual_status()
    assert mt.iterations() == mj.iterations()
    same_problem(mt.to_problem(), mj.to_problem())
    assert isinstance(mt.to_problem().V if isinstance(mt.to_problem(), QP)
                      else mt.to_problem().c, torch.Tensor)
    if tt == OPTIMAL:
        assert abs(mt.objective_value() - mj.objective_value()) < PAR
        np.testing.assert_allclose(mt.values(), mj.values(), rtol=0,
                                   atol=PAR)
        np.testing.assert_array_equal(mt.statuses(), mj.statuses())
        if "f" in exp:
            assert abs(mt.objective_value() - exp["f"]) < ATOL
        if "x" in exp:
            np.testing.assert_allclose(mt.values(), exp["x"], atol=ATOL)
    if mt.dual_status() == "FEASIBLE_POINT":
        dt, dj = mt.duals(), mj.duals()
        for k in ("eq", "ineq", "bounds"):
            np.testing.assert_allclose(dt[k], dj[k], rtol=0, atol=PAR)
    return mt, exp


# ---- the LP cases of tests/test_model.py --------------------------------

def basic_lp(M):
    # max 2x + 3y s.t. x + y <= 4, x, y >= 0 -> (0, 4), f = 12
    m = M()
    x, y = m.add_variables(2, lb=0.0)
    m.add_le({x: 1.0, y: 1.0}, 4.0)
    m.set_objective(lin={x: 2.0, y: 3.0}, sense="max")
    return m, dict(term=OPTIMAL, f=12.0, x=[0.0, 4.0])


def ge_and_interval(M):
    # min x + y s.t. x + 2y >= 2, 1 <= x - y <= 3, x, y in [0, 5]
    m = M()
    x, y = m.add_variables(2, lb=0.0, ub=5.0)
    m.add_ge({x: 1.0, y: 2.0}, 2.0)
    m.add_interval({x: 1.0, y: -1.0}, 1.0, 3.0)
    m.set_objective(lin={x: 1.0, y: 1.0})
    return m, dict(term=OPTIMAL, f=5.0 / 3.0, x=[4.0 / 3.0, 1.0 / 3.0])


def infeasible(M):
    m = M()
    x = m.add_variable(lb=0.0, ub=1.0)
    m.add_ge({x: 1.0}, 2.0)
    m.set_objective(lin={x: 1.0})
    return m, dict(term=INFEASIBLE)


def unbounded(M):
    m = M()
    x = m.add_variable(lb=0.0)
    y = m.add_variable(lb=0.0)
    m.add_ge({x: 1.0, y: 1.0}, 1.0)
    m.set_objective(lin={x: -1.0})
    return m, dict(term=INFEASIBLE_OR_UNBOUNDED)


def objective_constant(M):
    m = M()
    x = m.add_variable(lb=1.0, ub=2.0)
    m.add_le({x: 1.0}, 5.0)
    m.set_objective(lin={x: 1.0}, constant=10.0)
    return m, dict(term=OPTIMAL, f=11.0)


def auto_downgrade_to_lp(M):
    m = M()
    x = m.add_variable(lb=0.0, ub=1.0)
    m.add_le({x: 1.0}, 1.0)
    m.set_objective(quad={}, lin={x: -1.0})
    return m, dict(term=OPTIMAL, x=[1.0], lp=True)


def lp_round_trip(M):
    from ssqp_tpu.types import make_lp as jmake_lp
    from ssqp_tpu_torch import make_lp

    kw = dict(G=[[1.0, 1.0]], g=[4.0], u=[3.0, 3.0])
    if M is tmodel:
        P = make_lp([-1.0, -2.0], **kw, device="cpu")
        m = TModel.from_problem(P)
    else:
        m = JModel.from_problem(jmake_lp([-1.0, -2.0], **kw))
    return m, dict(term=OPTIMAL, x=[1.0, 3.0], lp=True)


# ---- the analytic presolve (mc == -20) ----------------------------------

def equality_only_lp(M):
    m = M()
    x, y = m.add_variables(2)  # free
    m.add_eq({x: 1.0, y: 1.0}, 2.0)
    m.add_eq({x: 1.0, y: -1.0}, 0.0)
    m.set_objective(lin={x: 1.0})
    return m, dict(term=OPTIMAL, x=[1.0, 1.0])


def unconstrained_qp(M):
    m = M()
    x = m.add_variable()
    m.set_objective(quad={(x, x): 2.0}, lin={x: -2.0})
    return m, dict(term=OPTIMAL, x=[1.0])


def unconstrained_lp_unbounded(M):
    m = M()
    x = m.add_variable()
    m.set_objective(lin={x: 1.0})
    return m, dict(term=INFEASIBLE_OR_UNBOUNDED)


def equality_qp_with_duals(M):
    # min x^2 + y^2 s.t. x + y = 2, free: the presolve's KKT solve and its
    # multiplier
    m = M()
    x, y = m.add_variables(2)
    m.add_eq({x: 1.0, y: 1.0}, 2.0)
    m.set_objective(quad={(x, x): 2.0, (y, y): 2.0})
    return m, dict(term=OPTIMAL, x=[1.0, 1.0], f=2.0)


CASES = [basic_lp, ge_and_interval, infeasible, unbounded,
         objective_constant, auto_downgrade_to_lp, lp_round_trip,
         equality_only_lp, unconstrained_qp, unconstrained_lp_unbounded,
         equality_qp_with_duals]


@pytest.mark.parametrize("build", CASES, ids=[c.__name__ for c in CASES])
def test_model_case_matches_jax(build):
    mt, exp = run_pair(build)
    if exp.get("lp"):
        assert isinstance(mt._problem, LP)  # downgraded (MOIwrapper.jl:120)


def test_refined_tier_matches_jax():
    """optimize(refine=True) with a float32 search on float64 data
    (tests/test_model.py::test_model_refined_tier), and the LP rejection."""
    rng = np.random.default_rng(11)
    N = 16
    H = rng.standard_normal((N, N))
    V = H @ H.T / N + 0.4 * np.eye(N)
    lin = rng.standard_normal(N)

    def build(M):
        m = M()
        m.add_variables(N, lb=0.0, ub=0.3)
        m.add_eq(np.ones(N), 1.0)
        m.set_objective(quad=2.0 * V, lin=lin)
        return m, dict(term=OPTIMAL)

    mj, _ = build(jmodel)
    mt, _ = build(tmodel)
    assert mj.optimize(refine=True, search_dtype=jnp.float32) == OPTIMAL
    assert mt.optimize(refine=True, search_dtype=torch.float32) == OPTIMAL
    assert abs(mt.objective_value() - mj.objective_value()) < PAR
    np.testing.assert_allclose(mt.values(), mj.values(), rtol=0, atol=PAR)
    np.testing.assert_allclose(mt.duals()["eq"], mj.duals()["eq"], rtol=0,
                               atol=PAR)
    ml = tmodel()
    ml.add_variables(2, lb=0.0, ub=1.0)
    ml.add_eq([1.0, 1.0], 1.0)
    ml.set_objective(lin=[1.0, 2.0])
    with pytest.raises(ValueError, match="refine"):
        ml.optimize(refine=True)


def test_bookkeeping():
    m = tmodel()
    m.add_variable(lb=0.0)
    assert m.termination_status() == OPTIMIZE_NOT_CALLED
    assert m.primal_status() == "NO_SOLUTION"
    with pytest.warns(UserWarning):
        m.add_le({}, 1.0)
    x = m.add_variable(lb=0.0, ub=2.0)
    m.add_le({x: 1.0}, 2.0)
    m.set_objective(quad={(x, x): 2.0}, lin={x: -2.0})
    assert m.optimize() == OPTIMAL
    assert m.solve_time >= 0.0 and m.iterations() >= 1
    assert "2 variables" in repr(m)
    with pytest.raises(ValueError):
        m.set_objective(sense="up")


def test_default_dtype_is_float32_and_device_is_kept():
    m = TModel(device="cpu")
    x = m.add_variable(lb=0.0, ub=1.0)
    m.add_le({x: 1.0}, 1.0)
    m.set_objective(quad={(x, x): 2.0}, lin={x: -1.0})
    P = m.to_problem()
    assert P.V.dtype == torch.float32 and P.V.device.type == "cpu"
    assert m.optimize() == OPTIMAL and abs(m.value(x) - 0.5) < 1e-6
    m2 = TModel.from_problem(P)
    assert m2.dtype == np.float32 and m2.device.type == "cpu"
