"""The QP cases of tests/test_model.py through both packages' ``Model``
(ssqp_tpu_torch/model.py against ssqp_tpu/model.py) on the CPU in float64,
with the checks of tests/test_torch_model.py (which holds the LP, presolve
and refined cases): the same status strings; objective, x and duals within
1e-9; the assembled arrays identical; the case's own optimum within 1e-6.
"""

import numpy as np
import pytest

from test_torch_model import OPTIMAL, run_pair


def basic_qp(M):
    # min x^2 + y^2 s.t. x + y = 2 -> (1, 1), f = 2
    m = M()
    x, y = m.add_variables(2, lb=0.0)
    m.add_eq({x: 1.0, y: 1.0}, 2.0)
    m.set_objective(quad={(x, x): 2.0, (y, y): 2.0})
    return m, dict(term=OPTIMAL, x=[1.0, 1.0], f=2.0)


def duplicate_quad_terms_accumulate(M):
    # (a, a) given twice: 1 + 1 = 2 -> the objective of basic_qp
    m = M()
    a, c = m.add_variables(2, lb=0.0)
    m.add_eq({a: 1.0, c: 1.0}, 2.0)
    m.set_objective(quad={(c, c): 2.0})
    for k, v in [((a, a), 1.0), ((a, a), 1.0)]:
        m._quad[k] = m._quad.get(k, 0.0) + v
    return m, dict(term=OPTIMAL, x=[1.0, 1.0], f=2.0)


def max_qp(M):
    # max -(x-1)^2 = -x^2 + 2x - 1 over [0, 5] -> x = 1, f = 0
    m = M()
    x = m.add_variable(lb=0.0, ub=5.0)
    m.add_le({x: 1.0}, 5.0)
    m.set_objective(quad={(x, x): -2.0}, lin={x: 2.0}, constant=-1.0,
                    sense="max")
    return m, dict(term=OPTIMAL, x=[1.0], f=0.0)


def qp_with_inequalities(M):
    # min 1/2||x||^2 s.t. x1 + x2 >= 1 -> (0.5, 0.5)
    m = M()
    x, y = m.add_variables(2)
    m.set_bounds(x, lb=-10.0, ub=10.0)
    m.set_bounds(y, lb=-10.0, ub=10.0)
    m.add_ge({x: 1.0, y: 1.0}, 1.0)
    m.set_objective(quad={(x, x): 1.0, (y, y): 1.0})
    return m, dict(term=OPTIMAL, x=[0.5, 0.5])


def qp_round_trip(M):
    # problem -> Model -> problem -> solve (reference QP2MOI/MOI2QP,
    # MOIwrapper.jl:461-509)
    from ssqp_tpu.types import make_qp as jmake_qp
    from ssqp_tpu.utils.problems import generate_qp_known_opt
    from ssqp_tpu_torch import Model, make_qp

    g = generate_qp_known_opt(seed=3, N=8, M=2, J=2)
    kw = dict(G=g.G, g=g.g, d=g.d, u=g.u)
    if M.__name__ == "tmodel":
        m = Model.from_problem(make_qp(g.V, g.q, g.A, g.b, **kw,
                                       device="cpu"))
        P = m.to_problem()
        np.testing.assert_allclose(P.V.numpy(), (g.V + g.V.T) / 2,
                                   atol=1e-12)
    else:
        from ssqp_tpu.model import Model as JModel

        m = JModel.from_problem(jmake_qp(g.V, g.q, g.A, g.b, **kw))
    return m, dict(term=OPTIMAL, x=g.x_opt)


CASES = [basic_qp, duplicate_quad_terms_accumulate, max_qp,
         qp_with_inequalities, qp_round_trip]


@pytest.mark.parametrize("build", CASES, ids=[c.__name__ for c in CASES])
def test_model_qp_case_matches_jax(build):
    mt, _ = run_pair(build)
    d = mt.duals()
    assert d["eq"].shape == (mt.to_problem().M,)
