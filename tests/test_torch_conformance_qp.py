"""The conformance registry's QP cases (tests/conformance/registry.py)
through the port on the CPU in float64: the 93 cases routed
``via="solver"`` through ``ssqp_tpu_torch.solve_qp`` and the 6 routed
``via="model"`` through the port's ``Model``, with the checks of
tests/conformance/test_conformance.py::test_qp_conformance (status by the
expected outcome; for optima the objective within the case's atol relative
to max(1, |f|) and the KKT residual of
ssqp_tpu/utils/problems.py::kkt_residual, a numpy oracle, below 10 atol).
Imports the registry and the oracle, no JAX solver.
"""

import numpy as np
import pytest

from ssqp_tpu.utils.problems import kkt_residual
from ssqp_tpu_torch import Model, make_qp, solve_qp
from ssqp_tpu_torch.model import (
    INFEASIBLE, INFEASIBLE_OR_UNBOUNDED, NUMERICAL_ERROR, OPTIMAL)

from conformance.registry import REGISTRY

QP_CASES = [c for c in REGISTRY if c.kind == "qp"]


def _via_model(Q, case):
    """Route through the port's Model and translate the termination status
    back into the raw status-code convention (as the JAX runner does)."""
    m = Model.from_problem(Q)
    term = m.optimize()
    if term == OPTIMAL:
        if case.f_opt is not None:
            f = m.objective_value()
            assert abs(f - case.f_opt) <= case.atol * max(
                1.0, abs(case.f_opt)), f"{case.name}[model]: f={f}"
        st = 1
    else:
        st = {INFEASIBLE: 0, INFEASIBLE_OR_UNBOUNDED: 3,
              NUMERICAL_ERROR: -1}.get(term, -7777)
    return m.values(), st


@pytest.mark.parametrize("case", QP_CASES, ids=[c.name for c in QP_CASES])
def test_qp_conformance(case):
    Q = make_qp(case.V, case.c, A=case.A, b=case.b, G=case.G, g=case.g,
                d=case.d, u=case.u, device="cpu")
    if case.via == "model":
        x, st = _via_model(Q, case)
    else:
        r = solve_qp(Q)
        x, st = r.x.numpy(), int(r.status)
    if case.expect == "optimal":
        assert st > 0, f"{case.name}: status {st}"
        x = np.asarray(x, float)
        f = float(0.5 * x @ np.asarray(case.V) @ x
                  + np.asarray(case.c) @ x)
        assert abs(f - case.f_opt) <= case.atol * max(1.0, abs(case.f_opt)), (
            f"{case.name}: f={f} expected {case.f_opt}")
        res = kkt_residual(*(getattr(Q, k).numpy() for k in
                             ("V", "q", "A", "b", "G", "g", "d", "u")),
                           x)["max"]
        assert res < 10 * case.atol, f"{case.name}: KKT residual {res:.2e}"
    elif case.expect == "infeasible":
        assert st == 0, f"{case.name}: status {st}"
    elif case.expect == "invalid":
        assert st == -1, f"{case.name}: status {st}"
    else:  # pragma: no cover
        raise AssertionError(case.expect)


def test_registry_qp_runs():
    """93 QP cases through the solver and 6 through the Model."""
    assert len(QP_CASES) == 99
    assert sum(c.via == "model" for c in QP_CASES) == 6
