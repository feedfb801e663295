"""The conformance registry's LP cases (tests/conformance/registry.py) through
the port's engines on the CPU in float64: ``simplex_lp`` for the "simplex"
engine, ``solve_lp`` for "cclp" and the port's ``Model`` for "model" (its
termination status translated back to the raw status code, and the
objective checked on OPTIMAL, as the JAX runner does), with the checks of
tests/conformance/test_conformance.py::test_lp_conformance (status by the
expected outcome; for optima, feasibility within 1e-6, the objective within
the case's atol relative to max(1, |f|), x within 1e-5 where the case gives
it). Imports the registry, no JAX solver.
"""

import numpy as np
import pytest

from ssqp_tpu_torch import Model, make_lp, simplex_lp, solve_lp
from ssqp_tpu_torch.model import (
    INFEASIBLE, INFEASIBLE_OR_UNBOUNDED, NUMERICAL_ERROR, OPTIMAL)

from conformance.registry import REGISTRY

RUNS = [(c, e) for c in REGISTRY if c.kind == "lp" for e in c.engines]


def _via_model(P, case):
    """Route through the port's Model (the reference's MOI path)."""
    m = Model.from_problem(P)
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


@pytest.mark.parametrize("case,engine", RUNS,
                         ids=[f"{c.name}-{e}" for c, e in RUNS])
def test_lp_conformance(case, engine):
    P = make_lp(case.c, case.A, case.b, G=case.G, g=case.g, d=case.d,
                u=case.u, device="cpu")
    if engine == "model":
        x, st = _via_model(P, case)
    else:
        r = simplex_lp(P) if engine == "simplex" else solve_lp(P)
        x, st = r.x.numpy(), int(r.status)
    if case.expect == "optimal":
        assert st in (1, 2), f"{case.name}[{engine}]: status {st}"
        x = np.asarray(x, float)
        if case.A is not None and len(case.A):
            assert np.abs(case.A @ x - case.b).max() < 1e-6
        if case.G is not None and len(case.G):
            assert (case.G @ x - case.g).max() < 1e-6
        if case.d is not None:
            assert (case.d - x).max() < 1e-6
        if case.u is not None:
            assert (x - case.u).max() < 1e-6
        if case.f_opt is not None:
            f = float(np.asarray(case.c) @ x)
            assert abs(f - case.f_opt) <= case.atol * max(
                1.0, abs(case.f_opt)), (
                f"{case.name}[{engine}]: f={f} expected {case.f_opt}")
        if case.x_opt is not None:
            assert np.abs(x - case.x_opt).max() < 1e-5
    elif case.expect == "infeasible":
        assert st == 0, f"{case.name}[{engine}]: status {st}"
    elif case.expect == "unbounded":
        assert st == 3, f"{case.name}[{engine}]: status {st}"
    elif case.expect == "invalid":
        assert st == -1, f"{case.name}[{engine}]: status {st}"
    else:  # pragma: no cover
        raise AssertionError(case.expect)


def test_registry_lp_runs():
    """80 LP cases, 157 runs: 154 over the two engines and 3 through the
    Model."""
    lp = [c for c in REGISTRY if c.kind == "lp"]
    assert len(lp) == 80 and len(RUNS) == 157
    assert sum(e == "model" for _, e in RUNS) == 3
