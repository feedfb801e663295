"""The conformance registry's LP cases (tests/conformance/registry.py) through
the port's engines on the CPU in float64: ``simplex_lp`` for the "simplex"
engine and ``solve_lp`` for "cclp", with the checks of
tests/conformance/test_conformance.py::test_lp_conformance (status by the
expected outcome; for optima, feasibility within 1e-6, the objective within
the case's atol relative to max(1, |f|), x within 1e-5 where the case gives
it). The registry's "model" runs wait for the port's modelling layer.
Imports the registry, no JAX solver.
"""

import numpy as np
import pytest

from ssqp_tpu_torch import make_lp, simplex_lp, solve_lp

from conformance.registry import REGISTRY

RUNS = [(c, e) for c in REGISTRY if c.kind == "lp" for e in c.engines
        if e != "model"]


@pytest.mark.parametrize("case,engine", RUNS,
                         ids=[f"{c.name}-{e}" for c, e in RUNS])
def test_lp_conformance(case, engine):
    P = make_lp(case.c, case.A, case.b, G=case.G, g=case.g, d=case.d,
                u=case.u, device="cpu")
    r = simplex_lp(P) if engine == "simplex" else solve_lp(P)
    st = int(r.status)
    if case.expect == "optimal":
        assert st in (1, 2), f"{case.name}[{engine}]: status {st}"
        x = r.x.numpy()
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
    """80 LP cases, 154 runs over the two engines (the 3 "model" runs
    aside)."""
    lp = [c for c in REGISTRY if c.kind == "lp"]
    assert len(lp) == 80 and len(RUNS) == 154
