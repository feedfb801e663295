"""The port's spans and counters (ssqp_tpu_torch/utils/diagnostics.py) on the
CPU: nothing records without a profiler; under a CPU ``torch.profiler``
session the solver's ranges and the registry's counters appear; the plain
CG counts each row's steps as the kernel does; ``trace()`` writes the
ranges into its Chrome trace.

Problems: bench.py's frontier generator cut to N = 16 (V = HH'/N + 0.5 I,
mu ~ U(0, 0.2), 1'x = 1, 0 <= x <= 4/N) on a sorted lambda grid of B = 16
points, float64. No JAX.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ssqp_tpu_torch import Settings, make_qp
from ssqp_tpu_torch.ops import cg
from ssqp_tpu_torch.parallel import batch as tb
from ssqp_tpu_torch.solvers import ssqp as ts
from ssqp_tpu_torch.solvers.phase1 import init_qp_traced
from ssqp_tpu_torch.utils import diagnostics

N, B = 16, 16


def frontier(seed=3):
    """(batch, shared) of the frontier grid."""
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((N, N))
    V = H @ H.T / N + 0.5 * np.eye(N)
    mu = rng.uniform(0.0, 0.2, N)
    Q = make_qp(V, mu, u=np.full(N, 4.0 / N), dtype=np.float64,
                device="cpu")
    return tb.frontier_batch(Q, np.linspace(0.0, 2.0, B))


def profiled(fn):
    """(result, names of the ``ssqp.`` ranges, counters) of one call under a
    CPU profiler, the registry cleared first."""
    diagnostics.clear_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    names = [e.name for e in prof.events() if e.name.startswith("ssqp.")]
    return out, names, diagnostics.counters()


def test_nothing_records_without_a_profiler():
    Qb, sh = frontier()
    diagnostics.clear_counters()
    assert diagnostics.span("s_loop_trip") is diagnostics.span("x")
    res = tb.solve_qp_batch_auto(Qb, Settings(), sh)
    assert bool((res.status > 0).all())
    assert diagnostics.counters() == {}


def test_profiled_solve_records_loops_and_route():
    Qb, sh = frontier()
    res, names, c = profiled(lambda: tb.solve_qp_batch_auto(Qb, Settings(),
                                                            sh))
    assert bool((res.status > 0).all())
    for name in ("s_loop_trip", "pdas_round", "attach_duals", "route.plain"):
        assert names.count("ssqp." + name) == c[name] >= 1
    assert c["route.plain"] == 1 and "route.tail" not in c
    assert "s_loop.instance_iters" in c
    # every instance attempts at least one PDAS round
    assert c["pdas.instance_rounds"] >= B
    assert names.count("ssqp.phase1_fallback") == c.get("phase1_fallback",
                                                         0)
    assert "cg.launches" not in c  # a CPU tensor launches no kernel


def test_tail_route_records_its_passes(monkeypatch):
    """tail=4 with the residual bound at 0: four passes of B/4 instances."""
    Qb, sh = frontier()
    monkeypatch.setattr(tb, "_tail_resid_bound", lambda n: 0.0)
    res, names, c = profiled(lambda: tb.solve_qp_batch_auto(
        Qb, Settings(), sh, tail=4))
    assert bool((res.status > 0).all())
    assert c["route.tail"] == 1 and names.count("ssqp.route.tail") == 1
    assert c["tail_pass"] == names.count("ssqp.tail_pass") == 4
    assert c["tail.refined"] == B
    assert 0 <= c["tail.accepted"] <= B


def test_s_loop_counts_each_instance_iteration():
    """One S-loop call from Phase 1 in which every instance solves: the
    instance-iterations are the sum of the statuses (each the instance's
    iteration count), and the trips one more than the longest."""
    Qb, sh = frontier()
    st = tb.settings_for_shared(Settings(), sh)
    x0, Sx0, Se0, st1 = init_qp_traced(Qb, st)
    res, names, c = profiled(lambda: ts.solve_qp_loop(
        Qb, Sx0, Se0, x0, st, pre_status=st1))
    assert bool((res.status > 0).all())
    assert c["s_loop.instance_iters"] == int(res.status.sum())
    assert c["s_loop_trip"] == int(res.status.max()) + 1
    assert names.count("ssqp.s_loop_trip") == c["s_loop_trip"]


@pytest.mark.parametrize("entry", ["reference", "padded_rows"])
def test_cg_counts_one_step_on_a_diagonal_v(entry):
    """Jacobi-preconditioned CG on a diagonal V ends in one step; a row
    started at its solution runs none."""
    C = 6
    d = torch.linspace(1.0, 3.0, N, dtype=torch.float64)
    V = torch.diag(d)
    fmr = torch.ones((C, N), dtype=torch.float64)
    fmr[1, :4] = 0.0  # fixed coordinates: the identity there
    dinvr = 1.0 / (fmr * d + (1.0 - fmr))
    Br = torch.tensor(np.random.default_rng(0).standard_normal((C, N)))
    tol2r = 1e-20 * (Br * Br).sum(1, keepdim=True)
    X0r = torch.zeros_like(Br)
    X0r[4] = Br[4] * dinvr[4]  # the solution
    steps = torch.full((C,), -1, dtype=torch.int32)
    fn = cg.cg_rows_reference if entry == "reference" else cg.cg_padded_rows
    X, rr = fn(V, fmr, dinvr, Br, tol2r, 40, X0r, None, steps)
    assert steps.tolist() == [1, 1, 1, 1, 0, 1]
    torch.testing.assert_close(X, Br * dinvr, rtol=1e-14, atol=0)
    assert bool((rr <= tol2r).all())


def test_trace_writes_program_ranges(tmp_path):
    """The registry holds the traced region's counters alone."""
    Qb, sh = frontier()
    _, _, before = profiled(lambda: tb.solve_qp_batch_auto(Qb, Settings(),
                                                           sh))
    with diagnostics.trace(str(tmp_path)):
        res = tb.solve_qp_batch_auto(Qb, Settings(), sh)
    assert bool((res.status > 0).all())
    assert diagnostics.counters() == before
    (path,) = [os.path.join(tmp_path, f) for f in os.listdir(tmp_path)]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"ssqp.route.plain", "ssqp.s_loop_trip",
            "ssqp.pdas_round"} <= names
