"""The simplex kernel (``ops/csrc/simplex.cu``) against the host loop.

The route rule (``ops/simplex.py::uses_kernel``) is a pure function and is
tested here on the CPU. Every other test carries the ``cuda`` marker, skips
without a CUDA device, and holds the kernel (``bounded_simplex`` on CUDA
tensors) to the plain host loop (``bounded_simplex_loop``) run on the same
card tensors. No JAX:

    python -m pytest tests/test_torch_simplex_kernel.py -m cuda -q --noconftest

Tolerances: float64, every instance's status, basis, statuses and steps
equal and x within 1e-9; float32 at lp-mixed256's shape (256, 25, 245),
every status equal, basis, statuses and steps equal on at least 99% of
instances (a near-tie in float32 may go the other way in another summation
order), the objective within 1e-6 relative on every optimal instance.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from ssqp_tpu_torch import Settings, make_lp  # noqa: E402
from ssqp_tpu_torch.ops import simplex as ks  # noqa: E402
from ssqp_tpu_torch.solvers import lp as tlp  # noqa: E402
from ssqp_tpu_torch.solvers import simplex as ts  # noqa: E402
from ssqp_tpu_torch.solvers.phase1 import standardize_bounded  # noqa: E402
from ssqp_tpu_torch.types import DN, IN  # noqa: E402
from ssqp_tpu_torch.utils import diagnostics  # noqa: E402

F32, F64 = torch.float32, torch.float64


def test_route_rule():
    """The kernel takes CUDA tensors under the Dantzig rule whose instance
    fits a block's shared memory: lp-mixed256's (25, 245) in both dtypes;
    config 4's Phase 1 (110, 1234), the other rules and every CPU tensor
    run the host loop."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for dt in (F32, F64):
        assert ks.uses_kernel(cuda, "dantzig", 25, 245, dt)
        assert ks.uses_kernel("cuda:0", "dantzig", 25, 245, dt)
        assert not ks.uses_kernel(cuda, "dantzig", 110, 1234, dt)
        assert not ks.uses_kernel(cpu, "dantzig", 25, 245, dt)
        assert not ks.uses_kernel("cpu", "dantzig", 1, 3, dt)
        for rule in ("max_improvement", "steepest_edge"):
            assert not ks.uses_kernel(cuda, rule, 25, 245, dt)
            assert not ks.uses_kernel(cpu, rule, 25, 245, dt)
    assert not ks.uses_kernel(cuda, "dantzig", 25, 245, torch.float16)
    # the bytes at the cell's shape, and the widest Nt that fits at R = 25
    assert ks.smem_bytes(25, 245, F32) == 49123
    assert ks.smem_bytes(25, 245, F64) == 81123
    wide = max(n for n in range(245, 20000)
               if ks.smem_bytes(25, n, F32) <= ks.SMEM_PER_BLOCK)
    assert ks.uses_kernel(cuda, "dantzig", 25, wide, F32)
    assert not ks.uses_kernel(cuda, "dantzig", 25, wide + 1, F32)


# ---- on the card ------------------------------------------------------------

cuda = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _runs(args, **kw):
    """(kernel, host loop) on the same tensors; the kernel launches once,
    the loop never."""
    before = ks.LAUNCHES
    k = ts.bounded_simplex(*args, **kw)
    assert ks.LAUNCHES == before + 1
    h = ts.bounded_simplex_loop(*args, **kw)
    assert ks.LAUNCHES == before + 1
    torch.cuda.synchronize()
    return k, h


def _rows_equal(a, b):
    return (a == b).reshape(a.shape[0], -1).all(1)


def _exact(k, h, xtol=1e-9, x=True):
    """Every instance: status, x (within ``xtol``), basis, statuses, steps."""
    for name, i in (("status", 0), ("B", 2), ("S", 3), ("it", 4)):
        assert bool(_rows_equal(k[i], h[i]).all()), name
    if x:
        assert float((k[1] - h[1]).abs().max()) <= xtol


def _close(c, k, h):
    """The float32 bar: statuses equal; B, S and it equal on >= 99% of
    instances; the objective within 1e-6 relative where optimal."""
    assert torch.equal(k[0], h[0])
    n = k[0].shape[0]
    for i in (2, 3, 4):
        assert int(_rows_equal(k[i], h[i]).sum()) >= 0.99 * n
    fk = (c.double() * k[1].double()).sum(1)
    fh = (c.double() * h[1].double()).sum(1)
    opt = (h[0] == 1) | (h[0] == 2)
    assert bool(((fk - fh).abs()[opt]
                 <= 1e-6 * fh.abs()[opt].clamp(min=1.0)).all())


def _cell(seed, dev):
    """One lp-mixed256 request (256 instances of config 2, float32) from the
    benchmark's builder and traffic, standardized and purged."""
    from gpubench.configs import lp_n100
    from gpubench.traffic import lp_cbg

    cfg = json.loads((ROOT / "gpubench/configs/lp_n100.json").read_text())
    p = lp_n100.build(cfg, F32, dev)
    req = lp_cbg.Requests({"batch": 256}, seed, p, dev).request(0)
    P = dataclasses.replace(p.qp, c=req["c"], b=req["b"], g=req["g"])
    st = Settings.for_dtype(F32)
    return P, st, tlp._lp_prep(P.A, P.G, P.b, P.g, P.d, P.u, st, 256)


def _phase1_args(prep):
    A1 = prep.A1
    Bn, R, Nt = A1.shape
    c1 = torch.cat([torch.zeros((Bn, Nt - R), dtype=A1.dtype,
                                device=A1.device),
                    torch.ones((Bn, R), dtype=A1.dtype, device=A1.device)], 1)
    std = prep.std
    return (c1, A1, prep.b0p, std.d1, std.u1, std.B0, std.S0, std.d1,
            std.real)


def _phase2_args(P, prep, st):
    """Phase 2 from the Phase-1 exit and the drive-out."""
    start = tlp._lp_phase1(prep, st)
    c0 = tlp._lp_cost(prep, P.c, P.N, P.J, True)
    u2, real2 = tlp._phase2_bounds(prep)
    return (c0, prep.A1, prep.b0p, prep.std.d1, u2, start.B, start.S,
            start.x, real2)


@cuda
@pytest.mark.parametrize("phase", [1, 2])
@pytest.mark.parametrize("seed", [3000000019, 3000000029, 41, 2**31 + 7])
def test_kernel_matches_loop_at_the_cell_shape(dev, seed, phase):
    P, st, prep = _cell(seed, dev)
    assert tuple(prep.A1.shape) == (256, 25, 245)
    args = _phase1_args(prep) if phase == 1 else _phase2_args(P, prep, st)
    k, h = _runs(args, tol=st.tol, max_iter=st.max_iter)
    _close(args[0], k, h)
    assert bool(((h[0] == 1) | (h[0] == 2)).all())


def _family(dtype, dev, N=32, M=4, J=12, B=32, seed=3):
    """bench_suite.py::config2's generators, cut to N=32, M=4, J=12."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, N))
    G = rng.standard_normal((J, N))
    X0 = rng.uniform(0.1, 1.0, (B, N))
    P = make_lp(np.zeros(N), A, A @ X0[0], G=G, g=G @ X0[0] + 0.5,
                d=np.zeros(N), u=np.full(N, 2.0), dtype=np.float64,
                device="cpu")
    bat = dict(c=rng.standard_normal((B, N)), b=X0 @ A.T,
               g=X0 @ G.T + rng.uniform(0.1, 1.0, (B, J)))
    P = dataclasses.replace(P, **{k: torch.tensor(v) for k, v in bat.items()})
    P = P.astype(dtype).to(dev)
    st = Settings.for_dtype(dtype)
    return P, st, tlp._lp_prep(P.A, P.G, P.b, P.g, P.d, P.u, st, B)


@cuda
@pytest.mark.parametrize("phase", [1, 2])
def test_kernel_matches_loop_float64(dev, phase):
    P, st, prep = _family(F64, dev)
    args = _phase1_args(prep) if phase == 1 else _phase2_args(P, prep, st)
    k, h = _runs(args, tol=st.tol, max_iter=st.max_iter)
    _exact(k, h)


@cuda
@pytest.mark.parametrize("dtype", [F32, F64])
def test_kernel_pre_done_and_iteration_limit(dev, dtype):
    """pre_done instances return status 1 and their start untouched; a
    max_iter that cuts every instance gives -max_iter and it = max_iter."""
    P, st, prep = _family(dtype, dev)
    args = _phase1_args(prep)
    pd = torch.arange(32, device=dev) % 3 == 1
    k, h = _runs(args, tol=st.tol, max_iter=st.max_iter, pre_done=pd)
    _exact(k, h, xtol=1e-9 if dtype == F64 else 1e-5)
    assert bool((k[0][pd] == 1).all() and (k[4][pd] == 0).all())
    assert torch.equal(k[1][pd], args[7][pd])
    assert torch.equal(k[2][pd], args[5][pd])
    assert torch.equal(k[3][pd], args[6][pd])
    assert bool((k[0][~pd] > 0).all())
    k, h = _runs(args, tol=st.tol, max_iter=7)
    _exact(k, h, xtol=1e-9 if dtype == F64 else 1e-5)
    assert bool((k[0] == -7).all() and (k[4] == 7).all())


@cuda
@pytest.mark.parametrize("dtype", [F32, F64])
def test_kernel_singular_start_and_unbounded(dev, dtype):
    """A basis that repeats a column exits -1 at its first step; min -x0
    s.t. x0 - x1 + a = 0, x >= 0 is unbounded (3); its neighbour with
    x0 + x1 + a = 0 is optimal."""
    P, st, prep = _family(dtype, dev)
    args = list(_phase1_args(prep))
    B0 = args[5].clone()
    B0[5, 1] = B0[5, 0]
    args[5] = B0
    k, h = _runs(tuple(args), tol=st.tol, max_iter=st.max_iter)
    _exact(k, h, x=False)
    assert int(k[0][5]) == -1 and int(k[4][5]) == 1
    ok = torch.arange(32, device=dev) != 5
    assert float((k[1][ok] - h[1][ok]).abs().max()) <= (
        1e-9 if dtype == F64 else 1e-5)

    t = lambda v: torch.tensor(v, dtype=dtype, device=dev)
    A = t([[[1.0, -1.0, 1.0]], [[1.0, 1.0, 1.0]]])
    c = t([[-1.0, 0.0, 0.0]] * 2)
    zero = torch.zeros((2, 3), dtype=dtype, device=dev)
    u = torch.full((2, 3), float("inf"), dtype=dtype, device=dev)
    B0 = torch.full((2, 1), 2, dtype=torch.int64, device=dev)
    S0 = torch.tensor([[DN, DN, IN]] * 2, dtype=torch.int8, device=dev)
    real = torch.ones((2, 3), dtype=torch.bool, device=dev)
    k, h = _runs((c, A, zero[:, :1], zero, u, B0, S0, zero, real),
                 tol=st.tol, max_iter=100)
    _exact(k, h)
    assert k[0].tolist() == [3, 1]


def _box_family(B, R, n, seed, dev):
    """Small box LPs, slacks basic at x = 0, in float64: [G | I] x = b,
    0 <= x_j <= u_j (u_j in [1, 2]) on the n structural columns. Many
    instances take more steps than their Nt = n + R columns."""
    g = torch.Generator().manual_seed(seed)
    rand = lambda *s: torch.rand(s, generator=g, dtype=F64)
    G = rand(B, R, n) * 2 - 0.5
    A = torch.cat([G, torch.eye(R, dtype=F64).expand(B, R, R)], 2)
    b = rand(B, R) * n * 0.5
    c = torch.cat([0.3 - 2 * rand(B, n), torch.zeros((B, R), dtype=F64)], 1)
    Nt = n + R
    d = torch.zeros((B, Nt), dtype=F64)
    u = torch.cat([1 + rand(B, n), torch.full((B, R), float("inf"),
                                              dtype=F64)], 1)
    B0 = (n + torch.arange(R)).expand(B, R).clone()
    S0 = torch.full((B, Nt), DN, dtype=torch.int8)
    S0[:, n:] = IN
    real = torch.ones((B, Nt), dtype=torch.bool)
    return tuple(x.to(dev) for x in (c, A, b, d, u, B0, S0, d, real))


def _padded(args, k=40):
    """The same LPs with k more columns, zero and never eligible: the
    Bland switch at it > Nt moves past every run."""
    pad = lambda t, v: torch.cat(
        [t, torch.full(t.shape[:-1] + (k,), v, dtype=t.dtype,
                       device=t.device)], -1)
    c, A, b, d, u, B0, S0, x0, real = args
    return (pad(c, 0.0), pad(A, 0.0), b, pad(d, 0.0), pad(u, 1.0), B0,
            pad(S0, DN), pad(x0, 0.0), pad(real, False))


@cuda
def test_kernel_crosses_the_bland_switch(dev):
    """Runs longer than Nt steps switch to Bland's least index at it > Nt:
    the kernel follows the host loop there, and on the instances where the
    switch changes the path (found against the padded LPs, which never
    switch) too."""
    tol = Settings().tol
    longer = switched = 0
    for R, n, seed in ((3, 8, 1), (3, 5, 1), (6, 8, 0)):
        args = _box_family(8192, R, n, seed, dev)
        k, h = _runs(args, tol=tol, max_iter=7777)
        _exact(k, h)
        kp, hp = _runs(_padded(args), tol=tol, max_iter=7777)
        _exact(kp, hp)
        longer += int((k[4] > n + R + 1).sum())
        switched += int((~_rows_equal(k[2], kp[2]) | (k[4] != kp[4])).sum())
    assert longer >= 3 and switched >= 1


@cuda
def test_wide_float64_phase1_stays_on_the_host_loop(dev):
    """Config 4's Phase-1 shape (B, 110, 1234) in float64 does not fit a
    block: no launch, the host loop's result bit for bit."""
    rng = np.random.default_rng(4)
    N, M, J, B = 512, 10, 100, 2
    t = lambda a: torch.tensor(a, dtype=F64, device=dev)
    A, G = t(rng.standard_normal((M, N))), t(rng.standard_normal((J, N)))
    x0 = t(rng.uniform(-1, 1, N))
    std = standardize_bounded(A, G, A @ x0, G @ x0 + 0.5, x0 - 2, x0 + 2, B)
    R, Nt = std.A1.shape[1:]
    assert (R, Nt) == (110, 1234)
    c1 = torch.cat([torch.zeros((B, Nt - R), dtype=F64, device=dev),
                    torch.ones((B, R), dtype=F64, device=dev)], 1)
    args = (c1, std.A1, std.b0, std.d1, std.u1, std.B0, std.S0, std.d1,
            std.real)
    before = ks.LAUNCHES
    k = ts.bounded_simplex(*args, tol=Settings().tol, max_iter=5)
    h = ts.bounded_simplex_loop(*args, tol=Settings().tol, max_iter=5)
    assert ks.LAUNCHES == before
    for a, b in zip(k, h):
        assert torch.equal(a, b)


@cuda
@pytest.mark.parametrize("rule", ["max_improvement", "steepest_edge"])
def test_other_rules_stay_on_the_host_loop(dev, rule):
    P, st, prep = _family(F64, dev)
    args = _phase1_args(prep)
    before = ks.LAUNCHES
    k = ts.bounded_simplex(*args, tol=st.tol, max_iter=st.max_iter,
                           rule=rule)
    h = ts.bounded_simplex_loop(*args, tol=st.tol, max_iter=st.max_iter,
                                rule=rule)
    assert ks.LAUNCHES == before
    for a, b in zip(k, h):
        assert torch.equal(a, b)


@cuda
def test_kernel_wrapper_checks_and_shared_memory_rule(dev):
    """The C side's shared memory is the route rule's; CPU tensors and a
    shape wider than a block's shared memory raise, the latter from the C
    side's check; an empty batch launches nothing."""
    from ssqp_tpu_torch.ops import _build

    lib = _build.load()
    for R, Nt in ((1, 3), (25, 245), (40, 130), (110, 1234)):
        for f64, dt in ((0, F32), (1, F64)):
            assert lib.ssqp_simplex_smem_bytes(R, Nt, f64) == \
                ks.smem_bytes(R, Nt, dt)
    P, st, prep = _family(F64, dev)
    c1, A1, b, d, u, B0, S0, x0, real = _phase1_args(prep)
    cA = torch.ones_like(c1)
    invB = torch.eye(16, dtype=F64, device=dev).expand(32, 16, 16)
    with pytest.raises(ValueError):
        ks.simplex_run(*(t.cpu() for t in (c1, A1, b, d, u, real, cA, invB,
                                           B0, S0, x0)), None,
                       tol=st.tol, max_iter=10)
    R, Nt = 110, 1234
    z = lambda *shape: torch.zeros(shape, dtype=F32, device=dev)
    with pytest.raises(RuntimeError):
        ks.simplex_run(z(1, Nt), z(1, R, Nt), z(1, R), z(1, Nt), z(1, Nt),
                       torch.ones((1, Nt), dtype=torch.bool, device=dev),
                       z(1, Nt) + 1, torch.eye(R, device=dev)[None],
                       torch.arange(R, device=dev)[None],
                       torch.zeros((1, Nt), dtype=torch.int8, device=dev),
                       z(1, Nt), None, tol=st.tol, max_iter=10)
    before = ks.LAUNCHES
    out = ks.simplex_run(*(t[:0] for t in (c1, A1, b, d, u, real, cA, invB,
                                           B0, S0, x0)), None, tol=st.tol,
                         max_iter=10)
    assert ks.LAUNCHES == before and all(o.shape[0] == 0 for o in out)


@cuda
def test_kernel_route_records_one_trip(dev):
    """While a profiler records, a kernel call is one ``simplex_step``
    span, its launch record, and its instances' steps summed on the
    device; the LP batch path makes one launch a phase."""
    from ssqp_tpu_torch.parallel.batch import solve_lp_batch_auto

    P, st, prep = _cell(7, dev)
    args = _phase1_args(prep)
    torch.cuda.synchronize()
    diagnostics.clear_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        out = ts.bounded_simplex(*args, tol=st.tol, max_iter=st.max_iter)
        c = diagnostics.counters()
    assert c["simplex_step"] == 1
    assert c["simplex.instance_pivots"] == int(out[4].sum())
    assert c["simplex.launches"] == {(256, 25, 245, "float32"): 1}
    diagnostics.clear_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        res = solve_lp_batch_auto(P, st, ("A", "G", "d", "u"))
        c = diagnostics.counters()
    assert bool((res.status > 0).all())
    assert c["simplex_step"] == 2
    assert c["simplex.launches"] == {(256, 25, 245, "float32"): 2}
    diagnostics.clear_counters()
