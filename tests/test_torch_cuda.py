"""The port on the card: the hand-written CUDA kernels (CG, Cholesky) against
their plain PyTorch versions, and the solver slice on CUDA tensors against
the same slice on CPU tensors (where every kernel runs its plain version).

Every test here carries the ``cuda`` marker and skips without a CUDA device.
The file imports no JAX, so it runs on a machine that has PyTorch only:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

Tolerances:
  * kernel vs plain version on X: float32 5e-4 (tests/test_pallas_cg.py's
    bound), float64 1e-9; with the iteration cap hit (no row converges)
    float32 1e-4 and float64 1e-10, as tests/test_torch_cg.py;
  * the float32 tensor-core body: a row's X alone and inside a full batch
    within 1e-6 (the same row, another tile's company: only the tile size
    may change its summation order); its float64 true residual no more than
    4x the plain float32 version's (one-pass TF32 would be ~1e3x);
  * Cholesky kernel vs plain version (both on the card, SPD batches of
    condition number 100): float32 1e-4 and float64 1e-10, relative to
    max|X| (the same recurrence in another summation order), and the float64
    residual |A X - RHS| within 1e-2 (float32) and 1e-9 (float64); on non-PD
    input neither returns a solution;
  * the float32 blocked Cholesky body: as above against the plain version;
    bit for bit where only data it never reads differ (the lower triangle)
    or where the same instance is solved in another batch (each instance is
    one block, its sums in a fixed order);
  * CUDA vs CPU solves, float64: status and S equal, x within 1e-9;
    float32: the same solved count, objective within 1e-5 relative, S equal
    on at least 90% of instances;
  * the R >= 16 class through solve_qp_batch_auto with tail=4: float64
    status and S equal, x within 1e-6 (the refinement's correction runs in
    float32 on a CUDA tensor and in float64 on a CPU tensor, the JAX
    package's rule); float32 all solved, objective within 1e-6 relative;
  * the QP batch protocols (waves, c2f, compaction) on the card against the
    same call on the CPU: float64 status and S equal, x within 1e-9;
    float32 all solved, objective within 1e-5 relative;
  * the refined tiers (float32 search, float64 data): x within 1e-9 of the
    CPU's and of the plain float64 solve; the LU tier in float64 from one
    searched point: x and lam within 1e-9; the double-double pair as on
    the CPU (x_hi 1e-12, x_lo 1e-20);
  * the Cholesky kernel at the LP path's (B, 25, 1): as above, 1e-4
    relative to max|X|;
  * the LP engines and batch protocols on the card against the same call
    on the CPU: float64 status equal, objective within 1e-9 relative, and
    for the simplex routes S equal and x within 1e-9 (criss-cross walks
    depend on the backend's inverse: status and objective only); float32
    the same statuses, objective within 5e-5 relative;
  * the PDAS variants (Chebyshev, W-PCG) on the card against the same call
    on the CPU: float64 S equal and x within 1e-9, float32 objective
    within 1e-5 relative; the Chebyshev interval on the card encloses the
    float64 spectrum; the CG kernel at N = 1024 (tensor-core body) and
    1025 (first body) within 5e-4 of the plain version.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ssqp_tpu_torch import Settings, make_qp
from ssqp_tpu_torch.ops import cg, chol
from ssqp_tpu_torch.parallel import batch as tb
from ssqp_tpu_torch.solvers import ssqp as ts

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 5e-4, torch.float64: 1e-9}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cg_problem(seed, N, K, batch, dtype, per_instance=False):
    rng = np.random.default_rng(seed)

    def spd():
        H = rng.standard_normal((N, N))
        return H @ H.T / N + 0.5 * np.eye(N)

    V = np.stack([spd() for _ in range(batch)]) if per_instance else spd()
    FM = (rng.uniform(size=(batch, N)) < 0.7).astype(np.float64)
    DINV = 1.0 / (FM * np.diagonal(V, axis1=-2, axis2=-1) + (1.0 - FM))
    B = rng.standard_normal((batch, N, K))
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    TOL2 = rtol * rtol * np.maximum((B * B).sum(1), 1e-30)
    return [torch.tensor(a, dtype=dtype) for a in (V, FM, B, DINV, TOL2)]


def _both(args, iters, X0, dev):
    """(kernel result on the card, plain result on the CPU), as numpy."""
    before = cg.LAUNCHES
    Xk, rrk = cg.cg_padded_batch(*(a.to(dev) for a in args), iters, X0.to(dev))
    assert cg.LAUNCHES == before + 1
    Xp, rrp = cg.cg_padded_batch(*args, iters, X0)
    return Xk.cpu().numpy(), rrk.cpu().numpy(), Xp.numpy(), rrp.numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("per_instance", [False, True])
@pytest.mark.parametrize("N,K,batch", [(37, 3, 6), (256, 2, 64), (300, 1, 5),
                                       (1, 2, 3)])
def test_kernel_matches_plain_version(dev, dtype, per_instance, N, K, batch):
    """Odd N (no padding), N above one thread per column (300), a row count
    that is not a multiple of the row tile, shared and per-instance V."""
    args = _cg_problem(N + K, N, K, batch, dtype, per_instance)
    X0 = torch.zeros_like(args[2])
    Xk, rrk, Xp, rrp = _both(args, 300, X0, dev)
    tol2 = args[4].numpy()
    assert np.isfinite(Xk).all()
    np.testing.assert_allclose(Xk, Xp, rtol=0, atol=TOL[dtype])
    assert (rrk <= 1.01 * tol2).all() and (rrp <= 1.01 * tol2).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("iters", [3, 11])
def test_kernel_iteration_cap_matches_plain_version(dev, dtype, iters):
    """tol2 = 0: no row converges, both run exactly ``iters`` steps (11
    checks the chunk clamp at a non-multiple of 8)."""
    V, FM, B, DINV, TOL2 = _cg_problem(5, 40, 2, 7, dtype)
    args = (V, FM, B, DINV, torch.zeros_like(TOL2))
    Xk, rrk, Xp, rrp = _both(args, iters, torch.zeros_like(B), dev)
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    np.testing.assert_allclose(Xk, Xp, rtol=0, atol=tol)
    np.testing.assert_allclose(rrk, rrp, rtol=2e-2 if dtype == torch.float32
                               else 1e-8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_leaves_converged_warm_start_alone(dev, dtype):
    V, FM, B, DINV, TOL2 = _cg_problem(3, 16, 2, 3, dtype)
    f = FM.double()
    Vp = f.unsqueeze(-1) * f.unsqueeze(-2) * V.double() \
        + torch.diag_embed(1.0 - f)
    X0 = torch.linalg.solve(Vp, B.double()).to(dtype)
    Xk, _, Xp, _ = _both((V, FM, B, DINV, TOL2 * 1e4), 100, X0, dev)
    np.testing.assert_array_equal(Xk, X0.numpy())
    np.testing.assert_array_equal(Xp, X0.numpy())


def test_kernel_wrapper_checks_and_empty_batch(dev):
    V, FM, B, DINV, TOL2 = (t.to(dev) for t in
                            _cg_problem(1, 8, 2, 2, torch.float32))
    Br, X0r, fmr, dinvr, tol2r = cg._rows(B, FM, DINV, TOL2, torch.zeros_like(B))
    before = cg.LAUNCHES
    X, rr = cg.cg_padded_rows(V, fmr[:0], dinvr[:0], Br[:0], tol2r[:0], 10,
                              X0r[:0])
    assert X.shape == (0, 8) and rr.shape == (0, 1)
    assert cg.LAUNCHES == before  # nothing to launch for zero rows
    with pytest.raises(ValueError):
        cg.cg_padded_rows(V.double(), fmr, dinvr, Br, tol2r, 10, X0r)
    with pytest.raises(ValueError):
        cg.cg_padded_rows(V, fmr.cpu(), dinvr, Br, tol2r, 10, X0r)
    with pytest.raises(ValueError):
        cg.cg_padded_rows(V, fmr, dinvr, Br, tol2r[:, :0], 10, X0r)


def _frontier(dtype, N=32, B=16):
    rng = np.random.default_rng(7)
    H = rng.standard_normal((N, N))
    V = H @ H.T / N + 0.5 * np.eye(N)
    mu = rng.uniform(0.0, 0.2, N)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    Q = make_qp(V.astype(npdt), mu.astype(npdt), u=np.full(N, 4.0 / N, npdt),
                dtype=npdt, device="cpu")
    return Q, np.linspace(0.001, 2.0, B)


def _obj(Q, x):
    V, q = Q.V.double().cpu().numpy(), Q.q.double().cpu().numpy()
    x = x.astype(np.float64)
    return 0.5 * np.einsum("bi,ij,bj->b", x, V, x) + (q * x).sum(1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mf", [True, False])
def test_frontier_batch_on_card_matches_cpu(dev, dtype, mf):
    """multi_free on: the PDAS guess path; off: Phase-1 simplex + the exact
    S-loop, which the N=256 main path rarely reaches."""
    Q, lams = _frontier(dtype)
    st = dataclasses.replace(Settings.for_dtype(dtype), multi_free=mf)
    Qb, sh = tb.frontier_batch(Q, lams)
    rc = tb.solve_qp_batch(Qb, st, shared=sh).numpy()
    cg.LAUNCHES = 0
    Qg, shg = tb.frontier_batch(Q.to(dev), lams)
    rg = tb.solve_qp_batch(Qg, st, shared=shg).numpy()
    assert cg.LAUNCHES > 0
    assert (rc.status > 0).all() and (rg.status > 0).all()
    if dtype == torch.float64:
        np.testing.assert_array_equal(rg.status, rc.status)
        np.testing.assert_array_equal(rg.S, rc.S)
        np.testing.assert_allclose(rg.x, rc.x, rtol=0, atol=1e-9)
        np.testing.assert_allclose(rg.lam, rc.lam, rtol=0, atol=1e-9)
    else:
        fc, fg = _obj(Qb, rc.x), _obj(Qb, rg.x)
        assert (np.abs(fg - fc) <= 1e-5 * np.maximum(1.0, np.abs(fc))).all()
        assert (rg.S == rc.S).all(axis=1).mean() >= 0.9


def _with_inequalities(seed, N=10, J=3):
    """A feasible box QP with one budget row and J inequality rows, two of
    them active at a feasible point built into g."""
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((N, N))
    V = H @ H.T / N + 0.1 * np.eye(N)
    x_f = np.full(N, 1.0 / N)
    G = rng.standard_normal((J, N))
    g = G @ x_f + np.r_[np.zeros(2), rng.uniform(0.1, 0.5, J - 2)]
    return make_qp(V, rng.standard_normal(N), G=G, g=g, u=np.full(N, 0.5),
                   device="cpu")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mf", [True, False])
def test_solve_qp_with_inequalities_on_card_matches_cpu(dev, seed, mf):
    """J > 0 (R = 4 < 16) on the card: the Gauss-Jordan purge, dropped-row
    multipliers, the row ratio test and Phase-1's slack columns."""
    Q = _with_inequalities(seed)
    st = Settings(multi_free=mf)
    rc = ts.solve_qp(Q, settings=st).numpy()
    rg = ts.solve_qp(Q.to(dev), settings=st).numpy()
    assert int(rc.status) > 0
    assert int(rg.status) == int(rc.status)
    np.testing.assert_array_equal(rg.S, rc.S)
    np.testing.assert_allclose(rg.x, rc.x, rtol=0, atol=1e-9)


def test_per_instance_V_batch_on_card_matches_cpu(dev):
    """Every leaf batched: the kernel's per-instance-V form on the solver's
    path (PDAS round 1's shared W is off)."""
    qps = [_frontier(torch.float64, N=12)[0]]
    rng = np.random.default_rng(3)
    for s in range(3):
        H = rng.standard_normal((12, 12))
        qps.append(make_qp(H @ H.T / 12 + 0.5 * np.eye(12),
                           rng.uniform(-0.2, 0.0, 12), u=np.full(12, 0.3),
                           device="cpu"))
    Qb = tb.stack_qps(qps)
    rc = tb.solve_qp_batch(Qb, Settings()).numpy()
    rg = tb.solve_qp_batch(Qb.to(dev), Settings()).numpy()
    assert (rc.status > 0).all()
    np.testing.assert_array_equal(rg.status, rc.status)
    np.testing.assert_array_equal(rg.S, rc.S)
    np.testing.assert_allclose(rg.x, rc.x, rtol=0, atol=1e-9)


def _spd(rng, B, n, kappa=100.0):
    Qm, _ = np.linalg.qr(rng.standard_normal((B, n, n)))
    A = (Qm * np.logspace(0.0, np.log10(kappa), n)) @ Qm.transpose(0, 2, 1)
    return (A + A.transpose(0, 2, 1)) / 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [16, 110, 111, 256, 512])
@pytest.mark.parametrize("kcol", ["0", "1", "3", "n"])
def test_chol_kernel_matches_plain_version(dev, dtype, n, kcol):
    """Shared-memory form (n <= ~160 in float32 with K <= n), the
    device-memory form (n = 256, 512), odd n, K = 0."""
    rng = np.random.default_rng(n)
    K = n if kcol == "n" else int(kcol)
    B = 3 if n < 256 else 2
    A = torch.tensor(_spd(rng, B, n), dtype=dtype, device=dev)
    R = torch.tensor(rng.standard_normal((B, n, K)), dtype=dtype, device=dev)
    before = chol.LAUNCHES
    Xk = chol.chol_solve_batch(A, R)
    assert chol.LAUNCHES == before + (K > 0)
    Xp = chol.chol_solve_reference(A, R)
    torch.cuda.synchronize()
    assert Xk.shape == (B, n, K) and Xk.dtype == dtype
    if K:
        tol = (1e-4 if dtype == torch.float32 else 1e-10) * float(
            Xp.abs().max())
        assert float((Xk - Xp).abs().max()) <= tol
        Xd = Xk.double().cpu().numpy()
        res = np.abs(A.double().cpu().numpy() @ Xd
                     - R.double().cpu().numpy()).max()
        assert res <= (1e-2 if dtype == torch.float32 else 1e-9)


@pytest.mark.parametrize("n", [20, 300])
def test_chol_kernel_on_non_pd_input(dev, n):
    """A negative and a zero pivot: no fault, and neither the kernel nor the
    plain version returns a solution; the good instance is solved."""
    rng = np.random.default_rng(5)
    A = _spd(rng, 3, n)
    A[0, 5, 5] = -1.0
    A[1, 7, :] = A[1, :, 7] = 0.0
    R = rng.standard_normal((3, n, 2))
    At = torch.tensor(A, dtype=torch.float32, device=dev)
    Rt = torch.tensor(R, dtype=torch.float32, device=dev)
    for X in (chol.chol_solve_batch(At, Rt), chol.chol_solve_reference(At, Rt)):
        X = X.double().cpu().numpy()
        for b in (0, 1):
            bad = (not np.isfinite(X[b]).all()
                   or np.abs(A[b] @ X[b] - R[b]).max() > 1e-2)
            assert bad, b
        assert np.abs(A[2] @ X[2] - R[2]).max() < 1e-3


def test_chol_wrapper_checks(dev):
    A = torch.eye(16, device=dev).expand(2, 16, 16).contiguous()
    R = torch.ones((2, 16, 1), device=dev)
    with pytest.raises(ValueError):
        chol.chol_solve_batch(A.half(), R.half())
    with pytest.raises(ValueError):
        chol.chol_solve_batch(A, R.double())
    with pytest.raises(ValueError):
        chol.chol_solve_batch(A, R[:, :8])
    before = chol.LAUNCHES
    assert chol.chol_solve_batch(A[:0], R[:0]).shape == (0, 16, 1)
    assert chol.LAUNCHES == before
    X = chol.chol_solve_batch(A, R)
    assert torch.equal(X, R)


# ---- the float32 blocked Cholesky body ------------------------------------


def _blocked_max_n(K):
    """The largest n the blocked body takes at this K (its rule)."""
    return max(n for n in range(16, 400) if chol.body(n, K) == "blocked")


def _chol_check(A, R, Xk):
    """Xk against the plain version (1e-4 max|X|) and the residual (1e-2)."""
    Xp = chol.chol_solve_reference(A, R)
    torch.cuda.synchronize()
    assert Xk.shape == R.shape and bool(torch.isfinite(Xk).all())
    assert float((Xk - Xp).abs().max()) <= 1e-4 * float(Xp.abs().max())
    Ad, Xd, Rd = A.double(), Xk.double(), R.double()
    assert float((Ad @ Xd - Rd).abs().max()) <= 1e-2


@pytest.mark.parametrize("n,kcol", [
    (n, k) for n in ("16", "17", "31", "32", "33", "47", "110", "111")
    for k in ("1", "3", "100", "n")] + [("max", "1"), ("max", "3")])
def test_blocked_chol_panel_edges(dev, n, kcol):
    """n one below, at and one above a multiple of the 16-row panel, the main
    path's n = 110, and the largest n the body takes at K = 1 (K = 1, 3
    there: K = 100 or n does not fit)."""
    n = _blocked_max_n(1) if n == "max" else int(n)
    K = n if kcol == "n" else int(kcol)
    assert chol.body(n, K) == "blocked"
    rng = np.random.default_rng(1000 + n + K)
    A = torch.tensor(_spd(rng, 2, n), dtype=torch.float32, device=dev)
    R = torch.tensor(rng.standard_normal((2, n, K)), dtype=torch.float32,
                     device=dev)
    before, by_shape = chol.LAUNCHES, chol.LAUNCHES_BY_SHAPE[(2, n, K)]
    Xk = chol.chol_solve_batch(A, R)
    assert chol.LAUNCHES == before + 1
    assert chol.LAUNCHES_BY_SHAPE[(2, n, K)] == by_shape + 1
    _chol_check(A, R, Xk)


def test_blocked_chol_body_rule(dev):
    """float32 main-path shapes take the blocked body; float64, and float32
    past its shared-memory fit, the rank-1 body."""
    for K in (1, 100, 110):
        assert chol.body(110, K) == "blocked"
        assert chol.body(110, K, torch.float64) == "rank1-shared"
    assert chol.body(512, 1) == "rank1-device"
    assert chol.body(512, 111) == "rank1-device"
    nmax = _blocked_max_n(1)
    assert 200 <= nmax < 256
    assert chol.body(nmax + 1, 1) != "blocked"


@pytest.mark.parametrize("K", [1, 110])
def test_blocked_chol_reads_the_upper_triangle_only(dev, K):
    """A not exactly symmetric A: the kernel agrees with the plain version
    (both read the upper triangle) and gives bit for bit what it gives on
    the upper triangle mirrored."""
    rng = np.random.default_rng(K)
    A = _spd(rng, 3, 110)
    il = np.tril_indices(110, -1)
    A_up = A.copy()
    A_up[:, il[0], il[1]] = A_up[:, il[1], il[0]]  # mirrored upper
    A[:, il[0], il[1]] += rng.uniform(-0.5, 0.5, (3, il[0].size))
    At = torch.tensor(A, dtype=torch.float32, device=dev)
    Au = torch.tensor(A_up, dtype=torch.float32, device=dev)
    R = torch.tensor(rng.standard_normal((3, 110, K)), dtype=torch.float32,
                     device=dev)
    Xk = chol.chol_solve_batch(At, R)
    assert torch.equal(Xk, chol.chol_solve_batch(Au, R))
    Xp = chol.chol_solve_reference(At, R)
    assert float((Xk - Xp).abs().max()) <= 1e-4 * float(Xp.abs().max())


@pytest.mark.parametrize("K", [1, 100])
def test_blocked_chol_non_pd_instances(dev, K):
    """A negative pivot inside a panel (row 40), one on a panel boundary
    (row 48) and a NaN on the diagonal (row 70): no fault and no solution
    there; the other instances bit for bit as when solved alone."""
    rng = np.random.default_rng(7 + K)
    A = _spd(rng, 5, 110)
    A[0, 40, 40] = A[1, 48, 48] = -1.0
    A[2, 70, 70] = np.nan
    R = rng.standard_normal((5, 110, K))
    At = torch.tensor(A, dtype=torch.float32, device=dev)
    Rt = torch.tensor(R, dtype=torch.float32, device=dev)
    X = chol.chol_solve_batch(At, Rt)
    torch.cuda.synchronize()
    Xn = X.double().cpu().numpy()
    for b in range(3):
        assert (not np.isfinite(Xn[b]).all()
                or np.abs(A[b] @ Xn[b] - R[b]).max() > 1e-2), b
    assert torch.equal(X[3:], chol.chol_solve_batch(At[3:], Rt[3:]))
    _chol_check(At[3:], Rt[3:], X[3:])


@pytest.mark.parametrize("B", [1, 300])
@pytest.mark.parametrize("K", [1, 110])
def test_blocked_chol_batch_sizes(dev, B, K):
    """One instance, and more blocks than one wave of the card: every
    instance as the plain version, the first bit for bit as alone."""
    rng = np.random.default_rng(B + K)
    A = torch.tensor(_spd(rng, B, 110), dtype=torch.float32, device=dev)
    R = torch.tensor(rng.standard_normal((B, 110, K)), dtype=torch.float32,
                     device=dev)
    X = chol.chol_solve_batch(A, R)
    _chol_check(A, R, X)
    assert torch.equal(X[:1], chol.chol_solve_batch(A[:1], R[:1]))


def _ineq_class(dtype, N=32, M=2, J=16, B=8, seed=4):
    """BASELINE config 4's generator cut to N=32, M=2, J=16 (R = 18):
    shared V, A, b, G, g, d, u; q ~ N(0, 1) per instance."""
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((N, N))
    V = H @ H.T / N + 0.5 * np.eye(N)
    A = rng.standard_normal((M, N))
    x0 = rng.uniform(0.0, 1.0, N)
    G = rng.standard_normal((J, N))
    g = G @ x0 + rng.uniform(0.1, 1.0, J)
    q = rng.standard_normal((B, N))
    npdt = np.float32 if dtype == torch.float32 else np.float64
    Q = make_qp(V, np.zeros(N), A, A @ x0, G=G, g=g, d=x0 - 2.0, u=x0 + 2.0,
                dtype=npdt, device="cpu")
    return dataclasses.replace(Q, q=torch.tensor(q, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ineq_class_with_tail_on_card_matches_cpu(dev, dtype):
    """R >= 16 on the card: the QR purge, the Cholesky kernel (float32), the
    dropped-row multipliers and the tail refinement. In float64 the card
    and the CPU run the same float64 search and no tail pass, so x agrees
    to 1e-9; in float32, objectives within 1e-6 relative."""
    Q = _ineq_class(dtype)
    shared = ("V", "A", "G", "b", "g", "d", "u")
    st = Settings.for_dtype(dtype)
    rc = tb.solve_qp_batch_auto(Q, st, shared, tail=4).numpy()
    cg.LAUNCHES = chol.LAUNCHES = 0
    rg = tb.solve_qp_batch_auto(Q.to(dev), st, shared, tail=4).numpy()
    assert cg.LAUNCHES > 0
    # float64 searches stay below the tail's residual bound, so no float32
    # correction (and no float32 SPD solve) runs there
    assert (chol.LAUNCHES > 0) == (dtype == torch.float32)
    assert (rc.status > 0).all() and (rg.status > 0).all()
    if dtype == torch.float64:
        np.testing.assert_array_equal(rg.status, rc.status)
        np.testing.assert_array_equal(rg.S, rc.S)
        np.testing.assert_allclose(rg.x, rc.x, rtol=0, atol=1e-9)
    else:
        fc, fg = _obj(Q, rc.x), _obj(Q, rg.x)
        assert (np.abs(fg - fc) <= 1e-6 * np.maximum(1.0, np.abs(fc))).all()


# ---- the float32 shared-V tensor-core body --------------------------------


def _rows_problem(seed, N, C, rtol=1e-5, dev=None):
    """C independent rows of width N on one SPD V (70% free), as the
    kernel's row layout, float32 on ``dev``."""
    V, FM, B, DINV, TOL2 = _cg_problem(seed, N, 1, C, torch.float64)
    TOL2 = rtol * rtol * torch.clamp((B * B).sum(1), min=1e-30)
    Br, X0r, fmr, dinvr, tol2r = cg._rows(B, FM, DINV, TOL2,
                                          torch.zeros_like(B))
    return [t.to(device=dev, dtype=torch.float32)
            for t in (V, fmr, dinvr, Br, tol2r, X0r)]


def _kernel_and_plain(V, fmr, dinvr, Br, tol2r, X0r, iters):
    before = cg.LAUNCHES
    Xk, rrk = cg.cg_padded_rows(V, fmr, dinvr, Br, tol2r, iters, X0r)
    assert cg.LAUNCHES == before + 1
    Xp, rrp = cg.cg_rows_reference(V, fmr, dinvr, Br, tol2r, iters, X0r)
    torch.cuda.synchronize()
    return Xk, rrk, Xp, rrp


@pytest.mark.parametrize("N", [1, 13, 37, 300, 513])
@pytest.mark.parametrize("C", [35, 4261])
def test_tc_kernel_tile_edges(dev, N, C):
    """C a multiple of no row tile; N a multiple of no k-slice and no MMA
    tile. At C = 4261 the tile is the largest N allows (64 rows up to N =
    256, 32 to 512, 16 past it); at C = 35 it is 16."""
    tr = cg.tile_rows(C, N)
    assert tr == (16 if C == 35 or N > 512 else 32 if N > 256 else 64)
    args = _rows_problem(N + C, N, C, dev=dev)
    Xk, rrk, Xp, rrp = _kernel_and_plain(*args, 300)
    tol2r = args[4]
    assert bool(torch.isfinite(Xk).all())
    assert float((Xk - Xp).abs().max()) <= TOL[torch.float32]
    conv = rrp <= tol2r
    assert bool((rrk[conv] <= 1.01 * tol2r[conv]).all())


def test_tc_kernel_at_the_ineq_shape(dev):
    """The ineq path's widths cut to 4 instances: N = 512, K = 1 + M + J =
    111 columns each (C = 444), the tail sweep's 96 steps."""
    V, FM, B, DINV, TOL2 = (t.to(dev, torch.float32) for t in
                            _cg_problem(512, 512, 111, 4, torch.float32))
    X0 = torch.zeros_like(B)
    Xk, rrk = cg.cg_padded_batch(V, FM, B, DINV, TOL2, 96, X0)
    Br, X0r, fmr, dinvr, tol2r = cg._rows(B, FM, DINV, TOL2, X0)
    Xp, rrp = cg.cg_rows_reference(V, fmr, dinvr, Br, tol2r, 96, X0r)
    Xp = Xp.reshape(4, 111, 512).transpose(1, 2)
    assert float((Xk - Xp).abs().max()) <= TOL[torch.float32]
    conv = rrp.reshape(4, 111) <= TOL2
    assert bool(conv.all())
    assert bool((rrk[conv] <= 1.01 * TOL2[conv]).all())


@pytest.mark.parametrize("N,C", [(256, 4261), (512, 2250)])
def test_tc_kernel_rows_converge_at_different_steps(dev, N, C):
    """Tolerances from 1e-1 to 1e-5 in one tile, one row in eight converged
    at its warm start (rr <= tol2 before the first step): each row freezes
    on its own step, and the converged ones keep their warm start."""
    V, fmr, dinvr, Br, tol2r, X0r = _rows_problem(7, N, C, dev=dev)
    rng = np.random.default_rng(N)
    rtol = torch.tensor(10.0 ** rng.uniform(-5, -1, (C, 1)),
                        dtype=torch.float32, device=dev)
    tol2r = (rtol * rtol) * (Br * Br).sum(1, keepdim=True)
    warm = torch.arange(C, device=dev) % 8 == 3
    tol2r[warm] = 1e4 * (Br[warm] * Br[warm]).sum(1, keepdim=True)
    X0r = torch.tensor(rng.standard_normal((C, N)), dtype=torch.float32,
                       device=dev) * warm[:, None]
    Xk, rrk, Xp, rrp = _kernel_and_plain(V, fmr, dinvr, Br, tol2r, X0r, 200)
    assert float((Xk - Xp).abs().max()) <= TOL[torch.float32]
    assert torch.equal(Xk[warm], X0r[warm])
    conv = rrp <= tol2r
    assert bool(conv.all())
    assert bool((rrk <= 1.01 * tol2r).all())


@pytest.mark.parametrize("iters", [3, 11])
@pytest.mark.parametrize("N,C", [(256, 4261), (512, 2250)])
def test_tc_kernel_iteration_cap(dev, iters, N, C):
    """tol2 = 0 at the main paths' widths: exactly ``iters`` steps (11: the
    chunk clamp at a non-multiple of 8) in 64- and 32-row tiles."""
    V, fmr, dinvr, Br, tol2r, X0r = _rows_problem(3, N, C, dev=dev)
    Xk, rrk, Xp, rrp = _kernel_and_plain(V, fmr, dinvr, Br,
                                         torch.zeros_like(tol2r), X0r, iters)
    assert float((Xk - Xp).abs().max()) <= 1e-4
    torch.testing.assert_close(rrk, rrp, rtol=2e-2, atol=0)


@pytest.mark.parametrize("N,C", [(256, 16384), (512, 28416)])
def test_tc_kernel_row_result_ignores_its_tile_company(dev, N, C):
    """The first rows solved alone (16-row tile, the other rows empty) and
    inside the full batch (64- or 32-row tiles of other systems) agree to
    1e-6: a row's freeze and sums are its own."""
    V, fmr, dinvr, Br, tol2r, X0r = _rows_problem(5, N, C, dev=dev)
    assert cg.tile_rows(C, N) in (32, 64) and cg.tile_rows(5, N) == 16
    X_all, rr_all = cg.cg_padded_rows(V, fmr, dinvr, Br, tol2r, 96, X0r)
    X_one, rr_one = cg.cg_padded_rows(V, fmr[:5], dinvr[:5], Br[:5],
                                      tol2r[:5], 96, X0r[:5])
    assert float((X_all[:5] - X_one).abs().max()) <= 1e-6


def test_tc_kernel_keeps_float32_accuracy(dev):
    """3xTF32, not one-pass TF32: at rtol 1e-6 (near float32 CG's floor)
    the float64 true residual ||b - vp(x)|| of the kernel's X is at most 4x
    that of the plain float32 version's X; a one-pass TF32 product (10-bit
    mantissa) would leave it near 1e-3 ||b||."""
    N, C = 512, 256
    V, fmr, dinvr, Br, tol2r, X0r = _rows_problem(11, N, C, rtol=1e-6,
                                                  dev=dev)
    Xk, _, Xp, _ = _kernel_and_plain(V, fmr, dinvr, Br, tol2r, X0r, 300)
    Vd, fd, bd = V.double(), fmr.double(), Br.double()

    def resid(X):
        X = X.double()
        return (bd - (fd * ((fd * X) @ Vd.T) + (1.0 - fd) * X)).norm(dim=1)

    rk, rp = resid(Xk), resid(Xp)
    assert float(rk.max()) <= 4.0 * float(rp.max())
    assert float((rk / bd.norm(dim=1)).max()) < 1e-4


# ---- the QP batch protocols and the refinement tiers ------------------------


def _card_and_cpu(fn, Qb, dev, *args):
    """``fn`` on the CPU batch and on its copy on the card, with the card's
    CG launches counted; both results as numpy."""
    rc = fn(Qb, *args).numpy()
    before = cg.LAUNCHES
    rg = fn(Qb.to(dev), *args).numpy()
    return rc, rg, cg.LAUNCHES - before


def _same_solve(Qb, rc, rg, dtype):
    assert (rc.status > 0).all() and (rg.status > 0).all()
    if dtype == torch.float64:
        np.testing.assert_array_equal(rg.status, rc.status)
        np.testing.assert_array_equal(rg.S, rc.S)
        np.testing.assert_allclose(rg.x, rc.x, rtol=0, atol=1e-9)
    else:
        fc, fg = _obj(Qb, rc.x), _obj(Qb, rg.x)
        assert (np.abs(fg - fc) <= 1e-5 * np.maximum(1.0, np.abs(fc))).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("proto", ["waves", "waves_compact", "c2f",
                                   "compact"])
def test_protocols_on_card_match_cpu(dev, dtype, proto):
    """The wave (W=4, with and without compaction), coarse-to-fine (coarse
    4) and compaction ((2, 4, 8)) protocols on the card against the same
    call on the CPU, on the N=32, B=16 frontier grid."""
    Q, lams = _frontier(dtype, B=32)
    Qb, sh = tb.frontier_batch(Q, lams)
    st = Settings.for_dtype(dtype)
    fn = {"waves": lambda Q: tb.solve_qp_batch_waves(Q, st, sh, waves=4),
          "waves_compact": lambda Q: tb.solve_qp_batch_waves(
              Q, st, sh, waves=4, compact=4),
          "c2f": lambda Q: tb.solve_qp_batch_c2f(Q, st, sh, coarse=4),
          "compact": lambda Q: tb.solve_qp_batch_compact(
              Q, st, sh, compact=(2, 4, 8))}[proto]
    rc, rg, launches = _card_and_cpu(fn, Qb, dev)
    assert launches > 0
    _same_solve(Qb, rc, rg, dtype)


@pytest.mark.parametrize("method", ["cg", "lu"])
def test_batch_refined_on_card_matches_cpu(dev, method):
    """float32 search on the card, refinement against float64 data: the
    refined x within 1e-9 of the CPU's and of the plain float64 solve."""
    Q, lams = _frontier(torch.float64, B=16)
    Qb, sh = tb.frontier_batch(Q, lams)
    fn = lambda Q: tb.solve_qp_batch_refined(
        Q, search_dtype=torch.float32, shared=sh, method=method)
    rc, rg, launches = _card_and_cpu(fn, Qb, dev)
    assert launches > 0
    x64 = tb.solve_qp_batch(Qb.to(dev), Settings(), shared=sh).x
    assert (rc.status > 0).all() and (rg.status > 0).all()
    np.testing.assert_array_equal(rg.status, rc.status)
    np.testing.assert_array_equal(rg.S, rc.S)
    assert rg.x.dtype == np.float64
    np.testing.assert_allclose(rg.x, rc.x, rtol=0, atol=1e-9)
    np.testing.assert_allclose(rg.x, x64.cpu().numpy(), rtol=0, atol=1e-9)


def test_refine_result_float64_on_card_matches_cpu(dev):
    """The LU tier factors in float64 on the card (no float32 pin): from
    the same searched point, x and the duals as on the CPU."""
    from ssqp_tpu_torch.solvers import refine as tr

    Q = _ineq_class(torch.float64)
    shared = ("V", "A", "G", "b", "g", "d", "u")
    rs = tb._solve_qp_batch_nodual(Q.astype(torch.float32),
                                   Settings.for_dtype(torch.float32), shared)
    res = tb.Result(rs.x.double(), rs.S, rs.status)
    rc = tr.refine_result(Q, res, Settings(), 2).numpy()
    resg = tb.Result(*(t.to(dev) for t in (res.x, res.S, res.status)))
    rg = tr.refine_result(Q.to(dev), resg, Settings(), 2).numpy()
    assert (rc.status > 0).all()
    np.testing.assert_allclose(rg.x, rc.x, rtol=0, atol=1e-9)
    np.testing.assert_allclose(rg.lam, rc.lam, rtol=0, atol=1e-9)


def test_refined_dd_on_card(dev):
    """The double-double continuation of a problem on the card: the same
    pair as on the CPU (its sweeps run in host numpy either way)."""
    from ssqp_tpu_torch.solvers import refine as tr

    Q, _ = _frontier(torch.float64, N=16)
    rc, lc = tr.solve_qp_refined_dd(Q)
    rg, lg = tr.solve_qp_refined_dd(Q.to(dev))
    assert int(rg.status) > 0 and lg.device.type == "cuda"
    np.testing.assert_allclose(rg.x.cpu().numpy(), rc.x.numpy(), rtol=0,
                               atol=1e-12)
    assert torch.isfinite(lg).all() and bool((lg != 0).any())
    np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=0,
                               atol=1e-20)


def test_auto_routes_on_card(dev, monkeypatch):
    """solve_qp_batch_auto on the card takes the wave and compaction routes
    where the JAX rule picks them (recorded, not run at B=8192)."""
    Q, _ = _frontier(torch.float32, N=16)
    seen = []
    for name in ("solve_qp_batch_waves", "solve_qp_batch_compact"):
        monkeypatch.setattr(tb, name, lambda *a, _n=name, **k: seen.append(
            (_n, a[0].device.type)))
    for B, waves in ((8192, None), (4096, None)):
        Qb, sh = tb.frontier_batch(Q.to(dev), np.linspace(0.0, 2.0, B))
        tb.solve_qp_batch_auto(Qb, Settings.for_dtype(torch.float32), sh,
                               waves=waves)
    assert seen == [("solve_qp_batch_waves", "cuda"),
                    ("solve_qp_batch_compact", "cuda")]


# ---- the LP engines (config 2's routes at a small size) ---------------------


@pytest.mark.parametrize("B", [256, 4096])
def test_chol_kernel_at_the_lp_shape(dev, B):
    """The LP dual recovery's systems at config 2 (n = M + J = 25, K = 1):
    the blocked body pads them to 32 rows."""
    rng = np.random.default_rng(B)
    A = torch.tensor(_spd(rng, B, 25), dtype=torch.float32, device=dev)
    R = torch.tensor(rng.standard_normal((B, 25, 1)), dtype=torch.float32,
                     device=dev)
    assert chol.body(25, 1) == "blocked"
    before = chol.LAUNCHES_BY_SHAPE[(B, 25, 1)]
    Xk = chol.chol_solve_batch(A, R)
    assert chol.LAUNCHES_BY_SHAPE[(B, 25, 1)] == before + 1
    Xp = chol.chol_solve_reference(A, R)
    torch.cuda.synchronize()
    assert float((Xk - Xp).abs().max()) <= 1e-4 * float(Xp.abs().max())


def _lp_family(route, dtype, N=32, M=4, J=12, B=32, seed=3):
    """bench_suite.py::config2's generators at N=32, M=4, J=12 (R = 16, so
    float32 dual recovery takes the Cholesky kernel), on the CPU."""
    from ssqp_tpu_torch import make_lp

    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, N))
    G = rng.standard_normal((J, N))
    X0 = rng.uniform(0.1, 1.0, (B, N))
    ts = np.linspace(0.0, 1.0, B)[:, None]
    c0, dc = rng.standard_normal(N), rng.standard_normal(N) * 0.5
    slack = rng.uniform(0.1, 1.0, J)
    if route in ("mixed", "cclp"):
        bat = dict(c=rng.standard_normal((B, N)), b=X0 @ A.T,
                   g=X0 @ G.T + rng.uniform(0.1, 1.0, (B, J)))
        shared = ("A", "G", "d", "u")
    elif route == "cgrid":
        bat = dict(c=c0 + ts * dc)
        shared = ("A", "b", "G", "g", "d", "u")
    else:
        Xc = X0[0] + ts * (X0[1] - X0[0])
        bat = dict(b=Xc @ A.T, g=Xc @ G.T + slack)
        shared = ("c", "A", "G", "d", "u")
    x0 = X0[0]
    P = make_lp(c0, A, A @ x0, G=G, g=G @ x0 + slack, d=np.zeros(N),
                u=np.full(N, 2.0), dtype=np.float64, device="cpu")
    P = dataclasses.replace(P, **{k: torch.tensor(v) for k, v in bat.items()})
    return P.astype(dtype), shared


def _lp_same(P, rc, rg, dtype, exact):
    np.testing.assert_array_equal(rg.status, rc.status)
    c = np.broadcast_to(P.c.double().numpy(), rc.x.shape)
    fc = (c * rc.x).sum(1)
    fg = (c * rg.x.astype(np.float64)).sum(1)
    tol = 1e-9 if dtype == torch.float64 else 5e-5
    assert (np.abs(fg - fc) <= tol * np.maximum(1.0, np.abs(fc))).all()
    if dtype == torch.float64 and exact:
        np.testing.assert_array_equal(rg.S, rc.S)
        np.testing.assert_allclose(rg.x, rc.x, rtol=0, atol=1e-9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("route", ["mixed", "cgrid", "rhs", "cclp"])
def test_lp_routes_on_card_match_cpu(dev, dtype, route):
    """Each LP route through its entry point (solve_lp_batch_auto: plain,
    waves=8, dual waves=8; solve_lp_batch_cclp_rescued) on the card against
    the same call on the CPU; float32 launches the Cholesky kernel."""
    P, sh = _lp_family(route, dtype)
    st = Settings.for_dtype(dtype)
    fn = ((lambda P: tb.solve_lp_batch_cclp_rescued(P, st, sh))
          if route == "cclp" else
          (lambda P: tb.solve_lp_batch_auto(P, st, sh)))
    rc = fn(P).numpy()
    before = chol.LAUNCHES
    rg = fn(P.to(dev)).numpy()
    if dtype == torch.float32:
        assert chol.LAUNCHES > before
    assert np.isin(rc.status, (1, 2)).all()
    _lp_same(P, rc, rg, dtype, exact=route != "cclp")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lp_single_entry_points_on_card_match_cpu(dev, dtype):
    """simplex_lp (cold, maximize, warm_from), solve_lp and box_lp on one
    LP on the card against the CPU."""
    from ssqp_tpu_torch import box_lp, make_lp, simplex_lp, solve_lp

    P, _ = _lp_family("mixed", dtype, B=2)
    one = dataclasses.replace(P, c=P.c[0], b=P.b[0], g=P.g[0])
    calls = (lambda Q: simplex_lp(Q),
             lambda Q: simplex_lp(Q, minimize=False),
             lambda Q: simplex_lp(Q, warm_from=simplex_lp(Q)),
             lambda Q: solve_lp(Q, route="cclp"))
    for fn in calls:
        rc, rg = fn(one), fn(one.to(dev))
        assert int(rg.status) == int(rc.status) and int(rc.status) in (1, 2)
        fc = float((one.c.double() * rc.x.double()).sum())
        fg = float((one.c.double() * rg.x.double().cpu()).sum())
        tol = 1e-9 if dtype == torch.float64 else 5e-5
        assert abs(fg - fc) <= tol * max(1.0, abs(fc))
    box = make_lp([1.0, -2.0, 0.0], d=[0.0, 0.0, -1.0], u=[1.0, 3.0, 1.0],
                  device="cuda")
    r = box_lp(box)
    assert r.x.device.type == "cuda" and int(r.status) == 2
    np.testing.assert_array_equal(r.x.cpu().numpy(), [0.0, 3.0, -1.0])


# ---- the outer layers: frontier sweeps, diff, Model/MPS, diagnostics,
# warm-up and the sharded solves --------------------------------------------


@pytest.mark.parametrize("sweep", ["frontier_batch_sweep",
                                   "frontier_waves_sweep",
                                   "frontier_warm_sweep",
                                   "frontier_mu_sweep",
                                   "frontier_mu_warm_sweep"])
def test_frontier_sweeps_on_card_match_cpu(dev, sweep):
    """Each frontier sweep on the card against the same call on the CPU
    (float64, N=32, 16 grid points): status and S equal, x, ret and risk
    within 1e-9; every sweep launches the CG kernel."""
    from ssqp_tpu_torch.models import frontier as tf

    Q, lams = _frontier(torch.float64)
    rets = Q.q.clone()
    if "mu" in sweep:  # inside the returns reachable with x <= 4/N
        r = np.sort(rets.numpy())
        lo, hi = r[:8].mean(), r[-8:].mean()
        grid = np.linspace(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo), 16)
    else:
        grid = lams
    fn = getattr(tf, sweep)
    kw = dict(waves=4) if sweep == "frontier_waves_sweep" else {}
    fc = fn(Q, rets, torch.tensor(grid), Settings(), **kw)
    before = cg.LAUNCHES
    fg = fn(Q.to(dev), rets.to(dev), torch.tensor(grid, device=dev),
            Settings(), **kw)
    assert cg.LAUNCHES > before
    assert (fc.status > 0).all()
    np.testing.assert_array_equal(fg.status.cpu().numpy(), fc.status.numpy())
    np.testing.assert_array_equal(fg.S.cpu().numpy(), fc.S.numpy())
    for k in ("x", "ret", "risk"):
        np.testing.assert_allclose(getattr(fg, k).cpu().numpy(),
                                   getattr(fc, k).numpy(), rtol=0, atol=1e-9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_diff_gradients_on_card_match_cpu(dev, dtype):
    """solve_qp_diff on a frontier batch (N=32, B=16, the ineq class's rows
    cut in: J=2) on the card: x and the gradients of sum(w x) with respect
    to q, b, u and V against the CPU's (float64 1e-9; float32 1e-4
    relative to the largest entry)."""
    from ssqp_tpu_torch.solvers.diff import solve_qp_diff

    Q, lams = _frontier(dtype)
    Qb, _ = tb.frontier_batch(Q, lams)
    w = torch.tensor(np.random.default_rng(3).standard_normal((16, 32)),
                     dtype=dtype)

    def run(device):
        leaves = {f: getattr(Qb, f).to(device).clone().requires_grad_(True)
                  for f in ("q", "b", "u", "V")}
        r = solve_qp_diff(dataclasses.replace(Qb.to(device), **leaves))
        (w.to(device) * r.x).sum().backward()
        return r, {f: t.grad.cpu().numpy() for f, t in leaves.items()}

    rc, gc = run("cpu")
    before = cg.LAUNCHES
    rg, gg = run(dev)
    assert cg.LAUNCHES > before
    assert (rc.status > 0).all()
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    np.testing.assert_allclose(rg.x.detach().cpu().numpy(),
                               rc.x.detach().numpy(), rtol=0,
                               atol=tol if dtype == torch.float64 else 1e-5)
    for f in gc:
        scale = max(np.abs(gc[f]).max(), 1e-30)
        assert np.abs(gg[f] - gc[f]).max() <= tol * scale, f


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_model_and_mps_on_card_match_cpu(dev, dtype, tmp_path):
    """The Model on the card (the ineq class at N=32, J=16, R=17 rows:
    float32 launches the Cholesky kernel; and an LP with R=16): the same
    status strings and objectives within 1e-9 (float64) or 1e-5 relative
    (float32) of the CPU's; write_mps gives the same text; solve_mps reads
    it back on the card."""
    from ssqp_tpu_torch import Model
    from ssqp_tpu_torch.utils import mps

    Q = _ineq_class(torch.float64, B=1)
    Q1 = dataclasses.replace(Q, q=Q.q[0])
    P, _ = _lp_family("mixed", torch.float64, B=1)
    P1 = dataclasses.replace(P, c=P.c[0], b=P.b[0], g=P.g[0])
    for prob in (Q1, P1):
        mc = Model.from_problem(prob.astype(dtype))
        mg = Model.from_problem(prob.astype(dtype).to(dev))
        assert mg.device.type == "cuda"
        before = chol.LAUNCHES
        assert mg.optimize() == mc.optimize() == "OPTIMAL"
        if dtype == torch.float32:
            assert chol.LAUNCHES > before
        fc, fg = mc.objective_value(), mg.objective_value()
        tol = 1e-9 if dtype == torch.float64 else 1e-5
        assert abs(fg - fc) <= tol * max(1.0, abs(fc))
        text = mps.write_mps(mg)
        assert text == mps.write_mps(mc)
        path = tmp_path / "m.mps.gz"
        mps.write_mps(mg, path=path)
        m2 = mps.solve_mps(path, dtype=dtype)
        assert m2.to_problem().d.device.type == "cuda"
        assert m2.termination_status() == "OPTIMAL"
        assert abs(m2.objective_value() - fg) <= tol * max(1.0, abs(fg))


def test_kkt_report_and_trace_on_card(dev, tmp_path):
    from ssqp_tpu_torch.utils.diagnostics import kkt_report, trace

    Q = _ineq_class(torch.float64)
    sh = ("V", "A", "G", "b", "g", "d", "u")
    rc = tb.solve_qp_batch(Q, Settings(), shared=sh)
    Qg = Q.to(dev)
    with trace(str(tmp_path / "tr")):
        rg = tb.solve_qp_batch(Qg, Settings(), shared=sh)
        torch.cuda.synchronize()
    files = list((tmp_path / "tr").iterdir())
    assert len(files) == 1 and files[0].stat().st_size > 0
    repc, repg = kkt_report(Q, rc, batched=True), kkt_report(Qg, rg,
                                                             batched=True)
    for a, b in zip(repg, repc):
        assert a.device.type == "cuda"
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                   atol=1e-9)
    assert (repg.stationarity < 1e-7).all() and repg.solved.all()


def test_warmup_on_card(dev):
    from ssqp_tpu_torch.ops import _build
    from ssqp_tpu_torch.utils.aot import enable_compilation_cache, warmup

    assert enable_compilation_cache() == str(_build.build_dir())
    assert warmup(((16, 1, 0), (16, 1, 2)), batch=4, refined=True) == 6


def test_sharded_solves_on_a_one_card_nccl_group(dev, tmp_path):
    """A world-size-1 NCCL group (file store): the sharded QP and LP solves
    equal the batch solves they wrap; the statistics are on the card."""
    import torch.distributed as dist

    from ssqp_tpu_torch.parallel import sharded

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        Q, lams = _frontier(torch.float32, B=64)
        Qb, sh = tb.frontier_batch(Q.to(dev), lams)
        st = Settings.for_dtype(torch.float32)
        res, stats = sharded.solve_qp_sharded(Qb, st, shared=sh)
        ref = tb.solve_qp_batch_auto(Qb, st, sh)
        assert torch.equal(res.x, ref.x) and torch.equal(res.S, ref.S)
        assert stats["solved"].device.type == "cuda"
        assert int(stats["solved"]) == 64 and int(stats["infeasible"]) == 0
        P, shp = _lp_family("mixed", torch.float32)
        Pg = P.to(dev)
        r, s2 = sharded.solve_lp_sharded(Pg, st, shared=shp)
        ref = tb.solve_lp_batch_auto(Pg, st, shp)
        assert torch.equal(r.x, ref.x) and int(s2["solved"]) == 32
        with pytest.raises(ValueError, match="NCCL"):
            sharded.solve_qp_sharded(Qb.to("cpu"), st, shared=sh,
                                     device="cpu")
    finally:
        dist.destroy_process_group()


# ---- the PDAS variants (Chebyshev, W-PCG) and the N = 1024 edge ----------


@pytest.mark.parametrize("flag", ["pdas_cheb", "pdas_pcg"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pdas_variant_on_card_matches_cpu(dev, flag, dtype):
    """The Chebyshev and W-PCG rounds on CUDA tensors against the same
    call on the CPU; the S-loop still launches the CG kernel."""
    from ssqp_tpu_torch.ops import kkt

    Q, lams = _frontier(dtype, B=48)
    st = dataclasses.replace(Settings.for_dtype(dtype), **{flag: True})
    Qb, sh = tb.frontier_batch(Q, lams)
    rc = tb.solve_qp_batch_auto(Qb, st, sh).numpy()
    calls = []
    name = "_vp_cheb" if flag == "pdas_cheb" else "_vp_pcg"
    real = getattr(kkt, name)
    setattr(kkt, name, lambda *a: (calls.append(1), real(*a))[1])
    try:
        cg.LAUNCHES = 0
        Qg, shg = tb.frontier_batch(Q.to(dev), lams)
        rg = tb.solve_qp_batch_auto(Qg, st, shg).numpy()
    finally:
        setattr(kkt, name, real)
    assert calls and cg.LAUNCHES > 0
    assert (rc.status > 0).all() and (rg.status > 0).all()
    if dtype == torch.float64:
        np.testing.assert_array_equal(rg.S, rc.S)
        np.testing.assert_allclose(rg.x, rc.x, rtol=0, atol=1e-9)
    else:
        fc, fg = _obj(Qb, rc.x), _obj(Qb, rg.x)
        assert (np.abs(fg - fc) <= 1e-5 * np.maximum(1.0, np.abs(fc))).all()


@pytest.mark.parametrize("with_W", [False, True])
def test_shared_jacobi_bounds_on_card_enclose_the_spectrum(dev, with_W):
    from ssqp_tpu_torch.ops.kkt import shared_jacobi_bounds

    Q, _ = _frontier(torch.float32, N=256)
    V = Q.V.to(dev)
    W, _ = ts._pdas_shared_W(V, Settings.for_dtype(torch.float32))
    lo, hi = shared_jacobi_bounds(V, W if with_W else None)
    assert lo.device.type == "cuda"
    s = torch.diagonal(V).double().rsqrt()
    ev = torch.linalg.eigvalsh(s[:, None] * V.double() * s[None, :])
    assert float(lo) <= float(ev.min()) and float(hi) >= float(ev.max())


def test_cg_body_switch_at_1024(dev):
    """N = 1024 takes the tensor-core body, N = 1025 the first port's; both
    agree with the plain version and are counted by body."""
    for N, want in ((1024, "tensor-core"), (1025, "cuda-core")):
        args = _cg_problem(3, N, 2, 8, torch.float32, False)
        X0 = torch.zeros_like(args[2])
        cg.LAUNCHES_BY_BODY.clear()
        Xk, _, Xp, _ = _both(args, 64, X0, dev)
        assert dict(cg.LAUNCHES_BY_BODY) == {want: 1}
        assert (cg.tile_rows(16, N) > 0) == (want == "tensor-core")
        np.testing.assert_allclose(Xk, Xp, rtol=0, atol=5e-4)
