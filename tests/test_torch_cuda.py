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
  * Cholesky kernel vs plain version (both on the card, SPD batches of
    condition number 100): float32 1e-4 and float64 1e-10, relative to
    max|X| (the same recurrence in another summation order); on non-PD
    input neither returns a solution;
  * CUDA vs CPU solves, float64: status and S equal, x within 1e-9;
    float32: the same solved count, objective within 1e-5 relative, S equal
    on at least 90% of instances;
  * the R >= 16 class through solve_qp_batch_auto with tail=4: float64
    status and S equal, x within 1e-6 (the refinement's correction runs in
    float32 on a CUDA tensor and in float64 on a CPU tensor, the JAX
    package's rule); float32 all solved, objective within 1e-6 relative.
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
