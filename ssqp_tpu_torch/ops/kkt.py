"""Padded equality-constrained KKT solves, batch-first (PyTorch).

Counterpart of ``ssqp_tpu/ops/kkt.py`` (the QP solver's subset). The
working-set KKT system is solved at full (N, M+J) shape with mask padding:
bound variables are pinned through an identity block
``Vp = f f' . V + diag(1-f)`` and inactive/purged rows through an identity
block on the Schur complement, exactly as in the JAX package. Every function
takes ``(B, ...)`` per-instance tensors; V and AG may be shared (unbatched)
or per-instance.

The Jacobi-CG solves go to the fused kernel (ops/cg.py) on CUDA tensors and
to its plain PyTorch version on CPU tensors. The two PDAS variants of the
JAX package, the shared-inverse PCG (``Settings.pdas_pcg``) and the
Chebyshev semi-iteration (``Settings.pdas_cheb``), are XLA loops there and
plain PyTorch loops here (:func:`_vp_pcg`, :func:`_vp_cheb`); the
S-loop's solves stay on the kernel. The (R, R) Schur systems and the other
batched SPD solves go through :func:`spd_solve`: the fused Cholesky kernel
route (ops/chol.py) in float32 at n >= 16, a library Cholesky otherwise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ssqp_tpu_torch.ops.bmat import mm, mtv, mv
from ssqp_tpu_torch.ops.cg import cg_padded_batch
from ssqp_tpu_torch.ops.chol import chol_solve_batch


def _chol_solve(A, rhs):
    L, info = torch.linalg.cholesky_ex(A)
    X = torch.cholesky_solve(rhs, L)
    # a failed factorization gives NaN, as XLA's Cholesky does, so the
    # callers' finite/residual gates reject it
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.full_like(X, float("nan")), X)


def spd_solve(A, rhs):
    """Solve the SPD system ``A x = rhs`` per instance: A (B, n, n), rhs
    (B, n) or (B, n, k).

    Same dispatch rule as the JAX package's batched ``spd_solve``: a float32
    system with n >= 16 goes to the fused Cholesky kernel route
    (``ops/chol.py``: the CUDA kernel on a CUDA tensor, its plain version on
    a CPU tensor); float64 or n < 16 use a library Cholesky factorization
    (the JAX package's XLA branch)."""
    squeeze = rhs.dim() == A.dim() - 1
    r3 = rhs.unsqueeze(-1) if squeeze else rhs
    if A.dtype == torch.float32 and A.shape[-1] >= 16:
        X = chol_solve_batch(A, r3)
    else:
        X = _chol_solve(A, r3)
    return X.squeeze(-1) if squeeze else X


class KKTResult(NamedTuple):
    alpha: torch.Tensor  # (B, N) candidate minimizer
    p: torch.Tensor  # (B, N) step direction alpha - z (zero on bound coords)
    alphaL: torch.Tensor  # (B, R) working-row multipliers
    gamma: torch.Tensor  # (B, N) reduced gradient at alpha
    ok: torch.Tensor  # (B,) bool


def _vp_apply(V, fm, x):
    """Apply ``Vp = f f' . V + diag(1-f)`` without materializing it:
    fm (B, N), x (B, N, K)."""
    f = fm.unsqueeze(-1)
    return f * mm(V, x * f) + (1.0 - f) * x


def _vp_cg(V, fm, B, dinv, tol2, iters, X0):
    """CG core on ``Vp X = B`` (B (batch, N, K)). One dispatch rule: the
    fused kernel on a CUDA tensor, its plain version on a CPU tensor."""
    return cg_padded_batch(V, fm, B, dinv, tol2, iters, X0)


_CHUNK = 8  # iterations between the host's any-alive checks


def _masked_loop(step, state, tol2, iters):
    """Run ``state = step(*state)`` while an instance runs, per instance: the
    loop of a vmapped ``lax.while_loop`` whose cond is ``i < iters`` and any
    column of the instance above its tolerance. ``state[1]`` is the residual
    (batch, N, K); tol2 (batch, K). An instance whose cond fails keeps its
    state from then on (its later iterations are masked out, as the vmapped
    loop selects the old carry). The host checks that some instance still
    runs before every :data:`_CHUNK` iterations; in between the check is on
    the device. Returns the final state."""

    def running(R):
        return (torch.sum(R * R, dim=1) > tol2).any(dim=1)

    i = 0
    while i < iters and bool(running(state[1]).any()):
        for _ in range(min(_CHUNK, iters - i)):
            run = running(state[1])
            new = step(*state)
            state = tuple(
                torch.where(run.view((-1,) + (1,) * (o.dim() - 1)), n, o)
                if o.dim() > 0 else n for n, o in zip(new, state))
        i += _CHUNK
    return state


def _vp_pcg(V, fm, B, W, tol2, iters, X0):
    """PCG on ``Vp X = B`` with the shared-inverse preconditioner
    ``M^{-1} r = f.(W (f.r)) + (1-f).r`` (``W ~= V^{-1}``): the JAX
    package's ``_vp_pcg_xla``, batch-first (fm (batch, N), B and X0 (batch,
    N, K), tol2 (batch, K); V and W shared or per instance). Two products
    with an (N, N) matrix per iteration against Jacobi's one. Columns
    freeze on their own (alpha = 0, beta = 0 once converged), instances on
    their own (:func:`_masked_loop`). Returns (X, final squared residual
    (batch, K))."""
    f = fm.unsqueeze(-1)

    def prec(r):
        return f * mm(W, r * f) + (1.0 - f) * r

    r = B - _vp_apply(V, fm, X0)
    z = prec(r)
    rz = torch.sum(r * z, dim=1)

    def step(X, r, p, rz):
        alive = torch.sum(r * r, dim=1) > tol2
        Ap = _vp_apply(V, fm, p)
        pAp = torch.sum(p * Ap, dim=1)
        alpha = torch.where(alive & (pAp > 0),
                            rz / torch.clamp(pAp, min=1e-30),
                            torch.zeros_like(pAp)).unsqueeze(1)
        X = X + alpha * p
        r = r - alpha * Ap
        zn = prec(r)
        rzn = torch.sum(r * zn, dim=1)
        beta = torch.where(alive, rzn / torch.clamp(rz, min=1e-30),
                           torch.zeros_like(rz)).unsqueeze(1)
        return X, r, zn + beta * p, rzn

    X, r, _, _ = _masked_loop(step, (X0, r, z, rz), tol2, int(iters))
    return X, torch.sum(r * r, dim=1)


def _vp_cheb(V, fm, B, dinv, lo, hi, tol2, iters, X0):
    """Jacobi-preconditioned Chebyshev semi-iteration on ``Vp X = B`` over
    the spectral interval ``[lo, hi]`` of the Jacobi-scaled operator (see
    :func:`shared_jacobi_bounds`): the JAX package's ``_vp_cheb_xla``,
    batch-first (dinv (batch, N); the rest as :func:`_vp_pcg`). The step
    coefficients come from the fixed recurrence (Saad, alg. 12.1)
    ``rho_k = 1/(2 sigma - rho_{k-1})``, ``D_k = rho_k rho_{k-1} D_{k-1} +
    (2 rho_k / delta) Z_k``, not from dot products; they are the same for
    every running instance (all are at the same step), so ``rho``, ``sigma``
    and ``delta`` are 0-d device tensors in the batch dtype. The columns of
    an instance do not freeze: the instance runs until all of them
    converge, then stops on its own (:func:`_masked_loop`). Returns (X,
    final squared residual (batch, K))."""
    dtype, dev = B.dtype, B.device
    lo = torch.as_tensor(lo, dtype=dtype, device=dev)
    hi = torch.as_tensor(hi, dtype=dtype, device=dev)
    theta = (hi + lo) / 2.0
    delta = torch.clamp((hi - lo) / 2.0, min=1e-30)
    sigma = theta / delta
    dv = dinv.unsqueeze(-1)

    R = B - _vp_apply(V, fm, X0)
    D = R * dv / theta

    def step(X, R, D, rho):
        X = X + D
        R = R - _vp_apply(V, fm, D)
        rho_n = 1.0 / (2.0 * sigma - rho)
        D = (rho_n * rho) * D + (2.0 * rho_n / delta) * (R * dv)
        return X, R, D, rho_n

    X, R, _, _ = _masked_loop(step, (X0, R, D, 1.0 / sigma), tol2,
                              int(iters))
    return X, torch.sum(R * R, dim=1)


def shared_jacobi_bounds(V, W=None, power_iters: int = 32):
    """Spectral interval ``(lo, hi)`` of the Jacobi-scaled shared operator
    ``S = D^{-1/2} V D^{-1/2}`` for the Chebyshev solve, with safety
    margins, as the JAX package's ``shared_jacobi_bounds``: V (N, N).

    ``hi``: 1.1 times a power-iteration Rayleigh quotient, capped by the
    Gershgorin row-sum bound (an upper bound of the spectrum). ``lo``: 0.8
    over the top eigenvalue of ``D^{1/2} W D^{1/2}`` when ``W ~= V^{-1}`` is
    given, else 0.8 times ``hi`` less the top eigenvalue of ``hi I - S``;
    then clipped into ``[eps hi, 1]`` and ``hi`` raised to at least 1 (the
    padded identity block contributes eigenvalue 1). By Cauchy interlacing
    the interval covers every pin mask's operator. A NaN ``W`` (a failed
    factorization) gives a NaN ``lo``, as in the JAX package: the clip keeps
    it, and the Chebyshev solve on it returns NaN, which the KKT solve's
    finite gate rejects. Returns 0-d tensors ``(lo, hi)``."""
    dtype, dev = V.dtype, V.device
    N = V.shape[0]
    tiny = torch.finfo(dtype).tiny
    s = torch.sqrt(torch.clamp(torch.diagonal(V), min=tiny))
    sinv = 1.0 / s
    one = torch.ones((), dtype=dtype, device=dev)

    def smv(v):
        return sinv * (V @ (sinv * v))

    def power(fn, v0, n):
        v = v0
        for _ in range(n):
            w = fn(v)
            v = w / torch.clamp(torch.linalg.vector_norm(w), min=tiny)
        return torch.dot(v, fn(v)) / torch.clamp(torch.dot(v, v), min=tiny)

    i = torch.arange(N, dtype=dtype, device=dev)
    v0 = torch.cos(0.7 * i + 0.3) + 0.01
    v0 = v0 / torch.linalg.vector_norm(v0)

    ray_hi = power(smv, v0, power_iters)
    gersh = torch.max(torch.sum(
        torch.abs(sinv.unsqueeze(1) * V * sinv.unsqueeze(0)), dim=1))
    hi = torch.maximum(torch.minimum(1.1 * ray_hi, gersh), one)
    if W is not None:
        mu = power(lambda v: s * (W @ (s * v)), v0, power_iters)
        lo = 0.8 / torch.maximum(mu, one)
    else:
        ray_shift = power(lambda v: hi * v - smv(v), v0, power_iters)
        lo = 0.8 * torch.clamp(hi - ray_shift, min=tiny)
    eps = torch.finfo(dtype).eps
    lo = torch.minimum(torch.maximum(lo, eps * hi), one)
    return lo, hi


def cg_solve_padded(V, fm, B, iters, rtol, X0=None, W=None, cheb=None):
    """Jacobi-preconditioned CG on ``Vp X = B`` (multi-rhs, B (batch, N, K)).

    ``X0`` warm-starts the iteration; a (near-)zero right-hand-side column
    restarts at 0 (its exact solution), since a stale warm start there could
    never reach ``rtol * ||b||``. The norm floor is the dtype's smallest
    normal. ``cheb=(lo, hi)`` runs the Chebyshev semi-iteration on that
    interval instead (:func:`_vp_cheb`), else ``W`` the shared-inverse PCG
    (:func:`_vp_pcg`), else the CG kernel: the JAX package's order.
    Returns (X, relative residual (batch, K))."""
    dinv = 1.0 / (fm * torch.diagonal(V, dim1=-2, dim2=-1) + (1.0 - fm))
    tiny = torch.finfo(B.dtype).tiny
    bn2 = torch.sum(B * B, dim=1)
    bnorm2 = torch.clamp(bn2, min=tiny)
    tol2 = (rtol * rtol) * bnorm2
    if X0 is None:
        X = torch.zeros_like(B)
    else:
        live = (bn2 > tiny).unsqueeze(1)
        X = torch.where(live, X0, torch.zeros_like(X0))
    if cheb is not None:
        X, rr = _vp_cheb(V, fm, B, dinv, cheb[0], cheb[1], tol2, iters, X)
    elif W is not None:
        X, rr = _vp_pcg(V, fm, B, W, tol2, iters, X)
    else:
        X, rr = _vp_cg(V, fm, B, dinv, tol2, int(iters), X)
    return X, torch.sqrt(rr / bnorm2)


def _relmax(rel):
    if rel.shape[-1] == 0:
        return torch.zeros(rel.shape[:-1], dtype=rel.dtype, device=rel.device)
    return rel.amax(dim=-1)


def kkt_solve_cg(V, q, AG, bg, z, free, keep, cg_iters, rtol, ok_rtol=1e-3,
                 ridge=0.0, x0=None, return_sol=False, W=None, cheb=None):
    """CG form of :func:`kkt_solve` (same contract, factorization-free).

    Batched: q, z (B, N); free (B, N) bool; keep (B, R) bool; AG (R, N) or
    (B, R, N); bg (R,) or (B, R); ``x0`` (B, N, 1+R) warm start. ``W`` and
    ``cheb`` pick the inner solve (:func:`cg_solve_padded`)."""
    dtype = z.dtype
    fm = free.to(dtype)
    bm = 1.0 - fm
    km = keep.to(dtype)
    R = AG.shape[-2]

    zB = z * bm
    cp = fm * (mv(V, zB) + q)
    Ap = AG * (km.unsqueeze(-1) * fm.unsqueeze(-2))  # (B, R, N)
    bp = km * (bg - mv(AG, zB))

    if R == 0:
        sol, rel = cg_solve_padded(V, fm, cp.unsqueeze(-1), cg_iters, rtol,
                                   X0=x0, W=W, cheb=cheb)
        w = sol[..., 0]
        alphaL = torch.zeros((z.shape[0], 0), dtype=dtype, device=z.device)
        alpha_f = -w
        relmax = _relmax(rel)
    else:
        rhs = torch.cat([cp.unsqueeze(-1), Ap.transpose(1, 2)], dim=2)
        sol, rel = cg_solve_padded(V, fm, rhs, cg_iters, rtol, X0=x0, W=W,
                                   cheb=cheb)
        relmax = _relmax(rel)
        w, mT = sol[..., 0], sol[..., 1:]
        C = torch.bmm(Ap, mT)
        C = (C + C.transpose(1, 2)) / 2 \
            + torch.diag_embed((1.0 - km) + ridge * km)
        rhsC = torch.bmm(Ap, w.unsqueeze(-1)).squeeze(-1) + bp
        alphaL = -spd_solve(C, rhsC)
        alpha_f = -(torch.bmm(mT, alphaL.unsqueeze(-1)).squeeze(-1) + w)
        rS = torch.bmm(C, alphaL.unsqueeze(-1)).squeeze(-1) + rhsC
        sS = 1.0 + rhsC.abs().amax(dim=-1)
        relmax = torch.maximum(relmax, rS.abs().amax(dim=-1) / sS)

    alpha = fm * alpha_f + bm * z
    p = fm * (alpha_f - z)
    gamma = mv(V, alpha) + q + mtv(AG, km * alphaL)
    ok = (torch.isfinite(alpha).all(dim=-1)
          & torch.isfinite(alphaL).all(dim=-1) & (relmax < ok_rtol))
    res = KKTResult(alpha, p, alphaL, gamma, ok)
    return (res, sol) if return_sol else res


def kkt_solve_rhs_cg(V, AG, free, keep, r1, r2, cg_iters, rtol, ok_rtol=1e-3,
                     ridge=0.0, x0=None, return_sol=False):
    """Solve the fixed-active-set KKT system with an explicit right-hand side
    (factorization-free block elimination on the padded operator of
    :func:`kkt_solve_cg`): with ``f`` the free mask and ``k`` the kept rows,

        free rows:      (V dx)_i + (AG' (k . dl))_i = r1_i
        bound rows:      dx_i                       = r1_i
        kept rows:      (AG dx)_j                   = r2_j
        non-kept rows:   dl_j                       = r2_j

    One iterative-refinement sweep of ``solvers/refine.py`` solves it against
    a high-precision residual. Batched: free (B, N), keep (B, R), r1 (B, N),
    r2 (B, R); V and AG shared or per-instance; ``x0`` (B, N, 1+R) warm
    start. Returns ``(dx, dl, ok)`` (and the raw CG solution when
    ``return_sol``)."""
    dtype = r1.dtype
    fm = free.to(dtype)
    bm = 1.0 - fm
    km = keep.to(dtype)
    R = AG.shape[-2]

    dxB = bm * r1
    r1p = fm * (r1 - mv(V, dxB))
    if R == 0:
        sol, rel = cg_solve_padded(V, fm, r1p.unsqueeze(-1), cg_iters, rtol,
                                   X0=x0)
        dxF = sol[..., 0]
        dl = torch.zeros((r1.shape[0], 0), dtype=dtype, device=r1.device)
        relmax = _relmax(rel)
    else:
        r2p = km * (r2 - mv(AG, dxB))
        Ap = AG * (km.unsqueeze(-1) * fm.unsqueeze(-2))
        rhs = torch.cat([r1p.unsqueeze(-1), Ap.transpose(1, 2)], dim=2)
        sol, rel = cg_solve_padded(V, fm, rhs, cg_iters, rtol, X0=x0)
        relmax = _relmax(rel)
        w, mT = sol[..., 0], sol[..., 1:]
        C = torch.bmm(Ap, mT)
        C = (C + C.transpose(1, 2)) / 2 \
            + torch.diag_embed((1.0 - km) + ridge * km)
        rhsC = torch.bmm(Ap, w.unsqueeze(-1)).squeeze(-1) - r2p
        dlk = spd_solve(C, rhsC)
        dxF = w - torch.bmm(mT, dlk.unsqueeze(-1)).squeeze(-1)
        dl = km * dlk + (1.0 - km) * r2
        rS = torch.bmm(C, dlk.unsqueeze(-1)).squeeze(-1) - rhsC
        sS = 1.0 + rhsC.abs().amax(dim=-1)
        relmax = torch.maximum(relmax, rS.abs().amax(dim=-1) / sS)

    dx = fm * dxF + dxB
    ok = (torch.isfinite(dx).all(dim=-1) & torch.isfinite(dl).all(dim=-1)
          & (relmax < ok_rtol))
    return (dx, dl, ok, sol) if return_sol else (dx, dl, ok)


def kkt_allfree_shared(V, W, q, AG, bg, keep, ridge):
    """All-free KKT solve through a precomputed ``W ~= V^{-1}``
    (PDAS round 1). V and W are shared (N, N); ``keep`` (R,) is shared; AG
    and bg may be shared or per-instance. Everything that does not depend
    on q (``mT = W Ap'``, the Schur complement and its Cholesky factor) is
    computed once for a shared AG. Returns ``(KKTResult, sol)`` with the
    layout of ``kkt_solve_cg(..., return_sol=True)``."""
    dtype = q.dtype
    Bn = q.shape[0]
    km = keep.to(dtype)
    R = AG.shape[-2]
    w = q @ W.T  # (B, N)
    if R == 0:
        alphaL = torch.zeros((Bn, 0), dtype=dtype, device=q.device)
        alpha = -w
        sol = w.unsqueeze(-1)
        gamma = mv(V, alpha) + q
    else:
        Ap = AG * km.unsqueeze(-1)
        bp = km * bg
        if Ap.dim() == 2:
            mT = W @ Ap.T  # (N, R) shared
            C = Ap @ mT
            C = (C + C.T) / 2 + torch.diag((1.0 - km) + ridge * km)
            L, info = torch.linalg.cholesky_ex(C)
            rhs = w @ Ap.T + bp  # (B, R)
            alphaL = -torch.cholesky_solve(rhs.T, L).T
            if int(info) != 0:
                alphaL = torch.full_like(alphaL, float("nan"))
            alpha = -(alphaL @ mT.T + w)
            sol = torch.cat([w.unsqueeze(-1), mT.expand(Bn, *mT.shape)], dim=2)
        else:
            mT = mm(W, Ap.transpose(1, 2))  # (B, N, R)
            C = torch.bmm(Ap, mT)
            C = (C + C.transpose(1, 2)) / 2 + torch.diag(
                (1.0 - km) + ridge * km)
            rhs = torch.bmm(Ap, w.unsqueeze(-1)).squeeze(-1) + bp
            alphaL = -spd_solve(C, rhs)
            alpha = -(torch.bmm(mT, alphaL.unsqueeze(-1)).squeeze(-1) + w)
            sol = torch.cat([w.unsqueeze(-1), mT], dim=2)
        gamma = mv(V, alpha) + q + mtv(AG, km * alphaL)
    ok = torch.isfinite(alpha).all(dim=-1) & torch.isfinite(alphaL).all(dim=-1)
    return KKTResult(alpha, alpha, alphaL, gamma, ok), sol


def kkt_solve(V, q, AG, bg, z, free, keep, ok_rtol=1e-8) -> KKTResult:
    """Direct (Cholesky) working-set KKT solve at full padded shape — the
    escalation path of float64 solves. Same contract as
    :func:`kkt_solve_cg`; builds the (B, N, N) padded operator, so callers
    run it on the few instances that need it."""
    dtype = z.dtype
    fm = free.to(dtype)
    bm = 1.0 - fm
    km = keep.to(dtype)
    R = AG.shape[-2]

    zB = z * bm
    cp = fm * (mv(V, zB) + q)
    Vp = V * (fm.unsqueeze(-1) * fm.unsqueeze(-2)) + torch.diag_embed(bm)
    Ap = AG * (km.unsqueeze(-1) * fm.unsqueeze(-2))
    bp = km * (bg - mv(AG, zB))

    if R == 0:
        w = spd_solve(Vp, cp)
        alphaL = torch.zeros((z.shape[0], 0), dtype=dtype, device=z.device)
        alpha_f = -w
        res_primal = torch.zeros((z.shape[0], 0), dtype=dtype, device=z.device)
    else:
        rhs = torch.cat([cp.unsqueeze(-1), Ap.transpose(1, 2)], dim=2)
        sol = spd_solve(Vp, rhs)
        w, mT = sol[..., 0], sol[..., 1:]
        C = torch.bmm(Ap, mT)
        C = (C + C.transpose(1, 2)) / 2 + torch.diag_embed(1.0 - km)
        alphaL = -spd_solve(C, torch.bmm(Ap, w.unsqueeze(-1)).squeeze(-1) + bp)
        alpha_f = -(torch.bmm(mT, alphaL.unsqueeze(-1)).squeeze(-1) + w)
        res_primal = torch.bmm(Ap, alpha_f.unsqueeze(-1)).squeeze(-1) - bp
    alpha = fm * alpha_f + bm * z
    p = fm * (alpha_f - z)
    gamma = mv(V, alpha) + q + mtv(AG, km * alphaL)

    res_stat = (torch.bmm(Vp, alpha_f.unsqueeze(-1)).squeeze(-1)
                + torch.bmm(Ap.transpose(1, 2),
                            (km * alphaL).unsqueeze(-1)).squeeze(-1) + cp)
    s_stat = 1.0 + cp.abs().amax(dim=-1)
    s_prim = 1.0 + (bp.abs().amax(dim=-1) if R else torch.zeros_like(s_stat))
    relmax = torch.maximum(res_stat.abs().amax(dim=-1) / s_stat,
                           _relmax(res_primal.abs()) / s_prim)
    ok = (torch.isfinite(alpha).all(dim=-1)
          & torch.isfinite(alphaL).all(dim=-1) & (relmax < ok_rtol))
    return KKTResult(alpha, p, alphaL, gamma, ok)


def recover_duals(V, q, AG, z, free, act_rows, ridge=None):
    """Least-squares dual recovery at a solution: fit the working-row
    multipliers so stationarity holds on the free coordinates; the bound
    multiplier is the reduced gradient. Returns (y (B, R), gamma (B, N))."""
    return recover_duals_grad(mv(V, z) + q, AG, free, act_rows, ridge=ridge)


def recover_duals_grad(grad, AG, free, act_rows, ridge=None):
    """Gradient form of :func:`recover_duals` (``grad = V z + q``)."""
    dtype = grad.dtype
    fm = free.to(dtype)
    if AG.shape[-2] == 0:
        return torch.zeros((grad.shape[0], 0), dtype=dtype,
                           device=grad.device), grad
    am = act_rows.to(dtype)
    if ridge is None:
        ridge = 100.0 * torch.finfo(dtype).eps
    Apf = AG * (am.unsqueeze(-1) * fm.unsqueeze(-2))
    M1 = torch.bmm(Apf, Apf.transpose(1, 2)) \
        + torch.diag_embed((1.0 - am) + ridge * am)
    M1 = (M1 + M1.transpose(1, 2)) / 2
    y = -spd_solve(M1, torch.bmm(Apf, (fm * grad).unsqueeze(-1)).squeeze(-1))
    y = am * y
    return y, grad + mtv(AG, y)


def recover_dropped_multipliers(AG, free, keep, act_rows, alphaL, M: int):
    """Multipliers for active-but-purged inequality rows (reference
    SSQP.jl:149-172), in padded normal-equations form. Returns (B, J)."""
    dtype = alphaL.dtype
    fm = free.to(dtype)
    km = keep.to(dtype)
    Ap = AG * (km.unsqueeze(-1) * fm.unsqueeze(-2))
    Gp = AG[..., M:, :] * fm.unsqueeze(-2)
    M1 = torch.bmm(Ap, Ap.transpose(1, 2)) + torch.diag_embed(1.0 - km)
    M1 = (M1 + M1.transpose(1, 2)) / 2
    X = spd_solve(M1, torch.bmm(Ap, Gp.transpose(1, 2)))  # (B, R, J)
    recovered = torch.bmm(X.transpose(1, 2),
                          (km * alphaL).unsqueeze(-1)).squeeze(-1)
    kept_ineq = keep[..., M:]
    own = alphaL[..., M:]
    dropped_active = act_rows[..., M:] & ~kept_ineq
    return torch.where(kept_ineq, own,
                       torch.where(dropped_active, recovered,
                                   torch.zeros_like(recovered)))
