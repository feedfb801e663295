"""Padded equality-constrained KKT solves, batch-first (PyTorch).

Counterpart of ``ssqp_tpu/ops/kkt.py`` (the QP solver's subset). The
working-set KKT system is solved at full (N, M+J) shape with mask padding:
bound variables are pinned through an identity block
``Vp = f f' . V + diag(1-f)`` and inactive/purged rows through an identity
block on the Schur complement, exactly as in the JAX package. Every function
takes ``(B, ...)`` per-instance tensors; V and AG may be shared (unbatched)
or per-instance.

The CG solves go to the fused kernel (ops/cg.py) on CUDA tensors and to its
plain PyTorch version on CPU tensors. The (R, R) Schur systems and the other
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


def cg_solve_padded(V, fm, B, iters, rtol, X0=None):
    """Jacobi-preconditioned CG on ``Vp X = B`` (multi-rhs, B (batch, N, K)).

    ``X0`` warm-starts the iteration; a (near-)zero right-hand-side column
    restarts at 0 (its exact solution), since a stale warm start there could
    never reach ``rtol * ||b||``. The norm floor is the dtype's smallest
    normal. Returns (X, relative residual (batch, K))."""
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
    X, rr = _vp_cg(V, fm, B, dinv, tol2, int(iters), X)
    return X, torch.sqrt(rr / bnorm2)


def _relmax(rel):
    if rel.shape[-1] == 0:
        return torch.zeros(rel.shape[:-1], dtype=rel.dtype, device=rel.device)
    return rel.amax(dim=-1)


def kkt_solve_cg(V, q, AG, bg, z, free, keep, cg_iters, rtol, ok_rtol=1e-3,
                 ridge=0.0, x0=None, return_sol=False):
    """CG form of :func:`kkt_solve` (same contract, factorization-free).

    Batched: q, z (B, N); free (B, N) bool; keep (B, R) bool; AG (R, N) or
    (B, R, N); bg (R,) or (B, R); ``x0`` (B, N, 1+R) warm start."""
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
                                   X0=x0)
        w = sol[..., 0]
        alphaL = torch.zeros((z.shape[0], 0), dtype=dtype, device=z.device)
        alpha_f = -w
        relmax = _relmax(rel)
    else:
        rhs = torch.cat([cp.unsqueeze(-1), Ap.transpose(1, 2)], dim=2)
        sol, rel = cg_solve_padded(V, fm, rhs, cg_iters, rtol, X0=x0)
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
