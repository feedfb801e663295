"""Iterative refinement on the final active set, batch-first (PyTorch).

Counterpart of ``ssqp_tpu/solvers/refine.py``. The active-set search runs in
a fast work dtype; the final equality-KKT system on the converged active set
is then re-solved by iterative refinement: each sweep computes the residual
of that system in float64 and solves for a correction in the work dtype.
Three tiers: the dense LU of the assembled system (:func:`refine_result`),
the factorization-free padded-operator CG (:func:`refine_result_cg`, through
``ops/kkt.py::kkt_solve_rhs_cg``), and the double-double continuation on the
host (:func:`solve_qp_refined_dd`).

The refined system at a fixed active set (statuses S): stationarity on IN
variables, x pinned on DN/UP variables, kept working rows enforced,
dropped-row multipliers zeroed.

The LU tier factors in the problem's own dtype on every device (the JAX
package pins it to float32 off the CPU because a TPU's LU is float32-only).
Two rules of the CG tier carry over from the JAX package unchanged and are still to be
re-measured on the GPU (ROADMAP.md): the correction's work dtype is the
problem's own on a CPU tensor and float32 on a CUDA tensor, and the
residual dtype is always float64 (the JAX package's choice with x64 on).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ssqp_tpu_torch.ops.bmat import mtv, mv
from ssqp_tpu_torch.ops.kkt import kkt_solve_rhs_cg, recover_duals
from ssqp_tpu_torch.ops.masked_gj import select_purge
from ssqp_tpu_torch.solvers.ssqp import _primal_violation, _rows, _where
from ssqp_tpu_torch.types import (
    DN, EO, IN, QP, UP, QP_FIELDS, Result, Settings, as_torch_dtype)
from ssqp_tpu_torch.utils.diagnostics import span
from ssqp_tpu_torch.utils.precision import highest_matmul

HI = torch.float64  # the residual dtype


def _act_rows(Q: QP, S):
    """Working rows: every equality, and the inequalities with status EO."""
    act = torch.ones((S.shape[0], Q.M), dtype=torch.bool, device=S.device)
    if Q.J > 0:
        act = torch.cat([act, S[:, Q.N:] == EO], dim=1)
    return act


def _kkt_matrix(Q: QP, free, keep, z):
    """Assemble the fixed-active-set KKT matrix and right-hand side at full
    padded shape: K (B, N+R, N+R), rhs (B, N+R). Rows of free variables
    carry V, rows of bound variables the identity (x pinned to z), kept
    working rows [A; G], dropped rows the identity (multiplier zero). Masks
    and concatenations only: no rounding. Returns (K, rhs, AG, bg)."""
    dtype = Q.V.dtype
    AG, bg = _rows(Q)
    fm = free.to(dtype)
    km = keep.to(dtype)
    K11 = Q.V * fm.unsqueeze(-1) + torch.diag_embed(1.0 - fm)
    K12 = AG.transpose(-1, -2) * (fm.unsqueeze(-1) * km.unsqueeze(-2))
    K21 = AG * km.unsqueeze(-1)
    K22 = torch.diag_embed(1.0 - km)
    K = torch.cat([torch.cat([K11, K12], dim=-1),
                   torch.cat([K21, K22], dim=-1)], dim=-2)
    rhs = torch.cat([torch.where(free, -Q.q, z), km * bg], dim=-1)
    return K, rhs, AG, bg


# ---------------------------------------------------------------------------
# Double-double (compensated) arithmetic, the beyond-float64 residuals of
# solve_qp_refined_dd. These run in host numpy by design, as in the JAX
# package: an error-free transform is algebraically zero (TwoSum's error
# term simplifies to 0 in exact arithmetic), so a compiler that reassociates
# floating point across a larger graph can drop the compensation. Numpy
# evaluates each operation as written. They serve small problems, where a
# few O(n^2) host sweeps are cheap next to the device solve.
# ---------------------------------------------------------------------------

_SPLITTER = 134217729.0  # 2^27 + 1 (Dekker split for binary64)


def _np_two_sum(a, b):
    """Error-free sum: a + b = s + err exactly (Knuth TwoSum)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _np_two_prod(a, b):
    """Error-free product by Dekker splitting: a * b = p + err exactly."""
    p = a * b
    ac = _SPLITTER * a
    ahi = ac - (ac - a)
    alo = a - ahi
    bc = _SPLITTER * b
    bhi = bc - (bc - b)
    blo = b - bhi
    err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, err


def _np_dd_matvec(K, xh, xl):
    """Compensated ``K @ (xh + xl)`` as a double-double (hi, lo) pair: every
    float64 rounding error of the accumulation lands in the lo part."""
    hi = np.zeros(K.shape[0])
    lo = np.zeros(K.shape[0])
    for j in range(K.shape[1]):
        a = K[:, j]
        p, e = _np_two_prod(a, xh[j])
        hi, err = _np_two_sum(hi, p)
        lo = lo + (err + e + a * xl[j])
    return hi, lo


def _np_dd_add(sh, sl, e):
    """(sh + sl) + e in double-double, renormalized."""
    t, err = _np_two_sum(sh, e)
    sl = sl + err
    return _np_two_sum(t, sl)


def _kept_rows(Q: QP, res: Result, settings: Settings, free, z, fac_dtype):
    """The kept-rows decision of every refinement tier: purge the
    free-masked working rows in the factor dtype, with the tolerance floored
    at the float32 tier when downcast (the S-loop made its rank calls in the
    search dtype, and the refined system must enforce the same kept rows).
    Returns (keep, act, AG, bg, fm)."""
    M, J = Q.M, Q.J
    act = _act_rows(Q, res.S)
    AGf, bgf = _rows(Q)
    fm = free.to(Q.V.dtype)
    bE = bgf - mv(AGf, z * (1 - fm))
    Ap = (AGf * fm.unsqueeze(-2)).to(fac_dtype)
    bp = bE.to(fac_dtype)
    tol_p = (max(float(settings.tol), 2.0**-16)
             if fac_dtype == torch.float32 else settings.tol)
    keep, _, _ = select_purge(settings.pivot, M + J)(Ap, bp, act, tol_p)
    return keep, act, AGf, bgf, fm


def _as_hi(Q: QP) -> QP:
    return dataclasses.replace(
        Q, **{f: getattr(Q, f).to(HI) for f in QP_FIELDS})


def _refine_accept(Q: QP, res: Result, x_ref, settings: Settings, free,
                   with_duals: bool) -> Result:
    """Acceptance guard of the refinement paths: take the refined point only
    if it does not worsen the objective (by more than sqrt(tol)) and does
    not degrade primal feasibility beyond the searched point's own
    violation (floored at tol), or if it near-restores feasibility of a
    materially infeasible searched point; otherwise keep the searched
    point. x comes back in float64; failed solves keep their point and get
    zero duals."""
    Qh = _as_hi(Q)
    x_old = res.x.to(HI)
    fobj = lambda xx: (0.5 * torch.sum(xx * mv(Qh.V, xx), dim=1)
                       + torch.sum(Qh.q * xx, dim=1))
    ftol = float(settings.tol) ** 0.5
    tol_hi = float(settings.tol)
    viol_ref = _primal_violation(Qh, x_ref)
    viol_old = _primal_violation(Qh, x_old)
    feas = viol_ref <= torch.clamp(viol_old, min=tol_hi)
    better = fobj(x_ref) <= fobj(x_old) + ftol
    rescue = (viol_old > 10.0 * tol_hi) & (
        viol_ref <= torch.clamp(0.1 * viol_old, min=tol_hi))
    ok = (res.status > 0) & feas & (better | rescue)
    out = Result(_where(ok, x_ref, x_old), res.S, res.status)
    if with_duals:
        AGd, _ = _rows(Qh)
        lam, gam = recover_duals(Qh.V, Qh.q, AGd, out.x, free,
                                 _act_rows(Q, res.S))
        solved = res.status > 0
        lam = _where(solved, lam, torch.zeros_like(lam))
        gam = _where(solved, gam, torch.zeros_like(gam))
        out = Result(out.x, out.S, out.status, lam, gam)
    return out


@highest_matmul
def refine_result_cg(Q: QP, res: Result, settings: Settings, iters: int = 6,
                     with_duals: bool = True, exact_sweeps: bool = False):
    """Factorization-free iterative refinement of a solved batch on its
    converged active sets (statuses unchanged, only x improved).

    Each sweep is one float64 residual of the fixed-active-set KKT system
    and one CG correction solve in the work dtype, whose multi-RHS carry
    warm-starts the sweep-invariant ``Vp^{-1} Ap'`` columns across sweeps.
    ``exact_sweeps`` runs exactly ``iters`` sweeps (the tail-refine recipe);
    otherwise a float32 correction runs at least 6. Returns a float64 x
    through the acceptance guard (:func:`_refine_accept`), with dual
    certificates re-derived at the refined point when ``with_duals``."""
    N, M, J = Q.N, Q.M, Q.J
    R = M + J
    dtype = Q.V.dtype
    Sx = res.S[:, :N]
    free = Sx == IN
    z = torch.where(Sx == DN, Q.d, torch.where(Sx == UP, Q.u, res.x))

    fac_dtype = dtype if Q.device.type == "cpu" else torch.float32
    keep, _, AGf, bgf, fm = _kept_rows(Q, res, settings, free, z, fac_dtype)

    V_hi = Q.V.to(HI)
    AG_hi = AGf.to(HI)
    fm_hi = fm.to(HI)
    km_hi = keep.to(HI)
    z_hi = z.to(HI)
    rhs1 = torch.where(free, -Q.q.to(HI), z_hi)
    rhs2 = km_hi * bgf.to(HI)

    Vf = Q.V.to(fac_dtype)
    AGc = AGf.to(fac_dtype)
    if fac_dtype == torch.float32:
        cg_iters, cg_rtol = max(settings.cg_iters, 96), 1e-7
    else:
        cg_iters, cg_rtol = settings.cg_iters, settings.cg_rtol

    Bn = res.x.shape[0]
    x = fm_hi * res.x.to(HI) + (1.0 - fm_hi) * z_hi
    lam = torch.zeros((Bn, R), dtype=HI, device=Q.device)
    sol = torch.zeros((Bn, N, 1 + R), dtype=fac_dtype, device=Q.device)
    n_sweeps = (iters if exact_sweeps or fac_dtype == HI else max(iters, 6))
    for _ in range(n_sweeps):
        r1 = rhs1 - (fm_hi * (mv(V_hi, x) + mtv(AG_hi, km_hi * lam))
                     + (1.0 - fm_hi) * x)
        if R > 0:
            r2 = rhs2 - (km_hi * mv(AG_hi, x) + (1.0 - km_hi) * lam)
        else:
            r2 = torch.zeros((Bn, 0), dtype=HI, device=Q.device)
        # warm-start only the sweep-invariant columns 1..R: the residual
        # column's previous solution is the previous, larger correction
        sol[..., 0] = 0.0
        dx, dl, _ok, sol = kkt_solve_rhs_cg(
            Vf, AGc, free, keep, r1.to(fac_dtype), r2.to(fac_dtype),
            cg_iters, cg_rtol, x0=sol, return_sol=True)
        x = x + dx.to(HI)
        lam = lam + dl.to(HI)
    return _refine_accept(Q, res, x, settings, free, with_duals)


@highest_matmul
def refine_result(Q: QP, res: Result, settings: Settings, iters: int = 2,
                  with_duals: bool = True):
    """Refine a solved batch on its converged active sets (statuses
    unchanged, only x improved) through the dense LU of the fixed-active-set
    KKT system (:func:`_kkt_matrix`).

    The system is factored once per instance in the problem's dtype
    (``torch.linalg.lu_factor_ex``; a singular instance gives a non-finite
    point, which the guard rejects, and leaves the others alone); each sweep
    takes the residual in float64 and solves for the correction with the
    same factors: ``iters`` sweeps when the factor is float64, at least 6
    otherwise. Returns a float64 x through the acceptance guard
    (:func:`_refine_accept`), duals re-derived when ``with_duals``."""
    N = Q.N
    dtype = Q.V.dtype
    Sx = res.S[:, :N]
    free = Sx == IN
    z = torch.where(Sx == DN, Q.d, torch.where(Sx == UP, Q.u, res.x))
    keep, _, _, _, _ = _kept_rows(Q, res, settings, free, z, dtype)
    K, rhs, _, _ = _kkt_matrix(Q, free, keep, z)
    LU, piv, _ = torch.linalg.lu_factor_ex(K)
    solve = lambda r: torch.linalg.lu_solve(LU, piv, r.unsqueeze(-1)) \
        .squeeze(-1)
    K_hi = K.to(HI)
    rhs_hi = rhs.to(HI)
    s = solve(rhs).to(HI)
    n_sweeps = iters if dtype == HI else max(iters, 6)
    for _ in range(n_sweeps):
        r = rhs_hi - mv(K_hi, s)
        s = s + solve(r.to(dtype)).to(HI)
    return _refine_accept(Q, res, s[:, :N], settings, free, with_duals)


def _search_and_refine(Q: QP, Qs: QP, s_search: Settings, settings: Settings,
                       iters: int, method: str) -> Result:
    """Search on the search copy ``Qs`` (duals not attached), then refine
    against ``Q``; both single problems, run as a batch of one. The JAX
    package fuses the two into one compiled dispatch; here they are one
    plain function. The refinement runs inside the span ``ssqp.refine``."""
    from ssqp_tpu_torch.solvers.ssqp import solve_qp_auto_core

    refine = refine_result_cg if method == "cg" else refine_result
    one = lambda P: dataclasses.replace(P, q=P.q.unsqueeze(0))
    res = solve_qp_auto_core(one(Qs), s_search)
    res = Result(res.x.to(Q.V.dtype), res.S, res.status)
    with span("refine"):
        r = refine(one(Q), res, settings, iters)
    return Result(r.x[0], r.S[0], r.status[0], r.lam[0], r.gamma[0])


def solve_qp_refined(Q: QP, *, settings: Optional[Settings] = None,
                     iters: int = 2, search_dtype=None,
                     method: str = "cg") -> Result:
    """High-accuracy solve of one QP: the active-set search in a fast dtype
    (``search_dtype``, e.g. float32 on a float64 problem), then refinement
    of the final KKT system against the full-precision data,
    ``method="cg"`` (:func:`refine_result_cg`) or ``"lu"``
    (:func:`refine_result`). An invalid model (``mc <= 0``) returns the
    plain solve's rejection in the problem's dtype."""
    from ssqp_tpu_torch.solvers.ssqp import solve_qp

    if Q.batch_size is not None:
        raise ValueError("solve_qp_refined takes one QP; use "
                         "parallel.batch.solve_qp_batch_refined for a batch")
    if method not in ("cg", "lu"):
        raise ValueError(f"method={method!r}: 'cg' or 'lu'")
    if search_dtype is None or as_torch_dtype(search_dtype) == Q.V.dtype:
        Qs, s_search = Q, settings or Settings.for_dtype(Q.V.dtype)
    else:
        # the search dtype's tier, carrying the caller's structural choices
        # (budget, strategy, pivot rules) but not its tolerances
        Qs = Q.astype(search_dtype)
        s_search = Settings.for_dtype(search_dtype)
        if settings is not None:
            s_search = dataclasses.replace(
                s_search, max_iter=settings.max_iter,
                multi_free=settings.multi_free, clip_step=settings.clip_step,
                rule=settings.rule, pivot=settings.pivot)
    settings = settings or Settings.for_dtype(Q.V.dtype)
    if Q.mc <= 0:
        r = solve_qp(Qs, settings=s_search)
        cast = lambda t: None if t is None else t.to(Q.V.dtype)
        return Result(cast(r.x), r.S, r.status, cast(r.lam), cast(r.gamma))
    return _search_and_refine(Q, Qs, s_search, settings, iters, method)


def solve_qp_refined_dd(Q: QP, *, settings: Optional[Settings] = None,
                        search_dtype=None, sweeps: int = 6):
    """Beyond-float64 tier (the reference's Settings{BigFloat} at tol
    2^-76): :func:`solve_qp_refined`, then compensated double-double
    residual sweeps on the final fixed-active-set KKT system.

    Returns ``(Result, x_lo)``: the solution is approximated by the
    unevaluated float64 pair ``Result.x + x_lo`` (about 32 significant
    digits of representation; the accuracy is condition-limited near
    eps64^2). The sweeps run in host numpy, as in the JAX package, and that
    is the design, not a fallback: K and rhs are copied to the host and
    every error-free transform is evaluated as written (see the note above
    ``_np_two_sum``). For small problems and a float64 ``Q``; ``x_lo`` comes
    back on Q's device."""
    from scipy.linalg import lu_factor, lu_solve

    settings = settings or Settings.for_dtype(Q.V.dtype)
    res = solve_qp_refined(Q, settings=settings, search_dtype=search_dtype)
    dev = Q.device
    zeros = torch.zeros(Q.N, dtype=Q.V.dtype, device=dev)
    if int(res.status) <= 0:
        return res, zeros
    N, M, J = Q.N, Q.M, Q.J
    Sx = res.S[:N]
    free = Sx == IN
    z = torch.where(Sx == DN, Q.d, torch.where(Sx == UP, Q.u, res.x))
    # the kept rows of the refined solve being continued: refine_result_cg
    # purges in its work dtype, the problem's own on the CPU, float32 on a
    # CUDA tensor
    fac_dtype = Q.V.dtype if dev.type == "cpu" else torch.float32
    one = dataclasses.replace(Q, q=Q.q.unsqueeze(0))
    keep, _, _, _, _ = _kept_rows(
        one, Result(res.x[None], res.S[None], res.status[None]), settings,
        free[None], z[None], fac_dtype)
    K, rhs, _, _ = _kkt_matrix(one, free[None], keep, z[None])
    K = K[0].to(HI).cpu().numpy()
    rhs = rhs[0].to(HI).cpu().numpy()
    fac = lu_factor(K)
    sh = lu_solve(fac, rhs)
    for _ in range(2):  # plain float64 sweeps first
        sh = sh + lu_solve(fac, rhs - K @ sh)
    sl = np.zeros_like(sh)
    for _ in range(max(int(sweeps), 4)):
        mh, ml = _np_dd_matvec(K, sh, sl)
        rh, t = _np_two_sum(rhs, -mh)
        rl = t - ml
        e = lu_solve(fac, rh + rl)
        sh, sl = _np_dd_add(sh, sl, e)
    x_hi, x_lo = sh[:N], sl[:N]
    # the acceptance guard of the refined tiers: never a pair that is less
    # feasible or materially worse than the accepted refined point
    host = lambda t: t.to(HI).cpu().numpy()
    A, b, G, g, d, u = (host(t) for t in (Q.A, Q.b, Q.G, Q.g, Q.d, Q.u))
    V, q, x0 = host(Q.V), host(Q.q), host(res.x)

    def viol(x):
        v = 0.0
        if M > 0:
            v = max(v, np.abs(A @ x - b).max())
        if J > 0:
            v = max(v, max(0.0, (G @ x - g).max()))
        return max(v, max(0.0, (d - x).max()), max(0.0, (x - u).max()))

    fobj = lambda x: 0.5 * x @ V @ x + q @ x
    tol = float(settings.tol)
    ok = (np.isfinite(x_hi).all() and np.isfinite(x_lo).all()
          and viol(x_hi) <= max(viol(x0), tol)
          and fobj(x_hi) <= fobj(x0) + np.sqrt(tol))
    if not ok:
        return res, zeros
    as_t = lambda a: torch.tensor(a, dtype=Q.V.dtype, device=dev)
    return (Result(as_t(x_hi), res.S, res.status, res.lam, res.gamma),
            as_t(x_lo))
