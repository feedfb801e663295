"""Iterative refinement on the final active set, batch-first (PyTorch).

Counterpart of ``ssqp_tpu/solvers/refine.py`` (the factorization-free tier
that the batched tail refinement runs). The active-set search runs in a fast
work dtype; the final equality-KKT system on the converged active set is
then re-solved by iterative refinement: each sweep computes the residual of
that system in float64 and solves for a correction in the work dtype through
the padded-operator CG (``ops/kkt.py::kkt_solve_rhs_cg``).

The refined system at a fixed active set (statuses S): stationarity on IN
variables, x pinned on DN/UP variables, kept working rows enforced,
dropped-row multipliers zeroed.

Two rules carry over from the JAX package unchanged and are still to be
re-measured on the GPU (ROADMAP.md): the correction's work dtype is the
problem's own on a CPU tensor and float32 on a CUDA tensor, and the
residual dtype is always float64 (the JAX package's choice with x64 on).
"""

from __future__ import annotations

import dataclasses

import torch

from ssqp_tpu_torch.ops.bmat import mtv, mv
from ssqp_tpu_torch.ops.kkt import kkt_solve_rhs_cg, recover_duals
from ssqp_tpu_torch.ops.masked_gj import select_purge
from ssqp_tpu_torch.solvers.ssqp import _primal_violation, _rows, _where
from ssqp_tpu_torch.types import DN, EO, IN, QP, UP, QP_FIELDS, Result, Settings
from ssqp_tpu_torch.utils.precision import highest_matmul

HI = torch.float64  # the residual dtype


def _act_rows(Q: QP, S):
    """Working rows: every equality, and the inequalities with status EO."""
    act = torch.ones((S.shape[0], Q.M), dtype=torch.bool, device=S.device)
    if Q.J > 0:
        act = torch.cat([act, S[:, Q.N:] == EO], dim=1)
    return act


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
