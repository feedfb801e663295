"""Status Switching Method for convex QP — batch-first PyTorch version.

Counterpart of ``ssqp_tpu/solvers/ssqp.py`` (reference: src/SSQP.jl). Each
variable carries a status in {IN, DN, UP} and each inequality row one in
{OE, EO}; every iteration solves the equality-constrained KKT system on the
IN variables (mask-padded, ops/kkt.py) and flips statuses until the KKT
conditions hold.

Batching: every function works on a batch of instances. Each
``lax.while_loop`` of the JAX package (vmapped there) is a Python loop here
that runs its body on the instances still running and writes their results
back; finished instances keep their state, and per-instance counters (the
S-loop's ``it``, which is the status on success, and the PDAS round count)
advance only while the instance runs. That is what a vmapped while_loop
computes, without paying for the finished lanes.

Status codes (reference SSQP.jl:205-209): > 0 success (= iteration count),
0 infeasible (Phase-1), -1 numerical error, -max_iter not converged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ssqp_tpu_torch.ops.bmat import cat_vec, mtv, mv, stack_rows
from ssqp_tpu_torch.ops.kkt import (
    kkt_allfree_shared, kkt_solve, kkt_solve_cg, recover_dropped_multipliers,
    recover_duals, shared_jacobi_bounds,
)
from ssqp_tpu_torch.ops.masked_gj import select_purge
from ssqp_tpu_torch.types import (
    DN, EO, IN, OE, QP, UP, Result, Settings, batch_of,
)
from ssqp_tpu_torch.utils.diagnostics import count, span
from ssqp_tpu_torch.utils.precision import highest_matmul

_BIG = float("inf")


def _rows(Q: QP):
    """Stacked working rows ``AG = [A; G]`` and ``bg = [b; g]``."""
    if Q.J > 0:
        return stack_rows(Q.A, Q.G), cat_vec(Q.b, Q.g)
    return Q.A, Q.b


def _where(m, a, b):
    """Per-instance select: mask m (B,) broadcast against a, b (B, ...)."""
    return torch.where(m.view(m.shape + (1,) * (a.dim() - 1)), a, b)


def _polish(z, Sx, Se, d, u, G, g, tol):
    """Final cleanup (reference polishSz!, SSQP.jl:10-32): pin bound
    statuses, snap IN variables within tol of a bound, recompute inequality
    statuses."""
    z1 = torch.where(Sx == DN, d, torch.where(Sx == UP, u, z))
    snap_dn = (Sx == IN) & ((z - d).abs() < tol)
    snap_up = (Sx == IN) & ~snap_dn & ((z - u).abs() < tol)
    z1 = torch.where(snap_dn, d, torch.where(snap_up, u, z1))
    Sx1 = torch.where(snap_dn, DN, torch.where(snap_up, UP, Sx)).to(Sx.dtype)
    if g.shape[-1] > 0:
        Se1 = torch.where((g - mv(G, z1)).abs() < tol, EO, OE).to(Se.dtype)
    else:
        Se1 = Se
    return z1, Sx1, Se1


def _free_k(z, Sx, V, q, tol):
    """K=0 handler (reference freeK!, SSQP.jl:35-59): free bound variables
    whose gradient sign permits improvement; optimal if none."""
    p = mv(V, z) + q
    can_free = ((p >= -tol) & (Sx == UP)) | ((p <= tol) & (Sx == DN))
    any_free = can_free.any(dim=1)
    freed_max = torch.where(can_free, p.abs(), torch.zeros_like(p)).amax(dim=1)
    optimal = ~any_free | (any_free & (freed_max <= tol))
    Sx_new = torch.where(optimal.unsqueeze(1), Sx,
                         torch.where(can_free, IN, Sx)).to(Sx.dtype)
    return Sx_new, optimal


def _loop_body(Q: QP, settings: Settings, mf: bool, cg_it: int, z, Sx, Se,
               it, sol):
    """One S-loop iteration for every instance of the (sub-)batch
    (reference SSQP.jl:237-377; see the JAX package's ``solve_qp_loop`` for
    the reasoning behind each policy). ``it`` is already incremented."""
    V, q, G, g, d, u = Q.V, Q.q, Q.G, Q.g, Q.d, Q.u
    N, M, J = Q.N, Q.M, Q.J
    R = M + J
    Bn = z.shape[0]
    dtype, dev = z.dtype, z.device
    tol, tolG = settings.tol, settings.tolG
    AG, bg = _rows(Q)
    fu = torch.isfinite(u)
    fd = torch.isfinite(d)
    bfalse = torch.zeros(Bn, dtype=torch.bool, device=dev)

    free = Sx == IN
    K = free.sum(dim=1)
    SxK, optK = _free_k(z, Sx, V, q, tol)

    fm = free.to(dtype)
    act = torch.ones((Bn, M), dtype=torch.bool, device=dev)
    if J > 0:
        act = torch.cat([act, Se == EO], dim=1)
    bE = bg - mv(AG, z * (1.0 - fm))
    if R > 0:
        purge = select_purge(settings.pivot, R)
        keep, inconsistent, bad_rows = purge(AG * fm.unsqueeze(1), bE, act, tol)
    else:
        keep = torch.ones((Bn, 0), dtype=torch.bool, device=dev)
        inconsistent, bad_rows = bfalse, keep

    aggr = (it <= N + J + 16) & mf

    if settings.kkt_cg:
        res, sol_n = kkt_solve_cg(V, q, AG, bg, z, free, keep, cg_it,
                                  settings.cg_rtol, ok_rtol=settings.cg_ok_rtol,
                                  x0=sol, return_sol=True)
    else:
        res = kkt_solve(V, q, AG, bg, z, free, keep,
                        ok_rtol=settings.cg_ok_rtol)
        sol_n = sol
    alpha, p, gamma = res.alpha, res.p, res.gamma
    numerr = (inconsistent & (not mf)) | ~res.ok
    # working-set repair (multi_free mode only)
    any_bad = bad_rows.any(dim=1)
    if R > 0:
        supp = mtv(AG.abs(), bad_rows.to(dtype)) > 0
    else:
        supp = torch.zeros((Bn, N), dtype=torch.bool, device=dev)
    can_emerg = supp & ~free
    any_emerg = can_emerg.any(dim=1)
    emerg = any_bad & any_emerg & mf
    SxE = torch.where(can_emerg, IN, Sx).to(Sx.dtype)
    last_resort = any_bad & ~any_emerg & mf
    if J > 0:
        Se = torch.where((last_resort & aggr).unsqueeze(1) & bad_rows[:, M:],
                         OE, Se).to(Se.dtype)
    numerr = numerr | (last_resort & ~aggr)
    bad_eq = bad_rows[:, :M].any(dim=1) if M > 0 else bfalse
    numerr = numerr | (last_resort & bad_eq)

    # ---- aStep ratio test (SSQP.jl:61-134) ---------------------------------
    inf = torch.full_like(z, _BIG)
    safe_p = torch.where(p == 0, torch.ones_like(p), p)
    up_ev = free & (p > tol) & fu
    dn_ev = free & (p < -tol) & fd
    L_up = torch.where(up_ev, (u - z) / safe_p, inf)
    L_dn = torch.where(dn_ev, (d - z) / safe_p, inf)
    if J > 0:
        Og = Se == OE
        po = mv(G, p)
        zo = g - mv(G, z)
        row_ev = Og & (po > tol)
        L_row = torch.where(
            row_ev,
            torch.clamp(zo, min=0.0) / torch.where(po == 0, torch.ones_like(po), po),
            torch.full_like(po, _BIG))
        Lmin_rows = L_row.amin(dim=1)
    else:
        Lmin_rows = torch.full((Bn,), _BIG, dtype=dtype, device=dev)
    L1 = torch.clamp(torch.minimum(L_up.amin(dim=1),
                                   torch.minimum(L_dn.amin(dim=1), Lmin_rows)),
                     max=1.0)
    do_step = p.abs().amax(dim=1) > tolG
    partial_step = do_step & (L1 < 1.0)

    zE = z + L1.unsqueeze(1) * p
    fl_up_e = up_ev & (L_up <= (L1 + tol).unsqueeze(1))
    fl_dn_e = dn_ev & (L_dn <= (L1 + tol).unsqueeze(1))
    degen = ~aggr & (L1 <= tol) & mf
    ev_all = fl_up_e | fl_dn_e
    any_ev = ev_all.any(dim=1)
    first_ev = ev_all.to(torch.uint8).argmax(dim=1)
    single = torch.arange(N, device=dev) == first_ev.unsqueeze(1)
    dsel = (degen & any_ev).unsqueeze(1)
    fl_up_e = torch.where(dsel, fl_up_e & single, fl_up_e)
    fl_dn_e = torch.where(dsel, fl_dn_e & single, fl_dn_e)
    zE = torch.where(fl_up_e, u, torch.where(fl_dn_e, d, zE))

    if settings.clip_step:
        cl_up = free & fu & (alpha > u)
        cl_dn = free & fd & (alpha < d)
        kcap = torch.clamp(K - (M + J + 1), min=0)
        sev = torch.where(cl_up, alpha - u, torch.where(cl_dn, d - alpha, -inf))
        order = torch.argsort(-sev, dim=1, stable=True)
        rank = torch.empty_like(order)
        rank.scatter_(1, order, torch.arange(N, device=dev).expand(Bn, N))
        pin_ok = rank < kcap.unsqueeze(1)
        zG = torch.where(cl_up, u, torch.where(cl_dn, d, alpha))
        zG = torch.where(free, zG, z)
        aggr_clip = aggr & (it <= 12)
        ac = aggr_clip.unsqueeze(1)
        fl_up = torch.where(ac, cl_up & pin_ok, fl_up_e)
        fl_dn = torch.where(ac, cl_dn & pin_ok, fl_dn_e)
        zA = torch.where(ac, zG, zE)
    else:
        aggr_clip = bfalse
        fl_up, fl_dn, zA = fl_up_e, fl_dn_e, zE
    SxA = torch.where(fl_up, UP, torch.where(fl_dn, DN, Sx)).to(Sx.dtype)
    if J > 0:
        act_e = row_ev & (L_row <= (L1 + tol).unsqueeze(1))
        first_row = (torch.arange(J, device=dev)
                     == act_e.to(torch.uint8).argmax(dim=1).unsqueeze(1))
        act_e = torch.where(dsel, torch.zeros_like(act_e),
                            torch.where(degen.unsqueeze(1), act_e & first_row,
                                        act_e))
        if settings.clip_step:
            act_g = Og & (mv(G, zA) > g + tol)
            act_sel = torch.where(aggr_clip.unsqueeze(1), act_g, act_e)
        else:
            act_sel = act_e
        SeA = torch.where(act_sel, EO, Se).to(Se.dtype)
    else:
        SeA = Se

    # ---- full/zero-step outcome: KKT multiplier check (SSQP.jl:136-188) ----
    zB = _where(do_step, alpha, z)
    viol_up = (Sx == UP) & (gamma > tolG)
    viol_dn = (Sx == DN) & (gamma < -tolG)
    var_key = torch.where(viol_up, -gamma, torch.where(viol_dn, gamma, inf))
    if J > 0:
        Lda = recover_dropped_multipliers(AG, free, keep, act, res.alphaL, M)
        row_viol = (Se == EO) & (Lda < -tolG)
        row_key = torch.where(row_viol, Lda, torch.full_like(Lda, _BIG))
        keys = torch.cat([var_key, row_key], dim=1)
    else:
        keys = var_key
    kmin = keys.argmin(dim=1)
    found = keys.gather(1, kmin.unsqueeze(1)).squeeze(1) < _BIG
    one_hot_v = (torch.arange(N, device=dev) == kmin.unsqueeze(1)) \
        & found.unsqueeze(1)
    free_v = torch.where(aggr.unsqueeze(1), viol_up | viol_dn, one_hot_v)
    SxB = torch.where(free_v & found.unsqueeze(1), IN, Sx).to(Sx.dtype)
    if J > 0:
        one_hot_r = (torch.arange(J, device=dev) == (kmin - N).unsqueeze(1)) \
            & found.unsqueeze(1)
        free_r = torch.where(aggr.unsqueeze(1), row_viol, one_hot_r)
        SeB = torch.where(free_r & found.unsqueeze(1), OE, Se).to(Se.dtype)
    else:
        SeB = Se
    zP, SxP, SeP = _polish(zB, SxB, SeB, d, u, G, g, tol)

    # ---- combine: freeK -> emergency release -> numerical error -> partial
    # step -> KKT flip -> optimal ---------------------------------------------
    is_free_k = K == 0

    def sel(freek_v, emerg_v, err_v, partial_v, chk_v, opt_v):
        x = _where(found, chk_v, opt_v)
        x = _where(partial_step, partial_v, x)
        x = _where(numerr, err_v, x)
        x = _where(emerg, emerg_v, x)
        return _where(is_free_k, freek_v, x)

    btrue = ~bfalse
    i0 = torch.zeros_like(it)
    z_n = sel(z, z, z, zA, zB, zP)
    Sx_n = sel(SxK, SxE, Sx, SxA, SxB, SxP)
    Se_n = sel(Se, Se, Se, SeA, SeB, SeP)
    done_n = sel(optK, bfalse, btrue, bfalse, bfalse, btrue)
    status_n = sel(torch.where(optK, it, i0), i0, torch.full_like(it, -1), i0,
                   i0, it)
    return z_n, Sx_n, Se_n, done_n, status_n.to(torch.int32), sol_n


@highest_matmul
def solve_qp_loop(Q: QP, Sx0, Se0, x0, settings: Settings, pre_status=None,
                  mf_flag=None, max_iter=None, cg_iters=None, sol0=None,
                  return_sol: bool = False):
    """Run the S-loop from a warm start on a batch (reference
    solveQP(Q, S, x0), SSQP.jl:237-377). ``Sx0`` (B, N) / ``Se0`` (B, J) are
    int8 statuses, ``x0`` (B, N) feasible points consistent with them.
    ``pre_status`` (B,) lets a caller short-circuit instances: <= 0 means
    already done with that code. ``mf_flag``/``max_iter``/``cg_iters``
    override the settings for this call (the fast and exact passes of
    :func:`solve_qp_warm2`)."""
    N, M, J = Q.N, Q.M, Q.J
    R = M + J
    Bn = x0.shape[0]
    dtype = Q.V.dtype
    dev = Q.device
    mf = bool(settings.multi_free if mf_flag is None else mf_flag)
    max_it = int(settings.max_iter if max_iter is None else max_iter)
    cg_it = int(settings.cg_iters if cg_iters is None else cg_iters)

    pre = (torch.ones(Bn, dtype=torch.int32, device=dev) if pre_status is None
           else pre_status.to(torch.int32))
    z = x0.to(dtype).clone()
    Sx = Sx0.to(torch.int8).clone()
    Se = Se0.to(torch.int8).clone()
    it = torch.zeros(Bn, dtype=torch.int32, device=dev)
    done = pre <= 0
    status = torch.where(done, pre, torch.zeros_like(pre))
    sol = (torch.zeros((Bn, N, 1 + R), dtype=dtype, device=dev) if sol0 is None
           else sol0.to(dtype).clone())
    while True:
        with span("s_loop_trip"):
            run = (~done & (it < max_it)).nonzero().squeeze(1)
            if run.numel() == 0:
                break
            count("s_loop.instance_iters", run.numel())
            it[run] += 1
            z_n, Sx_n, Se_n, done_n, status_n, sol_n = _loop_body(
                Q.take(run), settings, mf, cg_it, z[run], Sx[run], Se[run],
                it[run], sol[run])
            z[run], Sx[run], Se[run] = z_n, Sx_n, Se_n
            done[run], status[run], sol[run] = done_n, status_n, sol_n
    status = torch.where(done, status, torch.full_like(status, -max_it))
    S = torch.cat([Sx, Se], dim=1) if J > 0 else Sx
    res = Result(z, S, status)
    return (res, sol) if return_sol else res


def _primal_violation(Q: QP, x):
    """Max primal constraint violation per instance (0 when feasible, +inf
    on non-finite points)."""
    v = torch.where(torch.isfinite(x).all(dim=1), 0.0, _BIG).to(x.dtype)
    if Q.M > 0:
        v = torch.maximum(v, (mv(Q.A, x) - Q.b).abs().amax(dim=1))
    if Q.J > 0:
        v = torch.maximum(v, (mv(Q.G, x) - Q.g).amax(dim=1))
    v = torch.maximum(v, (Q.d - x).amax(dim=1))
    v = torch.maximum(v, (x - Q.u).amax(dim=1))
    return torch.clamp(v, min=0.0)


def _objective(Q: QP, x):
    return 0.5 * torch.sum(x * mv(Q.V, x), dim=1) + torch.sum(Q.q * x, dim=1)


def _attach_duals(Q: QP, res: Result, settings: Optional[Settings] = None):
    """Finalize solved instances: re-solve the free coordinates on the
    labeled active set (accepted only if finite, primally feasible and not
    worse) and attach least-squares dual certificates. Failed instances get
    zero duals."""
    with span("attach_duals"):
        N, M, J = Q.N, Q.M, Q.J
        dtype = Q.V.dtype
        AG, bg = _rows(Q)
        Bn = res.x.shape[0]
        Sx = res.S[:, :N]
        free = Sx == IN
        act = torch.ones((Bn, M), dtype=torch.bool, device=Q.device)
        if J > 0:
            act = torch.cat([act, res.S[:, N:] == EO], dim=1)
        x = res.x
        ok = res.status > 0
        if settings is not None:
            ridge = 100.0 * torch.finfo(dtype).eps
            rp = kkt_solve_cg(Q.V, Q.q, AG, bg, x, free, act,
                              settings.cg_iters, settings.cg_rtol,
                              ridge=ridge)
            xp = torch.clamp(rp.alpha, min=Q.d, max=Q.u)
            accept = (ok & torch.isfinite(xp).all(dim=1)
                      & (_primal_violation(Q, xp) <= 10.0 * settings.tol)
                      & (_objective(Q, xp)
                         <= _objective(Q, x) + settings.tol))
            x = _where(accept, xp, x)
        lam, gamma = recover_duals(Q.V, Q.q, AG, x, free, act)
        lam = _where(ok, lam, torch.zeros_like(lam))
        gamma = _where(ok, gamma, torch.zeros_like(gamma))
        return Result(x, res.S, res.status, lam, gamma)


@highest_matmul
def solve_qp_warm2(Q: QP, Sx0, Se0, x0, settings: Settings, pre_status=None,
                   with_duals: bool = True, sol0=None,
                   return_sol: bool = False):
    """Two-pass warm-started batch solve: a fast multi-free loop with a
    capped budget, then an exact reference-semantics loop (4x CG budget) for
    the instances the fast pass did not converge, then (f64 tier) one
    direct-Cholesky rerun of instances flagged as numerical errors."""
    if not settings.multi_free:
        r, sol = solve_qp_loop(Q, Sx0, Se0, x0, settings,
                               pre_status=pre_status, sol0=sol0,
                               return_sol=True)
        r = _attach_duals(Q, r, settings) if with_duals else r
        return (r, sol) if return_sol else r
    Bn = x0.shape[0]
    cap = min(settings.max_iter, Q.N + Q.J + 64)
    r1, sol1 = solve_qp_loop(Q, Sx0, Se0, x0, settings, pre_status=pre_status,
                             mf_flag=True, max_iter=cap,
                             cg_iters=settings.cg_iters, sol0=sol0,
                             return_sol=True)
    ok1 = r1.status > 0
    pre = (torch.ones(Bn, dtype=torch.int32, device=Q.device)
           if pre_status is None else pre_status.to(torch.int32))
    pre2 = torch.where(ok1, torch.full_like(pre, -9), pre)
    r2, sol2 = solve_qp_loop(Q, Sx0, Se0, x0, settings, pre_status=pre2,
                             mf_flag=False, max_iter=settings.max_iter,
                             cg_iters=4 * settings.cg_iters, sol0=sol0,
                             return_sol=True)
    x = _where(ok1, r1.x, r2.x)
    S = _where(ok1, r1.S, r2.S)
    status = torch.where(ok1, r1.status, r2.status)
    sol = _where(ok1, sol1, sol2)
    if settings.kkt_cg and settings.escalate_direct:
        direct = dataclasses.replace(settings, kkt_cg=False)
        pre3 = torch.where(status == -1, pre, torch.full_like(pre, -9))
        r3 = solve_qp_loop(Q, Sx0, Se0, x0, direct, pre_status=pre3,
                           mf_flag=False, max_iter=settings.max_iter)
        esc = (status == -1) & (r3.status > 0)
        x = _where(esc, r3.x, x)
        S = _where(esc, r3.S, S)
        status = torch.where(esc, r3.status, status)
    r = Result(x, S, status.to(torch.int32))
    r = _attach_duals(Q, r, settings) if with_duals else r
    return (r, sol) if return_sol else r


def _pdas_update(Q: QP, fu, fd, Sx, Se, res):
    """Semismooth-Newton status rebuild from a KKT candidate
    (Hintermüller-Ito-Kunisch; see :func:`_guess_start`)."""
    M = Q.M
    alpha, gamma = res.alpha, res.gamma
    free = Sx == IN
    up = (free & fu & (alpha >= Q.u)) | ((Sx == UP) & (gamma <= 0))
    dn = (free & fd & (alpha <= Q.d)) | ((Sx == DN) & (gamma >= 0))
    Sx_new = torch.where(up, UP, torch.where(dn, DN, IN)).to(torch.int8)
    if Q.J > 0:
        viol = mv(Q.G, alpha) >= Q.g
        muJ = res.alphaL[:, M:]
        Se_new = torch.where(((Se == OE) & viol) | ((Se == EO) & (muJ >= 0)),
                             EO, OE).to(torch.int8)
    else:
        Se_new = Se
    return Sx_new, Se_new, torch.clamp(alpha, min=Q.d, max=Q.u)


def _pdas_round(Q: QP, settings: Settings, Sx, Se, sol, W_loop=None,
                cheb_bounds=None):
    """One PDAS identification round on a batch: CG KKT solve on the current
    pinned set (warm-started from ``sol``) + semismooth status rebuild. The
    inner solve is the CG kernel, or the Chebyshev semi-iteration on
    ``cheb_bounds``, or the PCG preconditioned by ``W_loop``
    (ops/kkt.py::cg_solve_padded). Returns (Sx', Se', z', sol', changed
    (B,))."""
    M, J = Q.M, Q.J
    dtype = Q.V.dtype
    AG, bg = _rows(Q)
    fu = torch.isfinite(Q.u)
    fd = torch.isfinite(Q.d)
    ridge = 100.0 * torch.finfo(dtype).eps
    free = Sx == IN
    keep = torch.ones((Sx.shape[0], M), dtype=torch.bool, device=Sx.device)
    if J > 0:
        keep = torch.cat([keep, Se == EO], dim=1)
    zb = torch.where(Sx == UP, Q.u, torch.where(Sx == DN, Q.d, 0.0))
    res, sol = kkt_solve_cg(Q.V, Q.q, AG, bg, zb, free, keep,
                            settings.pdas_cg_iters, settings.pdas_rtol,
                            ridge=ridge, x0=sol, return_sol=True,
                            W=W_loop, cheb=cheb_bounds)
    Sx_new, Se_new, z_new = _pdas_update(Q, fu, fd, Sx, Se, res)
    changed = (Sx_new != Sx).any(dim=1) | (Se_new != Se).any(dim=1)
    return Sx_new, Se_new, z_new, sol, changed


def _pdas_shared_W(V, settings: Settings):
    """One-time shared ``W ~= V^{-1}`` (shifted Cholesky; NaN when the
    factorization fails, which round 1's finite gate then rejects) and,
    under ``Settings.pdas_cheb``, the Chebyshev rounds' spectral interval
    (ops/kkt.py::shared_jacobi_bounds, from V and W; None otherwise).
    Returns ``(W, cheb_bounds)``."""
    dtype = V.dtype
    N = V.shape[0]
    eye = torch.eye(N, dtype=dtype, device=V.device)
    scale = torch.clamp(torch.mean(torch.diagonal(V)), min=1.0)
    Lw, info = torch.linalg.cholesky_ex(
        V + (100.0 * torch.finfo(dtype).eps) * scale * eye)
    W = torch.cholesky_solve(eye, Lw)
    if int(info) != 0:
        W = torch.full_like(W, float("nan"))
    cheb_bounds = shared_jacobi_bounds(V, W) if settings.pdas_cheb else None
    return W, cheb_bounds


def _pdas_round1(Q: QP, settings: Settings, W, Sx0, Se0, z0, sol0):
    """Closed-form PDAS round 1 through the shared ``W`` (from the all-IN
    start the KKT system is the unmasked equality solve). Returns the
    updated (it, Sx, Se, z, sol); unchanged (it=0) where the candidate is
    not finite."""
    M, J = Q.M, Q.J
    dtype = Q.V.dtype
    AG, bg = _rows(Q)
    fu = torch.isfinite(Q.u)
    fd = torch.isfinite(Q.d)
    ridge = 100.0 * torch.finfo(dtype).eps
    keep0 = torch.cat([torch.ones(M, dtype=torch.bool, device=Q.device),
                       torch.zeros(J, dtype=torch.bool, device=Q.device)])
    res1, sol1 = kkt_allfree_shared(Q.V, W, Q.q, AG, bg, keep0, ridge)
    Sx1, Se1, z1 = _pdas_update(Q, fu, fd, Sx0, Se0, res1)
    good = res1.ok
    return (good.to(torch.int32), _where(good, Sx1, Sx0),
            _where(good, Se1, Se0), _where(good, z1, z0),
            _where(good, sol1, sol0))


def _waterfill_seed(Q: QP):
    """Exact active set of the SEPARABLE model of a single-equality box QP
    (``min 1/2 x'Dx + q'x s.t. a'x = beta, d <= x <= u``, D = diag(V)) — the
    water-filling seed for PDAS identification. The dual root h(lam*) = beta
    is isolated sort-free by 6 levels of 33-point bracket subdivision and
    finished with one false-position step; see the JAX package's
    ``_waterfill_seed`` for the derivation. Returns ``(valid (B,), Sx, z)``.
    """
    LEVELS, K = 6, 32
    Bn, N = batch_of(Q), Q.N
    dtype, dev = Q.V.dtype, Q.device
    a = Q.A[..., 0, :].expand(Bn, N)
    beta = Q.b[..., 0].expand(Bn)
    D = torch.diagonal(Q.V, dim1=-2, dim2=-1).expand(Bn, N)
    q = Q.q.expand(Bn, N)
    d = Q.d.expand(Bn, N)
    u = Q.u.expand(Bn, N)
    one = torch.ones((), dtype=dtype, device=dev)
    ok_D = (D > 0).all(dim=1)
    Ds = torch.where(D > 0, D, one)
    az = a == 0
    asafe = torch.where(az, one, a)

    def h(lam):  # lam (B, P) -> (B, P)
        t = (-q.unsqueeze(1) - lam.unsqueeze(-1) * a.unsqueeze(1)) \
            / Ds.unsqueeze(1)
        t = torch.minimum(torch.maximum(t, d.unsqueeze(1)), u.unsqueeze(1))
        return torch.sum(torch.where(az.unsqueeze(1), 0.0,
                                     a.unsqueeze(1) * t), dim=-1)

    h1 = lambda lam: h(lam.unsqueeze(1)).squeeze(1)
    lo_i = (-q - Ds * torch.where(a > 0, u, d)) / asafe
    hi_i = (-q - Ds * torch.where(a > 0, d, u)) / asafe
    bp = torch.cat([lo_i, hi_i], dim=1)
    bp_ok = torch.isfinite(bp) & torch.cat([~az, ~az], dim=1)
    lmin = torch.where(bp_ok, bp, _BIG).amin(dim=1)
    lmax = torch.where(bp_ok, bp, -_BIG).amax(dim=1)
    free_lo = ~az & ~torch.isfinite(torch.where(a > 0, u, d))
    free_hi = ~az & ~torch.isfinite(torch.where(a > 0, d, u))
    S_lo = torch.sum(torch.where(free_lo, a * a / Ds, 0.0), dim=1)
    S_hi = torch.sum(torch.where(free_hi, a * a / Ds, 0.0), dim=1)
    root_lo = lmin - (beta - h1(lmin)) / torch.where(S_lo > 0, S_lo, one)
    root_hi = lmax + (h1(lmax) - beta) / torch.where(S_hi > 0, S_hi, one)
    span = torch.clamp(lmax - lmin, min=1.0)
    lo = torch.where((S_lo > 0) & (root_lo < lmin), root_lo, lmin) - 1e-3 * span
    hi = torch.where((S_hi > 0) & (root_hi > lmax), root_hi, lmax) + 1e-3 * span
    have_bp = bp_ok.any(dim=1)
    lo = torch.where(have_bp, lo, -one)
    hi = torch.where(have_bp, hi, one)
    valid = ok_D & have_bp & (h1(lo) >= beta) & (beta >= h1(hi))

    grid01 = torch.arange(K + 1, dtype=dtype, device=dev) / K
    for _ in range(LEVELS):
        lam_g = lo.unsqueeze(1) + (hi - lo).unsqueeze(1) * grid01
        cnt = (h(lam_g) >= beta.unsqueeze(1)).sum(dim=1)
        k = torch.clamp(cnt - 1, 0, K - 1).unsqueeze(1)
        lo = lam_g.gather(1, k).squeeze(1)
        hi = lam_g.gather(1, k + 1).squeeze(1)
    hlo, hhi = h1(lo), h1(hi)
    dec = hlo > hhi
    lam = torch.where(dec, lo + (hlo - beta) * (hi - lo)
                      / torch.where(dec, hlo - hhi, one), 0.5 * (lo + hi))
    valid = valid & torch.isfinite(lam)
    t = (-q - lam.unsqueeze(1) * a) / Ds
    Sx = torch.where(t >= u, UP, torch.where(t <= d, DN, IN)).to(torch.int8)
    z = torch.minimum(torch.maximum(t, d), u)
    z = torch.where(torch.isfinite(z), z, 0.0)
    return valid, Sx, z


def _guess_start(Q: QP, settings: Settings, rounds: int = 12):
    """Active-set guess by primal-dual active-set (PDAS) identification on a
    batch: closed-form round 1 through a shared ``W ~= V^{-1}``
    (Settings.pdas_precond), the water-filling seed (single-equality box
    QPs), then CG rounds until each instance's status vector stops changing
    or its ``rounds`` budget is spent. Each round runs on the instances still
    changing. The rounds' inner solve follows the JAX package: the
    Chebyshev semi-iteration under ``pdas_cheb``, the PCG preconditioned by
    W under ``pdas_pcg``, Jacobi CG on the kernel otherwise; both variants
    need W, so without ``pdas_precond`` (which ``settings_for_shared``
    turns off for a per-instance V) they run Jacobi CG, as in the JAX
    package. Returns batched ``(z, Sx, Se, sol)``."""
    Bn = batch_of(Q)
    N, M, J = Q.N, Q.M, Q.J
    dtype, dev = Q.V.dtype, Q.device
    Sx = torch.full((Bn, N), IN, dtype=torch.int8, device=dev)
    Se = torch.full((Bn, J), OE, dtype=torch.int8, device=dev)
    z = torch.zeros((Bn, N), dtype=dtype, device=dev)
    sol = torch.zeros((Bn, N, 1 + M + J), dtype=dtype, device=dev)
    it = torch.zeros(Bn, dtype=torch.int32, device=dev)
    W_loop = cheb_bounds = None
    if settings.pdas_precond:
        if Q.V.dim() != 2:
            raise ValueError("pdas_precond needs a shared V "
                             "(settings_for_shared turns it off otherwise)")
        W, cheb_bounds = _pdas_shared_W(Q.V, settings)
        if settings.pdas_pcg:
            W_loop = W
        with span("pdas_round1"):
            count("pdas.instance_rounds", Bn)
            it, Sx, Se, z, sol = _pdas_round1(Q, settings, W, Sx, Se, z,
                                              sol)
    if settings.pdas_waterfill and M == 1 and J == 0:
        okw, Sxw, zw = _waterfill_seed(Q)
        Sx = _where(okw, Sxw, Sx)
        z = _where(okw, zw, z)
    active = it < rounds
    while True:
        with span("pdas_round"):
            idx = active.nonzero().squeeze(1)
            if idx.numel() == 0:
                break
            count("pdas.instance_rounds", idx.numel())
            Sxn, Sen, zn, soln, ch = _pdas_round(
                Q.take(idx), settings, Sx[idx], Se[idx], sol[idx], W_loop,
                cheb_bounds)
            Sx[idx], Se[idx], z[idx], sol[idx] = Sxn, Sen, zn, soln
            it[idx] += 1
            active[idx] = ch & (it[idx] < rounds)
    return z, Sx, Se, sol


def _guess_start_batch(Q: QP, settings: Settings, shared: tuple = (),
                       rounds: int = 12, compact=4):
    """Batch-level PDAS identification with compaction (the JAX package's
    ``_guess_start_batch``): the same rounds per instance as
    :func:`_guess_start`, with late rounds paying only for the instances
    still changing.

    ``compact`` is an int >= 1 or a sorted tuple of them (a cascade such as
    ``(2, 4, 8)``), checked as the JAX package checks it. In the JAX package
    it sets the static widths ``B // k`` of the buffers that the still-
    changing instances are gathered into, because XLA needs static shapes.
    Here :func:`_guess_start` already gathers exactly the still-changing
    instances in every round (``Q.take``), so there are no buffers to size
    and the widths do not change the schedule: the result is the plain
    path's, bit for bit. Returns batched ``(z, Sx, Se, sol)``."""
    from ssqp_tpu_torch.parallel.batch import settings_for_shared

    levels = (compact,) if isinstance(compact, int) else tuple(compact)
    if not (levels and all(isinstance(k, int) and k >= 1 for k in levels)
            and list(levels) == sorted(levels)):
        raise ValueError(f"compact={compact!r}: an int >= 1 or a sorted "
                         "tuple of them")
    return _guess_start(Q, settings_for_shared(settings, shared), rounds)


def solve_qp_auto_core(Q: QP, settings: Settings,
                       settings_lp: Optional[Settings] = None,
                       return_sol: bool = False, guess=None):
    """Three-stage batch solve, duals not attached (see
    :func:`solve_qp_auto`). Phase-1 and the two-pass loop run on the
    instances whose PDAS guess was rejected only. ``guess`` injects a
    precomputed PDAS identification ``(z, Sx, Se, sol)`` (from
    :func:`_guess_start_batch`) in place of :func:`_guess_start`."""
    from ssqp_tpu_torch.solvers.phase1 import init_qp_traced

    if not settings.multi_free:
        x0, Sx0, Se0, st1 = init_qp_traced(Q, settings_lp or settings)
        r, sol = solve_qp_loop(Q, Sx0, Se0, x0, settings, pre_status=st1,
                               return_sol=True)
        return (r, sol) if return_sol else r

    cap = min(settings.max_iter, Q.N + Q.J + 64)
    guess_cap = min(cap, 16)
    zg, Sxg, Seg, solg = (guess if guess is not None
                          else _guess_start(Q, settings))
    rg, sol = solve_qp_loop(Q, Sxg, Seg, zg, settings, mf_flag=True,
                            max_iter=guess_cap, cg_iters=settings.cg_iters,
                            sol0=solg, return_sol=True)
    okg = (rg.status > 0) & (_primal_violation(Q, rg.x) <= 10.0 * settings.tol)
    x, S, status = rg.x, rg.S, rg.status
    bad = (~okg).nonzero().squeeze(1)
    if bad.numel() > 0:
        with span("phase1_fallback"):
            count("phase1.fallback_instances", bad.numel())
            Qb = Q.take(bad)
            x0, Sx0, Se0, st1 = init_qp_traced(Qb, settings_lp or settings)
            r2, sol2 = solve_qp_warm2(Qb, Sx0, Se0, x0, settings,
                                      pre_status=st1, with_duals=False,
                                      return_sol=True)
            x[bad], S[bad], status[bad], sol[bad] = (r2.x, r2.S, r2.status,
                                                     sol2)
    r = Result(x, S, status)
    return (r, sol) if return_sol else r


@highest_matmul
def solve_qp_auto(Q: QP, settings: Settings,
                  settings_lp: Optional[Settings] = None) -> Result:
    """Batched auto solve (reference solveQP(Q::QP), SSQP.jl:224-234):

      1. guess pass — S-loop from the PDAS-identified active set, accepted
         only if converged AND primally feasible;
      2. fast pass — Phase-1 simplex start + multi-free loop (capped);
      3. exact pass — reference-semantics loop from the same Phase-1 state.

    Attaches least-squares dual certificates (Result.lam/.gamma)."""
    return _attach_duals(Q, solve_qp_auto_core(Q, settings, settings_lp),
                         settings)


def solve_qp(Q: QP, S=None, x0=None, *, settings: Optional[Settings] = None,
             settings_lp: Optional[Settings] = None) -> Result:
    """Solve one convex QP (reference solveQP, SSQP.jl:213-234); a batch of
    one underneath.

    With ``S``/``x0`` given this is a warm start straight into the S-loop
    (reference solveQP(Q, S, x0)); otherwise the three-stage auto solve."""
    if Q.batch_size is not None:
        raise ValueError("solve_qp takes one QP; use "
                         "parallel.batch.solve_qp_batch for a batch")
    settings = settings or Settings.for_dtype(Q.V.dtype)
    dev = Q.device
    if Q.mc <= 0:
        S_out = torch.cat([torch.full((Q.N,), DN, dtype=torch.int8, device=dev),
                           torch.full((Q.J,), OE, dtype=torch.int8, device=dev)])
        return Result(torch.zeros(Q.N, dtype=Q.V.dtype, device=dev), S_out,
                      torch.tensor(-1, dtype=torch.int32, device=dev))
    Q1 = dataclasses.replace(Q, q=Q.q.unsqueeze(0))
    if S is None or x0 is None:
        r = solve_qp_auto(Q1, settings, settings_lp)
    else:
        for t in (S, x0):
            if isinstance(t, torch.Tensor) and t.device != dev:
                raise ValueError(f"warm start on {t.device}, QP on {dev}")
        S = torch.as_tensor(S, device=dev).to(torch.int8).unsqueeze(0)
        x0 = torch.as_tensor(x0, device=dev).to(Q.V.dtype).unsqueeze(0)
        r = solve_qp_warm2(Q1, S[:, :Q.N], S[:, Q.N:], x0, settings)
    return Result(r.x[0], r.S[0], r.status[0], r.lam[0], r.gamma[0])
