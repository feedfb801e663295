"""Least-index criss-cross LP solver, batch-first (PyTorch).

Counterpart of ``ssqp_tpu/solvers/cclp.py`` (the reference's exported
``solveLP``, CCLP.jl): no Phase-1; from a (possibly infeasible) basis chosen
by projected reduced cost, pivot on the smallest violated index, a dual
violation (reduced cost < -tol on a nonbasic column) or a primal one
(negative basic value), until none is left (CCLP.jl:88-174).

As in the JAX package: standard form from utils/standard_form.py; the basis
inverse is maintained (product-form update per pivot and three Newton
refreshes per step) with a drift gate at tol^(1/4) on the error left after
the refreshes; a -1 drift exit gets one second chance from a repaired,
freshly inverted basis (:func:`cclp_repair`); the "infinitely many" check
covers the original and G-slack columns. The while loops run through
``solvers/simplex.py::run_chunked`` (eight masked steps per host check);
the batch-level branches (the repair, the float64 rescue) run on the rows
that need them after one host check.

Status codes (CCLP.jl:59-61): 1 unique, 2 infinitely many, 0 infeasible,
3 unbounded or dual infeasible, -1 numerical error, -max_iter not done.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ssqp_tpu_torch.ops.masked_gj import masked_independent_cols
from ssqp_tpu_torch.solvers.lp import (
    _attach_lp_duals, _first, _invalid, _one, _put, _take, static_nonzero)
from ssqp_tpu_torch.solvers.simplex import _rows_where, run_chunked
from ssqp_tpu_torch.types import (
    DN, IN, LP, MC_INFEASIBLE, MC_NUMERICAL, Result, Settings)
from ssqp_tpu_torch.utils.precision import highest_matmul
from ssqp_tpu_torch.utils.standard_form import recover_solution, standard_form


class _CCState(NamedTuple):
    B: torch.Tensor  # (B, R) int64 basis column indices (unsorted positions)
    in_basis: torch.Tensor  # (B, Nt) bool
    S: torch.Tensor  # (B, Nt) int8
    xB: torch.Tensor  # (B, R) last basic values
    invB: torch.Tensor  # (B, R, R) maintained basis inverse
    it: torch.Tensor  # (B,) int32
    done: torch.Tensor  # (B,) bool
    status: torch.Tensor  # (B,) int32


def _basis_inverse(A1, B):
    Bn, R, _ = A1.shape
    A_B = torch.gather(A1, 2, B.unsqueeze(1).expand(Bn, R, R))
    return torch.linalg.inv_ex(A_B)[0]


def _init_basis(c1, A1, tol):
    """Starting basis by projected reduced cost (reference initSx,
    CCLP.jl:8-39): order the columns by p = c - A'(A' \\ c) ascending and
    keep the first maximal independent subset. The least squares go through
    ridge-regularized normal equations. Returns in_basis (B, Nt)."""
    Bn, R, Nt = A1.shape
    eye = torch.eye(R, dtype=A1.dtype, device=A1.device)
    Mn = torch.bmm(A1, A1.transpose(1, 2)) + 1e-10 * eye
    w = torch.linalg.solve_ex(
        Mn, torch.bmm(A1, c1.unsqueeze(-1)).squeeze(-1))[0]
    p = c1 - torch.bmm(A1.transpose(1, 2), w.unsqueeze(-1)).squeeze(-1)
    ones = torch.ones((Bn, Nt), dtype=torch.bool, device=A1.device)
    return masked_independent_cols(A1, ones, p, tol)


def _cclp_step(c1, A1, b1, st: _CCState, *, tol, ms_mask):
    """One criss-cross iteration for every instance given."""
    Bn, R, Nt = A1.shape
    dtype, dev = c1.dtype, c1.device
    ar = torch.arange(Bn, device=dev)
    arange = torch.arange(Nt, device=dev)
    eye = torch.eye(R, dtype=dtype, device=dev)
    B, in_basis, S, it = st.B, st.in_basis, st.S, st.it + 1
    A_B = torch.gather(A1, 2, B.unsqueeze(1).expand(Bn, R, R))
    # three Newton refreshes: least-index pivots are not ratio-guarded and
    # can be tiny; the gate reads the error left after them
    invB = st.invB
    for _ in range(2):
        invB = torch.bmm(invB, 2.0 * eye - torch.bmm(A_B, invB))
    E3 = torch.bmm(A_B, invB)
    invB = torch.bmm(invB, 2.0 * eye - E3)
    xB = torch.bmm(invB, b1.unsqueeze(-1)).squeeze(-1)
    w = torch.bmm(invB.transpose(1, 2),
                  torch.gather(c1, 1, B).unsqueeze(-1)).squeeze(-1)
    h = c1 - torch.bmm(A1.transpose(1, 2), w.unsqueeze(-1)).squeeze(-1)
    drift = (E3 - eye).abs().amax(dim=(1, 2)) > tol ** 0.25
    numbad = ~(torch.isfinite(xB).all(dim=1) & torch.isfinite(h).all(dim=1)
               & torch.isfinite(invB).all(dim=(1, 2))) | drift

    dv = ~in_basis & (h < -tol)
    idxK = torch.where(dv, arange, Nt).amin(dim=1)
    Bv = torch.where(xB < -tol, B, Nt)
    lpos = Bv.argmin(dim=1)  # position of the smallest violated basic index
    idxL = Bv[ar, lpos]
    no_viol = (idxK >= Nt) & (idxL >= Nt)
    ms = ((h.abs() < tol) & ~in_basis & ms_mask).any(dim=1)
    status_opt = torch.where(ms, 2, 1)
    entering = idxK < idxL

    # leaving pivot: row lpos leaves, the first eligible column enters
    k_in = torch.where(idxK < Nt, idxK, 0)
    yrow = torch.bmm(A1.transpose(1, 2),
                     invB[ar, lpos, :].unsqueeze(-1)).squeeze(-1)
    cand = ~in_basis & (yrow < -tol)
    infeas = ~entering & ~cand.any(dim=1)
    k_out = torch.where(cand, arange, Nt - 1).amin(dim=1)
    l_out = B[ar, lpos]

    # one entering-column product serves both flavors
    k = torch.where(entering, k_in, k_out)
    yk = torch.bmm(invB, A1[ar, :, k].unsqueeze(-1)).squeeze(-1)
    # entering pivot: the leaving row has the smallest basic index among
    # y > tol (the reference's J[1] on a sorted basis, CCLP.jl:156-164)
    rows = yk > tol
    unb = entering & ~rows.any(dim=1)
    rpos_in = torch.where(rows, B, Nt).argmin(dim=1)
    l = torch.where(entering, B[ar, rpos_in], l_out)
    rpos = torch.where(entering, rpos_in, lpos)

    stop = numbad | no_viol | unb | infeas
    do_pivot = ~stop
    e_r = (torch.arange(R, device=dev) == rpos.unsqueeze(1)).to(dtype)
    y_r = yk[ar, rpos]
    y_r = torch.where(y_r.abs() > 0, y_r, torch.ones_like(y_r))
    invB_piv = invB - ((yk - e_r) / y_r.unsqueeze(1)).unsqueeze(2) \
        * invB[ar, rpos, :].unsqueeze(1)
    invB1 = _rows_where(do_pivot, invB_piv, invB)
    B1 = B.clone()
    B1[ar, rpos] = torch.where(do_pivot, k, B[ar, rpos])
    in_b1 = in_basis.clone()
    in_b1[ar, l] = in_basis[ar, l] & ~do_pivot
    in_b1[ar, k] = in_b1[ar, k] | do_pivot
    S1 = S.clone()
    S1[ar, k] = torch.where(do_pivot, IN, S[ar, k]).to(S.dtype)
    S1[ar, l] = torch.where(do_pivot, DN, S1[ar, l]).to(S.dtype)
    status = torch.where(numbad, -1, torch.where(
        no_viol, status_opt, torch.where(unb, 3, 0)))
    return _CCState(B1, in_b1, S1, xB, invB1, it, stop,
                    status.to(torch.int32))


def _run(c1, A1, b1, st, *, tol, max_iter, ms_mask):
    step = lambda *a: _cclp_step(*a, tol=float(tol), ms_mask=ms_mask)
    return run_chunked(step, (c1, A1, b1), st, max_iter)


def cclp_stage1(c1, A1, b1, in_basis0, S0, *, tol, max_iter, ms_mask):
    """The least-index criss-cross loop on ``min c1'x, A1 x = b1, x >= 0``
    from the initial basis (B, Nt); returns the raw exit state. The basis is
    kept as unsorted positions: every least-index choice compares basis
    values. ``ms_mask`` (Nt,) restricts the infinitely-many check."""
    Bn, R, _ = A1.shape
    dev = A1.device
    B0 = static_nonzero(in_basis0, R)
    st0 = _CCState(
        B0, in_basis0, S0.to(torch.int8), torch.zeros_like(b1[:, :R]),
        _basis_inverse(A1, B0), torch.zeros(Bn, dtype=torch.int32, device=dev),
        torch.zeros(Bn, dtype=torch.bool, device=dev),
        torch.zeros(Bn, dtype=torch.int32, device=dev))
    return _run(c1, A1, b1, st0, tol=tol, max_iter=max_iter, ms_mask=ms_mask)


def cclp_repair(c1, A1, b1, st: _CCState, *, tol, max_iter, ms_mask):
    """Second chance for -1 drift exits: swap the basis's dependent columns
    for independent ones (preferring the current basis, then any column),
    invert it afresh and re-enter the loop once with a fresh iteration
    budget. Runs on the rows with status -1 only; the others pass
    through."""
    idx = (st.status == -1).nonzero().squeeze(1)
    if idx.numel() == 0:
        return st
    R = A1.shape[1]
    sub = _take(st, idx)
    c, A, b = c1[idx], A1[idx], b1[idx]
    n = idx.numel()
    keep = masked_independent_cols(
        A, torch.ones_like(sub.in_basis), torch.where(sub.in_basis, 0, 1),
        float(tol))
    B_f = static_nonzero(keep, R)
    sub = _CCState(B_f, keep, torch.where(keep, IN, DN).to(torch.int8),
                   sub.xB, _basis_inverse(A, B_f), torch.zeros_like(sub.it),
                   torch.zeros(n, dtype=torch.bool, device=A1.device),
                   sub.status)
    sub = _run(c, A, b, sub, tol=tol, max_iter=max_iter, ms_mask=ms_mask)
    return _put(st, idx, sub)


def cclp_output(st: _CCState, max_iter: int, Nt: int):
    """(status, x_full (B, Nt), S) from a criss-cross exit state."""
    status = torch.where(st.done, st.status,
                         torch.full_like(st.status, -max_iter))
    x_full = torch.zeros((st.B.shape[0], Nt), dtype=st.invB.dtype,
                         device=st.B.device).scatter(1, st.B, st.xB)
    return status.to(torch.int32), x_full, st.S


def cclp_core(c1, A1, b1, in_basis0, S0, *, tol, max_iter, ms_mask):
    """Stage-1 loop, the repair where needed, and the output."""
    st = cclp_stage1(c1, A1, b1, in_basis0, S0, tol=tol, max_iter=max_iter,
                     ms_mask=ms_mask)
    st = cclp_repair(c1, A1, b1, st, tol=tol, max_iter=max_iter,
                     ms_mask=ms_mask)
    return cclp_output(st, max_iter, c1.shape[1])


def _ms_mask(P: LP, Nt: int, device):
    return torch.arange(Nt, device=device) < (P.N + P.J)


def cclp_pre(P: LP, settings: Settings, batch: int):
    """Standard form, initial basis and the stage-1 loop of a batched LP.
    Returns (sf, st) so that the batch protocols gate the repair themselves."""
    sf = standard_form(P.c, P.A, P.b, P.G, P.g, P.d, P.u, batch,
                       tol=settings.tol)
    in_basis0 = _init_basis(sf.c1, sf.A1, settings.tol)
    S0 = torch.where(in_basis0, IN, DN).to(torch.int8)
    st = cclp_stage1(sf.c1, sf.A1, sf.b1, in_basis0, S0, tol=settings.tol,
                     max_iter=settings.max_iter,
                     ms_mask=_ms_mask(P, sf.c1.shape[1], sf.c1.device))
    return sf, st


def cclp_repair_sf(P: LP, sf, st: _CCState, settings: Settings) -> _CCState:
    """:func:`cclp_repair` on a standard form built by :func:`cclp_pre`."""
    return cclp_repair(sf.c1, sf.A1, sf.b1, st, tol=settings.tol,
                       max_iter=settings.max_iter,
                       ms_mask=_ms_mask(P, sf.c1.shape[1], sf.c1.device))


def cclp_post(P: LP, sf, st: _CCState, settings: Settings) -> Result:
    """Recover x and S from the exit state, map the slack statuses, attach
    the duals; infeasible and unbounded exits return x = 0."""
    N, J = P.N, P.J
    status, x_full, S1 = cclp_output(st, settings.max_iter, sf.c1.shape[1])
    xo, So, Se = recover_solution(x_full, S1, sf, N, J)
    status = torch.where(sf.inconsistent, 0, status).to(torch.int32)
    xo = torch.where((status <= 0).unsqueeze(1), torch.zeros_like(xo), xo)
    S = torch.cat([So, Se], dim=1) if J > 0 else So
    return _attach_lp_duals(Result(xo, S, status), P.c, P.A, P.G, True)


@highest_matmul
def solve_lp_traced(P: LP, settings: Settings) -> Result:
    """Criss-cross solve of a batched LP (reference solveLP(Q::LP),
    CCLP.jl:289-390): standardize, solve, repair the -1 exits once, recover
    x and S, map the slack statuses."""
    Bn = P.batch_size
    if Bn is None:
        raise ValueError("solve_lp_traced takes a batched LP")
    sf, st = cclp_pre(P, settings, Bn)
    st = cclp_repair_sf(P, sf, st, settings)
    return cclp_post(P, sf, st, settings)


def solve_lp(P: LP, *, settings: Optional[Settings] = None,
             rescue: bool = True, route: str = "auto") -> Result:
    """Solve one LP by the least-index criss-cross method (the reference's
    exported ``solveLP``); box-only problems take the closed form.

    ``route="auto"`` sends instances with N + J >= 100 to the two-phase
    simplex (:func:`~ssqp_tpu_torch.solvers.lp.simplex_lp`), where the
    least-index pivot count exhausts ``max_iter``; ``route="cclp"`` forces
    criss-cross. ``rescue=True`` retries a -1 / -max_iter float32 exit once
    in float64 (:func:`rescue_cclp_f64`)."""
    settings = settings or Settings.for_dtype(P.c.dtype)
    if (route == "auto" and P.N + P.J >= 100 and P.M + P.J > 0
            and P.mc > 0):
        from ssqp_tpu_torch.solvers.lp import simplex_lp

        return simplex_lp(P, settings=settings)
    if P.mc in (MC_INFEASIBLE, MC_NUMERICAL):
        # the reference's solveLP has no mc gate: d == u (mc=-30) and
        # equality-only (mc=-20) models are solved; only invalid ones are
        # rejected
        return _invalid(P)
    if P.M + P.J == 0:
        from ssqp_tpu_torch.solvers.boxlp import box_lp

        return box_lp(P, settings=settings)
    res = _first(solve_lp_traced(_one(P), settings))
    if rescue:
        res = rescue_cclp_f64(P, res, settings)
    return res


def rescue_cclp_f64(P: LP, res: Result, settings: Settings) -> Result:
    """Retry a failed float32 criss-cross exit (-1 / -max_iter) once in
    float64 on the problem's own device, and return it cast back to float32
    if it succeeds; otherwise (or for a float64 input, or a status >= 0)
    ``res`` unchanged. The JAX package pins this retry to the host CPU
    because the TPU has no float64 LU; a GPU does."""
    dtype = P.c.dtype
    if int(res.status) >= 0 or dtype != torch.float32:
        return res
    # the float64 tier's tolerances with the caller's budget and rules
    s64 = dataclasses.replace(Settings(), max_iter=settings.max_iter,
                              pivot=settings.pivot, rule=settings.rule)
    r64 = _first(solve_lp_traced(_one(P.astype(torch.float64)), s64))
    if int(r64.status) <= 0:
        return res
    return Result(r64.x.to(dtype), r64.S, r64.status, r64.lam.to(dtype),
                  r64.gamma.to(dtype))
