"""Two-phase bounded-variable simplex LP solver, batch-first (PyTorch).

Counterpart of ``ssqp_tpu/solvers/lp.py`` (the reference's ``SimplexLP``,
Simplex.jl:831-1034): standardize (slacks, free-variable split, one-sided
flip), purge redundant rows, Phase-1 from a +-identity artificial basis,
drive the artificials out of the basis, Phase-2 on the real cost, recover x
and the statuses, attach least-squares dual certificates.

As in the JAX package: purged rows are zeroed, not deleted (their
artificial stays basic at 0); the drive-out is a priority-ordered masked
independent-column selection; Phase-2 pins the artificials at [0, 0]; the
free-variable "infinitely many" re-check applies to optimal exits only.

Every function takes (B, ...) tensors. Where the JAX package runs a branch
per instance (``lax.cond`` under ``vmap``), the port runs it on the rows
that take it, after one host check, and scatters the rows back; results
are per instance, so the other rows are what they would have been.

Status contract: 1 unique / 2 infinitely many / 3 unbounded / 0 infeasible /
-1 numerical error / -max_iter iteration limit; S has length N+J.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ssqp_tpu_torch.ops.bmat import stack_rows
from ssqp_tpu_torch.ops.masked_gj import masked_gj_purge, masked_independent_cols
from ssqp_tpu_torch.solvers.phase1 import (
    Standardized, recover_x_status, standardize_bounded)
from ssqp_tpu_torch.solvers.simplex import (
    bounded_simplex, dual_feasibility_violation, dual_gate_tol,
    dual_simplex_bounded)
from ssqp_tpu_torch.types import DN, EO, IN, LP, OE, UP, Result, Settings
from ssqp_tpu_torch.utils.precision import highest_matmul


class _LPPrep(NamedTuple):
    """Cost-independent pieces of the two-phase simplex (per instance): the
    standardized system, its row purge and the artificial columns. For a
    c-parametric family all of it, and Phase-1, is shared."""
    std: Standardized
    A1: torch.Tensor  # (B, R, Nt)
    b0p: torch.Tensor  # (B, R)
    keep_rows: torch.Tensor  # (B, R) bool
    inconsistent: torch.Tensor  # (B,) bool


class _LPStart(NamedTuple):
    """A feasible Phase-2 start in standardized coordinates, with the
    Phase-1 outcome flags."""
    B: torch.Tensor  # (B, R) int64
    S: torch.Tensor  # (B, Nt) int8
    x: torch.Tensor  # (B, Nt)
    p1_fail: torch.Tensor  # (B,) bool
    p1_code: torch.Tensor  # (B,) int32
    infeasible: torch.Tensor  # (B,) bool


def _map(tup, fn):
    """Apply ``fn`` to every tensor of a (nested) NamedTuple."""
    return type(tup)(*(_map(t, fn) if isinstance(t, tuple) else fn(t)
                       for t in tup))


def _take(tup, idx):
    return _map(tup, lambda t: t[idx])


def _bcast(tup, n: int):
    """A batch-of-one tuple broadcast (as views) to ``n`` instances."""
    return _map(tup, lambda t: t.expand((n,) + t.shape[1:]))


def _put(dst, idx, src):
    """``dst`` with rows ``idx`` replaced by ``src`` (both tuples)."""
    return type(dst)(*(d.index_copy(0, idx, s) for d, s in zip(dst, src)))


def static_nonzero(mask, size: int):
    """``jnp.nonzero(mask, size=size, fill_value=0)`` per row: the indices
    of the True entries in ascending order, padded with 0 (B, size).
    Computed from a stable sort, with no host sync."""
    order = torch.sort((~mask).to(torch.int32), dim=1, stable=True).indices
    order = order[:, :size]
    cnt = mask.sum(dim=1, keepdim=True)
    ar = torch.arange(size, device=mask.device)
    return torch.where(ar < cnt, order, torch.zeros_like(order))


def _lp_prep(A, G, b, g, d, u, settings: Settings, batch: int) -> _LPPrep:
    M, N = A.shape[-2:]
    J = G.shape[-2]
    R = M + J
    N0 = 2 * N + J
    std = standardize_bounded(A, G, b, g, d, u, batch)
    A0 = std.A1[:, :, :N0]
    keep_rows, inconsistent, _ = masked_gj_purge(
        A0, std.b0, torch.ones((batch, R), dtype=torch.bool, device=A.device),
        settings.tol)
    rm = keep_rows.to(A0.dtype)
    A0p = A0 * rm.unsqueeze(-1)
    b0p = std.b0 * rm
    q0 = torch.bmm(A0p, std.d1[:, :N0].unsqueeze(-1)).squeeze(-1)
    sigma = torch.where(b0p >= q0, 1.0, -1.0).to(A0.dtype)
    A1 = torch.cat([A0p, torch.diag_embed(sigma)], dim=2)
    return _LPPrep(std, A1, b0p, keep_rows, inconsistent)


def _lp_phase1(prep: _LPPrep, settings: Settings, pre_done=None) -> _LPStart:
    std, A1, b0p = prep.std, prep.A1, prep.b0p
    Bn, R, Nt = A1.shape
    N0 = Nt - R
    dtype, dev = A1.dtype, A1.device
    tol = settings.tol
    c1 = torch.cat([torch.zeros((Bn, N0), dtype=dtype, device=dev),
                    torch.ones((Bn, R), dtype=dtype, device=dev)], dim=1)
    st1, x1, B1, S1, _ = bounded_simplex(
        c1, A1, b0p, std.d1, std.u1, std.B0, std.S0, std.d1, std.real,
        tol=tol, max_iter=settings.max_iter, rule=settings.rule,
        pre_done=pre_done)
    f_art = x1[:, N0:].sum(dim=1)
    # a Phase-1 failure (-max_iter, -1, or a numerically "unbounded"
    # artificial objective) is not infeasibility: it propagates as is
    p1_fail = (st1 <= 0) | (st1 == 3)
    p1_code = torch.where(st1 == 3, -1, st1).to(torch.int32)
    infeasible = (~p1_fail & (f_art > tol)) | prep.inconsistent

    # ---- drive the artificials out of the basis -------------------------
    col_ids = torch.arange(Nt, device=dev)
    basic_cols = torch.zeros((Bn, Nt), dtype=torch.bool, device=dev)
    basic_cols.scatter_(1, B1, True)
    nonart = col_ids < N0
    art_row = (col_ids - N0).clamp(0, R - 1)
    art_for_purged = (col_ids >= N0) & ~prep.keep_rows[:, art_row]
    col_mask = nonart | (art_for_purged & basic_cols)
    priority = torch.where(basic_cols & col_mask, 0,
                           torch.where(nonart, 1, 2))
    need = (B1 >= N0).any(dim=1)
    B2, S2 = B1, S1
    idx = need.nonzero().squeeze(1)
    if idx.numel():  # the selection only matters where an artificial is basic
        bc = basic_cols[idx]
        keep_cols = masked_independent_cols(A1[idx], col_mask[idx],
                                            priority[idx], tol)
        newly = keep_cols & ~bc
        dropped = bc & ~keep_cols
        S_i = torch.where(newly, IN, torch.where(dropped, DN, S1[idx]))
        B2 = B1.index_copy(0, idx, static_nonzero(keep_cols, R))
        S2 = S1.index_copy(0, idx, S_i.to(torch.int8))
    return _LPStart(B2, S2, x1, p1_fail, p1_code, infeasible)


def _lp_cost(prep: _LPPrep, c, N: int, J: int, minimize: bool):
    """Phase-2 cost (B, Nt) in standardized coordinates."""
    std = prep.std
    Bn = std.fv.shape[0]
    R = prep.b0p.shape[1]
    c = c.expand(Bn, N)
    z = lambda n: torch.zeros((Bn, n), dtype=c.dtype, device=c.device)
    sgn = torch.where(std.flip, -1.0, 1.0).to(c.dtype)
    c0 = torch.cat([c * sgn, z(J), torch.where(std.fv, -c, z(N)), z(R)],
                   dim=1)
    return c0 if minimize else -c0


def _phase2_bounds(prep: _LPPrep):
    """Phase-2 upper bounds and candidate mask: the artificials pinned."""
    std = prep.std
    Bn, R = prep.b0p.shape
    N0 = prep.A1.shape[2] - R
    u2 = torch.cat([std.u1[:, :N0], torch.zeros((Bn, R), dtype=std.u1.dtype,
                                                device=std.u1.device)], 1)
    real2 = torch.cat([std.real[:, :N0],
                       torch.zeros((Bn, R), dtype=torch.bool,
                                   device=std.real.device)], 1)
    return u2, real2


def _lp_phase2(prep: _LPPrep, c0, B, S, x, settings: Settings,
               pre_done=None):
    """Phase-2 from a feasible standardized start. Returns the raw exit
    (st2, x2, B3, S3), so the grid protocols can carry the basis on."""
    u2, real2 = _phase2_bounds(prep)
    st2, x2, B3, S3, _ = bounded_simplex(
        c0, prep.A1, prep.b0p, prep.std.d1, u2, B, S, x, real2,
        tol=settings.tol, max_iter=settings.max_iter, rule=settings.rule,
        pre_done=pre_done)
    return st2, x2, B3, S3


def _lp_phase2_dual(prep: _LPPrep, c0, b0p_i, B, S, x, settings: Settings,
                    pre_done=None):
    """Phase-2 by the DUAL simplex from an optimal basis of the same cost
    and another right-hand side ``b0p_i`` (B, R), purged by the family's
    keep rows: the Phase-1-skipping restart of rhs-parametric families. A
    basic artificial that the new rhs moves off zero violates its [0, 0]
    bounds and is pivoted out."""
    u2, real2 = _phase2_bounds(prep)
    st2, x2, B3, S3, _ = dual_simplex_bounded(
        c0, prep.A1, b0p_i, prep.std.d1, u2, B, S, x, real2,
        tol=settings.tol, max_iter=settings.max_iter, pre_done=pre_done)
    return st2, x2, B3, S3


def _lp_finish(prep: _LPPrep, start: _LPStart, c, c0, st2, x2, B3, S3,
               N: int, J: int, settings: Settings, minimize: bool,
               A, G) -> Result:
    std, A1 = prep.std, prep.A1
    Bn, R, Nt = A1.shape
    N0 = Nt - R
    dtype, dev = A1.dtype, A1.device
    tol = settings.tol

    xo, So, Se = recover_x_status(x2, S3, std, N, J)
    status = st2
    # free-variable "infinitely many" re-check (Simplex.jl:995-1021), on
    # the instances with a free variable (one host check). Artificials left
    # basic for purged rows get identity rows in the dual solve.
    any_fv = std.fv.any(dim=1)
    if bool(any_fv.any()):
        nj = N + J
        Bm = torch.where((B3 >= nj) & (B3 < nj + N), B3 - nj, B3)
        sel = B3 < N0
        A_nj = A1[:, :, :nj]
        c_nj = c0[:, :nj]
        Bc = Bm.clamp(0, nj - 1)
        ar_R = torch.arange(R, device=dev)
        Bdup = torch.where(sel, Bm, nj + ar_R)
        Bs = torch.sort(Bdup, dim=1).values
        dup = (Bs[:, 1:] == Bs[:, :-1]).any(dim=1)
        art_row_ix = (B3 - N0).clamp(0, R - 1)
        eye_rows = (art_row_ix.unsqueeze(-1) == ar_R).to(dtype)
        cols = torch.gather(A_nj, 2, Bc.unsqueeze(1).expand(Bn, R, R))
        K1 = torch.where(sel.unsqueeze(-1), cols.transpose(1, 2), eye_rows)
        rhs1 = torch.where(sel, torch.gather(c_nj, 1, Bc),
                           torch.zeros_like(Bc, dtype=dtype))
        # a singular system gives non-finite values (no error), as XLA's
        # solve does; they read as "infinitely many" below
        wv = torch.linalg.solve_ex(K1, rhs1)[0]
        h_nj = c_nj - torch.bmm(A_nj.transpose(1, 2),
                                wv.unsqueeze(-1)).squeeze(-1)
        in_b = torch.zeros((Bn, nj), dtype=torch.int32, device=dev)
        in_b = in_b.scatter_reduce(1, torch.where(sel, Bc, 0),
                                   sel.to(torch.int32), "amax") > 0
        ms = (((h_nj.abs() < tol) & ~in_b).any(dim=1) | dup
              | ~torch.isfinite(wv).all(dim=1))
        optimal = (st2 == 1) | (st2 == 2)
        status = torch.where(any_fv & optimal, torch.where(ms, 2, 1), st2)

    status = torch.where(start.infeasible, 0,
                         torch.where(start.p1_fail, start.p1_code, status))
    S = torch.cat([So, Se], dim=1) if J > 0 else So
    return _attach_lp_duals(Result(xo, S, status.to(torch.int32)), c, A, G,
                            minimize)


def _std_basis_from_result(prep: _LPPrep, S_prior, x_prior, N: int, J: int,
                           tol):
    """Map user-facing priors ``S`` (B, N+J) and ``x`` (B, N) back to a
    standardized basis, statuses and point (the inverse of
    recover_x_status); the basis is repaired to full rank by the masked
    independent-column selection, preferring the columns the prior marks
    basic. Feeds the DUAL simplex."""
    std, A1 = prep.std, prep.A1
    Bn, R, Nt = A1.shape
    N0 = Nt - R
    dtype, dev = A1.dtype, A1.device
    Sx = S_prior[:, :N]
    Se = S_prior[:, N:]
    x = x_prior.to(dtype)
    zero = torch.zeros_like(x)
    xs = torch.where(std.flip, -x, x)
    xpos = torch.where(std.fv, xs.clamp(min=0.0), xs)
    xneg = torch.where(std.fv, (-xs).clamp(min=0.0), zero)
    Sv = torch.where(std.flip & (Sx == UP), torch.full_like(Sx, DN), Sx)
    pos_in = (Sv == IN) & (~std.fv | (xs >= 0))
    neg_in = std.fv & (Sv == IN) & (xs < 0)
    slack_in = Se == OE
    want = torch.cat([pos_in, slack_in, neg_in,
                      torch.zeros((Bn, R), dtype=torch.bool, device=dev)], 1)
    prio = torch.where(want, 0, torch.where(
        torch.arange(Nt, device=dev) < N0, 1, 2))
    keep = masked_independent_cols(
        A1, torch.ones((Bn, Nt), dtype=torch.bool, device=dev), prio, tol)
    B0 = static_nonzero(keep, R)
    # nonbasic statuses follow the prior where meaningful (a variable at
    # its upper bound keeps UP); everything else sits at DN
    nb_var = torch.where((Sv == UP) & ~std.flip, UP, DN).to(torch.int8)
    nb = torch.cat([nb_var, torch.full((Bn, Nt - N), DN, dtype=torch.int8,
                                       device=dev)], 1)
    S0 = torch.where(keep, torch.full_like(nb, IN), nb)
    z = lambda n: torch.zeros((Bn, n), dtype=dtype, device=dev)
    x0 = torch.cat([xpos, z(J), xneg, z(R)], 1)
    # nonbasic entries sit exactly on the bound their status names
    u1 = std.u1
    x0 = torch.where(S0 == DN, std.d1, torch.where(
        S0 == UP, torch.where(torch.isfinite(u1), u1, x0), x0))
    return B0, S0, x0


def _batch_size(P: LP) -> int:
    Bn = P.batch_size
    if Bn is None:
        raise ValueError("expected a batched LP (a leaf with a leading "
                         "batch axis, e.g. c of shape (B, N))")
    return Bn


@highest_matmul
def simplex_lp_warm(P: LP, S_prior, x_prior, settings: Settings,
                    minimize: bool = True) -> Result:
    """Warm-restarted batch solve from prior statuses ``S_prior`` (B, N+J)
    and points ``x_prior`` (B, N). The prior bases, rebuilt in standardized
    coordinates, go to the DUAL simplex: against the same cost row they are
    dual feasible however b and g moved, so Phase-1 is skipped. An exit is
    then certified dual feasible by one (R, R) solve. Instances whose warm
    start was rejected (-1 at the entry gate, -max_iter) or whose exit
    fails the certificate re-solve by the full two-phase path, so the
    result is never worse than the cold solve."""
    N, J = P.N, P.J
    Bn = _batch_size(P)
    prep = _lp_prep(P.A, P.G, P.b, P.g, P.d, P.u, settings, Bn)
    c0 = _lp_cost(prep, P.c, N, J, minimize)
    B0, S0, x0 = _std_basis_from_result(prep, S_prior, x_prior, N, J,
                                        settings.tol)
    st2, x2, B3, S3 = _lp_phase2_dual(prep, c0, prep.b0p, B0, S0, x0,
                                      settings)

    # post-exit dual certificate: drift could leave an exit basis dual
    # infeasible beyond tolerance, which must not ship as "optimal"
    A1 = prep.A1
    R = A1.shape[1]
    A_B3 = torch.gather(A1, 2, B3.unsqueeze(1).expand(Bn, R, R))
    w3 = torch.linalg.solve_ex(A_B3.transpose(1, 2),
                               torch.gather(c0, 1, B3))[0]
    in_b3 = torch.zeros_like(S3, dtype=torch.bool).scatter_(1, B3, True)
    u2, real2 = _phase2_bounds(prep)
    dviol3 = dual_feasibility_violation(c0, A1, w3, S3, ~in_b3, real2,
                                        u2 - prep.std.d1)
    exit_bad = ((st2 == 1) | (st2 == 2)) & (
        (dviol3 > dual_gate_tol(c0, settings.tol))
        | ~torch.isfinite(w3).all(dim=1))

    dev = c0.device
    start = _LPStart(B3, S3, x2, torch.zeros(Bn, dtype=torch.bool, device=dev),
                     torch.zeros(Bn, dtype=torch.int32, device=dev),
                     prep.inconsistent)
    idx = ((st2 < 0) | exit_bad).nonzero().squeeze(1)
    if idx.numel():  # the cold fallback, on the rows that need it
        prep_c = _take(prep, idx)
        st_c = _lp_phase1(prep_c, settings)
        s, xx, Bb, Sb = _lp_phase2(prep_c, c0[idx], st_c.B, st_c.S, st_c.x,
                                   settings)
        st2 = st2.index_copy(0, idx, s)
        start = _put(start, idx, _LPStart(Bb, Sb, xx, st_c.p1_fail,
                                          st_c.p1_code, st_c.infeasible))
    return _lp_finish(prep, start, P.c, c0, st2, start.x, start.B, start.S,
                      N, J, settings, minimize, P.A, P.G)


@highest_matmul
def simplex_lp_traced(P: LP, settings: Settings,
                      minimize: bool = True) -> Result:
    """The two-phase simplex on a batched LP (every instance its own
    Phase-1 and Phase-2)."""
    N, J = P.N, P.J
    prep = _lp_prep(P.A, P.G, P.b, P.g, P.d, P.u, settings, _batch_size(P))
    start = _lp_phase1(prep, settings)
    c0 = _lp_cost(prep, P.c, N, J, minimize)
    st2, x2, B3, S3 = _lp_phase2(prep, c0, start.B, start.S, start.x,
                                 settings)
    return _lp_finish(prep, start, P.c, c0, st2, x2, B3, S3, N, J,
                      settings, minimize, P.A, P.G)


def _attach_lp_duals(res: Result, c, A, G, minimize: bool) -> Result:
    """Least-squares dual certificates at the labeled active set, in the
    min-sense convention (for ``-c`` when maximizing): ``c_eff + [A;G]'lam
    = gamma``, lam >= 0 on active inequality rows, gamma >= 0 at lower and
    <= 0 at upper bounds; zero on non-optimal exits. The normal-equations
    solve goes through ``ops/kkt.py::spd_solve``: the Cholesky kernel in
    float32 at M+J >= 16 on a CUDA tensor."""
    from ssqp_tpu_torch.ops.kkt import recover_duals_grad

    M, J = A.shape[-2], G.shape[-2]
    Bn, N = res.x.shape
    ceff = (c if minimize else -c).expand(Bn, N)
    AG = stack_rows(A, G) if J > 0 else A
    free = res.S[:, :N] == IN
    ones = torch.ones((Bn, M), dtype=torch.bool, device=res.x.device)
    act = torch.cat([ones, res.S[:, N:] == EO], dim=1) if J > 0 else ones
    lam, gamma = recover_duals_grad(ceff, AG, free, act)
    ok = (res.status > 0).unsqueeze(1)
    lam = torch.where(ok, lam, torch.zeros_like(lam))
    gamma = torch.where(ok, gamma, torch.zeros_like(gamma))
    return Result(res.x, res.S, res.status, lam, gamma)


def _invalid(P: LP) -> Result:
    """The -1 result of a model the constructor flagged (mc <= 0)."""
    dev = P.device
    S = torch.cat([torch.full((P.N,), DN, dtype=torch.int8, device=dev),
                   torch.full((P.J,), OE, dtype=torch.int8, device=dev)])
    return Result(torch.zeros(P.N, dtype=P.c.dtype, device=dev), S,
                  torch.tensor(-1, dtype=torch.int32, device=dev))


def _one(P: LP) -> LP:
    """One LP as a batch of one (its cost gets the batch axis)."""
    if P.batch_size is not None:
        raise ValueError("expected one LP; use parallel.batch.solve_lp_batch"
                         " for a batch")
    return LP(P.c.unsqueeze(0), P.A, P.b, P.G, P.g, P.d, P.u, P.N, P.M,
              P.J, P.mc)


def _first(r: Result) -> Result:
    return Result(*(None if t is None else t[0] for t in
                    (r.x, r.S, r.status, r.lam, r.gamma)))


def simplex_lp(P: LP, *, settings: Settings | None = None,
               minimize: bool = True, warm_from: Result | None = None) -> Result:
    """Solve one LP by the two-phase simplex (reference SimplexLP,
    Simplex.jl:831); a batch of one underneath.

    ``warm_from`` takes a prior :class:`Result` (e.g. of the same problem
    with another right-hand side): the solve then restarts the DUAL simplex
    from the prior basis and falls back to the two-phase solve where the
    warm start is rejected (:func:`simplex_lp_warm`)."""
    settings = settings or Settings.for_dtype(P.c.dtype)
    if P.mc <= 0:
        return _invalid(P)
    if P.M + P.J == 0:
        from ssqp_tpu_torch.solvers.boxlp import box_lp

        return box_lp(P, settings=settings, minimize=minimize)
    P1 = _one(P)
    if warm_from is not None:
        dev = P.device
        S = torch.as_tensor(warm_from.S, device=dev).to(torch.int8)
        x = torch.as_tensor(warm_from.x, device=dev).to(P.c.dtype)
        return _first(simplex_lp_warm(P1, S.unsqueeze(0), x.unsqueeze(0),
                                      settings, minimize))
    return _first(simplex_lp_traced(P1, settings, minimize))


def simplex_lp_standard(c, A, b, d, u, *, settings=None, minimize=True,
                        device="cuda") -> Result:
    """Pre-standardized variant (reference SimplexLP(c, A, b, d, u),
    Simplex.jl:1036): equality rows only, bounds may be infinite. Arrays
    are validated by :func:`make_lp` (float64) and built on ``device``."""
    from ssqp_tpu_torch.types import make_lp

    P = make_lp(c, A, b, d=d, u=u, device=device)
    return simplex_lp(P, settings=settings, minimize=minimize)
