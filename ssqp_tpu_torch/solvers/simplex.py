"""Bounded-variable dense simplex, batch-first (PyTorch).

Counterpart of ``ssqp_tpu/solvers/simplex.py::bounded_simplex``: solve
``min c'x s.t. Ax=b, d<=x<=u`` (d finite, u may be +inf) from a starting
basis, with bound-flip pivots and a MAINTAINED basis inverse (product-form
rank-1 update per exchange plus one Newton refresh ``invB <- invB (2I - A_B
invB)`` per iteration, and a drift gate on the post-refresh error).

Pivot rules (``rule``): 'dantzig' (largest-distance score h/||A_col||),
'max_improvement' (greatest |h theta| over all candidates) and
'steepest_edge' (h^2 / (1 + ||invB A_col||^2)), each switching to Bland's
least-index rule after Nt iterations. Basis gathers and scatters are plain
indexing (the JAX package's one-hot matmuls were a TPU workaround).

Status codes: 1 unique, 2 infinitely many, 3 unbounded, -1 numerical error,
-max_iter iteration limit.

:func:`dual_simplex_bounded` is the dual method from a dual-feasible basis
(the LP engines' Phase-1-skipping restart). Its loop, like the criss-cross
loop of solvers/cclp.py, runs through :func:`run_chunked`: eight masked
steps between host checks of the live set.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ssqp_tpu_torch.types import DN, IN, UP

_INF = float("inf")


def _all_ratio(Y, qv, S, db, ub, ud, fu, tol):
    """Ratio test for every candidate column at once (greatest-improvement
    rule): Y (B, R, Nt), qv/db/ub (B, R). Returns theta (B, Nt)."""
    pos = Y > tol
    neg = Y < -tol
    Ysafe = torch.where(Y == 0, torch.ones_like(Y), Y)
    lo_g = (qv - db).unsqueeze(-1) / Ysafe
    hi_g = (qv - ub).unsqueeze(-1) / Ysafe
    inf = torch.full_like(Y, _INF)
    gt_dn = torch.where(pos, lo_g, torch.where(neg, hi_g, inf))
    gt_up = torch.where(pos, hi_g, torch.where(neg, lo_g, -inf))
    g_dn = torch.minimum(gt_dn.amin(dim=1),
                         torch.where(fu, ud, torch.full_like(ud, _INF)))
    g_up = torch.maximum(gt_up.amax(dim=1), -ud)
    return torch.where(S == DN, g_dn, g_up)


def _simplex_step(c, Amat, b, d, u, real, cA_safe, ud, fu, B, S, x, invB, it,
                  tol, rule):
    """One iteration for every instance of the (sub-)batch. Returns the new
    (B, S, x, invB, done, status)."""
    Bn, R, Nt = Amat.shape
    dtype = c.dtype
    dev = c.device
    ar = torch.arange(Bn, device=dev)
    arange = torch.arange(Nt, device=dev)
    eye = torch.eye(R, dtype=dtype, device=dev)
    in_basis = torch.zeros((Bn, Nt), dtype=torch.bool, device=dev)
    in_basis.scatter_(1, B, True)
    A_B = torch.gather(Amat, 2, B.unsqueeze(1).expand(Bn, R, R))
    E = torch.bmm(A_B, invB)
    invB = torch.bmm(invB, 2.0 * eye - E)
    E2 = torch.bmm(A_B, invB)
    drift = (E2 - eye).abs().amax(dim=(1, 2)) > tol ** 0.5
    cB, db, ub = (torch.gather(v, 1, B) for v in (c, d, u))
    w = torch.bmm(invB.transpose(1, 2), cB.unsqueeze(-1)).squeeze(-1)
    h = c - torch.bmm(Amat.transpose(1, 2), w.unsqueeze(-1)).squeeze(-1)
    xn = torch.where(in_basis, torch.zeros_like(x), x)
    qv = torch.bmm(invB, (b - torch.bmm(Amat, xn.unsqueeze(-1)).squeeze(-1))
                   .unsqueeze(-1)).squeeze(-1)
    x2 = x.scatter(1, B, qv)

    ht = torch.where(S == DN, -h, h)
    elig = (~in_basis) & real & (ud > 0)
    cand = elig & (ht > tol)
    anyc = cand.any(dim=1)
    ms = ((ht.abs() < tol) & elig).any(dim=1)
    status_opt = torch.where(ms, 2, 1)

    bland = it > Nt
    ninf = torch.full_like(ht, -_INF)
    if rule == "dantzig":
        k_rule = torch.where(cand, ht / cA_safe, ninf).argmax(dim=1)
    elif rule == "steepest_edge":
        Y = torch.bmm(invB, Amat)
        se = ht * ht / (1.0 + torch.sum(Y * Y, dim=1))
        k_rule = torch.where(cand, se, ninf).argmax(dim=1)
    elif rule == "max_improvement":
        Y = torch.bmm(invB, Amat)
        theta = _all_ratio(Y, qv, S, db, ub, ud, fu, tol)
        k_rule = torch.where(cand, (ht * theta).abs(), ninf).argmax(dim=1)
    else:
        raise ValueError(f"unknown pivot rule {rule!r}")
    k_bland = torch.where(cand, arange, Nt + 1).argmin(dim=1)
    k = torch.where(bland, k_bland, k_rule)

    p = torch.bmm(invB, Amat[ar, :, k].unsqueeze(-1)).squeeze(-1)
    numbad = ~(torch.isfinite(w).all(dim=1) & torch.isfinite(qv).all(dim=1)
               & torch.isfinite(invB).all(dim=(1, 2)))
    numbad = numbad | (anyc & ~torch.isfinite(p).all(dim=1)) | drift

    Sk = S[ar, k]
    kd = Sk == DN
    pos = p > tol
    neg = p < -tol
    psafe = torch.where(p == 0, torch.ones_like(p), p)
    lo_g = (qv - db) / psafe
    hi_g = (qv - ub) / psafe
    inf = torch.full_like(p, _INF)
    gt_dn = torch.where(pos, lo_g, torch.where(neg, hi_g, inf))
    Sb_dn = torch.where(pos, DN, UP)
    gt_up = torch.where(pos, hi_g, torch.where(neg, lo_g, -inf))
    Sb_up = torch.where(pos, UP, DN)
    l_dn = gt_dn.argmin(dim=1)
    l_up = gt_up.argmax(dim=1)
    l = torch.where(kd, l_dn, l_up)
    gl = torch.where(kd, gt_dn[ar, l_dn], gt_up[ar, l_up])
    Sl = torch.where(kd, Sb_dn[ar, l], Sb_up[ar, l]).to(S.dtype)

    dk, uk, fuk, udk = d[ar, k], u[ar, k], fu[ar, k], ud[ar, k]
    flip = torch.where(kd, fuk & (gl >= udk), gl <= (dk - uk))
    unbounded = anyc & kd & ~fuk & ~torch.isfinite(gl)
    go = anyc & ~numbad & ~unbounded
    do_flip = go & flip
    do_pivot = go & ~flip

    i_leave = B[ar, l]
    B1 = B.clone()
    B1[ar, l] = torch.where(do_pivot, k, i_leave)
    y_l = p[ar, l]
    y_l = torch.where(y_l.abs() > 0, y_l, torch.ones_like(y_l))
    e_l = (torch.arange(R, device=dev) == l.unsqueeze(1)).to(dtype)
    invB_piv = invB - ((p - e_l) / y_l.unsqueeze(1)).unsqueeze(2) \
        * invB[ar, l, :].unsqueeze(1)
    invB1 = torch.where(do_pivot.view(-1, 1, 1), invB_piv, invB)
    S1 = S.clone()
    S1[ar, i_leave] = torch.where(do_pivot, Sl, S[ar, i_leave])
    k_status = torch.where(do_pivot, IN, torch.where(kd, UP, DN)).to(S.dtype)
    S1[ar, k] = torch.where(do_pivot | do_flip, k_status, S1[ar, k])
    x1 = x2.clone()
    x1[ar, i_leave] = torch.where(
        do_pivot, torch.where(Sl == DN, d[ar, i_leave], u[ar, i_leave]),
        x2[ar, i_leave])
    x1[ar, k] = torch.where(do_flip, torch.where(kd, uk, dk), x1[ar, k])

    done = numbad | ~anyc | unbounded
    status = torch.where(numbad, -1, torch.where(
        ~anyc, status_opt, torch.where(unbounded, 3, 0))).to(torch.int32)
    return B1, S1, x1, invB1, done, status


def bounded_simplex(c, Amat, b, d, u, B0, S0, x0, real, *, tol, max_iter,
                    rule: str = "dantzig", pre_done=None):
    """Run the bounded-variable simplex on a batch. Returns
    (status, x, B, S, iters), each with a leading batch axis.

    All per-instance arguments are batched: c, d, u, x0 (B, Nt); Amat
    (B, R, Nt); b (B, R); B0 (B, R) int64 basis; S0 (B, Nt) int8; real
    (B, Nt) bool masks padded dummy columns. ``pre_done`` (B,) bool marks
    instances whose result the caller discards: they start done with status
    1 and cost nothing. Each iteration runs on the still-running instances
    only; their iteration counters advance independently."""
    Bn, R, Nt = Amat.shape
    dtype = c.dtype
    dev = c.device
    tol = float(tol)
    cA = torch.sqrt(torch.sum(Amat * Amat, dim=1))
    cA_safe = torch.where(cA > 0, cA, torch.ones_like(cA))
    ud = u - d
    fu = torch.isfinite(u)

    B = B0.to(torch.int64).clone()
    S = S0.to(torch.int8).clone()
    x = x0.to(dtype).clone()
    A_B0 = torch.gather(Amat, 2, B.unsqueeze(1).expand(Bn, R, R))
    # a singular start gives non-finite entries (no error), as XLA's inverse
    # does; the loop's first step then exits -1
    invB = torch.linalg.inv_ex(A_B0)[0]
    it = torch.zeros(Bn, dtype=torch.int32, device=dev)
    pd = (torch.zeros(Bn, dtype=torch.bool, device=dev) if pre_done is None
          else pre_done.to(torch.bool).clone())
    done = pd.clone()
    status = torch.where(pd, 1, 0).to(torch.int32)
    while True:
        run = (~done & (it < max_iter)).nonzero().squeeze(1)
        if run.numel() == 0:
            break
        it[run] += 1
        B1, S1, x1, invB1, done1, status1 = _simplex_step(
            c[run], Amat[run], b[run], d[run], u[run], real[run],
            cA_safe[run], ud[run], fu[run], B[run], S[run], x[run],
            invB[run], it[run], tol, rule)
        B[run], S[run], x[run], invB[run] = B1, S1, x1, invB1
        done[run], status[run] = done1, status1
    status = torch.where(done, status,
                         torch.full_like(status, -max_iter)).to(torch.int32)
    return status, x, B, S, it


class SimplexState(NamedTuple):
    B: torch.Tensor  # (B, R) int64 basis column indices
    S: torch.Tensor  # (B, Nt) int8 statuses (IN = basic)
    x: torch.Tensor  # (B, Nt) values (basic entries refreshed each step)
    invB: torch.Tensor  # (B, R, R) maintained basis inverse
    it: torch.Tensor  # (B,) int32
    done: torch.Tensor  # (B,) bool
    status: torch.Tensor  # (B,) int32


def _rows_where(mask, new, old):
    return torch.where(mask.view((-1,) + (1,) * (new.dim() - 1)), new, old)


def run_chunked(step, data, st, max_iter: int, chunk: int = 8):
    """Run ``st = step(*data, st)`` on every instance with ``~done`` and
    ``it < max_iter`` until none is left: the batched form of a
    ``lax.while_loop`` whose condition is per instance.

    ``st`` is a NamedTuple of (B, ...) tensors with fields ``it`` and
    ``done``; ``step`` returns the next state with ``it + 1``. The live set
    is read on the host (one sync) every ``chunk`` steps and the loop runs
    on those rows alone; inside a chunk an instance that finishes is frozen
    by masks, so every instance takes exactly the steps the while loop
    would give it and keeps its own iteration count."""
    kind = type(st)
    Bn = st.done.shape[0]
    while True:
        live = (~st.done & (st.it < max_iter)).nonzero().squeeze(1)
        if live.numel() == 0:
            return st
        whole = live.numel() == Bn
        sub = st if whole else kind(*(t[live] for t in st))
        dsub = data if whole else tuple(t[live] for t in data)
        for _ in range(chunk):
            act = ~sub.done & (sub.it < max_iter)
            new = step(*dsub, sub)
            sub = kind(*(_rows_where(act, n, o) for n, o in zip(new, sub)))
        st = sub if whole else kind(*(o.index_copy(0, live, n)
                                      for o, n in zip(st, sub)))


def dual_feasibility_violation(c, Amat, w, S, nonbasic, real, ud):
    """Largest signed reduced-cost violation over the eligible nonbasic
    columns (B,): the measure shared by :func:`dual_simplex_bounded`'s entry
    gate and the warm restart's exit certificate
    (solvers/lp.py::simplex_lp_warm)."""
    h = c - torch.bmm(Amat.transpose(1, 2), w.unsqueeze(-1)).squeeze(-1)
    v = torch.where(S == DN, -h, torch.where(S == UP, h, torch.zeros_like(h)))
    v = torch.where(nonbasic & real & (ud > 0), v, torch.zeros_like(v))
    return v.amax(dim=1).clamp(min=0.0)


def dual_gate_tol(c, tol):
    """Dual-infeasibility threshold per instance (B,): 100x the solver tol,
    scaled by the cost (1 + max|c|)."""
    return 100.0 * tol * (1.0 + c.abs().amax(dim=1))


def _dual_step(c, Amat, b, d, u, real, ud, fu, st: SimplexState, *, tol):
    """One dual-simplex iteration for every instance given."""
    Bn, R, Nt = Amat.shape
    dtype, dev = c.dtype, c.device
    ar = torch.arange(Bn, device=dev)
    eye = torch.eye(R, dtype=dtype, device=dev)
    B, S, x, it = st.B, st.S, st.x, st.it + 1
    in_basis = torch.zeros((Bn, Nt), dtype=torch.bool, device=dev)
    in_basis.scatter_(1, B, True)
    A_B = torch.gather(Amat, 2, B.unsqueeze(1).expand(Bn, R, R))
    invB = torch.bmm(st.invB, 2.0 * eye - torch.bmm(A_B, st.invB))
    E2 = torch.bmm(A_B, invB)
    drift = (E2 - eye).abs().amax(dim=(1, 2)) > tol ** 0.5
    cB, db, ub = (torch.gather(v, 1, B) for v in (c, d, u))
    w = torch.bmm(invB.transpose(1, 2), cB.unsqueeze(-1)).squeeze(-1)
    h = c - torch.bmm(Amat.transpose(1, 2), w.unsqueeze(-1)).squeeze(-1)
    xn = torch.where(in_basis, torch.zeros_like(x), x)
    qv = torch.bmm(invB, (b - torch.bmm(Amat, xn.unsqueeze(-1)).squeeze(-1))
                   .unsqueeze(-1)).squeeze(-1)
    x2 = x.scatter(1, B, qv)

    viol_lo = qv < db - tol
    viol_up = qv > ub + tol
    viol = viol_lo | viol_up
    anyv = viol.any(dim=1)
    elig0 = (~in_basis) & real & (ud > 0)
    ms = ((h.abs() < tol) & elig0).any(dim=1)
    status_opt = torch.where(ms, 2, 1)

    # leaving row: largest violation; after Nt steps the least basic index
    vmag = torch.where(viol_lo, db - qv, torch.where(
        viol_up, qv - ub, torch.full_like(qv, -_INF)))
    r_mag = vmag.argmax(dim=1)
    r_bland = torch.where(viol, B, Nt + 1).argmin(dim=1)
    r = torch.where(it > Nt, r_bland, r_mag)
    leave_lo = viol_lo[ar, r]

    rho = invB[ar, r, :]
    alpha = torch.bmm(Amat.transpose(1, 2), rho.unsqueeze(-1)).squeeze(-1)
    at_dn = (~in_basis) & (S == DN)
    at_up = (~in_basis) & (S == UP)
    lo = leave_lo.unsqueeze(1)
    elig = real & (ud > 0) & torch.where(
        lo, (at_dn & (alpha < -tol)) | (at_up & (alpha > tol)),
        (at_dn & (alpha > tol)) | (at_up & (alpha < -tol)))
    anye = elig.any(dim=1)
    infeasible = anyv & ~anye

    # the dual min-ratio test over the eligible columns; the first minimum
    # wins, which is the dual method's least-index tie-break
    ht = torch.where(S == DN, h, -h)
    ratio = torch.where(
        elig, ht.clamp(min=0.0) / alpha.abs().clamp(min=tol),
        torch.full_like(ht, _INF))
    k = ratio.argmin(dim=1)

    p = torch.bmm(invB, Amat[ar, :, k].unsqueeze(-1)).squeeze(-1)
    numbad = ~(torch.isfinite(w).all(dim=1) & torch.isfinite(qv).all(dim=1)
               & torch.isfinite(invB).all(dim=(1, 2)))
    numbad = numbad | (anye & ~torch.isfinite(p).all(dim=1)) | drift
    do_pivot = anyv & ~numbad & ~infeasible

    i_leave = B[ar, r]
    B1 = B.clone()
    B1[ar, r] = torch.where(do_pivot, k, i_leave)
    y_r = p[ar, r]
    y_r = torch.where(y_r.abs() > 0, y_r, torch.ones_like(y_r))
    e_r = (torch.arange(R, device=dev) == r.unsqueeze(1)).to(dtype)
    invB_piv = invB - ((p - e_r) / y_r.unsqueeze(1)).unsqueeze(2) \
        * invB[ar, r, :].unsqueeze(1)
    invB1 = _rows_where(do_pivot, invB_piv, invB)
    Sl = torch.where(leave_lo, DN, UP).to(S.dtype)
    S1 = S.clone()
    S1[ar, i_leave] = torch.where(do_pivot, Sl, S[ar, i_leave])
    S1[ar, k] = torch.where(do_pivot, torch.full_like(Sl, IN), S1[ar, k])
    x1 = x2.clone()
    x1[ar, i_leave] = torch.where(
        do_pivot, torch.where(leave_lo, d[ar, i_leave], u[ar, i_leave]),
        x2[ar, i_leave])

    done = numbad | ~anyv | infeasible
    status = torch.where(numbad, -1, torch.where(~anyv, status_opt, 0))
    return SimplexState(B1, S1, x1, invB1, it, done, status.to(torch.int32))


def dual_simplex_bounded(c, Amat, b, d, u, B0, S0, x0, real, *, tol,
                         max_iter, pre_done=None):
    """Bounded-variable DUAL simplex from a dual-feasible basis, on a batch.

    Solves ``min c'x s.t. Ax=b, d<=x<=u`` from a basis whose reduced costs
    agree in sign with the nonbasic statuses (h >= 0 at DN, h <= 0 at UP),
    which an optimal basis of the same problem with another right-hand side
    provides. Each step takes the basic variable that most violates its
    bounds as the leaving row (the least basic index after Nt steps) and
    the entering column by the dual min-ratio over the sign-eligible
    nonbasics; it stops when every basic value is within bounds (optimal;
    1 or 2 by the multiplicity check) or when the violated row admits no
    entering column (primal infeasible, 0). Maintained inverse with one
    Newton refresh per step and a post-refresh drift gate at sqrt(tol), as
    :func:`bounded_simplex`. An entry gate flags a start whose dual
    violation exceeds :func:`dual_gate_tol` as -1 at once (callers rescue
    -1 through the primal path). Returns (status, x, B, S, iters), batched
    as :func:`bounded_simplex`'s arguments."""
    Bn, R, Nt = Amat.shape
    dtype, dev = c.dtype, c.device
    tol = float(tol)
    ud = u - d
    fu = torch.isfinite(u)
    B = B0.to(torch.int64).clone()
    A_B0 = torch.gather(Amat, 2, B.unsqueeze(1).expand(Bn, R, R))
    invB0 = torch.linalg.inv_ex(A_B0)[0]
    # entry gate: a materially dual-infeasible start would give garbage
    # verdicts
    w0 = torch.bmm(invB0.transpose(1, 2),
                   torch.gather(c, 1, B).unsqueeze(-1)).squeeze(-1)
    in_b0 = torch.zeros((Bn, Nt), dtype=torch.bool, device=dev)
    in_b0.scatter_(1, B, True)
    S = S0.to(torch.int8).clone()
    dviol = dual_feasibility_violation(c, Amat, w0, S, ~in_b0, real, ud)
    bad_start = (dviol > dual_gate_tol(c, tol)) \
        | ~torch.isfinite(invB0).all(dim=(1, 2))
    pd = (torch.zeros(Bn, dtype=torch.bool, device=dev) if pre_done is None
          else pre_done.to(torch.bool))
    st = SimplexState(
        B, S, x0.to(dtype).clone(), invB0,
        torch.zeros(Bn, dtype=torch.int32, device=dev), pd | bad_start,
        torch.where(pd, 1, torch.where(bad_start, -1, 0)).to(torch.int32))
    step = lambda *a: _dual_step(*a, tol=tol)
    st = run_chunked(step, (c, Amat, b, d, u, real, ud, fu), st, max_iter)
    status = torch.where(st.done, st.status,
                         torch.full_like(st.status, -max_iter))
    return status.to(torch.int32), st.x, st.B, st.S, st.it
