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
"""

from __future__ import annotations

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
    invB = torch.linalg.inv(A_B0)
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
