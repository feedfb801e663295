"""Closed-form LP over a box (no equality or inequality rows).

Counterpart of ``ssqp_tpu/solvers/boxlp.py`` (the reference's ``boxLP``,
utils.jl:282-329): a per-coordinate sign test on c. As in the JAX package,
the clean unique case returns status 1 (the reference leaves -1 there).
Works on one LP or on a batch (any leaf with a leading batch axis).
"""

from __future__ import annotations

import torch

from ssqp_tpu_torch.types import DN, IN, LP, UP, Result, Settings


def box_lp(P: LP, *, settings: Settings | None = None,
           minimize: bool = True) -> Result:
    settings = settings or Settings.for_dtype(P.c.dtype)
    tol = settings.tol
    c = P.c if minimize else -P.c
    c, d, u = torch.broadcast_tensors(c, P.d, P.u)
    fd, fu = torch.isfinite(d), torch.isfinite(u)

    pos = c > tol
    neg = c < -tol
    zero = ~pos & ~neg
    x = torch.where(neg, u, d)
    S = torch.where(neg, UP, DN)
    # zero-cost coordinates: any value is optimal; d if finite, else u or 0
    xz = torch.where(fd, d, torch.where(fu, u, torch.zeros_like(u)))
    x = torch.where(zero, xz, x)
    S = torch.where(zero & ~fd & fu, UP, S)
    S = torch.where(zero & ~fd & ~fu, IN, S).to(torch.int8)

    unbounded = ((pos & ~fd) | (neg & ~fu)).any(dim=-1)
    many = zero.any(dim=-1)
    status = torch.where(unbounded, 3, torch.where(many, 2, 1)).to(
        torch.int32)
    x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    # no rows: the reduced gradient is the minimized cost itself
    ok = (status > 0).unsqueeze(-1)
    gamma = torch.where(ok, c, torch.zeros_like(c))
    lam = torch.zeros(c.shape[:-1] + (0,), dtype=c.dtype, device=c.device)
    return Result(x, S, status, lam, gamma)
