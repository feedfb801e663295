"""Fixed-shape standard-form reduction ``min c'x, Ax=b, x>=0``, batch-first.

Counterpart of ``ssqp_tpu/utils/standard_form.py`` (the reference's ``cAb``,
utils.jl:202-279): purge redundant equality rows, slack-convert Gx<=g, split
free variables, sign-flip (-inf, u] variables, shift finite lower bounds to
zero, and turn finite upper bounds into extra equality rows with a
bound-slack identity block. Every size is static in (N, M, J):

  rows    [ M original equalities | J slack-converted inequalities | N bound rows ]
  columns [ y (N) | G slacks (J) | negative parts (N) | bound slacks (N) | row anchors (M+J) ]

The negative-part column of a non-free variable is a zero dummy; the bound
row of a non-boxed variable degenerates to ``s_i = 0``; a redundant [A|b] row
is zeroed and its anchor column carries it; inconsistent rows mark the
instance infeasible. Anchors and dummies have zero cost, so they never pivot
(solvers/cclp.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ssqp_tpu_torch.ops.bmat import cat_vec, stack_rows
from ssqp_tpu_torch.ops.masked_gj import masked_gj_purge


class StandardForm(NamedTuple):
    c1: torch.Tensor  # (B, Nt) costs
    A1: torch.Tensor  # (B, R2, Nt) equality matrix, R2 = M + J + N
    b1: torch.Tensor  # (B, R2) rhs
    d0: torch.Tensor  # (B, N + J) lower-bound shift of [y | G slacks]
    sgn: torch.Tensor  # (B, N) +-1 flip signs
    free: torch.Tensor  # (B, N) bool — split variables
    flip: torch.Tensor  # (B, N) bool — (-inf, u] variables
    boxed: torch.Tensor  # (B, N) bool — finite d and u
    keep_rows: torch.Tensor  # (B, M+J) bool — non-redundant [A; G-slack] rows
    inconsistent: torch.Tensor  # (B,) bool — rank([A b]) > rank(A)


def standard_form(c, A, b, G, g, d, u, batch: int, tol=None) -> StandardForm:
    """Build the standard form of ``batch`` instances (module docstring);
    each leaf may be shared (single-instance shape) or batched. ``tol`` is
    the redundancy purge's tolerance: pass the caller's ``Settings.tol`` so
    the rank decisions follow the solving dtype's tier."""
    M, N = A.shape[-2:]
    J = G.shape[-2]
    MJ = M + J
    dtype, dev = c.dtype, c.device
    tol = 2.0**-26 if tol is None else float(tol)
    c = c.expand(batch, N)
    d = d.expand(batch, N)
    u = u.expand(batch, N)

    free = ~torch.isfinite(u) & ~torch.isfinite(d)
    flip = ~torch.isfinite(d) & torch.isfinite(u)
    boxed = torch.isfinite(d) & torch.isfinite(u)
    sgn = torch.where(flip, -1.0, 1.0).to(dtype)
    zero = torch.zeros_like(d)
    dq = torch.where(free, zero, torch.where(flip, -u, d))
    uq = torch.where(flip, torch.full_like(u, float("inf")), u)
    cs = c * sgn

    AG = (stack_rows(A, G) if J > 0 else A).expand(batch, MJ, N)
    AGs = AG * sgn.unsqueeze(1)
    bg = (cat_vec(b, g) if J > 0 else b).expand(batch, MJ)

    # purge redundant or inconsistent rows of [A b] (G rows keep their own
    # slack columns and are never purged)
    if M > 0:
        keepA, inconsistent, _ = masked_gj_purge(
            A, b.expand(batch, M),
            torch.ones((batch, M), dtype=torch.bool, device=dev), tol)
    else:
        keepA = torch.zeros((batch, 0), dtype=torch.bool, device=dev)
        inconsistent = torch.zeros(batch, dtype=torch.bool, device=dev)
    keep_rows = torch.cat(
        [keepA, torch.ones((batch, J), dtype=torch.bool, device=dev)], dim=1)
    km = keep_rows.to(dtype)

    slackA = torch.zeros((batch, MJ, J), dtype=dtype, device=dev)
    if J > 0:
        slackA[:, M:, :] = torch.eye(J, dtype=dtype, device=dev)
    negA = torch.where(free.unsqueeze(1), -AGs, torch.zeros_like(AGs))
    d0 = torch.cat([dq, torch.zeros((batch, J), dtype=dtype, device=dev)], 1)

    kmr = km.unsqueeze(-1)
    top = torch.cat([AGs * kmr, slackA * kmr, negA * kmr,
                     torch.zeros((batch, MJ, N), dtype=dtype, device=dev),
                     torch.diag_embed(1.0 - km)], dim=2)
    b_top = km * (bg - torch.bmm(AGs, dq.unsqueeze(-1)).squeeze(-1))

    # bound rows: boxed i -> y_i + s_i = u_i - d_i ; else s_i = 0
    eyeN = torch.eye(N, dtype=dtype, device=dev).expand(batch, N, N)
    bound = torch.cat([eyeN * boxed.to(dtype).unsqueeze(-1),
                       torch.zeros((batch, N, J + N), dtype=dtype,
                                   device=dev),
                       eyeN,
                       torch.zeros((batch, N, MJ), dtype=dtype, device=dev)],
                      dim=2)
    b_bound = torch.where(boxed, uq - dq, zero)

    A1 = torch.cat([top, bound], dim=1)
    b1 = torch.cat([b_top, b_bound], dim=1)
    c1 = torch.cat([cs, torch.zeros((batch, J), dtype=dtype, device=dev),
                    torch.where(free, -c, zero),
                    torch.zeros((batch, N + MJ), dtype=dtype, device=dev)],
                   dim=1)
    return StandardForm(c1, A1, b1, d0, sgn, free, flip, boxed, keep_rows,
                        inconsistent)


def recover_solution(y_full, S1, sf: StandardForm, N: int, J: int):
    """Map a standard-form point and statuses (B, Nt) back to the original
    variables (the reference's CCLP.jl:315-367, with the intended
    free-variable semantics). Returns (x (B, N), Sx (B, N), Se (B, J))."""
    from ssqp_tpu_torch.types import DN, EO, IN, OE, UP

    xo = y_full[:, :N] + sf.d0[:, :N]
    neg = y_full[:, N + J:N + J + N]
    xo = torch.where(sf.free, xo - neg, xo)
    xo = torch.where(sf.flip, -xo, xo)

    So = S1[:, :N]
    # free variables are always IN (a DN label would read as x = d = -inf)
    So = torch.where(sf.free, torch.full_like(So, IN), So)
    So = torch.where(sf.flip & (So == DN), torch.full_like(So, UP), So)
    # a boxed variable whose bound slack is nonbasic sits at its upper bound
    bs = S1[:, N + J + N:N + J + 2 * N]
    So = torch.where(sf.boxed & (bs == DN), torch.full_like(So, UP), So)

    # slack basic -> row inactive (OE); slack nonbasic -> row tight (EO)
    Se = torch.where(S1[:, N:N + J] == IN, OE, EO).to(torch.int8)
    return xo, So.to(torch.int8), Se
