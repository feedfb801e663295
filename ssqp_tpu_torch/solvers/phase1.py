"""Phase-1 feasibility via the big-M-free bounded simplex, batch-first.

Counterpart of ``ssqp_tpu/solvers/phase1.py`` (reference initQP,
SSQP.jl:461-560): slack columns turn Gx<=g rows into equalities, free
variables are split x = x+ - x-, (-inf, u] variables are sign-flipped, and a
+-identity artificial basis with cost sum(artificials) gives a feasible start.
Every variable gets a negative-part column (a dummy, masked out through
``real``, where the variable is not free), so all shapes are fixed:

    [ original N | slacks J | negative parts N | artificials M+J ]
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ssqp_tpu_torch.ops.bmat import cat_vec, stack_rows
from ssqp_tpu_torch.solvers.simplex import bounded_simplex
from ssqp_tpu_torch.types import DN, EO, IN, OE, QP, UP, Settings, batch_of
from ssqp_tpu_torch.utils.precision import highest_matmul


class Standardized(NamedTuple):
    A1: torch.Tensor  # (B, R, Nt) with Nt = 2N + J + R
    b0: torch.Tensor  # (B, R)
    d1: torch.Tensor  # (B, Nt)
    u1: torch.Tensor
    real: torch.Tensor  # (B, Nt) bool
    fv: torch.Tensor  # (B, N) bool — free variables (split)
    flip: torch.Tensor  # (B, N) bool — (-inf, u] variables (sign-flipped)
    B0: torch.Tensor  # (B, R) initial (artificial) basis
    S0: torch.Tensor  # (B, Nt) initial statuses


def standardize_bounded(A, G, b, g, d, u, batch: int):
    """Build the standardized LP data for ``batch`` instances; each leaf may
    be shared or batched."""
    N = A.shape[-1]
    M, J = A.shape[-2], G.shape[-2]
    R = M + J
    dev = A.device
    dtype = A.dtype
    AG = stack_rows(A, G).expand(batch, R, N)
    b0 = cat_vec(b, g).expand(batch, R)
    d = d.expand(batch, N)
    u = u.expand(batch, N)

    fv = ~torch.isfinite(u) & ~torch.isfinite(d)
    flip = ~torch.isfinite(d) & ~fv
    sgn = torch.where(flip, -1.0, 1.0).to(dtype)
    AGs = AG * sgn.unsqueeze(1)
    zero = torch.zeros_like(d)
    d_o = torch.where(fv, zero, torch.where(flip, -u, d))
    u_o = torch.where(flip, torch.full_like(u, float("inf")), u)

    slackA = torch.zeros((batch, R, J), dtype=dtype, device=dev)
    if J > 0:
        slackA[:, M:, :] = torch.eye(J, dtype=dtype, device=dev)
    negA = torch.where(fv.unsqueeze(1), -AGs, torch.zeros_like(AGs))
    u_n = torch.where(fv, torch.full_like(u, float("inf")), zero)

    A0 = torch.cat([AGs, slackA, negA], dim=2)
    zJ = torch.zeros((batch, J), dtype=dtype, device=dev)
    infJ = torch.full((batch, J), float("inf"), dtype=dtype, device=dev)
    d0 = torch.cat([d_o, zJ, zero], dim=1)
    u0 = torch.cat([u_o, infJ, u_n], dim=1)

    q0 = torch.bmm(A0, d0.unsqueeze(-1)).squeeze(-1)
    sigma = torch.where(b0 >= q0, 1.0, -1.0).to(dtype)
    A1 = torch.cat([A0, torch.diag_embed(sigma)], dim=2)
    d1 = torch.cat([d0, torch.zeros((batch, R), dtype=dtype, device=dev)], 1)
    u1 = torch.cat([u0, torch.full((batch, R), float("inf"), dtype=dtype,
                                   device=dev)], 1)

    N0 = 2 * N + J
    ones = lambda n: torch.ones((batch, n), dtype=torch.bool, device=dev)
    real = torch.cat([ones(N + J), fv, ones(R)], dim=1)
    B0 = (N0 + torch.arange(R, device=dev)).expand(batch, R).clone()
    S0 = torch.full((batch, N0 + R), DN, dtype=torch.int8, device=dev)
    S0[:, N0:] = IN
    return Standardized(A1, b0.clone(), d1, u1, real, fv, flip, B0, S0)


def recover_x_status(x1, S1, std: Standardized, N: int, J: int):
    """Map the standardized solution back to original variables and
    statuses (reference SSQP.jl:540-559)."""
    xo = x1[:, :N]
    xneg = x1[:, N + J:N + J + N]
    xo = torch.where(std.fv, xo - xneg, xo)
    xo = torch.where(std.flip, -xo, xo)
    So = S1[:, :N]
    So = torch.where(std.fv, torch.full_like(So, IN), So)
    So = torch.where(std.flip & (So == DN), torch.full_like(So, UP), So)
    Se = torch.where(S1[:, N:N + J] == IN, OE, EO).to(torch.int8)
    return xo, So.to(torch.int8), Se


@highest_matmul
def init_qp_traced(Q: QP, settings: Settings, skip=None):
    """Phase-1 for a batched QP. Returns (x0 (B, N), Sx (B, N), Se (B, J),
    status (B,)); status 1 feasible, 0 infeasible, -1 numerical error.

    ``skip`` (B,) bool: instances whose result the caller discards; their
    simplex starts done and costs nothing."""
    N, M, J = Q.N, Q.M, Q.J
    Bn = batch_of(Q)
    dtype = Q.V.dtype
    dev = Q.device
    if M + J == 0:
        x0 = torch.clamp(torch.zeros((Bn, N), dtype=dtype, device=dev),
                         min=Q.d, max=Q.u)
        Sx = torch.where(torch.isfinite(Q.d) & (x0 == Q.d), DN,
                         torch.where(torch.isfinite(Q.u) & (x0 == Q.u), UP, IN))
        return (x0, Sx.to(torch.int8),
                torch.zeros((Bn, 0), dtype=torch.int8, device=dev),
                torch.ones(Bn, dtype=torch.int32, device=dev))

    std = standardize_bounded(Q.A, Q.G, Q.b, Q.g, Q.d, Q.u, Bn)
    R = M + J
    N0 = 2 * N + J
    c1 = torch.cat([torch.zeros((Bn, N0), dtype=dtype, device=dev),
                    torch.ones((Bn, R), dtype=dtype, device=dev)], dim=1)
    lp_status, x1, _, S1, _ = bounded_simplex(
        c1, std.A1, std.b0, std.d1, std.u1, std.B0, std.S0, std.d1, std.real,
        tol=settings.tol, max_iter=settings.max_iter, rule=settings.rule,
        pre_done=skip)
    f_art = x1[:, N0:].sum(dim=1)
    xo, Sx, Se = recover_x_status(x1, S1, std, N, J)
    status = torch.where(lp_status < 0, -1,
                         torch.where(f_art > settings.tol, 0, 1))
    return xo, Sx, Se, status.to(torch.int32)
