"""Differentiable QP solves: implicit differentiation at the optimum.

Counterpart of ``ssqp_tpu/solvers/diff.py``. The solution map
``theta -> x*(theta)`` of

    min (1/2) x'Vx + q'x   s.t.  Ax = b, Gx <= g, d <= x <= u

is made differentiable with respect to every problem datum (V, q, A, b, G,
g, d, u) in two steps:

  1. **identify**: the full status-switching solver runs on detached data
     under ``torch.no_grad()`` (on a CUDA tensor its CG solves are the
     hand-written kernel) and returns the optimal statuses ``S*``;
  2. **re-solve**: with the active set fixed at ``S*``, the optimum solves
     one equality-constrained KKT system (the mask-padded block elimination
     of ``ops/kkt.py``) built from the live data with differentiable
     PyTorch operations (``torch.linalg.cholesky_ex`` and
     ``torch.cholesky_solve``), whose autograd rules give the
     implicit-function derivative. Bound pins enter as ``where(S==DN, d,
     u)``, so gradients reach the box bounds too.

At a nondegenerate optimum the active set is locally constant, so the
derivative is exact; at degenerate points it is a valid one-sided choice.
The re-solve is a library Cholesky, as the JAX package's is an XLA one
outside any Pallas kernel: the Cholesky kernel has no backward.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ssqp_tpu_torch.ops.bmat import cat_vec, mtv, mv, stack_rows
from ssqp_tpu_torch.types import DN, EO, IN, OE, QP, UP, Result, Settings
from ssqp_tpu_torch.utils.precision import highest_matmul


def _spd(A, rhs):
    """Differentiable batched SPD solve: A (B, n, n), rhs (B, n, k). A
    failed factorization gives NaN on its instance, as XLA's Cholesky
    does, instead of raising for the whole batch. torch's Cholesky backward
    returns the symmetric part of the gradient with respect to A, where
    JAX's leaves it unsymmetrized: the two agree on every symmetric
    direction, the only ones a covariance moves in."""
    L, info = torch.linalg.cholesky_ex(A)
    X = torch.cholesky_solve(rhs, L)
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.full_like(X, float("nan")), X)


def kkt_resolve(Q: QP, Sx, Se, settings: Settings):
    """Differentiable fixed-active-set KKT re-solve at statuses ``Sx``
    (B, N) / ``Se`` (B, J) for a batched QP (shared leaves broadcast).

    The redundancy purge (a discrete row selection) runs on detached
    copies: its keep mask is piecewise constant in the data, like the
    active set. Returns (x (B, N), lam (B, M+J), gamma (B, N)): the
    optimum, the working-row multipliers (zero on inactive or purged rows)
    and the reduced gradient, all differentiable in Q's leaves."""
    from ssqp_tpu_torch.ops.masked_gj import select_purge

    dtype = Q.V.dtype
    N, M, J = Q.N, Q.M, Q.J
    R = M + J
    Bn = Sx.shape[0]

    free = (Sx == IN).detach()
    fm = free.to(dtype)
    bm = 1.0 - fm
    # pinned coordinates take their bound value; a pin at an infinite bound
    # cannot occur at a valid optimum, but is guarded so a corrupt status
    # vector cannot poison gradients with inf
    zero = torch.zeros((), dtype=dtype, device=Q.device)
    zB = torch.where(Sx == DN, Q.d, torch.where(Sx == UP, Q.u, zero)) * bm
    zB = torch.where(torch.isfinite(zB), zB, zero)

    c_full = mv(Q.V, zB) + Q.q
    cp = fm * c_full
    Vff = fm.unsqueeze(2) * fm.unsqueeze(1)
    Vp = Q.V * Vff + torch.diag_embed(bm)

    if R == 0:
        alpha_f = -_spd(Vp, cp.unsqueeze(-1)).squeeze(-1)
        x = fm * alpha_f + zB
        lam = torch.zeros((Bn, 0), dtype=dtype, device=Q.device)
        return x, lam, mv(Q.V, x) + Q.q

    AG = stack_rows(Q.A, Q.G) if J > 0 else Q.A
    bg = cat_vec(Q.b, Q.g) if J > 0 else Q.b
    act = torch.ones((Bn, M), dtype=torch.bool, device=Q.device)
    if J > 0:
        act = torch.cat([act, Se == EO], dim=1)
    bE = bg - mv(AG, zB)

    purge = select_purge(settings.pivot, R)
    with torch.no_grad():
        keep, _, _ = purge((AG * fm.unsqueeze(-2)).detach(), bE.detach(),
                           act, settings.tol)
    km = keep.to(dtype)

    Ap = AG * (km.unsqueeze(-1) * fm.unsqueeze(-2))  # (B, R, N)
    bp = km * bE
    rhs = torch.cat([cp.unsqueeze(-1), Ap.transpose(1, 2)], dim=2)
    sol = _spd(Vp, rhs)
    w, mT = sol[..., 0], sol[..., 1:]
    C = torch.bmm(Ap, mT)
    C = (C + C.transpose(1, 2)) / 2 + torch.diag_embed(1.0 - km)
    rC = (torch.bmm(Ap, w.unsqueeze(-1)).squeeze(-1) + bp).unsqueeze(-1)
    alphaL = -_spd(C, rC).squeeze(-1)
    alpha_f = -(torch.bmm(mT, alphaL.unsqueeze(-1)).squeeze(-1) + w)

    x = fm * alpha_f + zB
    lam = km * alphaL
    gamma = mv(Q.V, x) + Q.q + mtv(AG, lam)
    return x, lam, gamma


def _detached(Q: QP) -> QP:
    return dataclasses.replace(
        Q, **{f: t.detach() for f, t in Q.leaves().items()})


@highest_matmul
def solve_qp_diff(Q: QP, settings: Optional[Settings] = None,
                  settings_lp: Optional[Settings] = None) -> Result:
    """Solve a QP (or a batch) with a solution differentiable in the
    problem data.

    Identification runs the three-stage solver (PDAS guess, Phase-1,
    S-loop) on detached data without autograd; ``x``/``lam``/``gamma``
    then come from one differentiable fixed-active-set KKT re-solve on the
    live data (:func:`kkt_resolve`). Failed instances (status <= 0) pass
    the solver's own output through and get a zero gradient. A batched QP
    may share leaves (they stay unbatched); an unbatched QP gives
    unbatched results.

    The envelope theorem falls out: the gradient of :func:`qp_value` with
    respect to q is x*."""
    from ssqp_tpu_torch.solvers.ssqp import solve_qp, solve_qp_auto

    if settings is None:
        settings = Settings.for_dtype(Q.V.dtype)
    if Q.mc <= 0:  # invalid model: the same contract as solve_qp
        if Q.batch_size is not None:
            raise ValueError("solve_qp_diff: an invalid model (mc <= 0) "
                             "cannot be batched")
        return solve_qp(_detached(Q), settings=settings,
                        settings_lp=settings_lp)
    from ssqp_tpu_torch.parallel.batch import settings_for_shared

    single = Q.batch_size is None
    Qb = dataclasses.replace(Q, q=Q.q.unsqueeze(0)) if single else Q
    shared = tuple(f for f in Qb.leaves() if not Qb.is_batched(f))
    with torch.no_grad():
        res = solve_qp_auto(_detached(Qb), settings_for_shared(settings,
                                                                shared),
                            settings_lp)
    ok = res.status > 0
    N = Q.N
    # Failed instances must not poison gradients: where's backward gives
    # the untaken branch a zero cotangent, but 0 * NaN from re-solving a
    # garbage active set is still NaN. Their statuses are sanitized to the
    # all-free / all-inactive set (finite for PD V) before the re-solve, so
    # their gradient is a true zero.
    okc = ok.unsqueeze(1)
    Sx = torch.where(okc, res.S[:, :N], IN).to(res.S.dtype)
    Se = torch.where(okc, res.S[:, N:], OE).to(res.S.dtype)
    x, lam, gamma = kkt_resolve(Qb, Sx, Se, settings)
    x = torch.where(okc, x, res.x)
    lam = torch.where(okc, lam, res.lam)
    gamma = torch.where(okc, gamma, res.gamma)
    if single:
        return Result(x[0], res.S[0], res.status[0], lam[0], gamma[0])
    return Result(x, res.S, res.status, lam, gamma)


def qp_value(Q: QP, x) -> torch.Tensor:
    """Objective value ``(1/2) x'Vx + q'x`` (differentiable); per instance
    for a batch of x."""
    if x.dim() == 1:
        return 0.5 * x @ (Q.V @ x) + Q.q @ x
    return 0.5 * (x * mv(Q.V, x)).sum(dim=-1) + (Q.q * x).sum(dim=-1)
