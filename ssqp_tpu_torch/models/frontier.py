"""Efficient-frontier portfolio model family (PyTorch).

Counterpart of ``ssqp_tpu/models/frontier.py`` (the reference's
examples/SSQPspeed.jl protocol; QP frontier constructors types.jl:303-339).
Given a covariance V, expected returns r and portfolio constraints, the
frontier is traced either

  * L-parameterized: ``min 1/2 z'Vz - L r'z`` for a grid of risk-tolerance
    values L (types.jl:303-319), or
  * mu-parameterized: ``min 1/2 z'Vz  s.t. r'z = mu`` for a grid of target
    returns (types.jl:321-339).

``Q`` is always one (unbatched) constraint template. The batch sweeps solve
every grid point at once with every leaf but the varying one shared
(:func:`frontier_batch_sweep`, :func:`frontier_waves_sweep`,
:func:`frontier_mu_sweep`); the warm sweeps walk the grid in a Python loop,
one point per step, each warm-started from the previous point's optimum
(:func:`frontier_warm_sweep`, :func:`frontier_mu_warm_sweep`), where the
JAX package runs a ``lax.scan``.

Every sweep returns its points projected back onto their working rows
(:func:`_restore_rows`), a step the JAX package does not take: in float32
the KKT solves' Schur ridge (100 eps) leaves an equality row off by the
ridge times its multiplier, ~1e-5 on the mu sweeps' return row in both
packages, and the objective at the grid's own values off by that row error
times the multiplier. In float64 the step moves x by ~1e-14.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ssqp_tpu_torch.ops.bmat import mtv, mv
from ssqp_tpu_torch.ops.kkt import spd_solve
from ssqp_tpu_torch.solvers.phase1 import init_qp_traced
from ssqp_tpu_torch.solvers.ssqp import (
    _primal_violation, _rows, solve_qp_auto_core, solve_qp_loop)
from ssqp_tpu_torch.types import EO, IN, QP, Settings
from ssqp_tpu_torch.utils.precision import highest_matmul

_ALL_BUT_Q = ("V", "A", "G", "b", "g", "d", "u")
_MU_SHARED = ("V", "A", "G", "g", "d", "u")


class FrontierResult(NamedTuple):
    x: torch.Tensor  # (B, N) weights per grid point
    S: torch.Tensor  # (B, N+J) statuses
    status: torch.Tensor  # (B,) solver status codes
    ret: torch.Tensor  # (B,) expected return r'x
    risk: torch.Tensor  # (B,) sqrt(x'Vx)


def _grid(Q: QP, values) -> torch.Tensor:
    """A grid (list, numpy or a tensor on Q's device) as a 1-D tensor in
    Q's dtype on Q's device."""
    if isinstance(values, torch.Tensor) and values.device != Q.device:
        raise ValueError(f"grid on {values.device}, QP on {Q.device}")
    return torch.as_tensor(values, device=Q.device).to(Q.V.dtype).reshape(-1)


def _with_q(Q: QP, q) -> QP:
    return dataclasses.replace(Q, q=q)


def _with_mu_row(Q: QP, rets, mu) -> QP:
    """Template with the return row ``r'z = mu`` appended to A and a zero
    objective (the mu-parameterized constructor, reference QP(mu, P),
    types.jl:321-339). ``mu`` (B,) batches b; V, A, G, g, d and u stay
    shared, so M grows by 1 and V is never replicated. The zero q is a
    broadcast view of one row: the solver takes q per instance."""
    dtype = Q.V.dtype
    B = mu.shape[0]
    A = torch.cat([Q.A, rets.unsqueeze(0)], dim=0)
    b = torch.cat([Q.b.expand(B, Q.M), mu.unsqueeze(1)], dim=1)
    q = torch.zeros(Q.N, dtype=dtype, device=Q.device).expand(B, Q.N)
    return dataclasses.replace(Q, A=A, b=b, q=q, M=Q.M + 1)


def _stats(Q: QP, rets, x):
    ret = x @ rets
    risk = torch.sqrt(torch.clamp((x * mv(Q.V, x)).sum(dim=1), min=0.0))
    return ret, risk


def _restore_rows(Qb: QP, x, S, status):
    """Project each solved point back onto its working rows (the equality
    rows and the active inequality rows) over its free coordinates, in
    float64: ``x_F += A_F'(A_F A_F')^{-1}(b - A x)``, clamped to the box.
    To first order the objective moves by the rows' multipliers times the
    row error, the move the grid's own values ask for; the stationarity
    error it adds is V times a step of the row error's size. Taken only
    where the point solved and no constraint ends up more violated."""
    N, M, J = Qb.N, Qb.M, Qb.J
    if M + J == 0:
        return x
    Qh = Qb.astype(torch.float64)
    AG, bg = _rows(Qh)
    xh = x.to(torch.float64)
    act = torch.ones((x.shape[0], M), dtype=torch.bool, device=x.device)
    if J > 0:
        act = torch.cat([act, S[:, N:] == EO], dim=1)
    fm = (S[:, :N] == IN).to(xh.dtype)
    Ap = AG * (act.to(xh.dtype).unsqueeze(-1) * fm.unsqueeze(-2))
    norm2 = (Ap * Ap).sum(dim=-1)
    km = (norm2 > 0).to(xh.dtype)  # a row with no free coordinate stays
    ridge = torch.finfo(xh.dtype).eps * N * norm2.amax(dim=-1, keepdim=True)
    gram = (torch.bmm(Ap, Ap.transpose(1, 2))
            + torch.diag_embed((1.0 - km) + ridge * km))
    dl = spd_solve(gram, km * (bg - mv(AG, xh)))
    xp = torch.clamp(xh + mtv(Ap, km * dl), min=Qh.d, max=Qh.u)
    accept = ((status > 0) & (_primal_violation(Qh, xp)
                              <= _primal_violation(Qh, xh)))
    return torch.where(accept.unsqueeze(1), xp, xh).to(x.dtype)


def _result(Qb: QP, rets, x, S, status) -> FrontierResult:
    """The sweep's result from the batched QP ``Qb`` it solved: x with its
    rows restored, and its return and risk."""
    x = _restore_rows(Qb, x, S, status)
    ret, risk = _stats(Qb, rets, x)
    return FrontierResult(x, S, status, ret, risk)


@highest_matmul
def frontier_batch_sweep(Q: QP, rets, lams, settings: Settings
                         ) -> FrontierResult:
    """Solve every L-grid point at once (cold starts): the batched QP
    shares every leaf but q (``solve_qp_batch``).

    ``Q`` is the constraint template (its q field is ignored); ``rets`` the
    expected-return vector; ``lams`` the (B,) risk-tolerance grid."""
    from ssqp_tpu_torch.parallel.batch import solve_qp_batch

    lams, rets = _grid(Q, lams), _grid(Q, rets)
    Qb = _with_q(Q, -lams.unsqueeze(1) * rets.unsqueeze(0))
    res = solve_qp_batch(Qb, settings, shared=_ALL_BUT_Q)
    return _result(Qb, rets, res.x, res.S, res.status)


@highest_matmul
def frontier_waves_sweep(Q: QP, rets, lams, settings: Settings,
                         waves: int = 8) -> FrontierResult:
    """Wave-parallel warm sweep (``parallel/batch.py::solve_qp_batch_waves``):
    a strided coarse wave solves cold, the remaining waves warm-start from
    grid neighbours. ``len(lams)`` must be divisible by ``waves``; the grid
    should be sorted so neighbours are related."""
    from ssqp_tpu_torch.parallel.batch import solve_qp_batch_waves

    lams, rets = _grid(Q, lams), _grid(Q, rets)
    Qb = _with_q(Q, -lams.unsqueeze(1) * rets.unsqueeze(0))
    res = solve_qp_batch_waves(Qb, settings, _ALL_BUT_Q, waves=waves)
    return _result(Qb, rets, res.x, res.S, res.status)


def _warm_sweep(Q: QP, settings: Settings, points, mk) -> tuple:
    """The loop shared by the warm L- and mu-sweeps (the JAX package's
    ``_warm_step`` under ``lax.scan``). ``mk`` maps a (1,) slice of the grid
    to that point's batch-of-one QP, built inside the step so V is never
    replicated per point. Each step runs the S-loop from the carried
    (S, x); where it fails, the point is re-solved cold (guess + Phase-1 +
    fast/exact passes), and the carry moves on only from a point that
    solved. The first point's Phase-1 status gates every step, as the
    JAX package's ``pre_status``."""
    N = Q.N
    Q0 = mk(points[0:1])
    x, Sx, Se, st1 = init_qp_traced(Q0, settings)
    xs, Ss, sts = [], [], []
    for i in range(points.shape[0]):
        Qi = mk(points[i:i + 1])
        res = solve_qp_loop(Qi, Sx, Se, x, settings, pre_status=st1)
        if not bool(res.status[0] > 0):  # cold re-solve on failure only
            res = solve_qp_auto_core(Qi, settings)
        if bool(res.status[0] > 0):
            Sx, Se, x = res.S[:, :N], res.S[:, N:], res.x
        xs.append(res.x)
        Ss.append(res.S)
        sts.append(res.status)
    return torch.cat(xs), torch.cat(Ss), torch.cat(sts)


@highest_matmul
def frontier_warm_sweep(Q: QP, rets, lams, settings: Settings
                        ) -> FrontierResult:
    """Sweep the L grid in order, warm-starting each point from the
    previous optimum's (S, x) (reference protocol, SSQPspeed.jl:128-163).
    A failed point is re-solved cold before the sweep moves on; only if
    that also fails does the carry keep the last good state. One host
    check per point."""
    lams, rets = _grid(Q, lams), _grid(Q, rets)
    mk = lambda lam: _with_q(Q, -lam.unsqueeze(1) * rets.unsqueeze(0))
    xs, Ss, sts = _warm_sweep(Q, settings, lams, mk)
    return _result(mk(lams), rets, xs, Ss, sts)


@highest_matmul
def frontier_mu_sweep(Q: QP, rets, mus, settings: Settings
                      ) -> FrontierResult:
    """mu-parameterized frontier: ``min 1/2 z'Vz s.t. r'z = mu`` per grid
    point (reference QP(mu, P), types.jl:321-339), solved at once with the
    return row appended to A and only b varying across the batch."""
    from ssqp_tpu_torch.parallel.batch import solve_qp_batch

    mus, rets = _grid(Q, mus), _grid(Q, rets)
    Qb = _with_mu_row(Q, rets, mus)
    res = solve_qp_batch(Qb, settings, shared=_MU_SHARED)
    return _result(Qb, rets, res.x, res.S, res.status)


@highest_matmul
def frontier_mu_warm_sweep(Q: QP, rets, mus, settings: Settings
                           ) -> FrontierResult:
    """mu-parameterized sweep with warm starts carried point to point (the
    second half of the reference's warm protocol, SSQPspeed.jl:190-227).

    The carried x violates the new return row by (mu_prev - mu); the first
    S-loop iteration's KKT solve re-solves the free coordinates against the
    new right-hand side. A point the warm solve cannot crack is re-solved
    cold, Phase-1 included (feasibility depends on mu, so a genuinely
    unachievable mu stays status 0)."""
    mus, rets = _grid(Q, mus), _grid(Q, rets)
    mk = lambda mu: _with_mu_row(Q, rets, mu)
    xs, Ss, sts = _warm_sweep(Q, settings, mus, mk)
    return _result(mk(mus), rets, xs, Ss, sts)
