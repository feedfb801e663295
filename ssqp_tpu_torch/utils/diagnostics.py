"""Observability: batched KKT diagnostics and a profiling helper (PyTorch).

Counterpart of ``ssqp_tpu/utils/diagnostics.py``. :func:`kkt_report`
computes per-instance optimality and feasibility measures for a whole batch
as device tensors (nothing forces a host sync), and :func:`trace` wraps a
region in a ``torch.profiler`` trace written as a Chrome trace file.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import NamedTuple

import torch

from ssqp_tpu_torch.ops.bmat import mtv, mv, stack_rows
from ssqp_tpu_torch.types import DN, EO, IN, QP, UP, Result
from ssqp_tpu_torch.utils.precision import highest_matmul


class KKTReport(NamedTuple):
    feas_eq: torch.Tensor  # max |Ax - b|
    feas_ineq: torch.Tensor  # max(0, max (Gx - g))
    feas_bounds: torch.Tensor  # max bound violation
    stationarity: torch.Tensor  # free-coordinate projected-gradient norm
    complementarity: torch.Tensor  # max |(g - Gx)| over rows labeled EO
    iters: torch.Tensor  # iteration count (status if > 0, else 0)
    solved: torch.Tensor  # status > 0


def _report(Q: QP, res: Result) -> KKTReport:
    """The report for a batch: ``res`` leaves (B, ...), Q's leaves shared
    or batched."""
    x = res.x
    N, M, J = Q.N, Q.M, Q.J
    Bn = x.shape[0]
    dtype = x.dtype
    dev = x.device
    Sx = res.S[:, :N]
    zero = torch.zeros(Bn, dtype=dtype, device=dev)
    feas_eq = (mv(Q.A, x) - Q.b).abs().amax(dim=-1) if M > 0 else zero
    feas_in = (torch.clamp((mv(Q.G, x) - Q.g).amax(dim=-1), min=0.0)
               if J > 0 else zero)
    feas_bd = torch.maximum(torch.clamp(Q.d - x, min=0.0).amax(dim=-1),
                            torch.clamp(x - Q.u, min=0.0).amax(dim=-1))
    # stationarity on the free coordinates: the gradient projected onto the
    # null space of the working equalities must vanish
    grad = mv(Q.V, x) + Q.q
    fm = (Sx == IN).to(dtype)
    AG = stack_rows(Q.A, Q.G) if J > 0 else Q.A
    act = torch.ones((Bn, M), dtype=torch.bool, device=dev)
    if J > 0:
        act = torch.cat([act, res.S[:, N:] == EO], dim=1)
    act = act.to(dtype)
    Ap = AG * (act.unsqueeze(-1) * fm.unsqueeze(-2))  # (B, R, N)
    gf = grad * fm
    # least-squares multipliers through the normal equations (+ tiny
    # ridge), then sign-projected: with y = -lam stationarity reads
    # grad + AG'y = gamma, and optimality demands y >= 0 on active
    # inequality rows plus gamma >= 0 at DN / <= 0 at UP pins
    R = AG.shape[-2]
    ineq_row = torch.arange(R, device=dev) >= M
    if R > 0:
        Mn = torch.bmm(Ap, Ap.transpose(1, 2)) \
            + 1e-12 * torch.eye(R, dtype=dtype, device=dev)
        lam = torch.linalg.solve(
            Mn, torch.bmm(Ap, gf.unsqueeze(-1))).squeeze(-1)
        lam = torch.where(ineq_row, torch.clamp(lam, max=0.0), lam)
        stat_free = ((gf - mtv(Ap, lam)).abs() * fm).amax(dim=-1)
        gamma_b = grad - mtv(AG, act * lam)
    else:
        stat_free = gf.abs().amax(dim=-1)
        gamma_b = grad
    viol_dn = (torch.clamp(-gamma_b, min=0.0) * (Sx == DN)).amax(dim=-1)
    viol_up = (torch.clamp(gamma_b, min=0.0) * (Sx == UP)).amax(dim=-1)
    stat = torch.maximum(stat_free, torch.maximum(viol_dn, viol_up))
    if J > 0:
        slack = Q.g - mv(Q.G, x)
        comp = (slack.abs() * (res.S[:, N:] == EO)).amax(dim=-1)
        if res.lam is not None:
            # two-sided complementarity: an inactive (OE) row carrying a
            # spurious attached multiplier shows in |mu_j * slack_j|
            comp = torch.maximum(
                comp, (res.lam[:, M:] * slack).abs().amax(dim=-1))
    else:
        comp = zero
    it = torch.clamp(res.status, min=0)
    return KKTReport(feas_eq, feas_in, feas_bd, stat, comp, it,
                     res.status > 0)


@highest_matmul
def kkt_report(Q: QP, res: Result, batched: bool = False) -> KKTReport:
    """Per-instance optimality diagnostics, as tensors on the result's
    device.

    With ``batched=True`` every leaf of ``res`` carries a leading batch
    axis (Q's leaves may be shared or batched) and the report fields come
    back batched; otherwise ``Q`` and ``res`` are one problem and its
    solution, and the fields are 0-dim."""
    if batched:
        return _report(Q, res)
    Q1 = dataclasses.replace(Q, **{f: t.unsqueeze(0)
                                   for f, t in Q.leaves().items()})
    one = lambda t: None if t is None else torch.as_tensor(t).unsqueeze(0)
    r1 = Result(one(res.x), one(res.S), one(res.status), one(res.lam),
                one(res.gamma))
    return KKTReport(*(t[0] for t in _report(Q1, r1)))


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a region with ``torch.profiler`` (CPU activity, plus CUDA
    activity when a card is present) and write a Chrome trace file into
    ``logdir``:

    >>> with trace("traces/ssqp"):
    ...     res = solve_qp_batch(Qb, settings)
    ...     torch.cuda.synchronize()
    """
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    path = os.path.join(logdir, f"ssqp_trace_{os.getpid()}_"
                                f"{time.time_ns()}.json")
    prof.export_chrome_trace(path)
