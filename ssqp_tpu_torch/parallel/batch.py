"""Instance batching for the QP solver (PyTorch).

Counterpart of ``ssqp_tpu/parallel/batch.py`` (the QP batch subset). A batch
is a :class:`QP` whose leaves carry a leading batch axis, except the leaves
named in ``shared``, which stay unbatched and broadcast (one covariance V,
one budget row and one box for a whole efficient-frontier grid). Every solver
function is batch-first already, so a batch solve is one call; convergence is
per instance.
"""

from __future__ import annotations

import dataclasses

import torch

from ssqp_tpu_torch.ops.bmat import mtv, mv, stack_rows
from ssqp_tpu_torch.types import QP, QP_FIELDS, Result, Settings
from ssqp_tpu_torch.utils.precision import highest_matmul


def settings_for_shared(settings: Settings, shared: tuple) -> Settings:
    """Disable the PDAS round-1 closed form when V is per-instance: its
    one-time W ~= V^{-1} only amortizes as a shared matrix."""
    if "V" not in shared and settings.pdas_precond:
        settings = dataclasses.replace(settings, pdas_precond=False)
    return settings


def _check_shared(Q: QP, shared: tuple) -> None:
    for f in QP_FIELDS:
        if Q.is_batched(f) == (f in shared):
            raise ValueError(
                f"field {f!r} is {'batched' if Q.is_batched(f) else 'unbatched'}"
                f" but shared={shared!r} says otherwise")


@highest_matmul
def solve_qp_batch(Q: QP, settings: Settings, shared: tuple = ()) -> Result:
    """Solve a batch of QPs (PDAS guess, Phase-1 fallback, S-loop, duals);
    per-instance status codes come back in ``Result.status``."""
    from ssqp_tpu_torch.solvers.ssqp import solve_qp_auto

    _check_shared(Q, shared)
    return solve_qp_auto(Q, settings_for_shared(settings, shared))


def auto_protocol(N: int, B: int, q_only: bool) -> int:
    """The waves dispatch rule of the JAX package, verbatim: waves=8 iff the
    grid is q-only and the wave width B/8 is at least 1024. The rule was
    tuned on TPU measurements (see the JAX docstring); it has not been
    re-measured on a GPU."""
    return 8 if (q_only and B % 8 == 0 and B // 8 >= 1024) else 0


def batch_kkt_resid(Q: QP, res: Result):
    """Per-instance relative KKT residual (stationarity scaled by
    1 + max|q|, max'd with the absolute primal violations of the equalities
    and inequalities), evaluated in float64 with the attached duals. The
    tail refinement's selection statistic; failed instances report -inf."""
    hi = torch.float64
    M, J = Q.M, Q.J
    x = res.x.to(hi)
    AG = (stack_rows(Q.A, Q.G) if J > 0 else Q.A).to(hi)
    q = Q.q.to(hi)
    stat = mv(Q.V.to(hi), x) + q + mtv(AG, res.lam.to(hi)) - res.gamma.to(hi)
    e = stat.abs().amax(dim=1) / (1.0 + q.abs().amax(dim=-1))
    if M > 0:
        e = torch.maximum(
            e, (mv(Q.A.to(hi), x) - Q.b.to(hi)).abs().amax(dim=1))
    if J > 0:
        e = torch.maximum(e, (mv(Q.G.to(hi), x) - Q.g.to(hi)).amax(dim=1))
    return torch.where(res.status > 0, e, torch.full_like(e, -float("inf")))


def _tail_resid_bound(N: int) -> float:
    """Default float64 KKT-residual threshold above which a float32-searched
    instance gets tail-refined (:func:`solve_qp_batch_tail_refined`). The
    JAX package's value, calibrated there on frontier batches at N=512 and
    1024; it has not been re-measured on a GPU (ROADMAP.md)."""
    return 2.0e-6


def solve_qp_batch_auto(Q: QP, settings: Settings = None, shared: tuple = (),
                        waves: int = None, tail: int = None) -> Result:
    """One batch entry point that applies the JAX package's protocol rule.

    The plain protocol runs :func:`solve_qp_batch`; at N >= 512 outside
    float64 the residual-thresholded tail refinement
    (:func:`solve_qp_batch_tail_refined`, ``tail=4``, one sweep) follows it.
    Waves and PDAS compaction are not ported yet and raise
    ``NotImplementedError`` wherever the rule picks them, rather than run
    something else. ``None`` means "apply the rule"; explicit values
    override it."""
    settings = settings or Settings.for_dtype(Q.V.dtype)
    B = Q.batch_size
    if B is None:
        raise ValueError("solve_qp_batch_auto takes a batched QP")
    q_only = {"V", "A", "G", "b", "g", "d", "u"} <= set(shared)
    if waves is None:
        waves = auto_protocol(Q.N, B, q_only)
    if tail is None:
        tail = 4 if (Q.N >= 512 and Q.V.dtype != torch.float64) else 0
    compact = (2, 4, 8) if (waves == 0 and B >= 4096) else 0
    if tail > 0:
        return solve_qp_batch_tail_refined(Q, settings, shared, waves=waves,
                                           tail=tail, iters=1,
                                           compact=compact)
    _check_unported(waves, compact)
    return solve_qp_batch(Q, settings, shared=shared)


def _check_unported(waves: int, compact) -> None:
    if waves > 1:
        raise NotImplementedError(
            f"the wave protocol (solve_qp_batch_waves, waves={waves}) is not "
            "ported yet: ROADMAP.md, queue 1, still to port")
    if compact:
        raise NotImplementedError(
            "PDAS compaction (solve_qp_batch_compact) is not ported yet: "
            "ROADMAP.md, queue 1, still to port")


@highest_matmul
def solve_qp_batch_tail_refined(Q: QP, settings: Settings, shared: tuple = (),
                                waves: int = 0, tail: int = 16,
                                iters: int = 2, compact=0,
                                resid_bound: float = None,
                                max_passes: int = 4) -> Result:
    """Batch solve + residual-thresholded refinement of the worst tail.

    After the batch solve, passes of static width ``B // tail`` gather the
    instances with the largest float64 KKT residual (:func:`batch_kkt_resid`,
    argsort), run ``iters`` factorization-free sweeps on them
    (``solvers/refine.py::refine_result_cg`` with ``exact_sweeps``) and
    scatter x back, until no instance exceeds ``resid_bound`` (default
    :func:`_tail_resid_bound`) or ``max_passes`` passes ran. A refined
    instance leaves the selection. ``resid_bound=0.0`` refines the top
    ``B // tail`` unconditionally. Statuses and duals are the search's; x
    keeps the problem's dtype. One host synchronisation per pass."""
    from ssqp_tpu_torch.solvers.refine import refine_result_cg

    settings = settings_for_shared(settings, shared)
    _check_unported(waves, compact)
    res = solve_qp_batch(Q, settings, shared=shared)

    B = res.x.shape[0]
    K = max(B // max(tail, 1), 1)
    if resid_bound is None:
        resid_bound = _tail_resid_bound(Q.N)
    rs = batch_kkt_resid(Q, res)
    x = res.x.clone()
    p = 0
    while p < max_passes and bool((rs > resid_bound).any()):
        idx = torch.argsort(-rs, stable=True)[:K]
        rk = Result(x[idx], res.S[idx], res.status[idx])
        rr = refine_result_cg(Q.take(idx), rk, settings, iters,
                              with_duals=False, exact_sweeps=True)
        x[idx] = rr.x.to(x.dtype)
        rs[idx] = -float("inf")
        p += 1
    return Result(x, res.S, res.status, res.lam, res.gamma)


def stack_qps(qps) -> QP:
    """Stack a list of same-shape QPs into one batched QP."""
    q0 = qps[0]
    leaves = {f: torch.stack([getattr(q, f) for q in qps]) for f in QP_FIELDS}
    return dataclasses.replace(q0, **leaves)


def frontier_batch(Q: QP, lambdas) -> tuple:
    """Batch the L-parameterized frontier family ``min 1/2 z'Vz - L q'z``
    (reference QP(P, L), types.jl:303-319) over a vector of L values.

    Returns (batched QP, shared fields) ready for :func:`solve_qp_batch`.
    ``lambdas`` is host data (list, numpy) or a tensor on Q's device."""
    if isinstance(lambdas, torch.Tensor) and lambdas.device != Q.device:
        raise ValueError(f"lambdas on {lambdas.device}, QP on {Q.device}")
    lam = torch.as_tensor(lambdas, device=Q.device).to(Q.V.dtype)
    qb = -lam.unsqueeze(1) * Q.q.unsqueeze(0)
    return (dataclasses.replace(Q, q=qb),
            ("V", "A", "G", "b", "g", "d", "u"))
