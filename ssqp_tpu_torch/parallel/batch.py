"""Instance batching for the QP and LP solvers (PyTorch).

Counterpart of ``ssqp_tpu/parallel/batch.py``. A batch is a :class:`QP` (or
:class:`LP`) whose leaves carry a leading batch axis, except the leaves
named in ``shared``, which stay unbatched and broadcast (one covariance V,
one budget row and one box for a whole efficient-frontier grid). Every solver
function is batch-first already, so a batch solve is one call; convergence is
per instance.

The QP protocols: plain (:func:`solve_qp_batch`), PDAS compaction
(:func:`solve_qp_batch_compact`), the grid warm protocols on sorted q-only
grids (:func:`solve_qp_batch_waves`, :func:`solve_qp_batch_c2f`), the
residual-thresholded tail refinement and the refined tier
(:func:`solve_qp_batch_refined`); :func:`solve_qp_batch_auto` picks among
them by the JAX package's rule.

The LP protocols: the plain two-phase simplex (:func:`solve_lp_batch`),
criss-cross (:func:`solve_lp_batch_cclp`, with the float64 rescue in
:func:`solve_lp_batch_cclp_rescued`), the warm waves of c-parametric grids
(:func:`solve_lp_batch_waves`) and the dual-simplex waves of rhs-parametric
grids (:func:`solve_lp_batch_waves_rhs`); :func:`solve_lp_batch_auto`
picks among them by the JAX package's rule.
"""

from __future__ import annotations

import dataclasses

import torch

from ssqp_tpu_torch.ops.bmat import mtv, mv, stack_rows
from ssqp_tpu_torch.types import (
    LP, LP_FIELDS, QP, QP_FIELDS, Result, Settings, as_torch_dtype)
from ssqp_tpu_torch.utils.precision import highest_matmul


def settings_for_shared(settings: Settings, shared: tuple) -> Settings:
    """Disable the PDAS round-1 closed form when V is per-instance: its
    one-time W ~= V^{-1} only amortizes as a shared matrix. The Chebyshev
    and W-PCG rounds (``pdas_cheb``, ``pdas_pcg``) are built on that W, so
    such a batch runs Jacobi-CG rounds under either flag, as in the JAX
    package."""
    if "V" not in shared and settings.pdas_precond:
        settings = dataclasses.replace(settings, pdas_precond=False)
    return settings


def _check_shared(Q, shared: tuple) -> None:
    for f in (QP_FIELDS if isinstance(Q, QP) else LP_FIELDS):
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
    tuned on TPU measurements (see the JAX docstring). On an H100 the plain
    protocol beat waves=8 at every one of those cells (PERF.md,
    ``profile_port.py protocols``); retuning the rule is left to a
    performance change."""
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

    ``waves`` defaults to :func:`auto_protocol` (waves=8 on q-only grids
    whose wave width B/8 is at least 1024); ``tail`` to 4 at N >= 512
    outside float64 (the residual-thresholded tail refinement, one sweep);
    the plain protocol at B >= 4096 takes PDAS compaction ``(2, 4, 8)``.
    Routes: the tail refinement over whichever protocol, else
    :func:`solve_qp_batch_waves`, :func:`solve_qp_batch_compact` or
    :func:`solve_qp_batch`. ``None`` means "apply the rule"; explicit values
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
    if waves > 1:
        return solve_qp_batch_waves(Q, settings, shared, waves=waves)
    if compact:
        return solve_qp_batch_compact(Q, settings, shared=shared,
                                      compact=compact)
    return solve_qp_batch(Q, settings, shared=shared)


@highest_matmul
def solve_qp_batch_tail_refined(Q: QP, settings: Settings, shared: tuple = (),
                                waves: int = 0, tail: int = 16,
                                iters: int = 2, compact=0,
                                resid_bound: float = None,
                                max_passes: int = 4) -> Result:
    """Batch solve + residual-thresholded refinement of the worst tail.

    The batch solve is :func:`solve_qp_batch_waves` when ``waves > 1``,
    else :func:`solve_qp_batch_compact` when ``compact``, else
    :func:`solve_qp_batch`. After it, passes of static width ``B // tail``
    gather the instances with the largest float64 KKT residual
    (:func:`batch_kkt_resid`, argsort), run ``iters`` factorization-free
    sweeps on them (``solvers/refine.py::refine_result_cg`` with
    ``exact_sweeps``) and scatter x back, until no instance exceeds
    ``resid_bound`` (default :func:`_tail_resid_bound`) or ``max_passes``
    passes ran. A refined instance leaves the selection. ``resid_bound=0.0``
    refines the top ``B // tail`` unconditionally. Statuses and duals are
    the search's; x keeps the problem's dtype. One host synchronisation per
    pass."""
    from ssqp_tpu_torch.solvers.refine import refine_result_cg

    settings = settings_for_shared(settings, shared)
    if waves > 1:
        res = solve_qp_batch_waves(Q, settings, shared, waves=waves,
                                   compact=compact)
    elif compact:
        res = solve_qp_batch_compact(Q, settings, shared=shared,
                                     compact=compact)
    else:
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


@highest_matmul
def solve_qp_batch_warm(Q: QP, Sx0, Se0, x0, settings: Settings,
                        shared: tuple = ()) -> Result:
    """Warm-started batch solve from per-instance statuses ``Sx0`` (B, N),
    ``Se0`` (B, J) and feasible points ``x0`` (B, N) (the batched
    solveQP(Q, S, x0), SSQP.jl:237): the two-pass S-loop of
    :func:`solve_qp_warm2`, duals attached."""
    from ssqp_tpu_torch.solvers.ssqp import solve_qp_warm2

    _check_shared(Q, shared)
    return solve_qp_warm2(Q, Sx0, Se0, x0, settings)


@highest_matmul
def _solve_qp_batch_nodual(Q: QP, settings: Settings, shared: tuple = ()):
    """Batched auto solve without dual attachment: the search stage of the
    refined pipeline, whose duals the refinement would discard."""
    from ssqp_tpu_torch.solvers.ssqp import solve_qp_auto_core

    _check_shared(Q, shared)
    return solve_qp_auto_core(Q, settings_for_shared(settings, shared))


@highest_matmul
def solve_qp_batch_compact(Q: QP, settings: Settings, shared: tuple = (),
                           compact=4) -> Result:
    """Batched auto solve whose PDAS identification runs through
    :func:`solvers.ssqp._guess_start_batch` (``compact``: an int or a sorted
    tuple of divisors). Same semantics as :func:`solve_qp_batch`: the same
    rounds per instance, validation, fallbacks and duals. Without
    ``multi_free`` there is no PDAS stage, and this is the plain solve."""
    from ssqp_tpu_torch.solvers.ssqp import (
        _attach_duals, _guess_start_batch, solve_qp_auto_core)

    _check_shared(Q, shared)
    settings = settings_for_shared(settings, shared)
    if not settings.multi_free:
        return solve_qp_batch(Q, settings, shared)
    guess = _guess_start_batch(Q, settings, shared=shared, compact=compact)
    r = solve_qp_auto_core(Q, settings, guess=guess)
    return _attach_duals(Q, r, settings)


def _check_q_only(shared: tuple, name: str) -> None:
    if not {"V", "A", "G", "b", "g", "d", "u"} <= set(shared):
        raise ValueError(f"{name} needs a q-only batch (every leaf but q "
                         f"shared), got shared={shared!r}")


@highest_matmul
def solve_qp_batch_waves(Q: QP, settings: Settings, shared: tuple,
                         waves: int = 8, compact=0) -> Result:
    """Wave-parallel warm solve of a sorted q-only grid (frontier grids).

    The grid splits into ``waves`` strided sub-batches: grid point
    ``i * waves + k`` is slot i of wave k. Wave 0 solves cold
    (:func:`solve_qp_auto_core`, through :func:`_guess_start_batch` when
    ``compact``); waves 1..W-1 run in sequence, each slot warm-started
    (:func:`solve_qp_warm2`, with the carried KKT CG solution) from the
    same slot of the previous wave, its grid neighbour. A slot carries
    forward only a state that solved; points downstream of a failed cold
    slot are forced through the cold rescue, and the duals are attached
    once over the merged batch (:func:`_rescue_and_attach`).

    The cold wave's PDAS CG budget is cut from 24 to 16 iterations on the
    JAX package's terms: J == 0, float32, and the budget still the float32
    tier's default."""
    from ssqp_tpu_torch.solvers.ssqp import (
        _guess_start_batch, _where, solve_qp_auto_core, solve_qp_warm2)

    _check_q_only(shared, "solve_qp_batch_waves")
    _check_shared(Q, shared)
    settings = settings_for_shared(settings, shared)
    cold = settings
    f32_default = Settings.for_dtype(torch.float32).pdas_cg_iters
    if (Q.J == 0 and as_torch_dtype(settings.dtype) == torch.float32
            and settings.pdas_cg_iters == f32_default
            and settings.pdas_cg_iters > 16):
        cold = dataclasses.replace(settings, pdas_cg_iters=16)
    N = Q.N
    B = Q.q.shape[0]
    W = _check_waves(B, waves)
    # strided split: grid point i*W + k -> qg[k, i]
    qg = Q.q.reshape(B // W, W, N).transpose(0, 1).contiguous()

    Q0 = dataclasses.replace(Q, q=qg[0])
    guess = (_guess_start_batch(Q0, cold, shared=shared, compact=compact)
             if compact else None)
    r0, sol = solve_qp_auto_core(Q0, cold, return_sol=True, guess=guess)
    Sx, Se, x = r0.S[:, :N], r0.S[:, N:], r0.x
    parts = [r0]
    for k in range(1, W):
        rk, solk = solve_qp_warm2(dataclasses.replace(Q, q=qg[k]), Sx, Se,
                                  x, settings, with_duals=False, sol0=sol,
                                  return_sol=True)
        ok = rk.status > 0  # failed slots keep the neighbour's state
        Sx = _where(ok, rk.S[:, :N], Sx)
        Se = _where(ok, rk.S[:, N:], Se)
        x = _where(ok, rk.x, x)
        sol = _where(ok, solk, sol)
        parts.append(rk)

    def merge(leaves):  # wave k slot i -> grid point i*W + k
        a = torch.stack(leaves, dim=0).transpose(0, 1)
        return a.reshape((B,) + a.shape[2:])

    merged = Result(merge([r.x for r in parts]), merge([r.S for r in parts]),
                    merge([r.status for r in parts]))
    # a failed cold slot taints every point it warm-started
    force = (r0.status <= 0).unsqueeze(1).expand(B // W, W).reshape(B)
    return _rescue_and_attach(Q, merged, settings, force=force)


def _rescue_and_attach(Q: QP, merged: Result, settings: Settings,
                       force=None) -> Result:
    """Shared tail of the grid warm protocols (waves, coarse-to-fine).

    Instances that failed (status <= 0), or that ``force`` marks (warm-
    started from a failed cold anchor, so their start may be infeasible),
    re-solve cold: Phase-1 (:func:`init_qp_traced`) and the two-pass loop,
    on those instances only, gathered with ``Q.take``. One host check of
    ``need.any()`` stands in for the JAX package's batch-level ``lax.cond``.
    An instance is written back only where its rescue solved. Then one
    dual attachment over the whole batch."""
    from ssqp_tpu_torch.solvers.phase1 import init_qp_traced
    from ssqp_tpu_torch.solvers.ssqp import (
        _attach_duals, _where, solve_qp_warm2)

    need = merged.status <= 0
    if force is not None:
        need = need | force
    x, S, status = merged.x, merged.S, merged.status.to(torch.int32)
    if bool(need.any()):
        idx = need.nonzero().squeeze(1)
        Qn = Q.take(idx)
        x0, Sx0, Se0, st1 = init_qp_traced(Qn, settings)
        rr = solve_qp_warm2(Qn, Sx0, Se0, x0, settings, pre_status=st1,
                            with_duals=False)
        fix = rr.status > 0
        x, S, status = x.clone(), S.clone(), status.clone()
        x[idx] = _where(fix, rr.x, x[idx])
        S[idx] = _where(fix, rr.S, S[idx])
        status[idx] = torch.where(fix, rr.status, status[idx])
    return _attach_duals(Q, Result(x, S, status), settings)


@highest_matmul
def solve_qp_batch_c2f(Q: QP, settings: Settings, shared: tuple,
                       coarse: int = 8) -> Result:
    """Coarse-to-fine warm solve of a sorted q-only grid.

    The coarse subgrid (every ``coarse``-th point) solves cold; then every
    grid point i warm-starts from its nearest coarse point,
    ``clip(round(i / coarse), 0, C - 1)`` (round half to even, as
    ``jnp.round``), in one batched warm pass; then the cold rescue of
    failed points and of points whose anchor failed, and the duals
    (:func:`_rescue_and_attach`)."""
    from ssqp_tpu_torch.solvers.ssqp import solve_qp_auto_core, solve_qp_warm2

    _check_q_only(shared, "solve_qp_batch_c2f")
    _check_shared(Q, shared)
    settings = settings_for_shared(settings, shared)
    N = Q.N
    B = Q.q.shape[0]
    if coarse < 1 or B % coarse != 0:
        raise ValueError(f"coarse={coarse} must divide the batch size {B}")
    C = B // coarse
    rc = solve_qp_auto_core(
        dataclasses.replace(Q, q=Q.q[::coarse].contiguous()), settings)
    near = _c2f_anchors(B, coarse, Q.device)
    rw = solve_qp_warm2(Q, rc.S[near, :N], rc.S[near, N:], rc.x[near],
                        settings, with_duals=False)
    return _rescue_and_attach(Q, rw, settings, force=(rc.status <= 0)[near])


def _c2f_anchors(B: int, coarse: int, device=None):
    """The coarse point each grid point of :func:`solve_qp_batch_c2f` starts
    from: ``clip(round(i / coarse), 0, B // coarse - 1)``, ties to even."""
    i = torch.arange(B, dtype=torch.float64, device=device)
    return torch.clamp(torch.round(i / coarse), 0, B // coarse - 1).long()


def solve_qp_batch_refined(Q: QP, *, settings: Settings = None,
                           iters: int = 2, search_dtype=None,
                           shared: tuple = (), method: str = "cg") -> Result:
    """Batched high-accuracy solve: the active-set search (duals not
    attached) in ``search_dtype`` (e.g. float32 on a float64 batch), then
    per-instance refinement of the final KKT system against the
    full-precision data, ``method="cg"`` (factorization-free,
    ``refine_result_cg``) or ``"lu"`` (dense LU, ``refine_result``). No
    dual certificates; x comes back in float64."""
    from ssqp_tpu_torch.solvers.refine import refine_result, refine_result_cg

    if method not in ("cg", "lu"):
        raise ValueError(f"method={method!r}: 'cg' or 'lu'")
    refine = refine_result_cg if method == "cg" else refine_result
    settings = settings or Settings.for_dtype(Q.V.dtype)
    if (search_dtype is not None
            and as_torch_dtype(search_dtype) != Q.V.dtype):
        Qs, s_search = Q.astype(search_dtype), Settings.for_dtype(search_dtype)
    else:
        Qs, s_search = Q, settings
    res = _solve_qp_batch_nodual(Qs, s_search, shared=shared)
    res = Result(res.x.to(Q.V.dtype), res.S, res.status)
    return refine(Q, res, settings, iters, with_duals=False)


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


def stack_lps(lps) -> LP:
    """Stack a list of same-shape LPs into one batched LP."""
    p0 = lps[0]
    leaves = {f: torch.stack([getattr(p, f) for p in lps]) for f in LP_FIELDS}
    return dataclasses.replace(p0, **leaves)


@highest_matmul
def solve_lp_batch(P: LP, settings: Settings, shared: tuple = (),
                   minimize: bool = True) -> Result:
    """Solve a batch of LPs by the two-phase simplex (SimplexLP per
    instance)."""
    from ssqp_tpu_torch.solvers.lp import simplex_lp_traced

    _check_shared(P, shared)
    return simplex_lp_traced(P, settings, minimize)


@highest_matmul
def solve_lp_batch_cclp(P: LP, settings: Settings,
                        shared: tuple = ()) -> Result:
    """Solve a batch of LPs by the least-index criss-cross method (the
    batched reference ``solveLP``). No Phase-1: infeasible instances exit
    with status 0 from their own walk. The second-chance basis repair runs
    on the -1 exits only, after one host check."""
    from ssqp_tpu_torch.solvers.cclp import cclp_post, cclp_pre, cclp_repair_sf

    _check_shared(P, shared)
    sf, st = cclp_pre(P, settings, P.batch_size)
    st = cclp_repair_sf(P, sf, st, settings)
    return cclp_post(P, sf, st, settings)


def _upd(ok, new, old):
    """Per instance: ``new`` where ``ok``, else ``old`` (tuples)."""
    from ssqp_tpu_torch.solvers.simplex import _rows_where

    return tuple(_rows_where(ok, n, o) for n, o in zip(new, old))


def _merge_waves(parts, B: int):
    """Wave k slot i -> grid point i * W + k, for a list of per-wave
    tensors."""
    a = torch.stack(parts, dim=0).transpose(0, 1)
    return a.reshape((B,) + a.shape[2:])


def _check_waves(B: int, waves: int) -> int:
    W = int(waves)
    if W < 1 or B % W != 0:
        raise ValueError(f"waves={waves} must divide the batch size {B}")
    return W


@highest_matmul
def solve_lp_batch_waves(P: LP, settings: Settings, shared: tuple,
                         waves: int = 8, minimize: bool = True) -> Result:
    """Wave-parallel warm simplex for a c-parametric LP family (constraints
    shared, cost varying along a sorted grid).

    Everything cost-independent is computed once: the standardization, the
    row purge and Phase-1 (which never sees ``c``). The grid splits into
    ``waves`` strided sub-batches (grid point ``i * waves + k`` is slot i
    of wave k); wave 0 runs Phase-2 from the shared Phase-1 basis, waves
    1..W-1 from the same slot of the previous wave, its grid neighbour's
    optimal basis (any basis of the shared constraints is a valid Phase-2
    start). Only optimal exits (1/2) update the carry. Slots that exit
    <= 0 re-run Phase-2 once from the Phase-1 start, on those slots only,
    and take that result where it is 1, 2 or 3."""
    from ssqp_tpu_torch.solvers.lp import (
        _bcast, _lp_cost, _lp_finish, _lp_phase1, _lp_phase2, _lp_prep)

    if not {"A", "b", "G", "g", "d", "u"} <= set(shared):
        raise ValueError("solve_lp_batch_waves needs a c-only batch "
                         f"(constraints shared), got shared={shared!r}")
    _check_shared(P, shared)
    B = P.c.shape[0]
    W = _check_waves(B, waves)
    N, J = P.N, P.J
    prep1 = _lp_prep(P.A, P.G, P.b, P.g, P.d, P.u, settings, 1)
    start1 = _lp_phase1(prep1, settings)
    width = B // W
    prep_w, start = _bcast(prep1, width), _bcast(start1, width)
    cg = P.c.reshape(width, W, N).transpose(0, 1)

    carry = (start.B, start.S, start.x)
    parts = []
    for k in range(W):
        st, x, Bb, Sb = _lp_phase2(prep_w, _lp_cost(prep_w, cg[k], N, J,
                                                    minimize),
                                   carry[0], carry[1], carry[2], settings)
        carry = _upd((st == 1) | (st == 2), (Bb, Sb, x), carry)
        parts.append((st, x, Bb, Sb))
    st2, x2, B3, S3 = (_merge_waves([p[i] for p in parts], B)
                       for i in range(4))

    prep, startB = _bcast(prep1, B), _bcast(start1, B)
    c0 = _lp_cost(prep, P.c, N, J, minimize)
    # rescue: a failed warm slot (numerical / -max_iter; an unbounded
    # verdict is legitimate from any feasible basis) re-runs Phase-2 once
    # from the Phase-1 start
    idx = (st2 <= 0).nonzero().squeeze(1)
    if idx.numel():
        n = idx.numel()
        pr = _bcast(prep1, n)
        sr = _bcast(start1, n)
        s_r, x_r, B_r, S_r = _lp_phase2(pr, c0[idx], sr.B, sr.S, sr.x,
                                        settings)
        fix = (s_r == 1) | (s_r == 2) | (s_r == 3)
        cur = (st2[idx], x2[idx], B3[idx], S3[idx])
        new = _upd(fix, (s_r, x_r, B_r, S_r), cur)
        st2, x2, B3, S3 = (t.index_copy(0, idx, v) for t, v in
                           zip((st2, x2, B3, S3), new))
    return _lp_finish(prep, startB, P.c, c0, st2, x2, B3, S3, N, J,
                      settings, minimize, P.A, P.G)


def solve_lp_batch_auto(P: LP, settings: Settings = None, shared: tuple = (),
                        waves: int = None, minimize: bool = True) -> Result:
    """One LP batch entry point that applies the JAX package's protocol
    rule, verbatim:

    * a c-parametric grid (everything but ``c`` shared) -> the warm waves
      (:func:`solve_lp_batch_waves`);
    * an rhs-parametric grid (everything but ``b`` and/or ``g`` shared) ->
      the dual-simplex waves (:func:`solve_lp_batch_waves_rhs`);
    * anything else -> the plain two-phase batch (:func:`solve_lp_batch`).

    ``waves=None`` applies the rule (8 where the family allows it, 8
    divides the batch and the wave width B/8 is at least 4); an explicit
    value forces it; ``waves=0`` forces the plain batch. The rule was tuned
    on TPU measurements; ``chip_smoke.py`` times the routes side by side on
    a GPU (PERF.md)."""
    settings = settings or Settings.for_dtype(P.c.dtype)
    sh = set(shared)
    c_only = {"A", "b", "G", "g", "d", "u"} <= sh and "c" not in sh
    rhs_only = ({"c", "A", "G", "d", "u"} <= sh
                and ("b" not in sh or "g" not in sh))
    B = next((getattr(P, f).shape[0] for f in ("c", "b", "g")
              if f not in sh), None)
    if waves is None:
        waves = 8 if (B is not None and (c_only or rhs_only)
                      and B % 8 == 0 and B // 8 >= 4) else 0
    if waves > 1 and c_only:
        return solve_lp_batch_waves(P, settings, shared, waves=waves,
                                    minimize=minimize)
    if waves > 1 and rhs_only:
        return solve_lp_batch_waves_rhs(P, settings, shared, waves=waves,
                                        minimize=minimize)
    return solve_lp_batch(P, settings, shared=shared, minimize=minimize)


@highest_matmul
def solve_lp_batch_waves_rhs(P: LP, settings: Settings, shared: tuple,
                             waves: int = 8, minimize: bool = True) -> Result:
    """Wave-parallel warm simplex for rhs-parametric LP families (b and/or
    g vary along a sorted grid; c and the constraint matrices shared).

    A neighbour's optimal basis stays dual feasible when only the rhs moves,
    so waves 1..W-1 restart the DUAL simplex from the same slot of the
    previous wave; wave 0 solves cold by the full two-phase path (its own
    prep per instance). Every member's standardized rhs is built against
    the family's keep rows (member 0's purge). Slots that exit < 0 re-solve
    cold, on those slots only. Then every claimed optimum is checked
    against its own original rows and demoted to infeasible (0) on a
    material violation, which a rhs inconsistent on a purged row would
    show.

    As in the JAX package, a warm dual exit is accepted without the
    dual-feasibility certificate that :func:`simplex_lp_warm` applies."""
    from ssqp_tpu_torch.solvers.lp import (
        _LPStart, _bcast, _lp_cost, _lp_finish, _lp_phase1, _lp_phase2,
        _lp_phase2_dual, _lp_prep)

    if not {"c", "A", "G", "d", "u"} <= set(shared):
        raise ValueError("solve_lp_batch_waves_rhs needs an rhs-only batch "
                         f"(c, A, G, d, u shared), got shared={shared!r}")
    bat = tuple(f for f in ("b", "g") if f not in shared)
    if not bat:
        raise ValueError("solve_lp_batch_waves_rhs: b or g must vary")
    _check_shared(P, shared)
    B = getattr(P, bat[0]).shape[0]
    W = _check_waves(B, waves)
    N, M, J = P.N, P.M, P.J
    dtype, dev = P.c.dtype, P.c.device
    width = B // W
    bB = P.b.expand(B, M) if "b" not in bat else P.b
    gB = P.g.expand(B, J) if "g" not in bat else P.g

    prep1 = _lp_prep(P.A, P.G, bB[:1], gB[:1], P.d, P.u, settings, 1)
    prep_w = _bcast(prep1, width)
    c0_w = _lp_cost(prep_w, P.c, N, J, minimize)
    rm = prep1.keep_rows.to(dtype)

    def cold(b_i, g_i):
        n = b_i.shape[0]
        prep_i = _lp_prep(P.A, P.G, b_i, g_i, P.d, P.u, settings, n)
        start_i = _lp_phase1(prep_i, settings)
        out = _lp_phase2(prep_i, c0_w[:1].expand(n, -1), start_i.B,
                         start_i.S, start_i.x, settings)
        return out + (start_i.p1_fail, start_i.p1_code, start_i.infeasible)

    bw = bB.reshape(width, W, M).transpose(0, 1)
    gw = gB.reshape(width, W, J).transpose(0, 1)
    st0, x0, B0, S0, pf0, pc0, inf0 = cold(bw[0], gw[0])
    carry = (B0, S0, x0)  # failed slots carry their own exit; the dual
    # entry gate and the rescue protect the downstream warm starts
    parts = [(st0, x0, B0, S0)]
    for k in range(1, W):
        b0p = torch.cat([bw[k], gw[k]], dim=1) * rm
        st, x, Bb, Sb = _lp_phase2_dual(prep_w, c0_w, b0p, carry[0],
                                        carry[1], carry[2], settings)
        carry = _upd((st == 1) | (st == 2), (Bb, Sb, x), carry)
        parts.append((st, x, Bb, Sb))
    st2, x2, B3, S3 = (_merge_waves([p[i] for p in parts], B)
                       for i in range(4))
    zb = torch.zeros(width, dtype=torch.bool, device=dev)
    p1f = _merge_waves([pf0] + [zb] * (W - 1), B)
    p1c = _merge_waves([pc0] + [torch.zeros_like(pc0)] * (W - 1), B)
    infs = _merge_waves([inf0] + [zb] * (W - 1), B)

    # rescue: numerical / budget-exhausted / invalid-warm-start exits
    # re-solve cold; every rescue verdict (a genuine 0 too) replaces them
    idx = (st2 < 0).nonzero().squeeze(1)
    if idx.numel():
        new = cold(bB[idx], gB[idx])
        st2, x2, B3, S3, p1f, p1c, infs = (
            t.index_copy(0, idx, v) for t, v in
            zip((st2, x2, B3, S3, p1f, p1c, infs), new))

    prep = _bcast(prep1, B)
    res = _lp_finish(prep, _LPStart(B3, S3, x2, p1f, p1c, infs), P.c,
                     _lp_cost(prep, P.c, N, J, minimize), st2, x2, B3, S3,
                     N, J, settings, minimize, P.A, P.G)

    # original-constraint guard: demote claimed optima that violate their
    # own rows (an unbounded exit's x is no certificate and is left alone)
    x = res.x
    v = torch.zeros(B, dtype=dtype, device=dev)
    scale = torch.ones(B, dtype=dtype, device=dev)
    if M > 0:
        v = torch.maximum(v, (mv(P.A, x) - bB).abs().amax(dim=1))
        scale = torch.maximum(scale, bB.abs().amax(dim=1))
    if J > 0:
        v = torch.maximum(v, (mv(P.G, x) - gB).amax(dim=1))
        scale = torch.maximum(scale, gB.abs().amax(dim=1))
    bad = ((res.status == 1) | (res.status == 2)) & (
        v > 100.0 * settings.tol * (1.0 + scale))
    x, lam, gamma = _upd(~bad, (x, res.lam, res.gamma),
                         tuple(torch.zeros_like(t) for t in
                               (x, res.lam, res.gamma)))
    return Result(x, res.S, torch.where(bad, 0, res.status).to(torch.int32),
                  lam, gamma)


def solve_lp_batch_cclp_rescued(P: LP, settings: Settings,
                                shared: tuple = ()) -> Result:
    """Batched criss-cross with a per-instance float64 rescue: instances
    exiting -1 (numerical) or -max_iter re-solve once as a float64
    sub-batch on the same device under the float64 tier's default
    ``Settings()``, and those that succeed are cast back and
    scattered in. No extra work when every instance solved or the batch is
    float64 already. (The JAX package pads the sub-batch to a power of two
    to reuse compiled programs, and pins it to the host CPU for want of a
    float64 LU on the TPU; neither applies here.)"""
    res = solve_lp_batch_cclp(P, settings, shared=shared)
    if P.c.dtype != torch.float32:
        return res
    need = (res.status == -1) | (res.status == -settings.max_iter)
    idx = need.nonzero().squeeze(1)
    if idx.numel() == 0:
        return res
    sub = P.take(idx).astype(torch.float64)
    r64 = solve_lp_batch_cclp(sub, Settings(), shared=shared)
    ok = r64.status > 0
    fix, take = idx[ok], ok.nonzero().squeeze(1)
    if fix.numel() == 0:
        return res
    put = lambda a, b: a.index_copy(0, fix, b[take].to(a.dtype))
    return Result(put(res.x, r64.x), put(res.S, r64.S),
                  put(res.status, r64.status), put(res.lam, r64.lam),
                  put(res.gamma, r64.gamma))
