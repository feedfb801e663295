"""Instance batching for the QP solver (PyTorch).

Counterpart of ``ssqp_tpu/parallel/batch.py`` (the slice's subset). A batch
is a :class:`QP` whose leaves carry a leading batch axis, except the leaves
named in ``shared``, which stay unbatched and broadcast (one covariance V,
one budget row and one box for a whole efficient-frontier grid). Every solver
function is batch-first already, so a batch solve is one call; convergence is
per instance.
"""

from __future__ import annotations

import dataclasses

import torch

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


def solve_qp_batch_auto(Q: QP, settings: Settings = None, shared: tuple = (),
                        waves: int = None, tail: int = None) -> Result:
    """One batch entry point that applies the JAX package's protocol rule.

    The plain protocol (no waves, no compaction, no tail refinement) runs
    :func:`solve_qp_batch`; waves, PDAS compaction and the tail refinement
    are not ported yet and raise ``NotImplementedError`` rather than run
    something else."""
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
        raise NotImplementedError(
            "tail refinement (solve_qp_batch_tail_refined, solvers/refine.py) "
            "is not ported yet: ROADMAP.md, queue 1, still to port, items "
            "2 and 3")
    if waves > 1:
        raise NotImplementedError(
            f"the wave protocol (solve_qp_batch_waves, waves={waves}) is not "
            "ported yet: ROADMAP.md, queue 1, still to port, item 2")
    if compact:
        raise NotImplementedError(
            "PDAS compaction (solve_qp_batch_compact) is not ported yet: "
            "ROADMAP.md, queue 1, still to port, item 2")
    return solve_qp_batch(Q, settings, shared=shared)


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
