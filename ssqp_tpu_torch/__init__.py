"""ssqp_tpu_torch — the status-switching QP solver on PyTorch and CUDA.

A port of ``ssqp_tpu`` (JAX/XLA/Pallas) to PyTorch, batch-first: every
solver function works on ``(B, ...)`` tensors, shared problem leaves stay
unbatched, and each ``lax.while_loop`` of the JAX package is a Python loop
with a per-instance ``alive`` mask. On a CUDA tensor every conjugate-gradient
solve runs the hand-written kernel in ``ops/csrc/cg.cu``; on a CPU tensor the
same function runs its plain PyTorch version; every batched float32 SPD
solve with n >= 16 likewise runs the hand-written Cholesky kernel in
``ops/csrc/chol.cu``.

Ported so far: the batched dense QP path (``solve_qp``, ``solve_qp_batch``,
``solve_qp_batch_auto``'s plain protocol and its tail refinement at
N >= 512) — PDAS identification, the S-loop (with the QR row purge at
M+J >= 16 working rows), the Phase-1 simplex fallback, dual attachment and
the factorization-free refinement (``solve_qp_batch_tail_refined``,
``refine_result_cg``). Problems are built on the card unless the caller
passes ``device="cpu"``.
"""

from ssqp_tpu_torch.types import (
    DN,
    EO,
    IN,
    MC_DEGENERATE_BOUNDS,
    MC_INFEASIBLE,
    MC_NO_CONSTRAINTS,
    MC_NOT_PSD,
    MC_NUMERICAL,
    MC_OK,
    MC_REDUNDANT,
    OE,
    QP,
    UP,
    Result,
    Settings,
    make_qp,
)

__all__ = [
    "IN", "DN", "UP", "OE", "EO",
    "QP", "Settings", "Result", "make_qp",
    "MC_OK", "MC_INFEASIBLE", "MC_NUMERICAL", "MC_REDUNDANT",
    "MC_NO_CONSTRAINTS", "MC_DEGENERATE_BOUNDS", "MC_NOT_PSD",
    "solve_qp", "solve_qp_batch", "solve_qp_batch_auto", "frontier_batch",
    "solve_qp_batch_tail_refined", "refine_result_cg",
]

__version__ = "0.1.0"


def __getattr__(name):  # lazy imports keep the package import light
    if name == "solve_qp":
        from ssqp_tpu_torch.solvers.ssqp import solve_qp
        return solve_qp
    if name in ("solve_qp_batch", "solve_qp_batch_auto", "frontier_batch",
                "solve_qp_batch_tail_refined"):
        from ssqp_tpu_torch.parallel import batch
        return getattr(batch, name)
    if name == "refine_result_cg":
        from ssqp_tpu_torch.solvers.refine import refine_result_cg
        return refine_result_cg
    raise AttributeError(f"module 'ssqp_tpu_torch' has no attribute {name!r}")
