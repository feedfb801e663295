"""ssqp_tpu_torch — the status-switching QP solver on PyTorch and CUDA.

A port of ``ssqp_tpu`` (JAX/XLA/Pallas) to PyTorch, batch-first: every
solver function works on ``(B, ...)`` tensors, shared problem leaves stay
unbatched, and each ``lax.while_loop`` of the JAX package is a Python loop
with a per-instance ``alive`` mask. On a CUDA tensor every conjugate-gradient
solve runs the hand-written kernel in ``ops/csrc/cg.cu``; on a CPU tensor the
same function runs its plain PyTorch version; every batched float32 SPD
solve with n >= 16 likewise runs the hand-written Cholesky kernel in
``ops/csrc/chol.cu``.

Ported so far: the batched dense QP path — PDAS identification, the S-loop
(with the QR row purge at M+J >= 16 working rows), the Phase-1 simplex
fallback and dual attachment — with every QP batch protocol that
``solve_qp_batch_auto`` routes to: plain (``solve_qp_batch``), PDAS
compaction (``solve_qp_batch_compact``), the grid warm protocols
(``solve_qp_batch_waves``, ``solve_qp_batch_c2f``, ``solve_qp_batch_warm``)
and the residual-thresholded tail refinement
(``solve_qp_batch_tail_refined``); and the refinement tiers: LU
(``refine_result``), factorization-free CG (``refine_result_cg``), the
refined solves (``solve_qp_refined``, ``solve_qp_batch_refined``) and the
double-double continuation (``solve_qp_refined_dd``). The LP engines: the
two-phase simplex (``simplex_lp``, with ``warm_from`` restarting the dual
simplex; ``simplex_lp_standard``), least-index criss-cross (``solve_lp``),
the closed-form box LP (``box_lp``) and the LP batch protocols that
``solve_lp_batch_auto`` routes to: plain (``solve_lp_batch``), the warm
waves of c-grids (``solve_lp_batch_waves``), the dual-simplex waves of
rhs grids (``solve_lp_batch_waves_rhs``), and criss-cross
(``solve_lp_batch_cclp``, ``solve_lp_batch_cclp_rescued``). The outer
layers: the frontier constructors (``qp_frontier_L``, ``qp_frontier_mu``)
and sweeps (``models/frontier.py``: batch, waves, mu and the two warm
sweeps), the differentiable solve (``solve_qp_diff``: identification on the
solver, a differentiable KKT re-solve for autograd), the modelling front end
(``Model``) with MPS input and output (``read_mps``, ``write_mps``,
``solve_mps``), the KKT diagnostics and ``torch.profiler`` trace
(``utils/diagnostics.py``), the kernel build cache and warm-up
(``utils/aot.py``) and the batches sharded over a ``torch.distributed``
process group (``parallel/sharded.py``). Problems and models are built on
the card unless the caller passes ``device="cpu"``.
"""

from ssqp_tpu_torch.types import (
    DN,
    EO,
    IN,
    LP,
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
    lp_from_qp,
    make_lp,
    make_qp,
    qp_from_lp,
    qp_frontier_L,
    qp_frontier_mu,
)

__all__ = [
    "IN", "DN", "UP", "OE", "EO",
    "QP", "LP", "Settings", "Result", "make_qp", "make_lp", "qp_from_lp",
    "lp_from_qp",
    "MC_OK", "MC_INFEASIBLE", "MC_NUMERICAL", "MC_REDUNDANT",
    "MC_NO_CONSTRAINTS", "MC_DEGENERATE_BOUNDS", "MC_NOT_PSD",
    "solve_qp", "solve_qp_batch", "solve_qp_batch_auto", "frontier_batch",
    "solve_qp_batch_tail_refined", "solve_qp_batch_compact",
    "solve_qp_batch_waves", "solve_qp_batch_c2f", "solve_qp_batch_warm",
    "solve_qp_batch_refined", "stack_qps",
    "refine_result", "refine_result_cg", "solve_qp_refined",
    "solve_qp_refined_dd",
    "simplex_lp", "simplex_lp_standard", "solve_lp", "box_lp",
    "solve_lp_batch", "solve_lp_batch_auto", "solve_lp_batch_waves",
    "solve_lp_batch_waves_rhs", "solve_lp_batch_cclp",
    "solve_lp_batch_cclp_rescued", "stack_lps",
    "solve_qp_diff", "qp_frontier_L", "qp_frontier_mu", "Model", "read_mps",
    "solve_mps", "write_mps",
]

_BATCH = ("solve_qp_batch", "solve_qp_batch_auto", "frontier_batch",
          "solve_qp_batch_tail_refined", "solve_qp_batch_compact",
          "solve_qp_batch_waves", "solve_qp_batch_c2f",
          "solve_qp_batch_warm", "solve_qp_batch_refined", "stack_qps",
          "solve_lp_batch", "solve_lp_batch_auto", "solve_lp_batch_waves",
          "solve_lp_batch_waves_rhs", "solve_lp_batch_cclp",
          "solve_lp_batch_cclp_rescued", "stack_lps")
_REFINE = ("refine_result", "refine_result_cg", "solve_qp_refined",
           "solve_qp_refined_dd")

__version__ = "0.1.0"


def __getattr__(name):  # lazy imports keep the package import light
    if name == "solve_qp":
        from ssqp_tpu_torch.solvers.ssqp import solve_qp
        return solve_qp
    if name in ("simplex_lp", "simplex_lp_standard"):
        from ssqp_tpu_torch.solvers import lp
        return getattr(lp, name)
    if name == "solve_lp":
        from ssqp_tpu_torch.solvers.cclp import solve_lp
        return solve_lp
    if name == "box_lp":
        from ssqp_tpu_torch.solvers.boxlp import box_lp
        return box_lp
    if name in _BATCH:
        from ssqp_tpu_torch.parallel import batch
        return getattr(batch, name)
    if name in _REFINE:
        from ssqp_tpu_torch.solvers import refine
        return getattr(refine, name)
    if name == "solve_qp_diff":
        from ssqp_tpu_torch.solvers.diff import solve_qp_diff
        return solve_qp_diff
    if name == "Model":
        from ssqp_tpu_torch.model import Model
        return Model
    if name in ("read_mps", "solve_mps", "write_mps"):
        from ssqp_tpu_torch.utils import mps
        return getattr(mps, name)
    raise AttributeError(f"module 'ssqp_tpu_torch' has no attribute {name!r}")
