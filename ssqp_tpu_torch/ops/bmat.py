"""Products with a matrix that is either shared by the batch or per-instance.

Batch-first solver code multiplies per-instance vectors ``(B, C)`` or blocks
``(B, C, K)`` by problem matrices that are shared on frontier grids (one
``(R, C)`` matrix) and per-instance otherwise (``(B, R, C)``). A shared
matrix is never expanded to the batch: its product is one GEMM with the batch
folded into the rows.
"""

from __future__ import annotations

import torch


def mv(Mat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``Mat @ x`` per instance: Mat (R, C) or (B, R, C), x (B, C) -> (B, R)."""
    if Mat.dim() == 2:
        return x @ Mat.T
    return torch.bmm(Mat, x.unsqueeze(-1)).squeeze(-1)


def mtv(Mat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``Mat' @ y`` per instance: Mat (R, C) or (B, R, C), y (B, R) -> (B, C)."""
    if Mat.dim() == 2:
        return y @ Mat
    return torch.bmm(Mat.transpose(1, 2), y.unsqueeze(-1)).squeeze(-1)


def mm(Mat: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``Mat @ X`` per instance: Mat (R, C) or (B, R, C), X (B, C, K) ->
    (B, R, K)."""
    if Mat.dim() == 2:
        return (X.transpose(1, 2) @ Mat.T).transpose(1, 2)
    return torch.bmm(Mat, X)


def stack_rows(A: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """``[A; G]`` where either may be shared or batched (the shared one is
    broadcast to the batch only when the other is batched)."""
    if A.dim() != G.dim():
        B = A.shape[0] if A.dim() == 3 else G.shape[0]
        A = A.expand(B, *A.shape[-2:]) if A.dim() == 2 else A
        G = G.expand(B, *G.shape[-2:]) if G.dim() == 2 else G
    return torch.cat([A, G], dim=-2)


def cat_vec(b: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``[b; g]`` where either may be shared (1-D) or batched (2-D)."""
    if b.dim() != g.dim():
        B = b.shape[0] if b.dim() == 2 else g.shape[0]
        b = b.expand(B, b.shape[-1]) if b.dim() == 1 else b
        g = g.expand(B, g.shape[-1]) if g.dim() == 1 else g
    return torch.cat([b, g], dim=-1)
