"""Masked Gauss-Jordan row purge with fixed shapes, batch-first (PyTorch).

Counterpart of ``ssqp_tpu/ops/masked_gj.py`` (the QP solver's subset). A working
row is kept iff it is linearly independent of the kept rows before it; a
dropped row whose eliminated right-hand side still exceeds ``tol`` marks the
system inconsistent. The elimination runs a fixed number of steps over
``(B, R, C)`` stacks and returns boolean masks instead of shrinking.
"""

from __future__ import annotations

import torch


def _gj_sweep(E: torch.Tensor, tol, ncols_pivot: int):
    """Row-ordered Gauss-Jordan over ``E`` (B, R, C), pivoting only in the
    first ``ncols_pivot`` columns. Returns (eliminated E, keep (B, R))."""
    Bn, R, C = E.shape
    pivot_zone = (torch.arange(C, device=E.device) < ncols_pivot).to(E.dtype)
    keep = torch.zeros((Bn, R), dtype=torch.bool, device=E.device)
    one = torch.ones((), dtype=E.dtype, device=E.device)
    ar = torch.arange(Bn, device=E.device)
    for i in range(R):
        row = E[:, i, :]
        absrow = row.abs() * pivot_zone
        j = absrow.argmax(dim=1)
        piv_ok = absrow[ar, j] > tol
        denom = torch.where(piv_ok, row[ar, j], one)
        r = row / denom.unsqueeze(-1)
        factors = torch.where(piv_ok.unsqueeze(-1), E[ar, :, j],
                              torch.zeros_like(E[:, :, 0]))
        factors[:, i] = 0.0
        E = E - factors.unsqueeze(-1) * r.unsqueeze(-2)
        E[:, i, :] = torch.where(piv_ok.unsqueeze(-1), r, row)
        keep[:, i] = piv_ok
    return E, keep


def masked_gj_purge(A, b, row_mask, tol):
    """Independent-row selection on ``[A | b]`` (reference getRowsGJr).

    A (B, R, C) (or shared (R, C)), b (B, R), row_mask (B, R) bool.
    Returns (keep (B, R), inconsistent (B,), bad_rows (B, R))."""
    rm = row_mask.to(b.dtype)
    Am = (A * rm.unsqueeze(-1)).expand(rm.shape[0], *A.shape[-2:])
    E = torch.cat([Am, (b * rm).unsqueeze(-1)], dim=-1)
    E, keep = _gj_sweep(E, tol, A.shape[-1])
    dropped = row_mask & ~keep
    bad_rows = dropped & (E[..., -1].abs() > tol)
    return keep, bad_rows.any(dim=-1), bad_rows


def masked_gj_purge_col(A, b, row_mask, tol):
    """Column-pivoted flavor (reference getRowsGJ): sweep columns left to
    right; the pivot row of column j is the max-|entry| unused active row.
    Returns (keep, inconsistent, bad_rows) like :func:`masked_gj_purge`."""
    Bn, R = row_mask.shape
    C = A.shape[-1]
    dtype = b.dtype
    rm = row_mask.to(dtype)
    Am = (A * rm.unsqueeze(-1)).expand(Bn, R, C)
    E = torch.cat([Am, (b * rm).unsqueeze(-1)], dim=-1)
    keep = torch.zeros((Bn, R), dtype=torch.bool, device=b.device)
    one = torch.ones((), dtype=dtype, device=b.device)
    ar = torch.arange(Bn, device=b.device)
    for j in range(C):
        colv = E[:, :, j].abs() * torch.where(keep, torch.zeros_like(rm), rm)
        i = colv.argmax(dim=1)
        piv_ok = colv[ar, i] > tol
        piv = E[ar, i, :]
        denom = torch.where(piv_ok, piv[:, j], one)
        r = piv / denom.unsqueeze(-1)
        factors = torch.where(piv_ok.unsqueeze(-1), E[:, :, j],
                              torch.zeros_like(E[:, :, j]))
        factors[ar, i] = 0.0
        E = E - factors.unsqueeze(-1) * r.unsqueeze(-2)
        E[ar, i, :] = torch.where(piv_ok.unsqueeze(-1), r, piv)
        keep[ar, i] = keep[ar, i] | piv_ok
    dropped = row_mask & ~keep
    bad_rows = dropped & (E[..., -1].abs() > tol)
    return keep, bad_rows.any(dim=-1), bad_rows


def masked_purge_qr(A, b, row_mask, tol):
    """One-shot QR twin of :func:`masked_gj_purge` (same contract), used at
    R >= 16 working rows, where the R-step sweep's sequential latency
    dominates.

    The greedy row-order keep rule ("keep iff independent of the kept rows
    above") comes from one Householder QR of the masked rows transposed:
    |R_jj| is the norm of row j's residual against the span of all previous
    rows, and dropped rows never extend that span. Consistency of dropped
    rows is a ridge-stabilized least-squares reconstruction of their
    right-hand sides from the kept rows (an SPD solve through
    ``ops/kkt.py::spd_solve``). The QR itself is a library call, as in the
    JAX package, where it runs outside any Pallas kernel.

    A (B, R, C) (or shared (R, C)), b (B, R), row_mask (B, R) bool.
    Returns (keep (B, R), inconsistent (B,), bad_rows (B, R))."""
    from ssqp_tpu_torch.ops.kkt import spd_solve

    Bn, R = row_mask.shape
    dtype = b.dtype
    rm = row_mask.to(dtype)
    Am = A * rm.unsqueeze(-1)  # (B, R, C)
    Rm = torch.linalg.qr(Am.transpose(1, 2), mode="r")[1]  # (B, min(C,R), R)
    diag = torch.diagonal(Rm, dim1=-2, dim2=-1).abs()
    if diag.shape[-1] < R:  # more rows than columns: the tail cannot be kept
        diag = torch.cat([diag, torch.zeros((Bn, R - diag.shape[-1]),
                                            dtype=dtype, device=b.device)],
                         dim=-1)
    keep = (diag > tol) & row_mask
    km = keep.to(dtype)
    Ak = Am * km.unsqueeze(-1)
    ridge = torch.finfo(dtype).eps
    M1 = torch.bmm(Ak, Ak.transpose(1, 2)) \
        + torch.diag_embed((1.0 - km) + ridge * km)
    M1 = (M1 + M1.transpose(1, 2)) / 2
    X = spd_solve(M1, torch.bmm(Ak, Am.transpose(1, 2)))  # (B, R, R)
    pred_b = torch.bmm(X.transpose(1, 2), (km * b).unsqueeze(-1)).squeeze(-1)
    dropped = row_mask & ~keep
    bad_rows = dropped & ((b * rm - pred_b).abs() > tol)
    return keep, bad_rows.any(dim=-1), bad_rows


def select_purge(pivot: str, R: int):
    """The redundancy-purge flavor, with the JAX package's dispatch rule:
    ``Settings.pivot`` picks row- or column-pivoting; the row flavor uses
    the one-shot QR twin (:func:`masked_purge_qr`) at R >= 16 working rows.
    The only place the rule lives: every engine that rebuilds a working set
    (the S-loop, the refinement sweeps) purges through it."""
    if pivot != "row":
        return masked_gj_purge_col
    return masked_purge_qr if R >= 16 else masked_gj_purge
