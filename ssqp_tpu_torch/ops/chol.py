"""Batched Cholesky factor-and-solve of SPD systems.

Counterpart of ``ssqp_tpu/ops/pallas_chol.py``. Every batched float32 SPD
solve with n >= 16 of the solver (``ops/kkt.py::spd_solve``: the Schur
systems of the KKT solves, dual recovery, the QR purge's reconstruction, the
direct N x N solves) ends here. Per instance, with no pivoting: a
right-looking Cholesky factorization whose pivot is
``rsqrt(max(a_jj, 1e-30))``, then forward substitution in elimination form
and backward substitution as a row-dot recurrence on K right-hand sides.
Singular or non-PD input gives whatever the floored recurrence gives (large,
inf or NaN); the callers' finite and residual gates reject it.

Dispatch is by device and nothing else: a CPU tensor runs
:func:`chol_solve_reference` (plain PyTorch); a CUDA tensor launches a
kernel of ``csrc/chol.cu`` or raises. Which of its bodies runs is one rule,
``chol_body()`` in ``csrc/chol.cu``, which the launch applies and
:func:`body` reports:

* ``"blocked"``: float32 whose matrix and right-hand sides, padded to a
  multiple of 16 rows (row stride + 4, K to a multiple of 4), fit a block's
  shared memory (n <= 224 at K = 1 on an H100; every main-path shape): the
  factor and both substitutions in panels of 16, two block barriers per
  panel and phase;
* ``"rank1-shared"``: the one-row-per-step body with A and RHS in shared
  memory, for float64 and the float32 shapes outside the blocked rule whose
  n^2 + n K fit;
* ``"rank1-device"``: the same body in place on a per-instance copy in
  device memory (the N x N direct solves, n = 512).

There is no fallback between bodies: a refused launch raises.
``LAUNCHES`` counts kernel launches, ``LAUNCHES_BY_SHAPE`` the same
launches by (B, n, K).
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from ssqp_tpu_torch.ops.cg import _ptr

LAUNCHES = 0
LAUNCHES_BY_SHAPE = Counter()


def chol_solve_reference(A, RHS):
    """Plain PyTorch version of the fused factor-and-solve.

    Args:
      A: (B, n, n) SPD matrices; only the upper triangle is read (row j of
        the trailing block stands for column j, as in the TPU kernel).
      RHS: (B, n, K) right-hand sides.

    Returns X (B, n, K) with ``A X = RHS`` per instance.
    """
    n = A.shape[-1]
    a = A.clone()
    lt = torch.zeros_like(a)  # rows of L^T
    for j in range(n):
        row = a[:, j, j:]
        inv = torch.rsqrt(torch.clamp(row[:, :1], min=1e-30))
        col = row * inv
        lt[:, j, j:] = col
        c = col[:, 1:]
        a[:, j + 1:, j + 1:] -= c.unsqueeze(-1) * c.unsqueeze(-2)
    x = RHS.clone()
    for j in range(n):  # L y = r, elimination form
        y = x[:, j, :] / lt[:, j, j].unsqueeze(-1)
        x[:, j, :] = y
        x[:, j + 1:, :] -= lt[:, j, j + 1:].unsqueeze(-1) * y.unsqueeze(-2)
    for j in range(n - 1, -1, -1):  # L^T x = y, row-dot recurrence
        s = torch.sum(lt[:, j, j + 1:].unsqueeze(-1) * x[:, j + 1:, :], dim=1)
        x[:, j, :] = (x[:, j, :] - s) / lt[:, j, j].unsqueeze(-1)
    return x


def body(n, K, dtype=torch.float32):
    """The body a CUDA launch takes for one instance's n and K on the
    current device: ``"blocked"``, ``"rank1-shared"`` or
    ``"rank1-device"``."""
    from ssqp_tpu_torch.ops import _build

    lib = _build.load()
    fn = (lib.ssqp_chol_body_f32 if dtype == torch.float32
          else lib.ssqp_chol_body_f64)
    name = fn(n, K)
    if name is None:
        raise RuntimeError("chol kernel: cannot read the device's "
                           "shared-memory limit")
    return name.decode()


def chol_solve_batch(A, RHS):
    """Solve ``A X = RHS`` for a batch of SPD matrices, A (B, n, n), RHS
    (B, n, K) -> X (B, n, K).

    A CPU tensor runs :func:`chol_solve_reference`; a CUDA tensor launches
    the kernel body :func:`body` names (float32 or float64, any n and K) and
    raises on anything it cannot take.
    """
    global LAUNCHES
    if A.device.type == "cpu" and RHS.device.type == "cpu":
        return chol_solve_reference(A, RHS)
    if A.device.type != "cuda":
        raise ValueError(f"chol_solve_batch: A on {A.device}, RHS on "
                         f"{RHS.device}: only CPU or CUDA tensors")
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"chol_solve_batch: A is {tuple(A.shape)}, "
                         "expected (B, n, n)")
    Bn, n, _ = A.shape
    dtype, dev = A.dtype, A.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"chol_solve_batch: unsupported dtype {dtype}")
    if (RHS.device != dev or RHS.dtype != dtype or RHS.dim() != 3
            or tuple(RHS.shape[:2]) != (Bn, n)):
        raise ValueError(
            f"chol_solve_batch: RHS is {tuple(RHS.shape)} {RHS.dtype} on "
            f"{RHS.device}, expected ({Bn}, {n}, K) {dtype} on {dev}")
    K = RHS.shape[2]
    if Bn == 0 or n == 0 or K == 0:
        return RHS.contiguous().clone()
    from ssqp_tpu_torch.ops import _build

    lib = _build.load()
    f32 = dtype == torch.float32
    solve = lib.ssqp_chol_solve_f32 if f32 else lib.ssqp_chol_solve_f64
    with torch.cuda.device(dev):
        # the shared-memory bodies only read A; the other factors in place
        Aw = A.contiguous()
        if body(n, K, dtype) == "rank1-device":
            Aw = Aw.clone()
        R = RHS.contiguous()
        X = torch.empty_like(R)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = solve(_ptr(Aw), _ptr(R), _ptr(X), ctypes.c_int(Bn),
                    ctypes.c_int(n), ctypes.c_int(K), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"chol kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    LAUNCHES_BY_SHAPE[(Bn, n, K)] += 1
    return X
