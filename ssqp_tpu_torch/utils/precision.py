"""Matmul precision guard.

The solver tolerances (tolG ~ 1e-6 in float32) need full-precision float32
products; TF32 keeps about three decimal digits and makes the active-set
iteration cycle. Counterpart of ``ssqp_tpu/utils/precision.py``: every solver
entry point runs under :func:`highest_matmul`, which turns TF32 off for both
matmuls and cuDNN and sets the float32 matmul precision to "highest" for the
duration of the call.
"""

from __future__ import annotations

import functools

import torch


def highest_matmul(fn):
    """Run ``fn`` with TF32 disabled and float32 matmul precision "highest"."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32,
                 torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved[0]
            torch.backends.cudnn.allow_tf32 = saved[1]
            torch.set_float32_matmul_precision(saved[2])

    return wrapped
