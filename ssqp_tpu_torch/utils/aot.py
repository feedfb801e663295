"""Kernel build cache and warm-up, the PrecompileTools analogue (PyTorch).

Counterpart of ``ssqp_tpu/utils/aot.py``. The reference pre-compiles its
entry points in a ``@compile_workload`` block (src/StatusSwitchingQP.jl:
39-77); the JAX package turns on XLA's persistent compilation cache and
runs the entry points once per shape. The port compiles nothing but its
hand-written CUDA kernels, so its cache is the directory the kernel library
is built into (``ops/_build.py``, keyed by a hash of the sources and
flags), and its warm-up builds that library and runs the same entry points
once on the card.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Tuple

import numpy as np


def enable_compilation_cache(path: Optional[str] = None) -> str:
    """Build and cache the CUDA kernel library under ``path`` (default:
    ``$SSQP_CACHE_DIR``, else ``build/`` at the repository root); returns
    the directory. A later process pointed at the same directory loads the
    library without compiling."""
    from ssqp_tpu_torch.ops import _build

    path = path or os.environ.get("SSQP_CACHE_DIR")
    if path is None:
        return str(_build.build_dir())
    os.makedirs(path, exist_ok=True)
    return str(_build.set_build_dir(path))


def warmup(
    shapes: Iterable[Tuple[int, int, int]] = ((16, 1, 0),),
    batch: int = 0,
    dtype=None,
    refined: bool = False,
    device="cuda",
) -> int:
    """Run the QP solve paths once for the given (N, M, J) shapes on
    ``device`` (the card by default, whose kernels are built first).

    ``solve_qp`` (the three-stage auto solve) is always run; ``batch > 0``
    also runs the batched path (``solve_qp_batch``) at that batch size, and
    ``refined=True`` the mixed-precision pipeline (float32 search, float64
    refinement; skipped with a warning when ``dtype`` is float64 already).
    Returns the number of entry points run. The problems are the JAX
    package's: a tiny portfolio QP through every entry point."""
    import torch

    from ssqp_tpu_torch.parallel.batch import solve_qp_batch, stack_qps
    from ssqp_tpu_torch.solvers.ssqp import solve_qp
    from ssqp_tpu_torch.types import (
        Settings, as_torch_dtype, check_device, make_qp)

    device = check_device(device)
    if device.type == "cuda":
        from ssqp_tpu_torch.ops import _build

        _build.load()
    dtype = np.dtype(np.float32 if dtype is None else
                     torch.empty(0, dtype=dtype).numpy().dtype
                     if isinstance(dtype, torch.dtype) else dtype)
    settings = Settings.for_dtype(dtype)
    n = 0
    for (N, M, J) in shapes:
        rng = np.random.default_rng(0)
        H = rng.standard_normal((N, N))
        V = (H @ H.T / N + 0.5 * np.eye(N)).astype(dtype)
        A = np.ones((M, N), dtype)
        b = np.ones((M,), dtype)
        G = rng.standard_normal((J, N)).astype(dtype) if J else None
        g = np.full((J,), 10.0, dtype) if J else None
        Q = make_qp(V, None, A, b, G=G, g=g, u=np.full(N, 1.0, dtype),
                    dtype=dtype, device=device)
        solve_qp(Q, settings=settings).x.cpu()
        n += 1
        if batch > 0:
            Qb = stack_qps([Q] * batch)
            solve_qp_batch(Qb, settings).x.cpu()
            n += 1
        if refined:
            if as_torch_dtype(dtype) == torch.float64:
                import warnings

                warnings.warn(
                    "warmup(refined=True) skipped: the search dtype is "
                    "float64 already, so the mixed-precision (float32 "
                    "search + float64 refine) path would not be the one "
                    "run; pass dtype=float32", stacklevel=2)
            else:
                from ssqp_tpu_torch.solvers.refine import solve_qp_refined

                solve_qp_refined(Q.astype(torch.float64),
                                 search_dtype=as_torch_dtype(dtype)).x.cpu()
                n += 1
    return n
