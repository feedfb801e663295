"""The bounded-variable primal simplex's loop as one CUDA kernel launch.

``csrc/simplex.cu`` runs :func:`ssqp_tpu_torch.solvers.simplex.
bounded_simplex`'s whole iteration loop on the card, one block per instance:
each block loads its instance into shared memory and takes the steps of the
host loop (``bounded_simplex_loop``, the plain version, which the CPU runs
and the card tests hold the kernel to) under the Dantzig rule until its
instance is done or reaches ``max_iter``, with the inverse and the sums in
float64 for both data types. A call is one launch and no host trip per
step.

:func:`uses_kernel` is the route rule, a function of what a call can
observe: CUDA tensors, the Dantzig rule, float32 or float64, and one
instance's state within a block's shared memory (:func:`smem_bytes` against
the H100's 227 KB). Everything else runs the host loop: the CPU, the other
pivot rules, wider shapes (config 4's Phase 1, R = 110 and Nt = 1234, needs
0.9 MB in float32 and 1.5 MB in float64). The launch raises on a CUDA error,
a shape too wide for the device's shared memory among them; nothing falls
back.

``LAUNCHES`` counts launches; while a profiler records, each launch adds a
record of its (B, R, Nt, dtype) to the registry of ``utils/diagnostics.py``
(``simplex.launches``).
"""

from __future__ import annotations

import ctypes

import torch

from ssqp_tpu_torch.ops.cg import _ptr
from ssqp_tpu_torch.utils.diagnostics import recording, simplex_launch

LAUNCHES = 0
# What a block may take of an H100's shared memory (the opt-in limit,
# cudaDevAttrMaxSharedMemoryPerBlockOptin: 227 KB)
SMEM_PER_BLOCK = 232448
_WARPS = 8  # csrc/simplex.cu's 256 threads a block
_DTYPES = (torch.float32, torch.float64)


def smem_bytes(R: int, Nt: int, dtype) -> int:
    """The kernel's shared memory for one instance of R rows and Nt columns:
    the inverse's two buffers, the refresh's product, five row vectors and
    the reductions' slots in float64 (the kernel's arithmetic); A, five
    column vectors, A_B and b in ``dtype``; the basis and slots as ints;
    statuses, the real mask and the in-basis flags as bytes
    (``simplex_smem_bytes`` in ``csrc/simplex.cu``)."""
    wide = 3 * R * R + 5 * R + 2 * _WARPS
    words = R * Nt + 5 * Nt + R * R + R
    ints = R + 5 * _WARPS
    return (8 * wide + (8 if dtype == torch.float64 else 4) * words
            + 4 * ints + 3 * Nt)


def uses_kernel(device, rule: str, R: int, Nt: int, dtype) -> bool:
    """Whether :func:`bounded_simplex` on tensors of ``device`` and
    ``dtype`` with R rows and Nt columns under pivot rule ``rule`` runs the
    kernel (else the host loop)."""
    return (torch.device(device).type == "cuda" and rule == "dantzig"
            and dtype in _DTYPES
            and smem_bytes(R, Nt, dtype) <= SMEM_PER_BLOCK)


def simplex_run(c, Amat, b, d, u, real, cA_safe, invB, B, S, x, pre_done,
                *, tol: float, max_iter: int):
    """Run the loop on the card from the basis B (B, R) int64, its inverse
    invB (B, R, R), the statuses S (B, Nt) and the values x (B, Nt); the
    other arguments as :func:`bounded_simplex`'s, with ``cA_safe`` the
    column norms (1 where 0) and ``pre_done`` (B,) bool or None. The kernel
    overwrites B with the exit basis. Returns (status, x, B, S, iters), x
    and S as new tensors; raises on a CUDA error."""
    global LAUNCHES
    Bn, R, Nt = Amat.shape
    dtype, dev = c.dtype, c.device
    # new contiguous x and S, which the kernel overwrites with the exit; the
    # inputs as they are where already contiguous and of their type
    own = lambda t, shape, dt: torch.empty(shape, dtype=dt,
                                           device=dev).copy_(t)
    xo = own(x, (Bn, Nt), dtype)
    So = own(S, (Bn, Nt), torch.int8)
    status = torch.empty(Bn, dtype=torch.int32, device=dev)
    it = torch.empty(Bn, dtype=torch.int32, device=dev)
    if Bn == 0:
        return status, xo, B, So, it
    dense = lambda t, shape, dt=dtype: t.to(dev, dt).expand(
        shape).contiguous()
    cw, dw, uw, cAw = (dense(t, (Bn, Nt)) for t in (c, d, u, cA_safe))
    Aw = dense(Amat, (Bn, R, Nt))
    bw = dense(b, (Bn, R))
    iw = dense(invB, (Bn, R, R))
    realw = dense(real, (Bn, Nt), torch.bool)
    pre = (torch.zeros(Bn, dtype=torch.bool, device=dev) if pre_done is None
           else dense(pre_done, (Bn,), torch.bool))
    from ssqp_tpu_torch.ops import _build

    lib = _build.load()
    fn = {torch.float32: lib.ssqp_simplex_f32,
          torch.float64: lib.ssqp_simplex_f64}[dtype]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(_ptr(t) for t in (cw, Aw, bw, dw, uw, realw, cAw, iw, pre,
                                     B, So, xo, status, it)),
                 ctypes.c_int(Bn), ctypes.c_int(R), ctypes.c_int(Nt),
                 ctypes.c_double(tol), ctypes.c_double(tol ** 0.5),
                 ctypes.c_int(int(max_iter)), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"simplex kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    if recording():
        simplex_launch(Bn, R, Nt, dtype)
    return status, xo, B, So, it
