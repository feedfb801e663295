"""Fused multi-RHS CG on the mask-padded KKT operator.

Counterpart of ``ssqp_tpu/ops/pallas_cg.py``. Every conjugate-gradient solve
of the solver (each PDAS round, each S-loop KKT solve, the dual attachment)
ends here. The batch of instances is flattened into system ROWS: an instance
with K = 1+M+J right-hand sides contributes K rows, and row c solves

    vp_c(x) = fm_c . (V_c (fm_c . x)) + (1 - fm_c) . x = b_c

by Jacobi-preconditioned CG from the warm start X0, each row freezing on its
own (alpha = 0 when rr <= tol2 or pAp <= 0, beta = 0 when rr <= tol2; 1e-30
division floors; any-alive exit checked every 8 steps).

Dispatch is by device and nothing else: a CPU tensor runs
:func:`cg_rows_reference` (plain PyTorch); a CUDA tensor launches the kernel
in ``csrc/cg.cu`` or raises. ``LAUNCHES`` counts kernel launches. Both can
return the number of steps each row ran (the steps that start with the row
alive, rr > tol2). While a profiler records, a launch runs inside the span
``ssqp.cg_kernel`` and adds a record of its shape, body and row steps to
the registry of ``utils/diagnostics.py``.

The kernel has three bodies, picked by a fixed rule on the arguments alone:
float32 with one shared V (``V.dim() == 2``) and N <= 1024 runs the
tensor-core body (3xTF32 ``mma.sync``, tiles of 16/32/64 rows chosen from C
and N, V streamed through shared memory); float64 with one shared V and
N <= 512 runs the DMMA body (float64 ``mma.sync`` on the float64 tensor
cores, 16-row tiles, V from L2 straight into the operand registers, p and r
in shared memory); a per-instance V, float32 with N > 1024 and float64 with
N > 512 run the first port's body (FFMA/DFMA, V read from L2 by every
8/16-row tile). What bounds the float64 case on the H100 is the product (2
N^2 per row and step) at the float64 tensor cores' 67 TFLOP/s; the first
body ran it on DFMA, latency-bound. No body falls back to another, to the
plain version or to a library call: a launch that fails raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ssqp_tpu_torch.utils.diagnostics import cg_launch, recording, span

LAUNCHES = 0

_CHUNK = 8


def _vp_rows(V, fmr, x, inst):
    xm = x * fmr
    if V.dim() == 2:
        y = xm @ V.T
    else:
        y = torch.bmm(V[inst], xm.unsqueeze(-1)).squeeze(-1)
    return fmr * y + (1.0 - fmr) * x


def cg_rows_reference(V, fmr, dinvr, Br, tol2r, iters, X0r,
                      inst: Optional[torch.Tensor] = None,
                      steps: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the fused CG (the semantics of
    ``ssqp_tpu/ops/kkt.py::_vp_cg_xla`` on rows).

    Args:
      V: (N, N) shared operator, or (B, N, N) with ``inst`` giving each row's
        instance.
      fmr, dinvr, Br, X0r: (C, N) free mask, Jacobi preconditioner,
        right-hand sides, warm start.
      tol2r: (C, 1) squared absolute residual tolerance.
      iters: int iteration bound.
      steps: optional (C,) int32 output, set to the number of steps each
        row ran (those that start with the row alive).

    Returns (X (C, N), rr (C, 1) final squared residual).
    """
    X = X0r.clone()
    r = Br - _vp_rows(V, fmr, X, inst)
    z = r * dinvr
    p = z
    rz = torch.sum(r * z, dim=1, keepdim=True)
    rr = torch.sum(r * r, dim=1, keepdim=True)
    if steps is not None:
        steps.zero_()
    i = 0
    go = bool((rr > tol2r).any())
    while i < iters and go:
        for _ in range(min(_CHUNK, iters - i)):
            alive = rr > tol2r
            if steps is not None:
                steps += alive.squeeze(1)
            Ap = _vp_rows(V, fmr, p, inst)
            pAp = torch.sum(p * Ap, dim=1, keepdim=True)
            alpha = torch.where(alive & (pAp > 0),
                                rz / torch.clamp(pAp, min=1e-30),
                                torch.zeros_like(pAp))
            X = X + alpha * p
            r = r - alpha * Ap
            zn = r * dinvr
            rzn = torch.sum(r * zn, dim=1, keepdim=True)
            beta = torch.where(alive, rzn / torch.clamp(rz, min=1e-30),
                               torch.zeros_like(rz))
            p = zn + beta * p
            rz = rzn
            rr = torch.sum(r * r, dim=1, keepdim=True)
        i += _CHUNK
        go = bool((rr > tol2r).any())
    return X, rr


def body(C: int, N: int, dtype, shared: bool) -> str:
    """The body a launch of C rows of width N takes, as the library's own
    rule reports it: ``"tensor-core"`` where :func:`tile_rows` gives a tile
    (float32, one shared V, N within the body's limit), ``"dmma"`` (float64,
    one shared V, N within the DMMA body's limit), else ``"cuda-core"`` (the
    first port's body)."""
    from ssqp_tpu_torch.ops import _build

    if shared and dtype == torch.float32 and tile_rows(C, N) > 0:
        return "tensor-core"
    if shared and dtype == torch.float64 and _build.load().ssqp_cg_body_f64(
            int(N)):
        return "dmma"
    return "cuda-core"


def tile_rows(C: int, N: int) -> int:
    """Rows per block of the tensor-core body for a float32 shared-V solve of
    C rows of width N on the current card; 0 where the first body runs."""
    from ssqp_tpu_torch.ops import _build

    tr = _build.load().ssqp_cg_tile_rows_f32(int(C), int(N))
    if tr < 0:
        raise RuntimeError("cg tile query failed: no usable CUDA device")
    return tr


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _check(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"cg_padded_rows: {name} is {tuple(t.shape)} {t.dtype} on "
            f"{t.device}, expected {shape} {dtype} on {device}")


def cg_padded_rows(V, fmr, dinvr, Br, tol2r, iters, X0r,
                   inst: Optional[torch.Tensor] = None,
                   steps: Optional[torch.Tensor] = None):
    """Fused CG for ``vp(x_c) = b_c`` over flattened system rows.

    Same arguments and result as :func:`cg_rows_reference`. A CPU tensor runs
    that plain version; a CUDA tensor launches the kernel (float32 or
    float64, any N, no padding) and raises on anything it cannot take.
    While a profiler records, the kernel counts each row's steps (into
    ``steps`` if given) for the registry's launch record.
    """
    global LAUNCHES
    if Br.device.type == "cpu":
        return cg_rows_reference(V, fmr, dinvr, Br, tol2r, iters, X0r, inst,
                                 steps)
    if Br.device.type != "cuda":
        raise ValueError(f"cg_padded_rows: unsupported device {Br.device}")
    C, N = Br.shape
    dev, dtype = Br.device, Br.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"cg_padded_rows: unsupported dtype {dtype}")
    for name, t in (("fmr", fmr), ("dinvr", dinvr), ("X0r", X0r)):
        _check(name, t, (C, N), dtype, dev)
    _check("tol2r", tol2r, (C, 1), dtype, dev)
    if V.dim() == 2:
        _check("V", V, (N, N), dtype, dev)
        if inst is not None:
            raise ValueError("cg_padded_rows: inst is only for a batched V")
    else:
        _check("V", V, (V.shape[0], N, N), dtype, dev)
        if inst is None:
            raise ValueError("cg_padded_rows: a batched V needs inst")
        _check("inst", inst, (C,), torch.int32, dev)
    if steps is not None:
        _check("steps", steps, (C,), torch.int32, dev)
    X = X0r.contiguous().clone()
    rr = torch.zeros((C, 1), dtype=dtype, device=dev)
    if C == 0 or N == 0:
        if steps is not None:
            steps.zero_()
        return X, rr
    rec = recording()
    if rec and steps is None:
        steps = torch.empty(C, dtype=torch.int32, device=dev)
    # the tensor-core body keeps the residual in device memory
    R = (torch.empty_like(X) if dtype == torch.float32 and V.dim() == 2
         else None)
    from ssqp_tpu_torch.ops import _build

    lib = _build.load()
    fn = lib.ssqp_cg_rows_f32 if dtype == torch.float32 else lib.ssqp_cg_rows_f64
    Vt = V.transpose(-1, -2).contiguous()
    vstride = 0 if V.dim() == 2 else N * N
    args = [t.contiguous() for t in (fmr, dinvr, Br, tol2r)]
    inst_c = None if inst is None else inst.contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with span("cg_kernel"):
            err = fn(_ptr(Vt), ctypes.c_longlong(vstride), _ptr(inst_c),
                     *(_ptr(t) for t in args), _ptr(X), _ptr(R), _ptr(rr),
                     _ptr(steps), ctypes.c_int(C), ctypes.c_int(N),
                     ctypes.c_int(int(iters)), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"cg kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    if rec:
        shared = V.dim() == 2
        cg_launch(C, N, dtype, shared, body(C, N, dtype, shared),
                  1 if shared else V.shape[0], steps)
    return X, rr


def _rows(B, FM, DINV, TOL2, X0):
    batch, N, K = B.shape
    C = batch * K
    Br = B.transpose(1, 2).reshape(C, N)
    X0r = X0.transpose(1, 2).reshape(C, N)
    fmr = FM.unsqueeze(1).expand(batch, K, N).reshape(C, N)
    dinvr = DINV.unsqueeze(1).expand(batch, K, N).reshape(C, N)
    return Br, X0r, fmr, dinvr, TOL2.reshape(C, 1)


def cg_padded_batch(V, FM, B, DINV, TOL2, iters, X0):
    """Batched adapter: flatten (batch, N, K) instances into system rows, run
    the fused CG, restore the batch layout.

    Args:
      V: (N, N) shared operator or (batch, N, N) per-instance.
      FM, DINV: (batch, N) free masks / preconditioners.
      B, X0: (batch, N, K); TOL2: (batch, K).

    Returns (X (batch, N, K), rr (batch, K)).
    """
    batch, N, K = B.shape
    Br, X0r, fmr, dinvr, tol2r = _rows(B, FM, DINV, TOL2, X0)
    inst = None
    if V.dim() == 3:
        inst = torch.arange(batch, dtype=torch.int32, device=B.device)
        inst = inst.repeat_interleave(K)
    Xr, rrr = cg_padded_rows(V, fmr, dinvr, Br, tol2r, iters, X0r, inst)
    X = Xr.reshape(batch, K, N).transpose(1, 2)
    return X, rrr.reshape(batch, K)
