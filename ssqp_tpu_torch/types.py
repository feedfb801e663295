"""Problem containers, status codes and solver settings (PyTorch).

Counterpart of ``ssqp_tpu/types.py``. Problem forms:

    QP: min (1/2) x'Vx + q'x  s.t.  Ax = b (M rows),  Gx <= g (J rows),  d <= x <= u
    LP: min c'x               s.t.  the same rows and bounds

Status codes are the same integers as the JAX package and the reference
(IN/DN/UP for variables, OE/EO for inequality rows), as are the
model-condition (``mc``) codes set by :func:`make_qp` and :func:`make_lp`.

Batching: every solver function is batch-first. A batched :class:`QP` carries
a leading batch axis on the leaves that vary across the batch; leaves shared
by the whole batch (V, A, G, b, g, d, u on a frontier grid) stay unbatched and
broadcast. A leaf is batched iff it has one more dimension than its
single-instance shape (V/A/G: 3 instead of 2; q/c/b/g/d/u: 2 instead of 1).
:class:`LP` follows the same convention.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

IN: int = 0
DN: int = 1
UP: int = 2
OE: int = 3
EO: int = 4

MC_OK = 1
MC_INFEASIBLE = 0
MC_NUMERICAL = -1
MC_REDUNDANT = -10
MC_NO_CONSTRAINTS = -20  # no inequalities and no finite bounds
MC_DEGENERATE_BOUNDS = -30  # d == u detected
MC_NOT_PSD = -70  # V not positive semi-definite

_NP_TO_TORCH = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}


def check_device(device) -> torch.device:
    """The device an entry point builds on: CUDA unless the caller asks for
    another. Asking for CUDA where there is none raises here, never falls
    back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port builds its problems on the card by "
            "default; pass device='cpu' to build them on the CPU")
    return device


def as_torch_dtype(dtype) -> torch.dtype:
    """Accept a torch dtype or anything numpy understands as float32/64."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _NP_TO_TORCH[np.dtype(dtype)]


@dataclasses.dataclass(frozen=True)
class Settings:
    """Solver configuration; same fields and defaults as
    ``ssqp_tpu.types.Settings`` with ``dtype`` a torch dtype. See that class
    for what each field controls."""

    max_iter: int = 7777
    tol: float = 2.0**-26
    tolG: float = 2.0**-33
    rule: str = "dantzig"  # 'dantzig' | 'max_improvement' | 'steepest_edge'
    pivot: str = "row"
    dtype: Any = torch.float64
    multi_free: bool = True
    clip_step: bool = False
    kkt_cg: bool = True
    cg_iters: int = 128
    cg_rtol: float = 1e-14
    pdas_cg_iters: int = 128
    pdas_rtol: float = 1e-10
    pdas_precond: bool = True
    pdas_waterfill: bool = True
    pdas_pcg: bool = False
    pdas_cheb: bool = False
    cg_ok_rtol: float = 1e-8
    escalate_direct: bool = True

    @staticmethod
    def for_dtype(dtype) -> "Settings":
        dtype = as_torch_dtype(dtype)
        if dtype == torch.float32:
            return Settings(tol=2.0**-16, tolG=2.0**-20, dtype=torch.float32,
                            cg_iters=64, cg_rtol=1e-7, cg_ok_rtol=2e-3,
                            pdas_cg_iters=24, pdas_rtol=1e-4,
                            escalate_direct=False)
        return Settings(dtype=dtype)


QP_FIELDS = ("V", "A", "G", "q", "b", "g", "d", "u")
_QP_NDIM = {"V": 2, "A": 2, "G": 2, "q": 1, "b": 1, "g": 1, "d": 1, "u": 1}


@dataclasses.dataclass(frozen=True)
class QP:
    """Quadratic program ``min (1/2)x'Vx + q'x  s.t. Ax=b, Gx<=g, d<=x<=u``.

    Leaves are torch tensors on one device; (N, M, J, mc) are static ints.
    Use :func:`make_qp` for validated construction."""

    V: torch.Tensor
    A: torch.Tensor
    G: torch.Tensor
    q: torch.Tensor
    b: torch.Tensor
    g: torch.Tensor
    d: torch.Tensor
    u: torch.Tensor
    N: int
    M: int
    J: int
    mc: int = MC_OK

    def leaves(self) -> dict:
        return {f: getattr(self, f) for f in QP_FIELDS}

    def is_batched(self, field: str) -> bool:
        return getattr(self, field).dim() == _QP_NDIM[field] + 1

    @property
    def batch_size(self) -> Optional[int]:
        """Leading batch size, or None when no leaf is batched."""
        for f in QP_FIELDS:
            if self.is_batched(f):
                return getattr(self, f).shape[0]
        return None

    @property
    def device(self) -> torch.device:
        return self.V.device

    def to(self, device) -> "QP":
        return dataclasses.replace(
            self, **{f: t.to(device) for f, t in self.leaves().items()})

    def astype(self, dtype) -> "QP":
        """The same problem with every leaf cast to ``dtype`` (the refined
        tiers' downcast search copy)."""
        dtype = as_torch_dtype(dtype)
        return dataclasses.replace(
            self, **{f: t.to(dtype) for f, t in self.leaves().items()})

    def take(self, idx: torch.Tensor) -> "QP":
        """Sub-batch: index the batched leaves, keep shared ones."""
        return dataclasses.replace(
            self, **{f: getattr(self, f)[idx] for f in QP_FIELDS
                     if self.is_batched(f)})

    @classmethod
    def from_numpy(cls, V, A, G, q, b, g, d, u, N, M, J, mc=MC_OK, *,
                   device="cuda", dtype=None) -> "QP":
        """Build a QP from the JAX package's problem fields given as numpy
        arrays (e.g. ``np.asarray(Q.V)``); leaves keep their shapes, so a
        batched field stays batched. The leaves go to the card unless
        ``device`` says otherwise."""
        device = check_device(device)
        arrs = [np.asarray(a) for a in (V, A, G, q, b, g, d, u)]
        dt = as_torch_dtype(arrs[0].dtype if dtype is None else dtype)
        leaves = [torch.tensor(a, device=device).to(dt) for a in arrs]
        return cls(*leaves, int(N), int(M), int(J), int(mc))


LP_FIELDS = ("c", "A", "b", "G", "g", "d", "u")
_LP_NDIM = {"c": 1, "A": 2, "b": 1, "G": 2, "g": 1, "d": 1, "u": 1}


@dataclasses.dataclass(frozen=True)
class LP:
    """Linear program ``min c'x  s.t. Ax=b, Gx<=g, d<=x<=u``.

    Leaves are torch tensors on one device; (N, M, J, mc) are static ints.
    A leaf is batched iff it has one more dimension than its single-instance
    shape. Use :func:`make_lp` for validated construction."""

    c: torch.Tensor
    A: torch.Tensor
    b: torch.Tensor
    G: torch.Tensor
    g: torch.Tensor
    d: torch.Tensor
    u: torch.Tensor
    N: int
    M: int
    J: int
    mc: int = MC_OK

    def leaves(self) -> dict:
        return {f: getattr(self, f) for f in LP_FIELDS}

    def is_batched(self, field: str) -> bool:
        return getattr(self, field).dim() == _LP_NDIM[field] + 1

    @property
    def batch_size(self) -> Optional[int]:
        """Leading batch size, or None when no leaf is batched."""
        for f in LP_FIELDS:
            if self.is_batched(f):
                return getattr(self, f).shape[0]
        return None

    @property
    def device(self) -> torch.device:
        return self.c.device

    def to(self, device) -> "LP":
        return dataclasses.replace(
            self, **{f: t.to(device) for f, t in self.leaves().items()})

    def astype(self, dtype) -> "LP":
        """The same problem with every leaf cast to ``dtype``."""
        dtype = as_torch_dtype(dtype)
        return dataclasses.replace(
            self, **{f: t.to(dtype) for f, t in self.leaves().items()})

    def take(self, idx: torch.Tensor) -> "LP":
        """Sub-batch: index the batched leaves, keep shared ones."""
        return dataclasses.replace(
            self, **{f: getattr(self, f)[idx] for f in LP_FIELDS
                     if self.is_batched(f)})

    @classmethod
    def from_numpy(cls, c, A, b, G, g, d, u, N, M, J, mc=MC_OK, *,
                   device="cuda", dtype=None) -> "LP":
        """Build an LP from the JAX package's problem fields given as numpy
        arrays (e.g. ``np.asarray(P.c)``); leaves keep their shapes, so a
        batched field stays batched. The leaves go to the card unless
        ``device`` says otherwise."""
        device = check_device(device)
        arrs = [np.asarray(a) for a in (c, A, b, G, g, d, u)]
        dt = as_torch_dtype(arrs[0].dtype if dtype is None else dtype)
        leaves = [torch.tensor(a, device=device).to(dt) for a in arrs]
        return cls(*leaves, int(N), int(M), int(J), int(mc))


def batch_of(Q: QP) -> int:
    """Batch size of a batched QP; the solver internals take batches only."""
    B = Q.batch_size
    if B is None:
        raise ValueError("expected a batched QP (a leaf with a leading "
                         "batch axis, e.g. q of shape (B, N))")
    return B


def _as2d(x, dtype) -> np.ndarray:
    a = np.asarray(x, dtype=dtype)
    if a.ndim != 2:
        a = a.reshape((-1, a.shape[-1]) if a.size else (0, 0))
    return a


def _prep_bounds(d, u, N, dtype):
    """d/u defaulting plus the reference's swap-if-reversed rule (u < d is
    swapped; d == u flags mc=-30)."""
    d = (np.full(N, 0.0, dtype) if d is None
         else np.asarray(d, dtype).reshape(N).copy())
    u = (np.full(N, np.inf, dtype) if u is None
         else np.asarray(u, dtype).reshape(N).copy())
    mc = MC_OK
    swap = u < d
    if swap.any():
        d[swap], u[swap] = u[swap].copy(), d[swap].copy()
    if (d == u).any():
        mc = MC_DEGENERATE_BOUNDS
    return d, u, mc


def make_qp(V, q=None, A=None, b=None, *, G=None, g=None, d=None, u=None,
            dtype=None, check_psd=True, device="cuda") -> QP:
    """Build a validated QP (validation in numpy, as ``ssqp_tpu.make_qp``).

    Defaults reproduce the portfolio problem ``min (1/2) z'Vz s.t. 1'z = 1,
    z >= 0``; V is symmetrized and PSD-checked (mc=-70 on failure), reversed
    bounds are swapped, d == u gives mc=-30 and a problem with neither
    inequalities nor finite bounds mc=-20. ``dtype`` defaults to float64.
    The problem is built on the card unless ``device`` says otherwise;
    without a card the default raises (pass ``device="cpu"``)."""
    device = check_device(device)
    npdt = np.dtype(np.float64 if dtype is None else
                    (torch.empty(0, dtype=dtype).numpy().dtype
                     if isinstance(dtype, torch.dtype) else dtype))
    V = _as2d(V, npdt)
    N = V.shape[0]
    if V.shape != (N, N):
        raise ValueError("V must be square")
    V = (V + V.T) / 2
    q = np.zeros(N, npdt) if q is None else np.asarray(q, npdt).reshape(N)
    A = np.ones((1, N), npdt) if A is None else _as2d(A, npdt)
    b = np.ones((1,), npdt) if b is None else np.asarray(b, npdt).reshape(-1)
    G = np.zeros((0, N), npdt) if G is None else _as2d(G, npdt)
    g = np.zeros((0,), npdt) if g is None else np.asarray(g, npdt).reshape(-1)
    M, J = b.shape[0], g.shape[0]
    if A.shape != (M, N):
        raise ValueError(f"incompatible dimension: A {A.shape} != {(M, N)}")
    if G.shape != (J, N):
        raise ValueError(f"incompatible dimension: G {G.shape} != {(J, N)}")
    if d is None:
        d = np.zeros(N, npdt)
    d, u, mc = _prep_bounds(d, u, N, npdt)
    if mc == MC_OK and J == 0 and not (np.isfinite(d).any() or np.isfinite(u).any()):
        mc = MC_NO_CONSTRAINTS
    if mc == MC_OK and check_psd and N > 0:
        w = np.linalg.eigvalsh(V.astype(np.float64))
        if w[0] < -1e-9 * max(1.0, abs(w[-1])):
            mc = MC_NOT_PSD
    return QP.from_numpy(V, A, G, q, b, g, d, u, N, M, J, mc, device=device)


def _check_dtype_realizable(dtype) -> np.dtype:
    """The numpy dtype a constructor builds in, or an error. The JAX
    package warns here when float64 is asked for with x64 off (its arrays
    would silently be float32 under float64-tier tolerances); torch always
    has float64, so the trap left is a dtype with no Settings tier at all
    (float16, bfloat16, integers), which is refused."""
    if isinstance(dtype, torch.dtype):
        dtype = torch.empty(0, dtype=dtype).numpy().dtype
    dtype = np.dtype(dtype)
    if dtype not in (np.float32, np.float64):
        raise ValueError(f"dtype {dtype}: the solvers have tolerance tiers "
                         "for float32 and float64 only")
    return dtype


def make_lp(c, A=None, b=None, *, G=None, g=None, d=None, u=None,
            dtype=None, device="cuda") -> LP:
    """Build a validated LP (validation in numpy, as ``ssqp_tpu.make_lp``):
    no rows by default, bounds ``0 <= x`` unless given, reversed bounds
    swapped, d == u gives mc=-30 and a problem with neither inequalities nor
    finite bounds mc=-20. ``dtype`` defaults to float64. The problem is
    built on the card unless ``device`` says otherwise; without a card the
    default raises (pass ``device="cpu"``)."""
    device = check_device(device)
    npdt = _check_dtype_realizable(np.float64 if dtype is None else dtype)
    c = np.asarray(c, npdt).reshape(-1)
    N = c.shape[0]
    A = np.zeros((0, N), npdt) if A is None else _as2d(A, npdt)
    b = np.zeros((0,), npdt) if b is None else np.asarray(b, npdt).reshape(-1)
    G = np.zeros((0, N), npdt) if G is None else _as2d(G, npdt)
    g = np.zeros((0,), npdt) if g is None else np.asarray(g, npdt).reshape(-1)
    M, J = b.shape[0], g.shape[0]
    if A.shape != (M, N):
        raise ValueError(f"incompatible dimension: A {A.shape} != {(M, N)}")
    if G.shape != (J, N):
        raise ValueError(f"incompatible dimension: G {G.shape} != {(J, N)}")
    d, u, mc = _prep_bounds(d, u, N, npdt)
    if mc == MC_OK and J == 0 and not (np.isfinite(d).any() or np.isfinite(u).any()):
        mc = MC_NO_CONSTRAINTS
    return LP.from_numpy(c, A, b, G, g, d, u, N, M, J, mc, device=device)


def qp_frontier_L(P: QP, L) -> QP:
    """L-parameterized frontier QP: objective ``1/2 z'Vz - L q'z`` where
    ``P.q`` holds expected returns (the reference's QP(P::QP, L),
    types.jl:303-319)."""
    L = float(L)
    return dataclasses.replace(P, q=-L * P.q)


def qp_frontier_mu(P: QP, mu) -> QP:
    """mu-parameterized frontier QP: appends the expected-return equality
    ``q'z = mu`` to Az=b and zeroes the linear term (the reference's
    QP(mu, P), types.jl:321-339); one QP, not a batch."""
    A = torch.cat([P.A, P.q.unsqueeze(0)], dim=0)
    b = torch.cat([P.b, torch.tensor([float(mu)], dtype=P.b.dtype,
                                     device=P.b.device)])
    return dataclasses.replace(P, A=A, b=b, q=torch.zeros_like(P.q),
                               M=P.M + 1)


def qp_from_lp(P: LP) -> QP:
    """Lift an LP to a QP with ``V = diag(|c| + 0.5)`` (the reference's
    types.jl:341-356); one LP, not a batch."""
    V = torch.diag(P.c.abs() + 0.5)
    return QP(V, P.A, P.G, P.c, P.b, P.g, P.d, P.u, P.N, P.M, P.J, P.mc)


def lp_from_qp(Q: QP, c=None) -> LP:
    """Drop the quadratic term (the reference's types.jl:358-373)."""
    c = Q.q if c is None else torch.as_tensor(c, dtype=Q.q.dtype,
                                              device=Q.q.device)
    return LP(c, Q.A, Q.b, Q.G, Q.g, Q.d, Q.u, Q.N, Q.M, Q.J, Q.mc)


@dataclasses.dataclass(frozen=True)
class Result:
    """Solver output: ``x`` (..., N), int8 statuses ``S`` (..., N+J), int32
    ``status`` (success = S-loop iteration count), and the dual certificates
    ``lam`` (..., M+J) / ``gamma`` (..., N) where the path computes them
    (same contract as ``ssqp_tpu.types.Result``)."""

    x: Any
    S: Any
    status: Any
    lam: Any = None
    gamma: Any = None

    @classmethod
    def from_numpy(cls, x, S, status, lam=None, gamma=None, *,
                   device="cuda") -> "Result":
        """Carry a result across from numpy leaves (e.g. the JAX package's
        ``Result`` through ``np.asarray``): x, lam and gamma keep their
        float dtype, S becomes int8 and status int32. The leaves go to the
        card unless ``device`` says otherwise."""
        device = check_device(device)
        f = lambda a: None if a is None else torch.tensor(np.asarray(a),
                                                          device=device)
        return cls(f(x), f(np.asarray(S, np.int8)),
                   f(np.asarray(status, np.int32)), f(lam), f(gamma))

    def numpy(self) -> "Result":
        """The same result with numpy leaves (host copies)."""
        cv = lambda t: None if t is None else t.detach().cpu().numpy()
        return Result(cv(self.x), cv(self.S), cv(self.status), cv(self.lam),
                      cv(self.gamma))
