"""Modelling API, the reference's MOI-wrapper equivalent (PyTorch).

Counterpart of ``ssqp_tpu/model.py`` (reference src/MOIwrapper.jl): a small
host-side model builder that assembles an :class:`~ssqp_tpu_torch.types.LP`
or :class:`~ssqp_tpu_torch.types.QP` on a device and dispatches the right
engine:

  * scalar affine constraints in EqualTo / LessThan / GreaterThan /
    Interval form (MOIwrapper.jl:97-109; an interval row is expanded to two
    <= rows);
  * variable bounds;
  * quadratic + affine objective with duplicate-term accumulation and
    symmetrization (MOIwrapper.jl:422-439), constant offset, MIN/MAX sense
    (negated internally, MOIwrapper.jl:448-451);
  * automatic downgrade to LP when the quadratic part is zero
    (MOIwrapper.jl:120-128);
  * the mc == -20 analytic presolve for models with no inequalities and no
    bounds (MOIwrapper.jl:131-160), in numpy as in the JAX package;
  * empty rows skipped with a warning (MOIwrapper.jl:279-283);
  * the termination-status mapping (MOIwrapper.jl:213-228), with the JAX
    package's fix: a QP status is its iteration count, so any status > 0
    maps to OPTIMAL.

The problem is built on the card unless the model is given ``device``;
the default dtype is float32, torch's default.
"""

from __future__ import annotations

import time
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ssqp_tpu_torch.types import (
    DN, LP, QP, Result, Settings, check_device, make_lp, make_qp)

# Termination statuses (MOI vocabulary, MOIwrapper.jl:213-228)
OPTIMAL = "OPTIMAL"
INFEASIBLE = "INFEASIBLE"
INFEASIBLE_OR_UNBOUNDED = "INFEASIBLE_OR_UNBOUNDED"
NUMERICAL_ERROR = "NUMERICAL_ERROR"
ITERATION_LIMIT = "ITERATION_LIMIT"
OPTIMIZE_NOT_CALLED = "OPTIMIZE_NOT_CALLED"

# Primal statuses
FEASIBLE_POINT = "FEASIBLE_POINT"
INFEASIBLE_POINT = "INFEASIBLE_POINT"
NO_SOLUTION = "NO_SOLUTION"


def _np(t) -> np.ndarray:
    """A host numpy copy of a tensor (or array)."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


class Model:
    """Build-and-solve model object (reference Optimizer,
    MOIwrapper.jl:8-35).

    >>> m = Model(device="cpu")
    >>> x = m.add_variables(3, lb=0.0)
    >>> m.add_eq({0: 1.0, 1: 1.0, 2: 1.0}, 1.0)
    >>> m.set_objective(quad={(0, 0): 2.0, (1, 1): 2.0, (2, 2): 2.0})
    >>> m.optimize()
    'OPTIMAL'
    """

    def __init__(self, *, settings: Optional[Settings] = None, dtype=None,
                 silent: bool = True, device="cuda"):
        self.device = check_device(device)
        self.dtype = _np_dtype(torch.get_default_dtype() if dtype is None
                               else dtype)
        self.settings = settings
        self.silent = silent
        self.n = 0
        self._lb: list = []
        self._ub: list = []
        self._rows: list = []  # (kind, coeffs dict, rhs lo, rhs hi)
        self._quad: Dict[Tuple[int, int], float] = {}
        self._lin: Dict[int, float] = {}
        self._f0 = 0.0
        self._sense = "min"
        self._result: Optional[Result] = None
        self._problem = None
        self._analytic = False
        self.solve_time = 0.0
        # set by utils/mps.py::read_mps(relax_integers=True): the model is a
        # MIP's continuous relaxation, so OPTIMAL refers to the relaxation
        self.relaxed_integers = False

    # ---- variables --------------------------------------------------------
    def add_variable(self, lb=-np.inf, ub=np.inf) -> int:
        self._lb.append(float(lb))
        self._ub.append(float(ub))
        self.n += 1
        return self.n - 1

    def add_variables(self, k: int, lb=-np.inf, ub=np.inf) -> list:
        return [self.add_variable(lb, ub) for _ in range(k)]

    def set_bounds(self, i: int, lb=None, ub=None) -> None:
        if lb is not None:
            self._lb[i] = float(lb)
        if ub is not None:
            self._ub[i] = float(ub)

    # ---- constraints ------------------------------------------------------
    def _coeffs(self, coeffs) -> Dict[int, float]:
        if isinstance(coeffs, dict):
            return {int(i): float(v) for i, v in coeffs.items()}
        arr = np.asarray(coeffs, float).reshape(-1)
        return {i: float(v) for i, v in enumerate(arr) if v != 0.0}

    def _add_row(self, kind, coeffs, lo, hi):
        c = self._coeffs(coeffs)
        if not c:
            # a constant row is not modeled (satisfied or trivially
            # infeasible)
            warnings.warn("empty constraint row skipped "
                          "(reference MOIwrapper.jl:279-283)")
            return
        self._rows.append((kind, c, lo, hi))

    def add_eq(self, coeffs, rhs: float) -> None:
        self._add_row("eq", coeffs, float(rhs), float(rhs))

    def add_le(self, coeffs, rhs: float) -> None:
        self._add_row("le", coeffs, -np.inf, float(rhs))

    def add_ge(self, coeffs, rhs: float) -> None:
        self._add_row("ge", coeffs, float(rhs), np.inf)

    def add_interval(self, coeffs, lo: float, hi: float) -> None:
        """lo <= a'x <= hi, expanded to two <= rows (bridge equivalent)."""
        self._add_row("interval", coeffs, float(lo), float(hi))

    # ---- objective --------------------------------------------------------
    def set_objective(self, *, quad=None, lin=None, constant: float = 0.0,
                      sense: str = "min") -> None:
        """Set ``sense( 1/2 x'Vx + q'x + constant )``.

        ``quad`` maps (i, j) -> coefficient of ``x_i x_j`` in ``x'Vx`` form
        (V entries; duplicates accumulate, MOIwrapper.jl:431-436), or is a
        dense (n, n) matrix. ``lin`` maps i -> q_i or is a dense vector.
        """
        if sense not in ("min", "max"):
            raise ValueError("sense must be 'min' or 'max'")
        self._sense = sense
        self._quad = {}
        if quad is not None:
            if isinstance(quad, dict):
                for (i, j), v in quad.items():
                    k = (int(i), int(j))
                    self._quad[k] = self._quad.get(k, 0.0) + float(v)
            else:
                arr = np.asarray(quad, float)
                for i, j in zip(*np.nonzero(arr)):
                    self._quad[(int(i), int(j))] = float(arr[i, j])
        self._lin = {}
        if lin is not None:
            if isinstance(lin, dict):
                for i, v in lin.items():
                    self._lin[int(i)] = self._lin.get(int(i), 0.0) + float(v)
            else:
                arr = np.asarray(lin, float).reshape(-1)
                self._lin = {i: float(v) for i, v in enumerate(arr)
                             if v != 0.0}
        self._f0 = float(constant)

    # ---- assembly ---------------------------------------------------------
    def _assemble(self):
        N = self.n
        V = np.zeros((N, N))
        for (i, j), v in self._quad.items():
            V[i, j] += v / 2.0
            V[j, i] += v / 2.0  # symmetrize (MOIwrapper.jl:437-439)
        q = np.zeros(N)
        for i, v in self._lin.items():
            q[i] = v
        if self._sense == "max":
            V, q = -V, -q  # minimize the negation (MOIwrapper.jl:448-451)

        A_rows, b_vals, G_rows, g_vals = [], [], [], []
        for kind, c, lo, hi in self._rows:
            row = np.zeros(N)
            for i, v in c.items():
                row[i] = v
            if kind == "eq":
                A_rows.append(row)
                b_vals.append(lo)
            elif kind == "le":
                G_rows.append(row)
                g_vals.append(hi)
            elif kind == "ge":
                G_rows.append(-row)
                g_vals.append(-lo)
            else:  # interval -> two rows
                G_rows.append(row)
                g_vals.append(hi)
                G_rows.append(-row)
                g_vals.append(-lo)
        A = np.asarray(A_rows) if A_rows else np.zeros((0, N))
        b = np.asarray(b_vals)
        G = np.asarray(G_rows) if G_rows else np.zeros((0, N))
        g = np.asarray(g_vals)
        d = np.asarray(self._lb)
        u = np.asarray(self._ub)

        if not self._quad or np.abs(V).max() == 0.0:
            return make_lp(q, A, b, G=G, g=g, d=d, u=u, dtype=self.dtype,
                           device=self.device)
        return make_qp(V, q, A, b, G=G, g=g, d=d, u=u, dtype=self.dtype,
                       device=self.device)

    def _presolve(self, P) -> Result:
        """Analytic solve of a model with no inequalities and no bounds
        (mc == -20; reference MOIwrapper.jl:131-160, which solves bare A\\b;
        here the objective participates: equality-constrained models solve
        the KKT system, classified by residual, not det(V))."""
        N = P.N
        A = _np(P.A)
        b = _np(P.b)

        def _feas(x):
            if P.M == 0:
                return True
            s = 1.0 + (np.abs(b).max() if b.size else 0.0)
            return np.abs(A @ x - b).max(initial=0.0) < 1e-8 * s

        lam_out = None
        if isinstance(P, QP):
            V = _np(P.V)
            q = _np(P.q)
            sq = 1.0 + (np.abs(q).max() if q.size else 0.0)
            if P.M > 0:
                K = np.block([[V, A.T], [A, np.zeros((P.M, P.M))]])
                rhs = np.concatenate([-q, b])
                sol, *_ = np.linalg.lstsq(K, rhs, rcond=None)
                x, lam = sol[:N], sol[N:]
                stat_ok = np.abs(V @ x + q + A.T @ lam).max(
                    initial=0.0) < 1e-7 * sq
                st = 1 if (_feas(x) and stat_ok) else (
                    0 if not _feas(x) else 3)
                if st == 1:
                    lam_out = lam
            else:
                x, *_ = np.linalg.lstsq(V, -q, rcond=None)
                # consistent Vx=-q (even singular V) -> a minimizer;
                # inconsistent -> unbounded below
                st = 1 if np.abs(V @ x + q).max(initial=0.0) < 1e-7 * sq \
                    else 3
        else:
            c = _np(P.c)
            sc = 1.0 + (np.abs(c).max() if c.size else 0.0)
            if P.M > 0:
                x, *_ = np.linalg.lstsq(A, b, rcond=None)
                if not _feas(x):
                    st = 0
                else:
                    # bounded iff c lies in the row space of A
                    y, *_ = np.linalg.lstsq(A.T, c, rcond=None)
                    st = 1 if np.abs(A.T @ y - c).max(
                        initial=0.0) < 1e-7 * sc else 3
            else:
                x = np.zeros(N)
                st = 1 if np.abs(c).max(initial=0.0) == 0 else 3
        return Result(
            np.asarray(x), np.full((N,), DN, np.int8), np.int32(st),
            None if lam_out is None else np.asarray(lam_out, float),
            None if lam_out is None else np.zeros(N))

    # ---- optimize ---------------------------------------------------------
    def optimize(self, *, refine: bool = False, search_dtype=None) -> str:
        """Assemble and solve; returns the termination status string.

        ``refine=True`` routes a QP through the mixed-precision accuracy
        tier (``solvers/refine.py::solve_qp_refined``): the active-set
        search in ``search_dtype`` (defaults to the model dtype), then
        refinement of the final KKT system against the full-precision data.
        LPs reject the flag."""
        from ssqp_tpu_torch.solvers.lp import simplex_lp
        from ssqp_tpu_torch.solvers.ssqp import solve_qp

        P = self._assemble()
        self._problem = P
        self._analytic = False
        settings = self.settings or Settings.for_dtype(P.d.dtype)

        if P.mc == -20:
            self._analytic = True
            self._result = self._presolve(P)
            self.solve_time = 0.0
            return self.termination_status()

        if refine and not isinstance(P, QP):
            raise ValueError("refine=True applies to QP models only")
        t0 = time.perf_counter()
        if isinstance(P, QP):
            if refine:
                from ssqp_tpu_torch.solvers.refine import solve_qp_refined

                r = solve_qp_refined(P, settings=settings,
                                     search_dtype=search_dtype)
            else:
                r = solve_qp(P, settings=settings)
        else:
            r = simplex_lp(P, settings=settings)
        # host copies: reading the result must not touch the device again
        self._result = Result(
            _np(r.x), _np(r.S), int(r.status),
            None if r.lam is None else _np(r.lam),
            None if r.gamma is None else _np(r.gamma))
        self.solve_time = time.perf_counter() - t0
        return self.termination_status()

    # ---- results ----------------------------------------------------------
    def termination_status(self) -> str:
        if self._result is None:
            return OPTIMIZE_NOT_CALLED
        st = int(self._result.status)
        if st == 3 and (isinstance(self._problem, LP) or self._analytic):
            return INFEASIBLE_OR_UNBOUNDED
        if st > 0:
            return OPTIMAL
        if st == 0:
            return INFEASIBLE
        if st == -1:
            return NUMERICAL_ERROR
        return ITERATION_LIMIT

    def primal_status(self) -> str:
        if self._result is None:
            return NO_SOLUTION
        st = int(self._result.status)
        if st == 0:
            return INFEASIBLE_POINT
        # numerical error (-1) / iteration limit (-max_iter): the stored x
        # was never certified feasible
        return FEASIBLE_POINT if st > 0 else NO_SOLUTION

    def objective_value(self) -> float:
        """Recomputed from the stored x (MOIwrapper.jl:231-240), in float64
        on the host."""
        x = np.asarray(self._result.x, float)
        P = self._problem
        if isinstance(P, QP):
            f = 0.5 * x @ _np(P.V).astype(float) @ x \
                + _np(P.q).astype(float) @ x
        else:
            f = _np(P.c).astype(float) @ x
        return float((f if self._sense == "min" else -f) + self._f0)

    def values(self) -> np.ndarray:
        return np.asarray(self._result.x, float)

    def value(self, i: int) -> float:
        return float(self._result.x[i])

    def statuses(self) -> np.ndarray:
        return np.asarray(self._result.S)

    def iterations(self) -> int:
        return max(0, int(self._result.status))

    def raw_status(self) -> str:
        return (str(int(self._result.status)) if self._result is not None
                else "?")

    def dual_status(self) -> str:
        """FEASIBLE_POINT when a dual certificate is attached to a solved
        problem (the QP path and the LP engines compute one; the reference
        does not, MOIwrapper.jl:255-257); NO_SOLUTION otherwise."""
        if self._result is None or int(self._result.status) <= 0:
            return NO_SOLUTION
        if self._result.lam is None:
            return NO_SOLUTION
        return FEASIBLE_POINT

    def duals(self) -> dict:
        """Dual certificates at the solution (raises when none is attached,
        e.g. a failed solve).

        Returns dict(eq=(M,), ineq=(J,), bounds=(N,)) in assembled row
        order, MIN-sense convention: stationarity
        ``Vx + q + A'eq + G'ineq = bounds`` (for LPs, ``c + A'eq + G'ineq =
        bounds``) with ``ineq >= 0`` on active rows and ``bounds >= 0`` at
        lower / ``<= 0`` at upper bounds. For a MAX-sense model negate them
        to read them against the original objective."""
        if self._result is None or self._result.lam is None:
            raise ValueError("no dual certificate available for this solve")
        P = self._problem
        lam = np.asarray(self._result.lam, float)
        return dict(eq=lam[:P.M], ineq=lam[P.M:],
                    bounds=np.asarray(self._result.gamma, float))

    def __repr__(self) -> str:  # reference Base.show, MOIwrapper.jl:71-88
        n_eq = sum(1 for k, *_ in self._rows if k == "eq")
        n_ineq = len(self._rows) - n_eq
        return (f"ssqp_tpu_torch.Model({self.n} variables, {n_eq} "
                f"equalities, {n_ineq} inequality rows, "
                f"status={self.termination_status()})")

    # ---- problem <-> model round trip (reference QP2MOI/LP2MOI,
    # MOIwrapper.jl:461-509, 380-419) -----------------------------------
    @classmethod
    def from_problem(cls, P, *, sense: str = "min") -> "Model":
        """Build a Model from an existing (unbatched) LP or QP, the reverse
        of ``optimize``'s assembly (reference QP2MOI / LP2MOI). The model
        keeps the problem's dtype and device."""
        m = cls(dtype=P.d.dtype, device=P.device)
        N = P.N
        d = _np(P.d).astype(float)
        u = _np(P.u).astype(float)
        for i in range(N):
            m.add_variable(d[i], u[i])
        A = _np(P.A).astype(float)
        b = _np(P.b).astype(float)
        for r in range(P.M):
            m.add_eq({i: A[r, i] for i in range(N) if A[r, i] != 0.0}, b[r])
        G = _np(P.G).astype(float)
        g = _np(P.g).astype(float)
        for r in range(P.J):
            m.add_le({i: G[r, i] for i in range(N) if G[r, i] != 0.0}, g[r])
        if isinstance(P, QP):
            V = _np(P.V).astype(float)
            # assembly does V[i,j] += v/2 and V[j,i] += v/2, so a diagonal
            # entry lands twice in the same cell and an off-diagonal one
            # splits across the two: emit V_ii and 2*V_ij for an exact
            # round trip
            quad = {(i, j): (V[i, j] if i == j else 2.0 * V[i, j])
                    for i in range(N) for j in range(i, N)
                    if V[i, j] != 0.0}
            c = _np(P.q).astype(float)
        else:
            quad = None
            c = _np(P.c).astype(float)
        lin = {i: float(c[i]) for i in range(N) if float(c[i]) != 0.0}
        m.set_objective(quad=quad, lin=lin, sense=sense)
        return m

    def to_problem(self):
        """Assemble and return the underlying LP/QP without solving."""
        return self._assemble()
