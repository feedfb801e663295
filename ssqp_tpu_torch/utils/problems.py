"""Problem generators and optimality checkers (test / benchmark support).

The port's own copy of ``ssqp_tpu/utils/problems.py``: plain numpy, the
same names and the same arrays for the same seeds, with the status codes
of ``ssqp_tpu_torch.types``. Build a problem on a device from its arrays
with ``make_qp(..., device=...)``.

The reference's conformance surface is the MOI.Test suite — hundreds of small
LP/QPs with known optima (SURVEY.md §4). The batch-solver equivalent here is a
*constructed-optimum* generator: sample an optimal point, active set and
correctly-signed multipliers, then derive the linear term so the KKT conditions
hold exactly. Plus a numpy KKT-residual checker usable as a solver-independent
oracle.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ssqp_tpu_torch.types import DN, EO, IN, OE, UP


def portfolio_start(d, u, budget=1.0):
    """Feasible start for the budget constraint ``1'z = budget, d <= z <= u``.

    Water-fills the remaining budget above the lower bounds. Returns
    (z0, Sx0) with statuses consistent for a warm start of the S-loop.
    """
    d = np.asarray(d, float)
    u = np.asarray(u, float)
    N = d.shape[0]
    z = d.copy()
    rem = budget - z.sum()
    if rem < 0:
        raise ValueError("budget below sum of lower bounds — infeasible")
    Sx = np.full(N, DN, np.int8)
    for k in range(N):
        room = u[k] - z[k]
        take = min(room, rem)
        if take > 0:
            z[k] += take
            rem -= take
            Sx[k] = UP if z[k] == u[k] else IN
        if rem <= 0:
            break
    if rem > 1e-12:
        raise ValueError("budget above sum of upper bounds — infeasible")
    # ensure at least one IN variable if possible (the loop frees otherwise)
    return z, Sx


@dataclasses.dataclass
class GeneratedQP:
    V: np.ndarray
    q: np.ndarray
    A: np.ndarray
    b: np.ndarray
    G: np.ndarray
    g: np.ndarray
    d: np.ndarray
    u: np.ndarray
    x_opt: np.ndarray
    Sx_opt: np.ndarray  # int8 variable statuses at the optimum
    Se_opt: np.ndarray  # int8 inequality statuses at the optimum
    f_opt: float


def generate_qp_known_opt(
    seed: int,
    N: int = 10,
    M: int = 2,
    J: int = 3,
    n_dn: int = 2,
    n_up: int = 1,
    j_act: int = 1,
    ridge: float = 0.5,
) -> GeneratedQP:
    """Construct a strictly-convex QP whose unique optimum is known exactly.

    Stationarity: V x* + q + A'lam + G'mu = gamma with gamma_i > 0 for DN
    variables, < 0 for UP, = 0 for IN; mu_j > 0 on active inequalities, 0
    otherwise. q is back-solved so these hold, making x* the unique optimum.
    """
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((N, N))
    V = H @ H.T / N + ridge * np.eye(N)
    A = rng.standard_normal((M, N)) if M else np.zeros((0, N))
    G = rng.standard_normal((J, N)) if J else np.zeros((0, N))

    x = rng.standard_normal(N)
    perm = rng.permutation(N)
    idx_dn, idx_up = perm[:n_dn], perm[n_dn : n_dn + n_up]
    Sx = np.full(N, IN, np.int8)
    Sx[idx_dn] = DN
    Sx[idx_up] = UP
    d = x - rng.uniform(0.5, 2.0, N)
    u = x + rng.uniform(0.5, 2.0, N)
    d[idx_dn] = x[idx_dn]
    u[idx_up] = x[idx_up]

    b = A @ x
    slack = rng.uniform(0.5, 2.0, J)
    act = np.zeros(J, bool)
    act[rng.permutation(J)[:j_act]] = True
    g = G @ x + np.where(act, 0.0, slack)
    Se = np.where(act, EO, OE).astype(np.int8)

    lam = rng.standard_normal(M)
    mu = np.where(act, rng.uniform(0.2, 1.5, J), 0.0)
    gamma = np.zeros(N)
    gamma[idx_dn] = rng.uniform(0.2, 1.5, n_dn)
    gamma[idx_up] = -rng.uniform(0.2, 1.5, n_up)
    q = gamma - V @ x - A.T @ lam - G.T @ mu

    f = 0.5 * x @ V @ x + q @ x
    return GeneratedQP(V, q, A, b, G, g, d, u, x, Sx, Se, float(f))


def kkt_residual(V, q, A, b, G, g, d, u, x, tol_act: float = 1e-7):
    """Solver-independent optimality measure for a convex QP.

    Returns a dict with primal feasibility violations and the stationarity
    residual after least-squares recovery of multipliers on the active set
    (with sign clipping so wrong-signed multipliers count as residual).
    """
    x = np.asarray(x, float)
    feas_eq = np.abs(A @ x - b).max() if len(b) else 0.0
    feas_in = max(0.0, (G @ x - g).max()) if len(g) else 0.0
    feas_lo = max(0.0, (d - x).max())
    feas_hi = max(0.0, (x - u).max())

    grad = V @ x + q
    act_g = (g - G @ x) <= tol_act if len(g) else np.zeros(0, bool)
    at_lo = (x - d) <= tol_act
    at_hi = (u - x) <= tol_act
    # columns: A' lam (free sign), G_act' mu (mu>=0), e_i gamma_lo (>=0 at lo),
    # -e_i gamma_hi (>=0 at hi); stationarity grad + A'lam + G'mu - glo + ghi = 0
    cols = [A.T]
    if act_g.any():
        cols.append(G[act_g].T)
    lo_idx = np.where(at_lo)[0]
    # at_hi WITHOUT excluding at_lo: a fixed variable (d==u) carries a
    # free-sign multiplier, represented by having BOTH its +-e_k columns
    # available to the NNLS — excluding the upper column forced gamma >= 0
    # and reported a phantom stationarity residual on optimal points whose
    # fixed coordinate needs a negative reduced gradient
    hi_idx = np.where(at_hi)[0]
    E = np.zeros((len(x), len(lo_idx) + len(hi_idx)))
    for i, k in enumerate(lo_idx):
        E[k, i] = -1.0
    for i, k in enumerate(hi_idx):
        E[k, len(lo_idx) + i] = 1.0
    cols.append(E)
    Mcols = np.concatenate([c for c in cols if c.shape[1]], axis=1) if any(
        c.shape[1] for c in cols
    ) else np.zeros((len(x), 0))
    if Mcols.shape[1]:
        # Sign-constrained recovery: free-sign equality multipliers become
        # a +/- column pair so the whole system is NNLS. (A plain lstsq with
        # after-the-fact clipping mis-splits the non-unique multipliers of a
        # VERTEX solution — zero free variables — and reports a phantom
        # stationarity residual on perfectly optimal points.)
        from scipy.optimize import nnls

        off = A.shape[0]
        Mn = np.concatenate([Mcols[:, :off], -Mcols[:, :off], Mcols[:, off:]],
                            axis=1)
        try:
            m, _ = nnls(Mn, -grad, maxiter=10 * Mn.shape[1] + 100)
            stat = np.abs(grad + Mn @ m).max()
        except Exception:
            m, *_ = np.linalg.lstsq(Mcols, -grad, rcond=None)
            na = int(act_g.sum())
            m2 = m.copy()
            m2[off : off + na] = np.maximum(m2[off : off + na], 0.0)
            m2[off + na :] = np.maximum(m2[off + na :], 0.0)
            stat = np.abs(grad + Mcols @ m2).max()
    else:
        stat = np.abs(grad).max()
    return dict(
        feas_eq=float(feas_eq),
        feas_ineq=float(feas_in),
        feas_lo=float(feas_lo),
        feas_hi=float(feas_hi),
        stationarity=float(stat),
        max=float(max(feas_eq, feas_in, feas_lo, feas_hi, stat)),
    )


# ---------------------------------------------------------------------------
# Reference-protocol dataset stand-ins (bench_suite config7)
# ---------------------------------------------------------------------------


def ungil_like():
    """N=14 market with the EXACT constraint structure of the reference's
    :Ungil benchmark problem (examples/SSQPspeed.jl:41-52): budget equality,
    a 25% cap-equality on the first two assets, two group inequality rows
    (last four assets hold >= 0.3 jointly but <= 0.6), and mixed boxes
    including SHORTABLE assets (d < 0 on the last four).

    The reference's E/V are a real market history downloaded at runtime
    (EfficientFrontier.EVdata(:Ungil)); with zero egress this fixture
    substitutes a deterministic factor-model covariance at realistic monthly
    scales (correlated, vols 3-9%). The constraint data — what exercises the
    solver paths — is protocol-exact.

    Returns (E, V, A, b, G, g, d, u) as float64 arrays.
    """
    N = 14
    rng = np.random.default_rng(1414)
    # one market factor + two style factors, monthly scale
    beta = 1.0 + 0.35 * rng.standard_normal(N)
    styles = 0.4 * rng.standard_normal((2, N))
    f_vol = np.array([0.045, 0.02, 0.015])
    B = np.vstack([beta, styles])
    idio = rng.uniform(0.015, 0.05, N)
    V = (B.T * f_vol**2) @ B + np.diag(idio**2)
    V = (V + V.T) / 2
    E = 0.005 + 0.06 * np.sqrt(np.diag(V)) + 0.01 * rng.standard_normal(N)

    A = np.zeros((2, N))
    A[0] = 1.0
    A[1, :2] = 1.0
    b = np.array([1.0, 0.25])
    G = np.zeros((2, N))
    G[0, 10:14] = -1.0  # joint holding of the last four >= 0.3
    G[1, 10:14] = 1.0   # ... and <= 0.6
    g = np.array([-0.3, 0.6])
    d = np.concatenate([np.zeros(10), np.full(4, -0.1)])
    u = np.concatenate([np.full(7, 0.2), np.full(3, 0.1), np.full(4, 0.3)])
    return E, V, A, b, G, g, d, u


def sp500_like(N: int = 263, T: int = 270, seed: int = 500):
    """SP500-scale covariance stand-in (reference examples/SSQPspeed.jl:53-75
    reads a serialized N=263 PSD-truncated sample covariance; zero egress
    here). Construction mirrors what makes the real one hard: a SAMPLE
    covariance of T < 2N days of factor-correlated returns, so the spectrum
    has one dominant market eigenvalue and a long near-singular tail
    (T - N -> 0 drives the smallest eigenvalues toward 0), then PSD-truncated
    like the reference's. Condition number ~1e6-1e8 — nothing like the
    well-conditioned ``H H'/N + 0.5 I`` synthetic markets elsewhere in the
    bench suite.

    Returns (E, V, u) — budget row and long-only lower bounds are the
    reference Problem(E, V, u) defaults (types.jl:229-236).
    """
    rng = np.random.default_rng(seed)
    k = 10
    beta = 1.0 + 0.4 * rng.standard_normal(N)
    B = np.vstack([beta, 0.35 * rng.standard_normal((k, N))])
    f_vol = np.concatenate([[0.011], 0.004 * np.exp(-0.25 * np.arange(k))])
    F = rng.standard_normal((T, k + 1)) * f_vol
    idio = rng.uniform(0.006, 0.02, N)
    R = F @ B + rng.standard_normal((T, N)) * idio
    R = R - R.mean(axis=0)
    V = (R.T @ R) / (T - 1)
    # PSD truncation (the reference dataset is described as PSD-truncated):
    # clip any roundoff-negative eigenvalues to zero, keep the tiny tail
    w, U = np.linalg.eigh((V + V.T) / 2)
    V = (U * np.maximum(w, 0.0)) @ U.T
    V = (V + V.T) / 2
    E = 0.0004 + 2.5 * np.diag(V) + 0.0002 * rng.standard_normal(N)
    u = np.full(N, 3.0 / 32.0)
    return E, V, u
