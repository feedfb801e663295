"""Plain reference solver for the benchmark's convex QPs.

    min 1/2 x'Vx + q'x   s.t.   Ax = b,  Gx <= g,  d <= x <= u

with V, A, G, d, u shared by a batch of S instances that differ in q
(S, N), b and g shared or given per instance ((S, M), (S, J)), and d < u
finite. It is a textbook primal-dual interior-point
method (Mehrotra's predictor-corrector, one common step length per
instance) followed by an active-set polish: the bounds and rows that the
interior point names active are imposed as equalities and the resulting
KKT system is solved directly; the polished point is kept only where it
satisfies every optimality condition to a tolerance, else the interior
point stands. Plain PyTorch on whatever device the data is on; it imports
nothing of the program under test and takes nothing the program made.

Multipliers follow the stationarity convention
``V x + q + A' lam_eq + G' lam_in - gamma = 0`` with ``lam_in >= 0`` and
``gamma >= 0`` at a lower bound, ``<= 0`` at an upper bound, 0 between.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Data:
    """The leaves of a batch of QPs (float64 unless cast); b and g may
    have a leading instance axis."""

    V: torch.Tensor  # (N, N)
    A: torch.Tensor  # (M, N)
    b: torch.Tensor  # (M,) or (S, M)
    G: torch.Tensor  # (J, N)
    g: torch.Tensor  # (J,) or (S, J)
    d: torch.Tensor  # (N,)
    u: torch.Tensor  # (N,)

    def to(self, dtype) -> "Data":
        return Data(*(getattr(self, f.name).to(dtype)
                      for f in dataclasses.fields(self)))


@dataclasses.dataclass
class Solution:
    x: torch.Tensor  # (S, N)
    lam: torch.Tensor  # (S, M + J): equality rows, then inequality rows
    gamma: torch.Tensor  # (S, N) bound multipliers
    lower: torch.Tensor  # (S, N) bool: at the lower bound
    upper: torch.Tensor  # (S, N) bool: at the upper bound
    active: torch.Tensor  # (S, J) bool: inequality row active
    ok: torch.Tensor  # (S,) bool: converged or polished
    polished: torch.Tensor  # (S,) bool
    iters: int


def objective(V, q, x):
    return 0.5 * ((x @ V) * x).sum(-1) + (q * x).sum(-1)


def _step(v, dv):
    """Largest alpha in (0, 1] with v + alpha dv >= 0, per instance."""
    ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, float("inf")))
    return ratio.amin(-1).clamp(max=1.0)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32's 10-bit mantissa (to nearest, ties
    away from zero), the precision of a TF32 tensor-core operand."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 on (the control's precision) or off for float32 products."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


def solve(data: Data, q: torch.Tensor, *, dtype=torch.float64,
          tf32: bool = False, max_iter: int = 100) -> Solution:
    """Solve the S instances of ``q`` (S, N) in ``dtype``: float64 for the
    reference; float32 for a control one step below float64; float32 with
    ``tf32`` for the control one step below float32, where every input is
    rounded to TF32 and every product runs in TF32."""
    data, q = data.to(dtype), q.to(dtype)
    if tf32:
        if dtype != torch.float32:
            raise ValueError("tf32 takes float32 data")
        data = Data(*(round_tf32(getattr(data, f.name))
                      for f in dataclasses.fields(data)))
        q = round_tf32(q)
    with matmul_precision(tf32), torch.no_grad():
        return _solve(data, q, max_iter)


def _solve(D: Data, q, max_iter):
    V, A, b, G, g, d, u = D.V, D.A, D.b, D.G, D.g, D.d, D.u
    S, N = q.shape
    M, J = A.shape[0], G.shape[0]
    dt, dev = q.dtype, q.device
    eps = torch.finfo(dt).eps
    tol = max(1e-12, eps)
    m = 2 * N + J
    qn = 1.0 + q.abs().amax(-1)
    bn = 1.0 + (b.abs().max() if M else torch.zeros((), dtype=dt, device=dev))
    gn = 1.0 + (g.abs().max() if J else torch.zeros((), dtype=dt, device=dev))

    x = ((d + u) / 2).expand(S, N).clone()
    zl = torch.ones_like(x)
    zu = torch.ones_like(x)
    y = torch.zeros((S, M), dtype=dt, device=dev)
    s = torch.clamp(g - x @ G.T, min=1.0) if J else x.new_zeros((S, 0))
    z = torch.ones_like(s)
    done = torch.zeros(S, dtype=torch.bool, device=dev)
    it = 0
    for it in range(1, max_iter + 1):
        tl, tu = x - d, u - x
        rd = x @ V + q + y @ A + z @ G - zl + zu
        rp = x @ A.T - b
        rg = x @ G.T + s - g
        mu = ((tl * zl).sum(-1) + (tu * zu).sum(-1) + (s * z).sum(-1)) / m
        err = torch.stack([
            rd.abs().amax(-1) / qn,
            (rp.abs().amax(-1) if M else torch.zeros_like(mu)) / bn,
            (rg.abs().amax(-1) if J else torch.zeros_like(mu)) / gn,
            mu / qn], dim=-1).amax(-1)
        done = done | (err <= tol) | ~torch.isfinite(err)
        if bool(done.all()):
            break
        Dx = zl / tl + zu / tu
        Wg = z / s
        H = V + torch.diag_embed(Dx)
        if J:
            H = H + (G.T * Wg.unsqueeze(1)) @ G
        K = torch.zeros((S, N + M, N + M), dtype=dt, device=dev)
        K[:, :N, :N] = H
        K[:, :N, N:] = A.T
        K[:, N:, :N] = A
        LU, piv, _ = torch.linalg.lu_factor_ex(K)

        def direction(cl, cu, cs):
            r1 = -rd + cl / tl - cu / tu
            if J:
                r1 = r1 - (Wg * rg + cs / s) @ G
            rhs = torch.cat([r1, -rp], dim=-1).unsqueeze(-1)
            sol = torch.linalg.lu_solve(LU, piv, rhs).squeeze(-1)
            dx, dy = sol[:, :N], sol[:, N:]
            gdx = dx @ G.T
            dz = Wg * (gdx + rg) + cs / s
            ds = -rg - gdx
            dzl = (cl - zl * dx) / tl
            dzu = (cu + zu * dx) / tu
            return dx, dy, dz, ds, dzl, dzu

        def alpha(dx, dz, ds, dzl, dzu):
            a = torch.stack([_step(tl, dx), _step(tu, -dx), _step(zl, dzl),
                             _step(zu, dzu)], -1).amin(-1)
            if J:
                a = torch.minimum(a, torch.minimum(_step(s, ds), _step(z, dz)))
            return a

        dxa, _, dza, dsa, dzla, dzua = direction(-tl * zl, -tu * zu, -s * z)
        aa = alpha(dxa, dza, dsa, dzla, dzua).unsqueeze(-1)
        mu_aff = (((tl + aa * dxa) * (zl + aa * dzla)).sum(-1)
                  + ((tu - aa * dxa) * (zu + aa * dzua)).sum(-1)
                  + ((s + aa * dsa) * (z + aa * dza)).sum(-1)) / m
        sm = ((mu_aff / mu) ** 3 * mu).unsqueeze(-1)
        dx, dy, dz, ds, dzl, dzu = direction(
            sm - tl * zl - dxa * dzla, sm - tu * zu + dxa * dzua,
            sm - s * z - dsa * dza)
        a = 0.995 * alpha(dx, dz, ds, dzl, dzu)
        # an instance whose direction is no longer finite (mu near the
        # precision's floor) stops where it is
        finite = torch.stack([torch.isfinite(t).all(-1) for t in
                              (dx, dy, dz, ds, dzl, dzu)], -1).all(-1)
        done = done | ~finite
        a = torch.where(done, torch.zeros_like(a), a).unsqueeze(-1)
        dx, dy, dz, ds, dzl, dzu = (torch.nan_to_num(t) for t in
                                    (dx, dy, dz, ds, dzl, dzu))
        x = x + a * dx
        y = y + a * dy
        z = z + a * dz
        s = s + a * ds
        zl = zl + a * dzl
        zu = zu + a * dzu

    tl, tu = x - d, u - x
    lower, upper = zl > tl, zu > tu
    active = z > s
    lam = torch.cat([y, z], dim=-1)
    gamma = zl - zu
    ok = done & torch.isfinite(x).all(-1)
    xp, lamp, gp, good = _polish(D, q, lower, upper, active,
                                 max(1e-9, 1e3 * eps))
    keep = good.unsqueeze(-1)
    return Solution(torch.where(keep, xp, x), torch.where(keep, lamp, lam),
                    torch.where(keep, gp, gamma), lower, upper, active,
                    ok | good, good, it)


def _polish(D: Data, q, lower, upper, active, tol, rounds: int = 8):
    """Impose the named active set as equalities and solve the KKT system
    directly (:func:`_kkt_on`); where some optimality condition fails,
    move the set by the primal-dual active-set rule (a bound or row joins
    where the point breaks it, leaves where its multiplier has the wrong
    sign) and solve again, at most ``rounds`` times. Returns (x, lam,
    gamma, accepted) where accepted means every condition holds to
    ``tol``, scaled."""
    x, lam, gamma, good = _kkt_on(D, q, lower, upper, active, tol)
    for _ in range(rounds):
        if bool(good.all()):
            break
        M = D.A.shape[0]
        w = lam[:, M:]
        redo = (~good).unsqueeze(-1)
        lower = torch.where(redo, torch.where(lower, gamma > 0, x < D.d),
                            lower)
        upper = torch.where(redo, torch.where(upper, gamma < 0, x > D.u),
                            upper)
        if D.G.shape[0]:
            active = torch.where(redo, torch.where(active, w > 0,
                                                   x @ D.G.T > D.g), active)
        x2, lam2, gamma2, good2 = _kkt_on(D, q, lower, upper, active, tol)
        take = (~good).unsqueeze(-1)
        x, lam, gamma = (torch.where(take, a2, a1) for a1, a2 in
                         ((x, x2), (lam, lam2), (gamma, gamma2)))
        good = good | good2
    return x, lam, gamma, good


def _kkt_on(D: Data, q, lower, upper, active, tol):
    """The KKT system on one active set: free coordinates keep
    stationarity, bound ones sit on their bound, active rows hold as
    equalities, inactive rows get a zero multiplier."""
    V, A, b, G, g, d, u = D.V, D.A, D.b, D.G, D.g, D.d, D.u
    S, N = q.shape
    M, J = A.shape[0], G.shape[0]
    dt, dev = q.dtype, q.device
    n = N + M + J
    f = (~(lower | upper)).to(dt)
    a = active.to(dt)
    K = torch.zeros((S, n, n), dtype=dt, device=dev)
    K[:, :N, :N] = f.unsqueeze(-1) * V + torch.diag_embed(1.0 - f)
    K[:, :N, N:N + M] = f.unsqueeze(-1) * A.T
    K[:, :N, N + M:] = f.unsqueeze(-1) * G.T
    K[:, N:N + M, :N] = A
    K[:, N + M:, :N] = a.unsqueeze(-1) * G
    K[:, N + M:, N + M:] = torch.diag_embed(1.0 - a)
    xb = torch.where(lower, d, u)
    rhs = torch.cat([f * -q + (1.0 - f) * xb, b.expand(S, M),
                     a * g], dim=-1)
    LU, piv, info = torch.linalg.lu_factor_ex(K)
    sol = torch.linalg.lu_solve(LU, piv, rhs.unsqueeze(-1)).squeeze(-1)
    x, lam = sol[:, :N], sol[:, N:]
    w = lam[:, M:]
    grad = x @ V + q + lam[:, :M] @ A + w @ G
    gamma = (1.0 - f) * grad
    qn = (1.0 + q.abs().amax(-1)).unsqueeze(-1)
    span = 1.0 + torch.maximum(d.abs(), u.abs())
    viol = [((d - x) / span).amax(-1), ((x - u) / span).amax(-1),
            ((f * grad).abs() / qn).amax(-1),
            (torch.where(lower, -gamma, torch.zeros_like(gamma)) / qn).amax(-1),
            (torch.where(upper, gamma, torch.zeros_like(gamma)) / qn).amax(-1)]
    if J:
        viol += [((x @ G.T - g) / (1.0 + g.abs())).amax(-1),
                 (-w / qn).amax(-1)]
    worst = torch.stack(viol, -1).amax(-1)
    good = (info == 0) & torch.isfinite(sol).all(-1) & (worst <= tol)
    return x, lam, gamma, good
