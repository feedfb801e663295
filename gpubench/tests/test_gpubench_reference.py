"""The plain reference against QPs whose optimum is known by
construction: pick x*, the active bounds and rows and multipliers of the
right signs, and set q so that x* satisfies every optimality condition."""

import pytest
import torch

from gpubench.reference import qp as ref


def constructed(seed, N=24, M=2, J=6, S=5):
    """S instances sharing V, A, b, G, g and the box. Instance i holds its
    first 3 + i coordinates at the lower bound and its last 3 at the upper
    one; A and G do not touch those coordinates, so every x* meets the same
    rows: the first J/2 inequality rows active, the others slack."""
    gen = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    rand = lambda *s: torch.rand(*s, generator=gen, dtype=f64)
    randn = lambda *s: torch.randn(*s, generator=gen, dtype=f64)
    H = randn(N, N)
    V = H @ H.T / N + 0.5 * torch.eye(N, dtype=f64)
    d, u = -rand(N) - 0.5, rand(N) + 0.5
    base = (d + u) / 2 + 0.2 * (u - d) * (rand(N) - 0.5)
    bound = list(range(3 + S)) + list(range(N - 3, N))
    A, G = randn(M, N), randn(J, N)
    A[:, bound] = 0.0
    G[:, bound] = 0.0
    b = A @ base
    g = G @ base + torch.cat([torch.zeros(J // 2, dtype=f64),
                              0.3 + rand(J - J // 2)])
    xs, qs = [], []
    for i in range(S):
        lo, hi = slice(0, 3 + i), slice(N - 3, N)
        x = base.clone()
        x[lo], x[hi] = d[lo], u[hi]
        gamma = torch.zeros(N, dtype=f64)
        gamma[lo] = rand(3 + i) + 0.1
        gamma[hi] = -rand(3) - 0.1
        w = rand(J) + 0.1
        w[J // 2:] = 0.0
        y = randn(M)
        xs.append(x)
        qs.append(-(V @ x + A.T @ y + G.T @ w - gamma))
    return ref.Data(V, A, b, G, g, d, u), torch.stack(qs), torch.stack(xs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_finds_constructed_optimum(seed):
    data, q, xstar = constructed(seed)
    sol = ref.solve(data, q)
    assert bool(sol.ok.all()) and bool(sol.polished.all())
    assert float((sol.x - xstar).abs().max()) < 1e-9
    f = ref.objective(data.V, q, sol.x)
    fs = ref.objective(data.V, q, xstar)
    assert float(((f - fs).abs() / fs.abs().clamp(min=1)).max()) < 1e-12


def test_reference_frontier_vertex():
    """At large lambda the frontier's optimum is a vertex: N/4 coordinates
    at 4/N and the rest at 0, so the budget row is implied by the bounds
    (its multiplier is not unique). The reference still returns it."""
    N = 16
    f64 = torch.float64
    V = 0.5 * torch.eye(N, dtype=f64)
    mu = torch.linspace(0.0, 0.2, N, dtype=f64)
    data = ref.Data(V, torch.ones(1, N, dtype=f64), torch.ones(1, dtype=f64),
                    torch.zeros(0, N, dtype=f64), torch.zeros(0, dtype=f64),
                    torch.zeros(N, dtype=f64),
                    torch.full((N,), 4.0 / N, dtype=f64))
    q = -50.0 * mu.unsqueeze(0)
    sol = ref.solve(data, q)
    want = torch.zeros(N, dtype=f64)
    want[-N // 4:] = 4.0 / N
    assert bool(sol.ok.all())
    assert float((sol.x[0] - want).abs().max()) < 1e-8


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0**-12, 1.0 + 3 * 2.0**-11, -2.5e-3])
    r = ref.round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 and r[2] == 1.0 + 2.0**-9
    assert float(((r - x).abs() / x.abs()).max()) <= 2.0**-11
