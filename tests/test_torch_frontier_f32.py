"""The port's mu sweep in float32 (ssqp_tpu_torch/models/frontier.py)
against the JAX package's on the CPU: the equality rows and the objective
at the grid's own values. The warm sweeps' cases are in
test_torch_frontier_f32_warm.py and test_torch_frontier_f32_mu_warm.py
(one JAX compile per sweep, 5-9 s each).

Problem: the benchmark's market cut to N=32 (seed 7, V = HH'/N + 0.5 I,
r ~ U(0, 0.2), budget row, 0 <= x <= 4/N); an L grid of 8 points on
[0, 2] and a mu grid of 8 points inside the returns the L grid reaches.

In float32 both packages' KKT solves carry a Schur ridge of 100 eps, so a
point's equality rows are off by the ridge times the row's multiplier; the
objective at the grid's values is then off by that row error times the
multiplier. Checks, per sweep:

- without the port's row restoration (``_restore_rows``), the port's sweep
  is the JAX sweep: status and S equal, x within 1e-5, each point's budget
  and return row errors within 2e-6 of JAX's (the ridge's error reads
  2.2e-5 on the mu sweep's return row in both, the warm sweeps' last
  iterates 3e-7 to 8e-7), and the objective gap at the grid's values
  within 1e-6 of JAX's (4.2e-5 on the mu sweep in both);
- with it, status and S are unchanged, x stays within 1e-4 of JAX's, the
  rows hold to 1e-7 and the objective at the grid's values is within 1e-7
  of the port's float64 sweep (which test_torch_frontier*.py hold to
  JAX's at 1e-9).

The restoration on a template with an inequality row is checked on its
own (no JAX counterpart: the JAX package does not restore rows).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssqp_tpu.models import frontier as jf
from ssqp_tpu.types import Settings as JSettings
from ssqp_tpu.types import make_qp as jmake_qp
from ssqp_tpu_torch import Settings as TSettings
from ssqp_tpu_torch import make_qp
from ssqp_tpu_torch.models import frontier as tf

N, B = 32, 8
SWEEPS = {"mu": ("frontier_mu_sweep", "mu"),
          "mu_warm": ("frontier_mu_warm_sweep", "mu"),
          "warm": ("frontier_warm_sweep", "L")}


@pytest.fixture(scope="module")
def market():
    rng = np.random.default_rng(7)
    H = rng.standard_normal((N, N))
    V = H @ H.T / N + 0.5 * np.eye(N)
    r = rng.uniform(0.0, 0.2, N)
    u = np.full(N, 4.0 / N)
    f32 = np.float32
    Qj = jmake_qp(V.astype(f32), r.astype(f32), u=u.astype(f32), dtype=f32)
    Qt = make_qp(V.astype(f32), r.astype(f32), u=u.astype(f32), dtype=f32,
                 device="cpu")
    Q64 = make_qp(V, r, u=u, device="cpu")
    lams = np.linspace(0.0, 2.0, B)
    ref = tf.frontier_batch_sweep(Q64, torch.tensor(r), lams, TSettings())
    lo, hi = float(ref.ret.min()), float(ref.ret.max())
    mus = np.linspace(lo + 0.02 * (hi - lo), hi - 0.02 * (hi - lo), B)
    return dict(V=V, r=r, Qj=Qj, Qt=Qt, Q64=Q64, L=lams, mu=mus, L64=ref)


def _objective(V, r, x, grid, kind):
    x = np.asarray(x, np.float64)
    f = 0.5 * np.einsum("bi,ij,bj->b", x, V, x)
    return f if kind == "mu" else f - grid * (x @ r)


def _rows(r, x, grid, kind):
    """Per-point |1'x - 1| and, on a mu sweep, |r'x - mu|."""
    x = np.asarray(x, np.float64)
    e = [np.abs(x.sum(1) - 1.0)]
    if kind == "mu":
        e.append(np.abs(x @ r - grid))
    return np.stack(e, 1)


def check_sweep(market, sweep, monkeypatch):
    name, kind = SWEEPS[sweep]
    V, r, grid = market["V"], market["r"], market[kind]
    s32 = TSettings.for_dtype(torch.float32)
    rt = torch.tensor(r, dtype=torch.float32)
    fj = getattr(jf, name)(market["Qj"], jnp.asarray(r, jnp.float32),
                           jnp.asarray(grid, jnp.float32),
                           JSettings.for_dtype(jnp.float32))
    ft = getattr(tf, name)(market["Qt"], rt, grid, s32)
    with monkeypatch.context() as m:
        m.setattr(tf, "_restore_rows", lambda Qb, x, S, status: x)
        raw = getattr(tf, name)(market["Qt"], rt, grid, s32)
    f64 = (market["L64"] if kind == "L" else
           tf.frontier_mu_sweep(market["Q64"], torch.tensor(r), grid,
                                TSettings()))
    assert bool((f64.status > 0).all())
    xj = np.asarray(fj.x, np.float64)
    ref = _objective(V, r, f64.x.numpy(), grid, kind)
    gap = lambda x: np.abs(_objective(V, r, x, grid, kind) - ref).max()
    for f in (raw, ft):
        np.testing.assert_array_equal(f.status.numpy(), np.asarray(fj.status))
        np.testing.assert_array_equal(f.S.numpy(), np.asarray(fj.S))
    assert bool((ft.status > 0).all())
    np.testing.assert_allclose(raw.x.double().numpy(), xj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(_rows(r, raw.x, grid, kind),
                               _rows(r, xj, grid, kind), rtol=0, atol=2e-6)
    assert abs(gap(raw.x) - gap(xj)) < 1e-6
    np.testing.assert_allclose(ft.x.double().numpy(), xj, rtol=0, atol=1e-4)
    assert _rows(r, ft.x, grid, kind).max() < 1e-7
    assert gap(ft.x) < 1e-7
    if sweep == "mu":
        assert gap(xj) > 1e-6


def test_f32_mu_sweep_rows_and_grid_gap(market, monkeypatch):
    check_sweep(market, "mu", monkeypatch)


def test_restore_rows_holds_active_inequality_rows(market):
    """A template with an inequality row (the first 8 weights capped at
    0.3, active on the high-return end): the restoration holds the budget
    and every active inequality row to 1e-7, leaves S, status and the
    inactive rows alone, and does not move a point whose status is 0."""
    V, r = market["V"], market["r"]
    f32 = np.float32
    G = np.zeros((1, N))
    G[0, np.argsort(r)[-8:]] = 1.0
    Q = make_qp(V.astype(f32), r.astype(f32), G=G.astype(f32),
                g=np.array([0.3], f32), u=np.full(N, 4.0 / N, f32),
                dtype=f32, device="cpu")
    rt = torch.tensor(r, dtype=torch.float32)
    lams = np.linspace(0.0, 2.0, B)
    fr = tf.frontier_batch_sweep(Q, rt, lams, TSettings.for_dtype(
        torch.float32))
    assert bool((fr.status > 0).all())
    active = (fr.S[:, N:] == 4).squeeze(1).numpy()
    assert active.any() and not active.all()
    x = fr.x.double().numpy()
    assert np.abs(x.sum(1) - 1.0).max() < 1e-7
    gx = x @ G[0]
    assert np.abs(gx[active] - 0.3).max() < 1e-7
    assert (gx[~active] <= 0.3 + 1e-7).all()
    Qb = tf._with_q(Q, -torch.tensor(lams, dtype=torch.float32)[:, None]
                    * rt[None])
    x0 = fr.x + 1e-4 * torch.ones_like(fr.x)  # off its rows
    status = fr.status.clone()
    status[0] = 0
    xr = tf._restore_rows(Qb, x0, fr.S, status)
    assert torch.equal(xr[0], x0[0])
    assert np.abs(xr[1:].double().numpy().sum(1) - 1.0).max() < 1e-7
