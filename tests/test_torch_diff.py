"""The port's differentiable solve (ssqp_tpu_torch/solvers/diff.py:
``kkt_resolve``, ``solve_qp_diff``, ``qp_value``) against the JAX package on
the CPU in float64.

Problem: tests/test_diff.py's portfolio QP (N=8, J=2 random rows, budget
row, 0 <= x <= 3/N, seed 3; seed 11 with J=0 for the frontier jacobian),
float64. The JAX references compile once each: one ``value_and_grad`` of
w'x* with respect to (q, b, u, V), which also returns (x, lam, gamma), and
one ``jacfwd`` of x*(lambda) on the frontier.

Tolerances:
  * x, lam and gamma within 1e-9 of the JAX package's, statuses equal;
  * the gradients of w'x* with respect to q, b, u and V within 1e-8
    relative to their largest entry, against ``jax.grad``; for V the
    symmetric parts (G + G')/2: torch's Cholesky backward symmetrizes its
    gradient and JAX's does not, so the two differ by an antisymmetric
    matrix, which is orthogonal to every symmetric direction dV (both are
    gradients of the same map on symmetric V); dx*/dlambda against
    ``jax.jacfwd`` within 1e-8 relative;
  * the envelope identity grad_q qp_value = x* within 1e-10;
  * a failed instance in a batch: finite gradients, exactly zero on it;
  * ``torch.autograd.gradcheck`` of x*(q) (its own default tolerances,
    central differences through full re-solves).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssqp_tpu.solvers import diff as jd
from ssqp_tpu.types import Settings as JSettings
from ssqp_tpu.types import make_qp as jmake_qp
from ssqp_tpu_torch import Settings as TSettings
from ssqp_tpu_torch import make_qp
from ssqp_tpu_torch.parallel.batch import frontier_batch
from ssqp_tpu_torch.solvers import diff as td

N = 8


def _data(N=N, J=2, seed=0, tight=True):
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((N, N))
    V = H @ H.T / N + 0.5 * np.eye(N)
    mu = rng.uniform(0.0, 0.3, N)
    G = rng.standard_normal((J, N)) if J else None
    g = (np.abs(G).sum(axis=1) * 0.35) if J else None
    u = np.full(N, 3.0 / N if tight else 10.0)
    return dict(V=V, q=mu, G=G, g=g, u=u)


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


LEAVES = ("q", "b", "u", "V")


@pytest.fixture(scope="module")
def grads():
    """w'x* and its gradients in both packages at seed 3."""
    kw = _data(seed=3)
    Qj = jmake_qp(**kw)
    Qt = make_qp(**kw, device="cpu")
    w = np.random.default_rng(99).standard_normal(N)

    def loss_j(q, b, u, V):
        r = jd.solve_qp_diff(dataclasses.replace(Qj, q=q, b=b, u=u, V=V),
                             JSettings())
        return jnp.asarray(w) @ r.x, (r.x, r.lam, r.gamma, r.status, r.S)

    (vj, auxj), gj = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1, 2, 3), has_aux=True))(
        *(getattr(Qj, f) for f in LEAVES))

    leaves = {f: getattr(Qt, f).clone().requires_grad_(True) for f in LEAVES}
    r = td.solve_qp_diff(dataclasses.replace(Qt, **leaves), TSettings())
    vt = torch.tensor(w) @ r.x
    vt.backward()
    gt = [leaves[f].grad.numpy() for f in LEAVES]
    return dict(jax=(float(vj), [np.asarray(a) for a in auxj],
                     [np.asarray(g) for g in gj]),
                torch=(float(vt.detach()), r, gt))


def test_solution_and_duals_match_jax(grads):
    _, (xj, lamj, gamj, stj, Sj), _ = grads["jax"]
    _, r, _ = grads["torch"]
    assert int(r.status) == int(stj) > 0
    np.testing.assert_array_equal(r.S.numpy(), Sj)
    for a, b in ((r.x, xj), (r.lam, lamj), (r.gamma, gamj)):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0, atol=1e-9)


@pytest.mark.parametrize("i,leaf", list(enumerate(LEAVES)))
def test_gradients_match_jax(grads, i, leaf):
    vj, _, gj = grads["jax"]
    vt, _, gt = grads["torch"]
    assert abs(vt - vj) < 1e-9
    a, b = gt[i], gj[i]
    assert np.isfinite(a).all()
    if leaf == "V":
        a, b = (a + a.T) / 2, (b + b.T) / 2
    assert _rel(a, b) < 1e-8, (leaf, _rel(a, b))


def test_frontier_jacobian_matches_jacfwd():
    """dx*/dlambda on the L frontier at three points (J=0, seed 11)."""
    kw = _data(seed=11, J=0)
    mu = kw["q"]
    Qj = jmake_qp(**kw)
    Qt = make_qp(**kw, device="cpu")

    def alloc_j(lam):
        return jd.solve_qp_diff(dataclasses.replace(Qj, q=-lam * mu),
                                JSettings()).x

    jac = jax.jit(jax.jacfwd(alloc_j))
    for lam in (0.3, 0.7, 1.2):
        Jj = np.asarray(jac(jnp.asarray(lam)))

        def alloc_t(l):
            Qi = dataclasses.replace(Qt, q=-l * torch.tensor(mu))
            return td.solve_qp_diff(Qi, TSettings()).x

        Jt = torch.autograd.functional.jacobian(
            alloc_t, torch.tensor(lam, dtype=torch.float64)).numpy()
        assert np.abs(Jj).max() > 1e-3  # the point moves with lambda
        assert _rel(Jt, Jj) < 1e-8


def test_envelope_identity():
    """d(optimal value)/dq = x* (envelope theorem)."""
    Qt = make_qp(**_data(seed=1), device="cpu")
    q = Qt.q.clone().requires_grad_(True)
    Qi = dataclasses.replace(Qt, q=q)
    r = td.solve_qp_diff(Qi, TSettings())
    td.qp_value(Qi, r.x).backward()
    np.testing.assert_allclose(q.grad.numpy(), r.x.detach().numpy(),
                               rtol=0, atol=1e-10)


def test_failed_instance_gets_a_zero_gradient():
    """A batch of three frontier points whose middle instance is
    infeasible (its budget row asks for more than the box allows): status
    0 there, finite gradients everywhere, exactly zero on that instance."""
    kw = _data(seed=2, J=0)
    Qt = make_qp(**kw, device="cpu")
    Qb, shared = frontier_batch(Qt, [0.2, 0.5, 0.9])
    b = torch.tensor([[1.0], [50.0], [1.0]], dtype=torch.float64)
    q = Qb.q.clone().requires_grad_(True)
    b.requires_grad_(True)
    V = Qt.V.clone().requires_grad_(True)
    r = td.solve_qp_diff(dataclasses.replace(Qb, q=q, b=b, V=V), TSettings())
    assert r.status.tolist()[1] == 0 and (r.status[[0, 2]] > 0).all()
    (r.x ** 2).sum().backward()
    for t in (q, b, V):
        assert torch.isfinite(t.grad).all()
    assert (q.grad[1] == 0).all() and (b.grad[1] == 0).all()
    assert q.grad[0].abs().max() > 0
    # the solved instances' gradients are those of their own single solves
    for i in (0, 2):
        qi = Qb.q[i].clone().requires_grad_(True)
        ri = td.solve_qp_diff(dataclasses.replace(Qt, q=qi), TSettings())
        (ri.x ** 2).sum().backward()
        np.testing.assert_allclose(q.grad[i].numpy(), qi.grad.numpy(),
                                   rtol=0, atol=1e-12)


def test_gradcheck_one_instance():
    Qt = make_qp(**_data(seed=7), device="cpu")

    def xstar(q):
        return td.solve_qp_diff(dataclasses.replace(Qt, q=q), TSettings()).x

    q = Qt.q.clone().requires_grad_(True)
    assert torch.autograd.gradcheck(xstar, (q,))


def test_batched_diff_matches_single_solves():
    """A shared-V frontier batch: x and the gradient with respect to the
    shared V are the sums of the single solves'."""
    Qt = make_qp(**_data(seed=5, J=2), device="cpu")
    Qb, _ = frontier_batch(Qt, [0.1, 0.6, 1.5, 2.5])
    V = Qt.V.clone().requires_grad_(True)
    r = td.solve_qp_diff(dataclasses.replace(Qb, V=V), TSettings())
    assert (r.status > 0).all()
    td.qp_value(dataclasses.replace(Qb, V=V), r.x).sum().backward()
    gV = torch.zeros_like(V)
    for i in range(4):
        Vi = Qt.V.clone().requires_grad_(True)
        Qi = dataclasses.replace(Qt, q=Qb.q[i], V=Vi)
        ri = td.solve_qp_diff(Qi, TSettings())
        np.testing.assert_allclose(r.x[i].detach().numpy(),
                                   ri.x.detach().numpy(), rtol=0, atol=1e-12)
        td.qp_value(Qi, ri.x).backward()
        gV += Vi.grad
    np.testing.assert_allclose(V.grad.numpy(), gV.numpy(), rtol=0,
                               atol=1e-12)


def test_invalid_model_passes_the_solver_rejection_through():
    Qt = make_qp(np.eye(3), d=np.zeros(3), u=np.array([0.0, 1.0, 1.0]),
                 device="cpu")
    r = td.solve_qp_diff(Qt)
    assert Qt.mc <= 0 and int(r.status) == -1
