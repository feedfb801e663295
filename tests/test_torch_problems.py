"""The port's problem library (ssqp_tpu_torch/utils/problems.py) against the
JAX package's (ssqp_tpu/utils/problems.py): the same names, the same arrays
for the same seeds (bit for bit), and the KKT-residual oracle within 1e-12.
Both modules are numpy; nothing here compiles JAX code.
"""

import dataclasses

import numpy as np
import pytest

from ssqp_tpu.utils import problems as jp
from ssqp_tpu_torch.utils import problems as tp

SEEDS = range(5)
SHAPES = [dict(), dict(N=8, M=2, J=2), dict(N=24, M=1, J=0, n_dn=5, n_up=3,
                                           j_act=0),
          dict(N=16, M=0, J=6, j_act=3, ridge=0.1)]


def test_same_names():
    public = lambda m: {n for n in vars(m) if not n.startswith("_")
                        and getattr(vars(m)[n], "__module__", m.__name__)
                        == m.__name__}
    assert public(jp) == public(tp)


@pytest.mark.parametrize("kw", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_generate_qp_known_opt_equal(seed, kw):
    a = jp.generate_qp_known_opt(seed, **kw)
    b = tp.generate_qp_known_opt(seed, **kw)
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(vb, va, err_msg=f.name)
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("seed", SEEDS)
def test_kkt_residual_agrees(seed):
    """At the constructed optimum (residual ~0) and at a perturbed point
    (residual of order 1), with and without equality rows."""
    g = jp.generate_qp_known_opt(seed, N=12, M=2, J=3)
    args = (g.V, g.q, g.A, g.b, g.G, g.g, g.d, g.u)
    rng = np.random.default_rng(100 + seed)
    for x in (g.x_opt, g.x_opt + 0.1 * rng.standard_normal(12)):
        ra, rb = jp.kkt_residual(*args, x), tp.kkt_residual(*args, x)
        assert ra.keys() == rb.keys()
        for k in ra:
            np.testing.assert_allclose(rb[k], ra[k], rtol=0, atol=1e-12,
                                       err_msg=k)
    assert tp.kkt_residual(*args, g.x_opt)["max"] < 1e-9


@pytest.mark.parametrize("budget", [1.0, 0.6])
@pytest.mark.parametrize("seed", SEEDS)
def test_portfolio_start_equal(seed, budget):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.0, 0.02, 20)
    u = d + rng.uniform(0.05, 0.2, 20)
    za, Sa = jp.portfolio_start(d, u, budget)
    zb, Sb = tp.portfolio_start(d, u, budget)
    np.testing.assert_array_equal(zb, za)
    np.testing.assert_array_equal(Sb, Sa)
    assert Sb.dtype == Sa.dtype


def test_portfolio_start_rejects_what_the_jax_module_rejects():
    for d, u in ((np.full(4, 0.5), np.ones(4)),    # lower bounds above 1
                 (np.zeros(4), np.full(4, 0.2))):  # upper bounds below 1
        with pytest.raises(ValueError):
            jp.portfolio_start(d, u)
        with pytest.raises(ValueError):
            tp.portfolio_start(d, u)


def test_reference_datasets_bit_for_bit():
    for a, b in zip(jp.ungil_like(), tp.ungil_like()):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b, a)
    for kw in (dict(), dict(N=40, T=60, seed=3)):
        for a, b in zip(jp.sp500_like(**kw), tp.sp500_like(**kw)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(b, a)
