"""The port's MPS reader and writer (ssqp_tpu_torch/utils/mps.py) and its
diagnostics (ssqp_tpu_torch/utils/diagnostics.py: ``kkt_report``,
``trace``) against the JAX package on the CPU in float64.

  * ``read_mps`` on every file of tests/data (and on raw text, bytes, gzip
    and the MIP markers): the assembled problem's arrays identical to the
    JAX reader's;
  * ``write_mps``: byte-identical text to the JAX writer's, for the
    fixtures and for tests/test_mps.py's all-features model, and an exact
    read-back;
  * ``solve_mps`` on the fixtures: the same status strings, objective and x
    within 1e-9 of the JAX package's and the fixture's optimum within 1e-7;
  * ``kkt_report`` single and batched (shared leaves on the port's side,
    stacked ones on the JAX side) within 1e-12 of the JAX package's;
  * ``trace`` writes a non-empty Chrome trace file.
"""

import gzip
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ssqp_tpu.model import Model as JModel
from ssqp_tpu.types import Result as JResult
from ssqp_tpu.types import make_qp as jmake_qp
from ssqp_tpu.utils import diagnostics as jdiag
from ssqp_tpu.utils import mps as jmps
from ssqp_tpu_torch import LP, QP, Model, Result, make_qp
from ssqp_tpu_torch.parallel.batch import frontier_batch, solve_qp_batch
from ssqp_tpu_torch.types import Settings
from ssqp_tpu_torch.utils import diagnostics as tdiag
from ssqp_tpu_torch.utils import mps as tmps

DATA = os.path.join(os.path.dirname(__file__), "data")
FILES = ("simple_lp.mps", "bounds_ranges.mps", "simple_qp.mps",
         "simple_qp.mps.gz")
FIELDS = {QP: ("V", "A", "G", "q", "b", "g", "d", "u"),
          LP: ("c", "A", "b", "G", "g", "d", "u")}
KW = dict(dtype=np.float64, device="cpu")


def same_problem(mt, mj):
    Pt, Pj = mt.to_problem(), mj.to_problem()
    assert type(Pt).__name__ == type(Pj).__name__
    assert (Pt.N, Pt.M, Pt.J, Pt.mc) == (Pj.N, Pj.M, Pj.J, Pj.mc)
    for f in FIELDS[type(Pt)]:
        np.testing.assert_array_equal(getattr(Pt, f).numpy(),
                                      np.asarray(getattr(Pj, f)))
    assert (mt._sense, mt._f0, mt.relaxed_integers) == (
        mj._sense, mj._f0, mj.relaxed_integers)


@pytest.mark.parametrize("name", FILES)
def test_read_mps_gives_identical_arrays(name):
    path = os.path.join(DATA, name)
    same_problem(tmps.read_mps(path, **KW), jmps.read_mps(path))
    if not name.endswith(".gz"):
        text = open(path).read()
        same_problem(tmps.read_mps(text, **KW), jmps.read_mps(text))
        with open(path, "rb") as fh:
            same_problem(tmps.read_mps(fh, **KW), jmps.read_mps(path))
    else:
        raw = open(path, "rb").read()
        same_problem(tmps.read_mps(raw, **KW), jmps.read_mps(raw))


def test_read_mps_markers_sense_and_errors():
    mip = ("NAME MIP\nOBJSENSE\n    MAX\nROWS\n N  OBJ\n G  R1\nCOLUMNS\n"
           "    M1        'MARKER'   'INTORG'\n"
           "    X1        OBJ       1.0   R1   1.0\n"
           "    M2        'MARKER'   'INTEND'\nRHS\n    RHS  R1  2.0\n"
           "BOUNDS\n UP BND X1 4.0\nENDATA\n")
    with pytest.raises(ValueError, match="relax_integers"):
        tmps.read_mps(mip, **KW)
    with pytest.warns(UserWarning, match="relaxed to continuous"):
        mt = tmps.read_mps(mip, relax_integers=True, **KW)
    with pytest.warns(UserWarning):
        mj = jmps.read_mps(mip, relax_integers=True)
    same_problem(mt, mj)
    with pytest.raises(ValueError):
        tmps.read_mps("NAME X\nSOS\n S1 SET 1\nENDATA\n", **KW)


def _all_features(M):
    """tests/test_mps.py's all-features model."""
    rng = np.random.default_rng(3)
    m = M()
    m.add_variable(0.0, np.inf)
    m.add_variable(-np.inf, np.inf)
    m.add_variable(0.25, 0.25)
    m.add_variable(-np.inf, 1.0 / 3.0)
    m.add_variable(0.0, -0.5)
    m.add_variable(np.pi, np.inf)
    m.add_variable(-2.5, 7.125)
    n = m.n
    m.add_eq(rng.standard_normal(n), 1.75)
    m.add_le(rng.standard_normal(n), -0.125)
    m.add_ge(rng.standard_normal(n), 0.5)
    m.add_interval(rng.standard_normal(n), -1.0, 2.0)
    quad = {(i, i): 1.0 + i for i in range(n)}
    quad[(0, 1)] = 0.7
    quad[(1, 0)] = 0.1
    m.set_objective(quad=quad, lin=rng.standard_normal(n), constant=3.25,
                    sense="max")
    return m


def test_write_mps_is_byte_identical(tmp_path):
    pairs = [(tmps.read_mps(os.path.join(DATA, f), **KW),
              jmps.read_mps(os.path.join(DATA, f))) for f in FILES]
    pairs.append((_all_features(lambda: Model(**KW)),
                  _all_features(lambda: JModel(dtype=np.float64))))
    for mt, mj in pairs:
        text = tmps.write_mps(mt, name="RT")
        assert text == jmps.write_mps(mj, name="RT")
        same_problem(tmps.read_mps(text, **KW), mj)  # exact read-back
    gz = tmp_path / "rt.mps.gz"
    text = tmps.write_mps(pairs[-1][0], path=gz)
    assert gzip.open(gz, "rt").read() == text
    same_problem(tmps.read_mps(gz, **KW), pairs[-1][1])


@pytest.mark.parametrize("name,f_opt", [("simple_lp.mps", -8.0),
                                        ("bounds_ranges.mps", 1.0),
                                        ("simple_qp.mps.gz", -9.0)])
def test_solve_mps_matches_jax(name, f_opt):
    path = os.path.join(DATA, name)
    mj = jmps.solve_mps(path)
    s = Settings(max_iter=333)
    mt = tmps.solve_mps(path, settings=s, **KW)
    assert mt.settings is None  # the settings were for this solve only
    assert mt.termination_status() == mj.termination_status() == "OPTIMAL"
    assert abs(mt.objective_value() - mj.objective_value()) < 1e-9
    assert abs(mt.objective_value() - f_opt) < 1e-7
    np.testing.assert_allclose(mt.values(), mj.values(), rtol=0, atol=1e-9)


def _ineq_problem():
    rng = np.random.default_rng(4)
    N, J = 10, 4
    H = rng.standard_normal((N, N))
    V = H @ H.T / N + 0.5 * np.eye(N)
    G = rng.standard_normal((J, N))
    x0 = np.full(N, 1.0 / N)
    return dict(V=V, q=rng.standard_normal(N), G=G, g=G @ x0 + 0.05,
                u=np.full(N, 0.3))


def test_kkt_report_matches_jax():
    """Single and batched reports on a solved problem with inequality rows
    and attached duals, and on a wrongly pinned vertex."""
    kw = _ineq_problem()
    Qt = make_qp(**kw, device="cpu")
    Qj = jmake_qp(**kw)
    Qb, shared = frontier_batch(Qt, [0.5, 1.0, 2.0])
    rb = solve_qp_batch(Qb, Settings(), shared=shared)
    assert (rb.status > 0).all()
    bad = rb.S.clone()
    bad[1, :3] = 2  # three coordinates pinned at their upper bound
    rb = Result(rb.x, bad, rb.status, rb.lam, rb.gamma)
    rep_t = tdiag.kkt_report(Qb, rb, batched=True)
    Qjb = jax.tree.map(lambda a: jnp.stack([a] * 3), Qj)
    Qjb = type(Qjb)(*(getattr(Qjb, f) for f in ("V", "A", "G")),
                    jnp.asarray(Qb.q.numpy()),
                    *(getattr(Qjb, f) for f in ("b", "g", "d", "u")),
                    Qj.N, Qj.M, Qj.J, Qj.mc)
    rj = JResult(*(jnp.asarray(t.numpy()) for t in (rb.x, rb.S, rb.status,
                                                    rb.lam, rb.gamma)))
    rep_j = jdiag.kkt_report(Qjb, rj, batched=True)
    for a, b in zip(rep_t, rep_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)
    assert float(rep_t.stationarity[1]) > 1e-3  # the wrong pins show
    assert float(rep_t.stationarity[0]) < 1e-8
    # one problem, unbatched leaves
    Q0 = type(Qt)(**{**Qt.leaves(), "q": Qb.q[0]}, N=Qt.N, M=Qt.M, J=Qt.J)
    r0 = Result(rb.x[0], rb.S[0], rb.status[0], rb.lam[0], rb.gamma[0])
    one = tdiag.kkt_report(Q0, r0)
    for a, b in zip(one, rep_t):
        assert a.shape == () and abs(float(a) - float(b[0])) < 1e-12


def test_trace_writes_a_chrome_trace(tmp_path):
    Qt = make_qp(**_ineq_problem(), device="cpu")
    Qb, shared = frontier_batch(Qt, [0.5, 1.0])
    with tdiag.trace(str(tmp_path / "tr")):
        solve_qp_batch(Qb, Settings(), shared=shared)
    files = list((tmp_path / "tr").iterdir())
    assert len(files) == 1 and files[0].stat().st_size > 0
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("solve" in str(e.get("name", "")) or e.get("cat") == "cpu_op"
               for e in events)
