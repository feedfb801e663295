"""The port's sharded solves (ssqp_tpu_torch/parallel/sharded.py) in two
processes on the CPU: a ``torch.distributed`` gloo group of two ranks, each
solving its contiguous half of the batch with ``device="cpu"``.

Each worker writes its shard and the group-wide statistics; the test holds
them to a single-process port solve of the whole batch (the shard's slice:
status and S equal, x within 1e-9) and to the JAX package's
``solve_qp_batch`` / ``solve_lp_batch`` / ``solve_lp_batch_cclp`` on the
same data (status equal, x within 1e-9). Batches (float64, B=16): a
frontier-style QP (N=8, budget row, box, shared V, A, G, g, d, u; q and b
per instance, instance 3's budget unreachable, so one infeasible); a
config-2-style LP family (N=10, M=2, J=3, shared A, G, d, u; c, b, g per
instance) through the engines "auto", "simplex" and "cclp". The cclp
maximize guard needs no group. The workers import this module with JAX
blocked, so it imports JAX inside the tests only.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 16


def qp_data():
    rng = np.random.default_rng(7)
    N = 8
    H = rng.standard_normal((N, N))
    V = H @ H.T / N + 0.5 * np.eye(N)
    mu = rng.uniform(0.0, 0.2, N)
    q = -np.linspace(0.0, 2.0, B)[:, None] * mu[None, :]
    b = np.ones((B, 1))
    b[3] = 50.0  # more than the box 0 <= x <= 4/N allows
    return dict(V=V, u=np.full(N, 4.0 / N)), dict(q=q, b=b)


def lp_data():
    rng = np.random.default_rng(99)
    N, M, J = 10, 2, 3
    A = rng.standard_normal((M, N))
    G = rng.standard_normal((J, N))
    X0 = rng.uniform(0.1, 1.0, (B, N))
    c = rng.standard_normal((B, N))
    return (dict(A=A, G=G, d=np.zeros(N), u=np.full(N, 2.0)),
            dict(c=c, b=X0 @ A.T, g=X0 @ G.T + rng.uniform(0.1, 1.0, (B, J))))


QP_SHARED = ("V", "A", "G", "g", "d", "u")
LP_SHARED = ("A", "G", "d", "u")
ENGINES = ("auto", "simplex", "cclp")


def port_qp():
    from ssqp_tpu_torch import make_qp

    shared, batched = qp_data()
    Q = make_qp(shared["V"], np.zeros(8), u=shared["u"], device="cpu")
    return dataclasses.replace(Q, **{k: torch.tensor(v)
                                     for k, v in batched.items()})


def port_lp():
    from ssqp_tpu_torch import make_lp

    shared, batched = lp_data()
    P = make_lp(batched["c"][0], shared["A"], batched["b"][0], G=shared["G"],
                g=batched["g"][0], d=shared["d"], u=shared["u"], device="cpu")
    return dataclasses.replace(P, **{k: torch.tensor(v)
                                     for k, v in batched.items()})


_WORKER = textwrap.dedent(
    """
    import sys
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.modules["jax"] = None  # the port needs no JAX
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    import test_torch_sharded as T
    from ssqp_tpu_torch import Settings
    from ssqp_tpu_torch.parallel import sharded

    s = Settings()
    save = {}
    res, st = sharded.solve_qp_sharded(T.port_qp(), s, shared=T.QP_SHARED,
                                       device="cpu")
    save.update(qp_x=res.x.numpy(), qp_S=res.S.numpy(),
                qp_status=res.status.numpy(),
                qp_stats=[int(st[k]) for k in ("solved", "iters_max",
                                               "infeasible")])
    res2, _ = sharded.solve_qp_sharded_2d(T.port_qp(), s,
                                          shared=T.QP_SHARED, device="cpu")
    assert torch.equal(res2.x, res.x)
    for e in T.ENGINES:
        r, st = sharded.solve_lp_sharded(T.port_lp(), s, shared=T.LP_SHARED,
                                         engine=e, device="cpu")
        save.update({f"lp_{e}_x": r.x.numpy(), f"lp_{e}_status":
                     r.status.numpy(), f"lp_{e}_stats":
                     [int(st["solved"]), int(st["infeasible"])]})
    np.savez(f"{out}/rank{rank}.npz", **save)
    dist.destroy_process_group()
    print(f"worker {rank} ok", flush=True)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _references():
    """The single-process port solves and the JAX package's, computed in
    the test process while the workers run."""
    import jax.numpy as jnp

    from ssqp_tpu.parallel import batch as jb
    from ssqp_tpu.types import Settings as JSettings
    from ssqp_tpu.types import make_lp as jmake_lp
    from ssqp_tpu.types import make_qp as jmake_qp
    from ssqp_tpu_torch import Settings
    from ssqp_tpu_torch.parallel import batch as tb

    s = Settings()
    refs = {"qp": tb.solve_qp_batch_auto(port_qp(), s, QP_SHARED).numpy()}
    shared, batched = qp_data()
    Qj = jmake_qp(shared["V"], np.zeros(8), u=shared["u"])
    Qj = dataclasses.replace(Qj, **{k: jnp.asarray(v)
                                    for k, v in batched.items()})
    rj = jb.solve_qp_batch(Qj, JSettings(), shared=QP_SHARED)
    refs["qp_jax"] = (np.asarray(rj.x), np.asarray(rj.status))
    P = port_lp()
    shared, batched = lp_data()
    Pj = jmake_lp(batched["c"][0], shared["A"], batched["b"][0],
                  G=shared["G"], g=batched["g"][0], d=shared["d"],
                  u=shared["u"])
    Pj = dataclasses.replace(Pj, **{k: jnp.asarray(v)
                                    for k, v in batched.items()})
    for e in ENGINES:
        one = (tb.solve_lp_batch_cclp(P, s, shared=LP_SHARED)
               if e == "cclp" else
               tb.solve_lp_batch_auto(P, s, LP_SHARED) if e == "auto"
               else tb.solve_lp_batch(P, s, shared=LP_SHARED))
        jfn = jb.solve_lp_batch_cclp if e == "cclp" else jb.solve_lp_batch
        rj = jfn(Pj, JSettings(), shared=LP_SHARED)
        refs[e] = one.numpy()
        refs[e + "_jax"] = (np.asarray(rj.x), np.asarray(rj.status))
    return refs


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """(each rank's saved shard, the references)."""
    out = tmp_path_factory.mktemp("sharded")
    port = str(_free_port())
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO, os.path.join(_REPO, "tests"), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(i), port, str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for i in range(2)]
    outs = []
    try:
        refs = _references()
        for p in procs:
            o, _ = p.communicate(timeout=240)
            outs.append(o.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{o[-3000:]}"
        assert f"worker {i} ok" in o
    return [dict(np.load(out / f"rank{i}.npz")) for i in range(2)], refs


def _halves(a):
    return a[:B // 2], a[B // 2:]


def test_qp_shards_match_one_process_and_jax(shards):
    shards, refs = shards
    one, (xj, stj) = refs["qp"], refs["qp_jax"]
    st = one.status
    assert st[3] == 0 and (np.delete(st, 3) > 0).all()
    for r, sh in enumerate(shards):
        sl = slice(r * B // 2, (r + 1) * B // 2)
        np.testing.assert_array_equal(sh["qp_status"], st[sl])
        np.testing.assert_array_equal(sh["qp_status"], stj[sl])
        np.testing.assert_array_equal(sh["qp_S"], one.S[sl])
        np.testing.assert_allclose(sh["qp_x"], one.x[sl], rtol=0, atol=1e-9)
        np.testing.assert_allclose(sh["qp_x"], xj[sl], rtol=0, atol=1e-9)
        assert list(sh["qp_stats"]) == [B - 1, int(np.abs(st).max()), 1]


@pytest.mark.parametrize("engine", ENGINES)
def test_lp_shards_match_one_process_and_jax(shards, engine):
    shards, refs = shards
    one, (xj, stj) = refs[engine], refs[engine + "_jax"]
    st = one.status
    assert np.isin(st, (1, 2)).all()
    for r, sh in enumerate(shards):
        sl = slice(r * B // 2, (r + 1) * B // 2)
        np.testing.assert_array_equal(sh[f"lp_{engine}_status"], st[sl])
        np.testing.assert_array_equal(sh[f"lp_{engine}_status"], stj[sl])
        np.testing.assert_allclose(sh[f"lp_{engine}_x"], one.x[sl], rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(sh[f"lp_{engine}_x"], xj[sl], rtol=0,
                                   atol=1e-9)
        assert list(sh[f"lp_{engine}_stats"]) == [B, 0]


def test_guards_need_no_group():
    from ssqp_tpu_torch import Settings
    from ssqp_tpu_torch.parallel import sharded

    with pytest.raises(ValueError, match="only minimizes"):
        sharded.solve_lp_sharded(port_lp(), Settings(), engine="cclp",
                                 minimize=False, device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        sharded.solve_lp_sharded(port_lp(), Settings(), engine="dual",
                                 device="cpu")
