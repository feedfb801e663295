"""The PyTorch port's L0 layer (ssqp_tpu_torch.types, utils.precision)
against the JAX package, plus the port's import hygiene.

Tolerance: construction is exact (the same numpy validation runs on both
sides), so leaves must be equal bit for bit."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from ssqp_tpu import types as jt
from ssqp_tpu_torch import types as tt
from ssqp_tpu_torch.utils.precision import highest_matmul

FIELDS = ("V", "A", "G", "q", "b", "g", "d", "u")
PORT = pathlib.Path(__file__).resolve().parents[1] / "ssqp_tpu_torch"


def _qp_cases():
    rng = np.random.default_rng(0)
    H = rng.standard_normal((5, 5))
    V = H @ H.T / 5 + 0.1 * np.eye(5)
    G = rng.standard_normal((2, 5))
    return {
        "portfolio": dict(V=V),
        "general": dict(V=V, q=rng.standard_normal(5), A=np.ones((1, 5)),
                        b=[1.0], G=G, g=[0.5, 0.7], d=-np.ones(5),
                        u=np.full(5, 2.0)),
        "reversed_bounds": dict(V=V, d=np.full(5, 1.0), u=np.zeros(5)),
        "degenerate_bounds": dict(V=V, d=np.zeros(5), u=np.r_[0.0, np.ones(4)]),
        "no_constraints": dict(V=V, d=np.full(5, -np.inf), u=np.full(5, np.inf)),
        "not_psd": dict(V=V - 2.0 * np.eye(5)),
        "asymmetric_V": dict(V=V + np.triu(np.ones((5, 5)), 1)),
        "float32": dict(V=V, q=rng.standard_normal(5), dtype=np.float32),
    }


@pytest.mark.parametrize("name", sorted(_qp_cases()))
def test_make_qp_matches_jax(name):
    kw = _qp_cases()[name]
    Qj = jt.make_qp(**kw)
    Qt = tt.make_qp(**kw, device="cpu")
    assert (Qt.N, Qt.M, Qt.J, Qt.mc) == (Qj.N, Qj.M, Qj.J, Qj.mc)
    for f in FIELDS:
        a, b = np.asarray(getattr(Qj, f)), getattr(Qt, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_mc_codes_of_the_cases():
    cases = _qp_cases()
    codes = {n: tt.make_qp(**cases[n], device="cpu").mc for n in cases}
    assert codes["degenerate_bounds"] == tt.MC_DEGENERATE_BOUNDS == -30
    assert codes["no_constraints"] == tt.MC_NO_CONSTRAINTS == -20
    assert codes["not_psd"] == tt.MC_NOT_PSD == -70
    assert codes["reversed_bounds"] == tt.MC_OK


def test_status_and_mc_constants_match():
    for name in ("IN", "DN", "UP", "OE", "EO", "MC_OK", "MC_INFEASIBLE",
                 "MC_NUMERICAL", "MC_REDUNDANT", "MC_NO_CONSTRAINTS",
                 "MC_DEGENERATE_BOUNDS", "MC_NOT_PSD"):
        assert getattr(tt, name) == getattr(jt, name), name


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_settings_for_dtype_matches_jax(dtype):
    sj = dataclasses.asdict(jt.Settings.for_dtype(dtype))
    st = dataclasses.asdict(tt.Settings.for_dtype(dtype))
    assert np.dtype(sj.pop("dtype")) == np.dtype(dtype)
    assert st.pop("dtype") == tt.as_torch_dtype(dtype)
    assert sj == st
    assert dataclasses.asdict(tt.Settings())["dtype"] == torch.float64


def test_from_numpy_and_result_numpy_round_trip():
    Qj = jt.make_qp(**_qp_cases()["general"])
    qb = np.stack([np.asarray(Qj.q) * s for s in (1.0, 2.0, 3.0)])
    Qt = tt.QP.from_numpy(*(qb if f == "q" else np.asarray(getattr(Qj, f))
                            for f in FIELDS), Qj.N, Qj.M, Qj.J, Qj.mc,
                          device="cpu")
    assert Qt.batch_size == 3 and Qt.is_batched("q")
    assert not any(Qt.is_batched(f) for f in FIELDS if f != "q")
    sub = Qt.take(torch.tensor([2, 0]))
    np.testing.assert_array_equal(sub.q.numpy(), qb[[2, 0]])
    assert sub.V is Qt.V  # shared leaves are not copied
    assert Qt.to("cpu").device == torch.device("cpu")
    r = tt.Result(torch.ones(3, 5), torch.zeros(3, 7, dtype=torch.int8),
                  torch.ones(3, dtype=torch.int32))
    rn = r.numpy()
    assert isinstance(rn.x, np.ndarray) and rn.lam is None
    assert rn.S.dtype == np.int8 and rn.status.dtype == np.int32


def test_entry_points_default_to_the_card(monkeypatch):
    """make_qp, QP.from_numpy, Result.from_numpy, Model, read_mps,
    solve_mps, warmup and the sharded solves build on CUDA unless told
    otherwise; without a card they raise, never fall back."""
    from ssqp_tpu_torch import Model
    from ssqp_tpu_torch.parallel import sharded
    from ssqp_tpu_torch.utils import aot, mps

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = _qp_cases()["general"]
    Qj = jt.make_qp(**kw)
    leaves = [np.asarray(getattr(Qj, f)) for f in FIELDS]
    Qb = tt.QP.from_numpy(*leaves[:3], leaves[3][None], *leaves[4:],
                          Qj.N, Qj.M, Qj.J, device="cpu")
    Pb = tt.make_lp(np.ones(3), G=np.ones((1, 3)), g=[1.0], device="cpu")
    Pb = tt.LP(Pb.c[None], *(getattr(Pb, f) for f in
                             ("A", "b", "G", "g", "d", "u")), 3, 0, 1)
    text = "NAME X\nROWS\n N OBJ\nCOLUMNS\n X1 OBJ 1.0\nENDATA\n"
    sh = tuple(f for f in FIELDS if f != "q")
    for build in (lambda: tt.make_qp(**kw),
                  lambda: tt.QP.from_numpy(*leaves, Qj.N, Qj.M, Qj.J),
                  lambda: tt.Result.from_numpy(np.zeros(5), np.zeros(7),
                                               np.int32(1)),
                  lambda: Model(),
                  lambda: mps.read_mps(text),
                  lambda: mps.solve_mps(text),
                  lambda: aot.warmup(),
                  lambda: sharded.solve_qp_sharded(Qb, tt.Settings(),
                                                   shared=sh),
                  lambda: sharded.solve_qp_sharded_2d(Qb, tt.Settings(),
                                                      shared=sh),
                  lambda: sharded.solve_lp_sharded(
                      Pb, tt.Settings(), shared=("A", "b", "G", "g", "d",
                                                 "u")),
                  lambda: sharded.shard_batch(Qb, shared=sh)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert tt.make_qp(**kw, device="cpu").device == torch.device("cpu")
    assert Model(device="cpu").device == torch.device("cpu")
    assert mps.read_mps(text, device="cpu").device == torch.device("cpu")


def test_result_from_numpy_carries_a_jax_result_across():
    rj = jt.Result(np.arange(6.0).reshape(2, 3),
                   np.array([[0, 1, 2, 3], [4, 0, 1, 2]], np.int8),
                   np.array([3, -1], np.int32), np.ones((2, 1)),
                   np.zeros((2, 3)))
    names = ("x", "S", "status", "lam", "gamma")
    rt = tt.Result.from_numpy(*(getattr(rj, n) for n in names), device="cpu")
    assert rt.S.dtype == torch.int8 and rt.status.dtype == torch.int32
    assert rt.x.dtype == torch.float64 and rt.x.device.type == "cpu"
    back = rt.numpy()
    for n in names:
        np.testing.assert_array_equal(getattr(back, n), getattr(rj, n))
    assert tt.Result.from_numpy(rj.x, rj.S, rj.status, device="cpu").lam \
        is None


def test_precision_guard_sets_and_restores():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    seen = {}

    @highest_matmul
    def probe():
        seen["mm"] = torch.backends.cuda.matmul.allow_tf32
        seen["dnn"] = torch.backends.cudnn.allow_tf32
        seen["prec"] = torch.get_float32_matmul_precision()

    try:
        probe()
        assert seen == {"mm": False, "dnn": False, "prec": "highest"}
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("highest")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_no_jax_package():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 10
    bad = [(p.name, m) for p in files for m in _imports(p)
           if m.split(".")[0] in ("jax", "jaxlib", "ssqp_tpu")]
    assert not bad, bad
    scripts = [PORT.parent / s for s in ("chip_smoke.py", "profile_port.py")]
    scripts += sorted((PORT.parent / "examples").glob("torch_*.py"))
    assert len(scripts) >= 8
    for script in scripts:
        assert not [m for m in _imports(script)
                    if m.split(".")[0] in ("jax", "jaxlib", "ssqp_tpu")], \
            script.name


def test_port_and_chip_smoke_import_with_jax_blocked():
    """Import every port module, chip_smoke.py and profile_port.py in a
    process where any import of jax or of the JAX package fails."""
    root = PORT.parent
    mods = sorted(".".join(p.relative_to(root).with_suffix("").parts)
                  for p in PORT.rglob("*.py"))
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'jaxlib', 'ssqp_tpu'): sys.modules[m] = None\n"
        f"for m in {mods!r}: importlib.import_module(m.removesuffix('.__init__'))\n"
        "import chip_smoke, profile_port\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ssqp_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok', len(" + repr(mods) + "))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
