"""What a run may load: no module whose top-level name is jax, jaxlib,
flax or the JAX package ``ssqp_tpu`` (compared whole: the port's
``ssqp_tpu_torch`` begins with it), and a reference that loads nothing of
the program."""

import subprocess
import sys

from conftest import ROOT

REF = ROOT / "gpubench" / "reference"


def _python(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_run_path_loads_no_jax():
    code = (
        "import sys, time; sys.path.insert(0, 'gpubench/tests'); "
        "sys.path.insert(0, '.'); import conftest as c; "
        "from gpubench import core; "
        "b = core.load_json(c.ROOT / 'BENCHMARK.json'); "
        "[c.run_small(b, n, seconds=0.2) for n in c.SMALL]; "
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'ssqp_tpu', 'ssqp_tpu_torch'}))")
    assert _python(code) == "['ssqp_tpu_torch']"


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.'); "
            "import gpubench.reference.qp, gpubench.check; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('ssqp_tpu', 'ssqp_tpu_torch', 'jax')))")
    assert _python(code) == "[]"
    for f in REF.glob("*.py"):
        assert "ssqp_tpu" not in f.read_text(), f


def test_forbidden_names_compare_whole(monkeypatch):
    from gpubench import core

    for name in ("ssqp_tpu_torch", "ssqp_tpu_torch.ops", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys.modules[__name__])
    assert "ssqp_tpu" not in core.forbidden_modules()
    assert "jax" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ssqp_tpu.types", sys.modules[__name__])
    assert "ssqp_tpu" in core.forbidden_modules()


def test_run_refuses_without_a_card():
    """No CUDA device here: the command exits non-zero and prints no
    result line."""
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "ineq64-single",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
