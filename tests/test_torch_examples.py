"""The six examples of the PyTorch/CUDA port (examples/torch_*.py, the
twins of examples/*.py): each one's ``main()`` run on the CPU (``--cpu``)
at the example's own size, with what it prints checked against what the
example claims. The examples import nothing of JAX (also checked by
tests/test_torch_types.py)."""

import importlib.util
import pathlib

import numpy as np
import pytest

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
NAMES = ("portfolio", "frontier_sweep", "lp_grid", "mps_workflow",
         "differentiable", "accuracy_tiers")


def run(name):
    path = EXAMPLES / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(["--cpu"])


@pytest.mark.parametrize("name", NAMES)
def test_example_runs_on_the_cpu(name, capsys):
    out = run(name)
    printed = capsys.readouterr().out
    assert printed.strip()
    if name == "portfolio":
        assert out["status"] > 0 and out["model"] == "OPTIMAL"
        assert out["refined_err"] < 1e-9
    elif name == "frontier_sweep":
        assert out == {k: 256 for k in ("batched cold", "warm walk",
                                        "wave-warm", "sharded")}
    elif name == "lp_grid":
        assert out["plain"] == out["waves"] == out["B"]
        assert out["max_diff"] < 1e-3
    elif name == "mps_workflow":
        assert {k: v[0] for k, v in out.items()} == {
            "simple_lp": "OPTIMAL", "simple_qp": "OPTIMAL",
            "bounds_ranges": "OPTIMAL"}
        np.testing.assert_allclose(out["simple_lp"][1], -8.0, atol=1e-6)
    elif name == "differentiable":
        assert out["fd_err"] < 2e-2
        np.testing.assert_allclose(*out["shadow"], rtol=1e-3)
        assert abs(out["lam"] - 1.3) < 1e-2 and out["loss"] < 1e-6
    else:  # accuracy_tiers: each tier at least as close as float64 needs
        assert out["refined"] < 1e-12 and out["f64"] < 1e-12
        assert out["dd"] < 1e-20
