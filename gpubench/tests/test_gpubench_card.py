"""On the card: one short run of every cell of ``BENCHMARK.json`` through
the benchmark's own command, its result line read back. Skips without a
CUDA device (decided inside the test)."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT, SEED


def _cells():
    return [w["name"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", _cells())
def test_cell_runs_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["attempted"] > 0
    assert list(res)[-1] == "checks"
