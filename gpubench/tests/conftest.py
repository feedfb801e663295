"""Shared pieces of the benchmark's CPU tests: each cell cut to a size a
CPU test run holds (widths kept in proportion where the check needs them,
N=64 so the float32 program keeps the configuration's 1e-6 objective gap)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL = {
    "frontier-waves8192": {"config": {"N": 64}, "traffic": {"points": 128}},
    "ineq64-batch256": {"config": {"N": 64, "M": 3, "J": 12},
                        "traffic": {"batch": 16}},
    "ineq64-single": {"config": {"N": 64, "M": 3, "J": 12}},
}
SEED = 2**31 + 977  # above 32 signed bits, as a checking run's seeds may be


@pytest.fixture(scope="session")
def bench():
    from gpubench import core

    return core.load_json(ROOT / "BENCHMARK.json")


def run_small(bench, name, seconds=0.5, traced=False, base=None,
              overrides=None, seed=SEED):
    """One CPU run of a cell at its small size."""
    import time

    from gpubench import core

    ov = dict(SMALL.get(name, {}))
    ov.update(overrides or {})
    kw = {"base": base} if base is not None else {}
    cell = core.Cell(name, bench, overrides=ov, **kw)
    return core.run_cell(cell, seed, seconds, traced, "cpu",
                         time.perf_counter(), log=lambda m: None)
