"""The port's warm L-sweep in float32 against the JAX package's on the CPU:
the budget row and the objective at the grid's own values, with the checks
and the problem of test_torch_frontier_f32.py."""

from test_torch_frontier_f32 import check_sweep, market  # noqa: F401 (fixture)


def test_f32_warm_sweep_rows_and_grid_gap(market, monkeypatch):
    check_sweep(market, "warm", monkeypatch)
