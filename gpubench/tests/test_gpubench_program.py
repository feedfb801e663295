"""What the program records about itself (gpubench/program.py and the four
metrics that read it): its ``ssqp.`` ranges reduced from made-up profiler
records, the idle gaps named by the innermost program range, the accepted
reduction (trace.summarize) unchanged in every field that a metric reads,
and the readers, which return None where the program records nothing."""

import types

import pytest

from gpubench import core, program, trace
from test_gpubench_trace import CPU, CUDA, Ev, _prof

MS = 1_000_000


def _window(extra):
    """A traced window of 100 ms: one request, its entry call 0..80 ms, a
    kernel launched at 1 ms (2..4 ms) and one at 70 ms (70..72 ms)."""
    return [
        Ev("gpubench.window", CPU, 0, 100 * MS, corr=1),
        Ev("gpubench.request", CPU, 0, 90 * MS, corr=2),
        Ev("gpubench.entry", CPU, 0, 80 * MS, corr=3),
        Ev("aten::mm", CPU, 1 * MS, 2 * MS, corr=4),
        Ev("gemm", CUDA, 2 * MS, 4 * MS, corr=100, linked=4),
        Ev("cudaLaunchKernel", CPU, 70 * MS, 70 * MS + 10, corr=101),
        Ev("cg_rows_kernel", CUDA, 70 * MS, 72 * MS, corr=101),
    ] + extra


def _trip():
    """An S-loop trip 5..60 ms holding 120 short host ops (5.1..17 ms),
    its nonzero's wait, then a ctypes launch inside a cg_kernel range."""
    ops = [Ev(f"aten::op{i}", CPU, 5 * MS + 100_000 * (i + 1),
              5 * MS + 100_000 * (i + 1) + 50_000, corr=10 + i)
           for i in range(120)]
    return [Ev("ssqp.s_loop_trip", CPU, 5 * MS, 60 * MS, corr=5),
            Ev("ssqp.cg_kernel", CPU, 69 * MS, 71 * MS, corr=6)] + ops


def test_program_ranges_count_host_and_device_time():
    prof = _prof(_window(_trip() + [
        Ev("ssqp.s_loop_trip", CPU, 61 * MS, 62 * MS, corr=7)]))
    got = program.program_ranges(prof)
    assert got["s_loop_trip"] == {"count": 2, "host_s": pytest.approx(0.056),
                                  "device_s": 0.0}
    assert got["cg_kernel"] == {"count": 1, "host_s": pytest.approx(0.002),
                                "device_s": pytest.approx(0.002)}


def test_gap_deep_in_a_range_goes_under_it():
    """The gap 4..70 ms has its middle (37 ms) 120 ops into the trip, past
    the 32 ops the accepted naming searches: the interval search still
    finds the trip."""
    gaps = dict(program.idle_gaps_by_span(_prof(_window(_trip()))))
    assert gaps["s_loop_trip"] == pytest.approx(0.066)
    # 0..2 ms: before any program range; 72..100 ms: past the entry call
    assert gaps[program.OUTSIDE] == pytest.approx(0.002)
    assert len(gaps) == 2


def test_accepted_reduction_reads_the_same():
    """The program's ranges are host ranges with no projection onto the
    device timeline: every field a metric reads is equal with and without
    them, and the idle gaps keep their total."""
    bare = trace.summarize(_prof(_window([])), {})
    ops = [e for e in _trip() if not e.name().startswith("ssqp.")]
    plain = trace.summarize(_prof(_window(ops)), {})
    full = trace.summarize(_prof(_window(_trip())), {})
    for f in ("window_s", "busy_s", "requests", "host_s", "device_s",
              "syncs", "calls", "device_ops"):
        assert getattr(full, f) == getattr(plain, f) == getattr(bare, f), f
    assert sum(t for _, t in full.idle_gaps) == pytest.approx(
        sum(t for _, t in plain.idle_gaps))


def _reader(name):
    return core.load_module(core.HERE / "metrics" / f"{name}.py")


NEW = ("cg_roofline_pct", "loop_trips_per_request",
       "pdas_rounds_per_instance", "phase1_fallback_pct")


@pytest.mark.parametrize("name", NEW)
def test_reader_is_silent_without_program_records(monkeypatch, name):
    t = types.SimpleNamespace(requests=3, device_s={"cg": 0.5})
    ctx = types.SimpleNamespace(trace=t, attempted=12)
    monkeypatch.setattr(program, "registry", lambda: {})
    assert _reader(name).read(ctx) is None
    monkeypatch.setattr(program, "registry", lambda: {"s_loop_trip": 1})
    assert _reader(name).read(types.SimpleNamespace(
        trace=None, attempted=12)) is None


def test_readers_on_made_up_counters(monkeypatch):
    key32 = (4096, 256, "float32", True, "tensor-core")
    key64 = (512, 1024, "float64", True, "cuda-core")
    rec32 = {"launches": 2, "matrices": 2, "row_steps": 4096 * 40}
    rec64 = {"launches": 1, "matrices": 1, "row_steps": 512 * 64}
    c = {"s_loop_trip": 30, "pdas_round": 12, "pdas.instance_rounds": 48,
         "phase1.fallback_instances": 3,
         "cg.launches": {key32: rec32, key64: rec64}}
    monkeypatch.setattr(program, "registry", lambda: c)
    # 3xTF32: 6 N^2 per row-step at 495 TFLOP/s, 12 N at 67; float64 at 67
    t32 = 4096 * 40 * (6 * 256**2 / 495e12 + 12 * 256 / 67e12)
    t64 = 512 * 64 * (2 * 1024**2 + 12 * 1024) / 67e12
    assert program.cg_least_s(key32, rec32) == pytest.approx(t32)
    assert program.cg_least_s(key64, rec64) == pytest.approx(t64)
    t = types.SimpleNamespace(requests=3, device_s={"cg": 10 * (t32 + t64)})
    ctx = types.SimpleNamespace(trace=t, attempted=12)
    assert _reader("cg_roofline_pct").read(ctx) == pytest.approx(10.0)
    assert _reader("loop_trips_per_request").read(ctx) == pytest.approx(14)
    assert _reader("pdas_rounds_per_instance").read(ctx) == pytest.approx(4)
    assert _reader("phase1_fallback_pct").read(ctx) == pytest.approx(25.0)
    # the bytes bound a launch of rows that ran no step
    idle = {"launches": 1, "matrices": 1, "row_steps": 0}
    assert program.cg_least_s(key32, idle) == pytest.approx(
        4 * (256**2 + 5 * 4096 * 256 + 2 * 4096) / 3.35e12)


def test_traced_cpu_run_reports_the_program_metrics(bench):
    from conftest import run_small

    from ssqp_tpu_torch.utils import diagnostics

    diagnostics.clear_counters()
    res = run_small(bench, "ineq64-batch256", traced=True)
    got = res["metrics"]
    assert res["correct"]
    for name in NEW[1:]:
        assert name in got, name
    assert got["loop_trips_per_request"]["value"] >= 2
    assert got["phase1_fallback_pct"]["value"] == 0.0
    assert "cg_roofline_pct" not in got  # a CPU tensor launches no kernel
