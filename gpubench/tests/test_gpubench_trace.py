"""The reduction of a traced window (trace.summarize) on a made-up set of
profiler records: device time is attributed to a span by where its launch
lies, the ranges' own projections onto the device timeline are not work,
host waits count only inside entry calls, and idle gaps are named by the
host op running under them."""

import types

import pytest
from torch.autograd import DeviceType

from gpubench import trace


class Ev:
    def __init__(self, name, dev, start, end, corr=0, linked=0):
        self._v = (name, dev, start, end, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def _prof(events):
    res = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=res))


def test_summarize_attributes_by_launch():
    ms = 1_000_000
    ev = [
        Ev("gpubench.window", CPU, 0, 100 * ms, corr=1),
        Ev("gpubench.request", CPU, 0, 60 * ms, corr=2),
        Ev("gpubench.entry", CPU, 0, 50 * ms, corr=3),
        Ev("aten::mm", CPU, 1 * ms, 2 * ms, corr=4),
        Ev("gpubench.cg", CPU, 10 * ms, 30 * ms, corr=5),
        Ev("aten::clone", CPU, 11 * ms, 13 * ms, corr=6),
        Ev("aten::item", CPU, 40 * ms, 45 * ms, corr=7),
        # runtime calls on the host: one wait inside the entry, one after
        Ev("cudaStreamSynchronize", CPU, 41 * ms, 44 * ms, corr=90,
           linked=7),
        Ev("cudaDeviceSynchronize", CPU, 51 * ms, 59 * ms, corr=91,
           linked=2),
        # device work: 2 ms launched by aten::mm, 10 ms inside the cg span
        # (one kernel launched by the span itself, one by an op inside it)
        Ev("gemm", CUDA, 2 * ms, 4 * ms, corr=100, linked=4),
        # a kernel launched through ctypes: no linked op, only the launch
        Ev("cudaLaunchKernel", CPU, 21 * ms, 22 * ms, corr=101),
        Ev("cg_rows_tc_kernel", CUDA, 20 * ms, 28 * ms, corr=101),
        Ev("copy", CUDA, 28 * ms, 30 * ms, corr=102, linked=6),
        # the cg range's projection onto the device timeline
        Ev("gpubench.cg", CUDA, 20 * ms, 30 * ms, linked=5),
    ]
    s = trace.summarize(_prof(ev), {"cg": []})
    assert s.window_s == pytest.approx(0.1)
    assert s.busy_s == pytest.approx(0.012)
    assert s.requests == 1
    assert s.device_s["cg"] == pytest.approx(0.010)
    assert s.device_s["entry"] == pytest.approx(0.012)
    assert s.host_s["cg"] == pytest.approx(0.020)
    assert s.syncs == 1
    names = [n for n, _ in s.device_ops]
    assert "gpubench.cg" not in names and names[0] == "cg_rows_tc_kernel"
    gaps = dict(s.idle_gaps)
    assert gaps == pytest.approx({
        "gpubench.window": 0.070,  # 30..100 ms: past the request's end
        "aten::clone": 0.016,  # 4..20 ms: the host in aten::clone at 12
        "aten::mm": 0.002})  # 0..2 ms
