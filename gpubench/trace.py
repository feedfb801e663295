"""Spans around calls into the program, and the reduction of a
``torch.profiler`` window to what the per-layer metrics read.

A span is a ``record_function`` range that a wrapper opens around every
call of one function of the program while a traced window runs; the
wrapper replaces the function in every loaded module of the program that
holds it, and is taken out again when the window closes. A call's device
time is that of the device operations whose launch lies inside the range,
whatever launches them. The profiler's records stay in memory: no trace
file is written.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import sys
import types
from collections import defaultdict
from typing import Callable, Optional

import numpy as np
import torch

PREFIX = "gpubench."
# the harness's own ranges: the traced window, each request (the entry call
# and the synchronisation that completes it) and each entry call alone
WINDOW, REQUEST, ENTRY = PREFIX + "window", PREFIX + "request", PREFIX + "entry"
# host calls that wait for the device
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")
PROGRAM = "ssqp_tpu_torch"


@dataclasses.dataclass(frozen=True)
class Span:
    """A range named ``PREFIX + name`` around ``module.attr``. With
    ``returns`` the function is a factory and the range goes around each
    call of the function it returns. ``record(args, kwargs)``, if given,
    keeps a value per call (in :attr:`Summary.calls`)."""

    name: str
    module: str
    attr: str
    returns: bool = False
    record: Optional[Callable] = None


class Spans:
    """Installs the wrappers of a set of spans; ``undo`` takes them out."""

    def __init__(self, spans):
        self.calls = defaultdict(list)
        self._undo = []
        for sp in spans:
            real = getattr(importlib.import_module(sp.module), sp.attr)
            wrapped = self._wrap(sp, real)
            for mod in list(sys.modules.values()):
                name = getattr(mod, "__name__", "") or ""
                if name.split(".")[0] != PROGRAM:
                    continue
                for key, val in list(vars(mod).items()):
                    if val is real:
                        setattr(mod, key, wrapped)
                        self._undo.append((mod, key, real))

    def _wrap(self, sp: Span, real):
        label = PREFIX + sp.name
        calls = self.calls[sp.name]

        def ranged(fn):
            @functools.wraps(fn)
            def inner(*a, **k):
                if sp.record is not None:
                    calls.append(sp.record(a, k))
                with torch.profiler.record_function(label):
                    return fn(*a, **k)
            return inner

        if not sp.returns:
            return ranged(real)

        @functools.wraps(real)
        def factory(*a, **k):
            return ranged(real(*a, **k))
        return factory

    def undo(self):
        for mod, key, real in reversed(self._undo):
            setattr(mod, key, real)
        self._undo.clear()


def _merge(iv):
    """Sorted, merged copy of (start, end) intervals as two arrays."""
    if not iv:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    iv = sorted(iv)
    starts, ends = [iv[0][0]], [iv[0][1]]
    for s, e in iv[1:]:
        if s <= ends[-1]:
            ends[-1] = max(ends[-1], e)
        else:
            starts.append(s)
            ends.append(e)
    return np.array(starts, np.int64), np.array(ends, np.int64)


def _inside(times, merged):
    """Boolean mask: which ``times`` fall inside the merged intervals."""
    starts, ends = merged
    if not len(starts):
        return np.zeros(len(times), bool)
    i = np.searchsorted(starts, times, side="right") - 1
    ok = i >= 0
    ok[ok] = times[ok] <= ends[i[ok]]
    return ok


@dataclasses.dataclass
class Summary:
    """A traced window reduced to what the metric readers take."""

    window_s: float
    busy_s: float
    requests: int
    host_s: dict  # span name -> merged host seconds of its ranges
    device_s: dict  # span name -> device seconds launched inside its ranges
    syncs: int  # host waits on the device inside entry calls
    calls: dict  # span name -> what Span.record kept, per call
    device_ops: list  # [(name, seconds)], most time first
    idle_gaps: list  # [(host op under the gap, seconds)], longest first


def summarize(prof, calls: dict, top: int = 10) -> Summary:
    """Reduce the profiler's in-memory records of one traced window."""
    from torch.autograd import DeviceType

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    ids, starts, ends, names = [], [], [], []
    ranges = defaultdict(list)
    dev = []  # (start, end, CUPTI correlation, linked frontend id, name)
    runtime = {}  # CUPTI correlation -> host start of the API call
    sync_t = []
    for e in prof.profiler.kineto_results.events():
        dt = e.device_type()
        name = e.name()
        if dt == cuda:
            # a range's projection onto the device's timeline is no work
            if not name.startswith(PREFIX):
                dev.append((e.start_ns(), e.end_ns(), e.correlation_id(),
                            e.linked_correlation_id(), name))
            continue
        if dt != cpu:
            continue
        if name.startswith("cu"):  # a CUDA runtime or driver API call
            runtime[e.correlation_id()] = e.start_ns()
            if name.split("_v")[0] in SYNCS:
                sync_t.append(e.start_ns())
            continue
        s = e.start_ns()
        ids.append(e.correlation_id())
        starts.append(s)
        ends.append(e.end_ns())
        names.append(name)
        if name.startswith(PREFIX):
            ranges[name].append((s, e.end_ns()))
    if not ranges[WINDOW]:
        raise RuntimeError("trace: the traced window left no record")
    w0, w1 = ranges[WINDOW][0]
    merged = {k: _merge(v) for k, v in ranges.items()}

    # each device operation's launch: the host call that launched it (by
    # CUPTI correlation), else the start of the frontend op it is linked to
    order = np.argsort(np.array(ids, np.int64), kind="stable")
    sid = np.array(ids, np.int64)[order]
    sstart = np.array(starts, np.int64)[order]
    d_start = np.array([d[0] for d in dev], np.int64)
    d_end = np.array([d[1] for d in dev], np.int64)
    launch = np.array([runtime.get(d[2], -1) for d in dev], np.int64)
    link = np.array([d[3] for d in dev], np.int64)
    if len(sid):
        j = np.clip(np.searchsorted(sid, link), 0, len(sid) - 1)
        linked = (launch < 0) & (link > 0) & (sid[j] == link)
        launch = np.where(linked, sstart[j], launch)
    found = launch >= 0
    dur = (d_end - d_start).astype(np.float64) / 1e9
    device_s, host_s = {}, {}
    for name, m in merged.items():
        key = name[len(PREFIX):]
        device_s[key] = float(dur[found & _inside(launch, m)].sum())
        host_s[key] = float((m[1] - m[0]).sum() / 1e9)
    syncs = int(_inside(np.array(sync_t, np.int64), merged.get(
        ENTRY, _merge([]))).sum())

    # busy: the union of device operations, clipped to the window
    clip = [(max(s, w0), min(e, w1)) for s, e in zip(d_start, d_end)
            if e > w0 and s < w1]
    bs, be = _merge(clip)
    busy_s = float((be - bs).sum() / 1e9)
    by_name = defaultdict(float)
    for (s, e, _, _, n), t in zip(dev, dur):
        if e > w0 and s < w1:
            by_name[n] += t
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    # idle gaps, each named by the innermost host op running at its middle
    # (the latest-started op that still runs then; up to 32 ops back)
    gap_s = np.concatenate([[w0], be]) if len(bs) else np.array([w0])
    gap_e = np.concatenate([bs, [w1]]) if len(bs) else np.array([w1])
    glen = (gap_e - gap_s).astype(np.float64) / 1e9
    mid = (gap_s + gap_e) // 2
    fo = np.argsort(np.array(starts, np.int64), kind="stable")
    fs = np.array(starts, np.int64)[fo]
    fe = np.array(ends, np.int64)[fo]
    uniq, name_id = np.unique(np.array(names, dtype=object)[fo],
                              return_inverse=True) if len(fo) else ([], [])
    label = np.full(len(mid), -1, np.int64)
    i = np.searchsorted(fs, mid, side="right") - 1
    for k in range(32):
        j = i - k
        hit = (label < 0) & (j >= 0)
        hit[hit] = fe[j[hit]] >= mid[hit]
        label[hit] = np.asarray(name_id)[j[hit]]
    sums = np.bincount(label + 1, weights=glen, minlength=len(uniq) + 1)
    labels = ["(host between ops)"] + list(uniq)
    idle = sorted(((labels[k], float(t)) for k, t in enumerate(sums) if t > 0),
                  key=lambda kv: -kv[1])[:top]
    return Summary(window_s=(w1 - w0) / 1e9, busy_s=busy_s,
                   requests=len(ranges[REQUEST]), host_s=host_s,
                   device_s=device_s, syncs=syncs, calls=dict(calls),
                   device_ops=device_ops, idle_gaps=idle)


@contextlib.contextmanager
def traced(spans, on_cuda: bool):
    """Profile the block with the spans installed; yields a holder whose
    ``summary`` is set once the block has closed."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda
                                     else [])
    holder = types.SimpleNamespace(summary=None)
    installed = Spans(spans)
    try:
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                yield holder
    finally:
        installed.undo()
    holder.summary = summarize(prof, installed.calls)

