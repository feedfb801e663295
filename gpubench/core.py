"""Run one cell once: the harness behind ``run.py``.

Everything that belongs to one configuration, traffic mix, entry or metric
lives in a file of its own, found by the name that ``BENCHMARK.json`` and
the cell's JSON give it:

* ``workloads/<cell>.json``: the configuration, the traffic, the entry, the
  precision the cell states, the sample the check compares, the limits of
  the compared numbers, and why the cell exists;
* ``configs/<config>.json`` (its sizes and data seed) and
  ``configs/<config>.py`` (``build(cfg, dtype, device)``, the problem);
* ``traffic/<traffic>.json``: a traffic mix, the parameters of its kind,
  and ``traffic/<kind>.py``: ``Requests(spec, seed, problem, device)``
  makes request r from (seed, r) alone and gives each instance's parameter
  (``param(request)``); ``reference(problem, param)`` the float64 data and
  linear terms the reference solves for those instances;
* ``entries/<entry>.py``: ``run(problem, request, settings)`` calls the
  program, ``view(problem, request, out)`` names its outputs;
* ``metrics/<metric>.py``: ``read(ctx)`` returns the metric or None, and
  ``SPANS`` lists the spans it needs around the program's functions.

The loop is closed with one client: the next request goes out when the
last one has completed on the device.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from gpubench import check, problem, trace

HERE = Path(__file__).resolve().parent
TRACE_SECONDS = 8.0  # the longest traced window
FORBIDDEN = ("jax", "jaxlib", "flax", "ssqp_tpu")  # compared whole


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import a harness file by path (its name need not be an
    identifier)."""
    name = "gpubench._files." + "".join(
        c if c.isalnum() else "_" for c in str(path.resolve()))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the run may not load."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class Cell:
    """A cell's files, resolved by name under ``base`` (the benchmark's
    folder) with ``bench`` the parsed ``BENCHMARK.json``."""

    def __init__(self, name: str, bench: dict, base: Path = HERE,
                 overrides: dict = None):
        overrides = overrides or {}
        self.name, self.bench, self.base = name, bench, base
        self.spec = load_json(base / "workloads" / f"{name}.json")
        self.spec.update(overrides.get("cell", {}))
        cname = self.spec["config"]
        self.cfg = load_json(base / "configs" / f"{cname}.json")
        self.cfg.update(overrides.get("config", {}))
        self.builder = load_module(base / "configs" / f"{cname}.py")
        self.traffic = load_json(base / "traffic" /
                                 f"{self.spec['traffic']}.json")
        self.traffic.update(overrides.get("traffic", {}))
        self.kind = load_module(base / "traffic" /
                                f"{self.traffic['kind']}.py")
        self.entry = load_module(base / "entries" /
                                 f"{self.spec['entry']}.py")
        self.dtype = problem.DTYPES[self.spec["dtype"]]

    def metrics(self, kind: str) -> list:
        """The metrics of ``BENCHMARK.json``'s ``kind`` list that this cell
        reports: (the list's entry, its reader module)."""
        out = []
        for m in self.bench[kind]:
            if "workloads" in m and self.name not in m["workloads"]:
                continue
            out.append((m, load_module(self.base / "metrics" /
                                       f"{m['name']}.py")))
        return out


def _settings(dtype):
    from ssqp_tpu_torch import Settings

    return Settings.for_dtype(dtype)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prepare(cell: Cell, seed: int, device):
    """The configuration's problem, the program's settings for the cell's
    precision, and the requests of the seed."""
    p = cell.builder.build(cell.cfg, cell.dtype, device)
    return p, _settings(cell.dtype), cell.kind.Requests(cell.traffic, seed,
                                                        p, device)


def loop(cell: Cell, p, settings, traffic, seed: int, device,
         seconds: float = None, requests: int = None):
    """The closed loop: requests 0, 1, ... until ``seconds`` have passed
    (the request in flight completes) or ``requests`` are done. Keeps the
    sampled rows of each request's answers."""
    entry, sample = cell.entry, cell.spec["sample"]
    kept, lat = [], []
    attempted = 0
    unsolved = torch.zeros((), dtype=torch.int64, device=device)
    st_sum = torch.zeros((), dtype=torch.int64, device=device)
    t0 = time.perf_counter()
    r = 0
    while True:
        req = traffic.request(r)
        t_req = time.perf_counter()
        with record_function(trace.REQUEST):
            with record_function(trace.ENTRY):
                out = entry.run(p, req, settings)
            _sync(device)
        t_done = time.perf_counter()
        lat.append(t_done - t_req)
        v = dict(entry.view(p, req, out), param=traffic.param(req))
        n = v["x"].shape[0]
        attempted += n
        ok = v["status"] > 0
        unsolved += (~ok).sum()
        st_sum += torch.where(ok, v["status"], 0).sum()
        picks = np.random.default_rng([int(seed), r, 2]).choice(
            n, size=min(sample["per_request"], n), replace=False)
        kept.append(_take(v, torch.as_tensor(np.sort(picks), device=device)))
        r += 1
        if (requests is not None and r >= requests) or (
                seconds is not None and t_done - t0 >= seconds):
            break
    _sync(device)
    return types.SimpleNamespace(
        latencies_s=lat, attempted=attempted, unsolved=int(unsolved),
        s_iters_sum=int(st_sum), kept=kept, requests=r,
        window_s=time.perf_counter() - t0)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, log=None) -> dict:
    """One run of ``cell``: build, warm up, the closed loop for
    ``seconds``, then the check. Returns the result line as a dict."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    device = torch.device(device)
    p, settings, traffic = prepare(cell, seed, device)
    # warm-up: the window's own first requests through the whole loop, so
    # only its shapes, and every kernel the window launches is loaded
    loop(cell, p, settings, traffic, seed, device,
         requests=cell.spec.get("warm_requests", 2))
    setup_s = time.perf_counter() - t_start
    log(f"{cell.name}: set-up {setup_s:.3f} s on {device}")

    metrics = cell.metrics("per_layer" if traced else "end_to_end")
    spans = [sp for _, mod in metrics for sp in getattr(mod, "SPANS", ())]
    if traced:
        with trace.traced(spans, device.type == "cuda") as holder:
            w = loop(cell, p, settings, traffic, seed, device,
                     seconds=min(seconds, TRACE_SECONDS))
    else:
        holder = None
        w = loop(cell, p, settings, traffic, seed, device, seconds=seconds)
    solved = w.attempted - w.unsolved
    mem_peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
    log(f"{cell.name}: {w.requests} requests, {w.attempted} instances, "
        f"{w.unsolved} unsolved, window {w.window_s:.3f} s")

    ctx = types.SimpleNamespace(
        cell=cell.name, latencies_s=w.latencies_s, attempted=w.attempted,
        solved=solved, window_s=w.window_s, setup_s=setup_s,
        requests=w.requests, s_iters_sum=w.s_iters_sum,
        trace=holder.summary if holder else None)
    values = {}
    for m, mod in metrics:
        val = mod.read(ctx)
        if val is not None:
            values[m["name"]] = {"value": float(val), "unit": m["unit"]}

    # the check, once the window has closed; the reference runs after the
    # peak memory was read
    rows = sample_rows(w.kept, cell.spec["sample"]["max"], seed)
    w.kept = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    nums = check.numbers(p, *cell.kind.reference(p, rows["param"]), rows,
                         w.unsolved)
    correct, checks = check.judge(nums, cell.spec["limits"])

    result = {"correct": bool(correct), "attempted": w.attempted,
              "failed": w.unsolved, "metrics": values,
              "device": _device(device, mem_peak)}
    if holder is not None:
        s = holder.summary
        result["device"].update(busy_s=s.busy_s, window_s=s.window_s)
        result["breakdown"] = {
            "device_ops": [[k[:160], v] for k, v in s.device_ops],
            "idle_gaps": [[k[:160], v] for k, v in s.idle_gaps]}
    result["checks"] = checks
    return result


def _take(v: dict, idx: torch.Tensor) -> dict:
    """Copies of the picked rows of an entry's outputs."""
    return {k: t.index_select(0, idx).clone() for k, t in v.items()
            if t is not None}


def sample_rows(kept: list, cap: int, seed: int) -> dict:
    """Concatenate the kept rows and draw at most ``cap`` of them from the
    seed."""
    rows = {k: torch.cat([d[k] for d in kept]) for k in kept[0]}
    total = rows["x"].shape[0]
    if total > cap:
        pick = np.sort(np.random.default_rng([int(seed), 3]).choice(
            total, size=cap, replace=False))
        idx = torch.as_tensor(pick, device=rows["x"].device)
        rows = {k: v.index_select(0, idx) for k, v in rows.items()}
    return rows


def _device(device, mem_peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(mem_peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}
