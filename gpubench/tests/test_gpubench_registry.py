"""A configuration, a traffic mix, a cell and a metric added as files
only: the harness finds each by its name, and no file it had changes."""

import json
import shutil

from conftest import ROOT, run_small


def test_new_files_only(tmp_path):
    base = tmp_path / "gpubench"
    shutil.copytree(ROOT / "gpubench", base,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    # a configuration: the frontier at another width, its sizes and builder
    cfg = json.loads((base / "configs" / "frontier_n256.json").read_text())
    cfg.update(name="frontier_n48", N=48)
    (base / "configs" / "frontier_n48.json").write_text(json.dumps(cfg))
    (base / "configs" / "frontier_n48.py").write_text(
        (base / "configs" / "frontier_n256.py").read_text())
    # a traffic mix and a cell
    (base / "traffic" / "grid96.json").write_text(json.dumps(
        {"kind": "lambda_grid", "points": 96, "span": 1.0, "step": 0.002}))
    cell = json.loads((base / "workloads" / "frontier-waves8192.json")
                      .read_text())
    cell.update(config="frontier_n48", traffic="grid96")
    (base / "workloads" / "frontier48-grid96.json").write_text(
        json.dumps(cell))
    # a metric
    (base / "metrics" / "requests_per_window.py").write_text(
        "def read(ctx):\n    return ctx.requests\n")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "frontier_n48", "source": "test",
                             "file": "gpubench/configs/frontier_n48.json",
                             "reduced": ["N"], "why": "test"})
    bench["workloads"].append({"name": "frontier48-grid96",
                               "config": "frontier_n48", "traffic": "grid96",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "requests_per_window",
                                "unit": "requests", "better": "higher",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["frontier48-grid96"]})
    res = run_small(bench, "frontier48-grid96", base=base,
                    overrides={"config": {}, "traffic": {}})
    assert res["correct"], res["checks"]
    assert res["metrics"]["requests_per_window"]["value"] >= 1
    assert res["attempted"] % 96 == 0
    # request_ms_p90 lists its cells; the new one is not among them
    assert set(res["metrics"]) == {"solves_per_s", "setup_s",
                                   "requests_per_window"}
    after = {p: p.read_bytes() for p in before}
    assert after == before


KIND = '''
import dataclasses
import torch
from gpubench.problem import generator


class Requests:
    def __init__(self, spec, seed, p, device):
        self.spec, self.seed, self.p, self.device = spec, seed, p, device

    def request(self, r):
        gen = generator(self.seed, self.device, 1000 + r)
        n, N = self.spec["batch"], self.p.data.V.shape[0]
        q = torch.randn((n, N), generator=gen, dtype=torch.float64,
                        device=self.device)
        b = 1.0 + 0.1 * torch.rand((n, 1), generator=gen,
                                   dtype=torch.float64, device=self.device)
        return {"q": q.to(self.p.dtype), "b": b.to(self.p.dtype)}

    def param(self, req):
        return torch.cat([req["q"], req["b"]], 1)


def reference(p, param):
    N = p.data.V.shape[0]
    return (dataclasses.replace(p.data, b=param[:, N:].double()),
            param[:, :N].double())
'''

ENTRY = '''
import dataclasses


def run(p, req, settings):
    from ssqp_tpu_torch.parallel.batch import solve_qp_batch_auto

    Q = dataclasses.replace(p.qp, q=req["q"], b=req["b"])
    return solve_qp_batch_auto(Q, settings, ("V", "A", "G", "g", "d", "u"))


def view(p, req, out):
    return dict(x=out.x, S=out.S, status=out.status, lam=out.lam,
                gamma=out.gamma)
'''


def _with_kind(base, kind):
    """A copy of the benchmark's folder at ``base`` with the kind, a mix,
    an entry and a cell added; returns the files it had, as they were."""
    shutil.copytree(ROOT / "gpubench", base,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    (base / "traffic" / "budget_q.py").write_text(kind)
    (base / "traffic" / "budget16.json").write_text(json.dumps(
        {"kind": "budget_q", "batch": 16}))
    (base / "entries" / "qb_batch_auto.py").write_text(ENTRY)
    cell = json.loads((base / "workloads" / "ineq64-batch256.json")
                      .read_text())
    cell.update(config="frontier_n256", traffic="budget16",
                entry="qb_batch_auto")
    (base / "workloads" / "frontier-budget16.json").write_text(
        json.dumps(cell))
    return before


def test_new_traffic_kind_files_only(tmp_path):
    """A traffic kind whose instances differ in more than q (here the
    budget row's right-hand side), with its own reference parameters: a
    kind module, a mix, an entry and a cell, and nothing else changes. The
    same answers judged against other budgets fail."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "frontier-budget16",
                               "config": "frontier_n256",
                               "traffic": "budget16", "chips": 1,
                               "why": "test"})
    small = {"config": {"N": 48}}
    base = tmp_path / "sound" / "gpubench"
    before = _with_kind(base, KIND)
    res = run_small(bench, "frontier-budget16", base=base, overrides=small)
    assert res["correct"], res["checks"]
    assert res["attempted"] % 16 == 0 and res["failed"] == 0
    after = {p: p.read_bytes() for p in before}
    assert after == before
    base = tmp_path / "shifted" / "gpubench"
    _with_kind(base, KIND.replace("param[:, N:].double()",
                                  "param[:, N:].double() + 0.01"))
    res = run_small(bench, "frontier-budget16", base=base, overrides=small)
    assert not res["correct"], res["checks"]


def test_metric_lists_follow_benchmark_json(bench):
    """A per-layer metric with a ``workloads`` key is read only in its
    cells; one without it in every cell."""
    from gpubench import core

    for cell in ("frontier-waves8192", "ineq64-single"):
        names = [m["name"] for m, _ in core.Cell(cell, bench).metrics(
            "per_layer")]
        assert "device_idle_pct" in names
        assert ("spd_roofline_pct" in names) == (cell == "ineq64-single")
