"""The check must say ``correct: false`` when the timed path is broken
underneath, and when the plain reference one precision step below the
cell's is put in the program's place (the control). Each cell at its small
CPU size; the harness's look for a card is skipped, the rest of a run is
driven as on the card. The sound program passes at the same size."""

import dataclasses
import sys

import pytest
import torch

from conftest import SEED, SMALL, run_small

ENTRY = {  # cell -> (module, function) its entry calls
    "frontier-waves8192": ("ssqp_tpu_torch.models.frontier",
                           "frontier_waves_sweep"),
    "ineq64-batch256": ("ssqp_tpu_torch.parallel.batch",
                        "solve_qp_batch_auto"),
    "ineq64-single": ("ssqp_tpu_torch.solvers.refine", "solve_qp_refined"),
}


def _everywhere(monkeypatch, module, name, fake):
    """Put ``fake`` wherever the program holds ``module.name``."""
    real = getattr(sys.modules[module], name)
    for mod in list(sys.modules.values()):
        if (getattr(mod, "__name__", "") or "").split(".")[0] != \
                "ssqp_tpu_torch":
            continue
        for key, val in list(vars(mod).items()):
            if val is real:
                monkeypatch.setattr(mod, key, fake)
    return real


def _map_result(res, fn):
    """A copy of a Result or FrontierResult with ``fn`` applied to each
    batched leaf."""
    if hasattr(res, "_replace"):
        return res._replace(**{k: fn(v) for k, v in res._asdict().items()})
    return dataclasses.replace(res, **{
        f.name: fn(getattr(res, f.name)) for f in dataclasses.fields(res)
        if getattr(res, f.name) is not None})


def state_unchanged(monkeypatch, cell):
    """The solver's steps return their state unchanged: each PDAS round
    keeps the statuses it was given, and the S-loop returns its starting
    point as if it had converged."""
    import ssqp_tpu_torch.solvers.ssqp  # noqa: F401
    from ssqp_tpu_torch.types import Result

    def pdas_update(Q, fu, fd, Sx, Se, res):
        return Sx, Se, torch.clamp(res.alpha, min=Q.d, max=Q.u)

    _everywhere(monkeypatch, "ssqp_tpu_torch.solvers.ssqp", "_pdas_update",
                pdas_update)

    def loop(Q, Sx0, Se0, x0, settings, pre_status=None, **k):
        B, N = x0.shape
        r = Result(x0.to(Q.V.dtype).clone(),
                   torch.cat([Sx0, Se0], 1).to(torch.int8),
                   torch.ones(B, dtype=torch.int32, device=x0.device))
        if k.get("return_sol"):
            sol = torch.zeros((B, N, 1 + Q.M + Q.J), dtype=Q.V.dtype,
                              device=x0.device)
            return r, sol
        return r

    _everywhere(monkeypatch, "ssqp_tpu_torch.solvers.ssqp", "solve_qp_loop",
                loop)


def half_batch(monkeypatch, cell):
    """The entry solves the first half of its batch and returns those
    answers for the second half too."""
    module, name = ENTRY[cell]
    __import__(module)
    real = getattr(sys.modules[module], name)

    def fake(Q, *a, **k):
        if name.startswith("frontier_"):
            rets, lams, settings = a[:3]
            h = lams.shape[0] // 2
            res = real(Q, rets, lams[:h], settings, *a[3:], **k)
        else:
            h = Q.q.shape[0] // 2
            res = real(dataclasses.replace(Q, q=Q.q[:h]), *a, **k)
        return _map_result(res, lambda t: torch.cat([t, t]))

    _everywhere(monkeypatch, module, name, fake)


def answer_altered(monkeypatch, cell):
    """Every answer comes back 1% off where it is produced."""
    module, name = ENTRY[cell]
    __import__(module)
    real = getattr(sys.modules[module], name)

    def fake(*a, **k):
        res = real(*a, **k)
        if hasattr(res, "_replace"):
            return res._replace(x=1.01 * res.x)
        return dataclasses.replace(res, x=1.01 * res.x)

    _everywhere(monkeypatch, module, name, fake)


FAULTS = [(c, f) for c in SMALL for f in (state_unchanged, answer_altered)]
FAULTS += [(c, half_batch) for c in SMALL if c != "ineq64-single"]


@pytest.mark.parametrize("cell", list(SMALL))
def test_sound_program_passes(bench, cell):
    res = run_small(bench, cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_is_caught(bench, monkeypatch, cell, fault):
    fault(monkeypatch, cell)
    res = run_small(bench, cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", list(SMALL))
def test_control_is_caught(bench, cell):
    """The reference one precision step below the cell's, on three seeds,
    reads above the cell's limits (calibrate.py's control, at the small
    size)."""
    from gpubench import check, core
    from gpubench.calibrate import readings

    c = core.Cell(cell, bench, overrides=SMALL[cell])
    for seed in (SEED, SEED + 1, SEED + 2):
        r = readings(c, seed, torch.device("cpu"), 2, True)
        assert not check.judge(r["control"], c.spec["limits"])[0], r
        assert check.judge(r["program"], c.spec["limits"])[0], r
