"""Instance batches sharded over processes with ``torch.distributed``.

Counterpart of ``ssqp_tpu/parallel/sharded.py``, where a batch is sharded
over a device mesh with ``shard_map``. Here a process group takes the
mesh's place: each rank (one process per card) takes its contiguous slice
of the batch, so a sorted parameter grid stays sorted within each shard,
solves it with the local batch protocol, and all-reduces the convergence
statistics over the group on its own device (``solved`` and ``infeasible``
by SUM, ``iters_max`` by MAX). Solutions stay where they were solved: each
rank returns its shard.

Under NCCL every rank runs on ``cuda:{local_rank}`` (the ``LOCAL_RANK``
environment variable, else the rank modulo the card count); under gloo the
solve runs on the CPU when the caller passes ``device="cpu"``. The caller
initializes the group (``torch.distributed.init_process_group``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from ssqp_tpu_torch.types import (
    LP, LP_FIELDS, QP, QP_FIELDS, Settings, check_device)
from ssqp_tpu_torch.utils.precision import highest_matmul


def local_device(group=None, device=None) -> torch.device:
    """The device this rank solves on: ``device`` if given (checked: a
    card asked for without one raises), else ``cuda:{local_rank}``."""
    if device is not None:
        dev = check_device(device)
    else:
        check_device("cuda")
        rank = int(os.environ.get(
            "LOCAL_RANK", dist.get_rank(group) if dist.is_initialized()
            else 0))
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if dist.is_initialized():
        backend = dist.get_backend(group)
        if backend == "nccl" and dev.type != "cuda":
            raise ValueError(f"the NCCL backend runs on the card, not on "
                             f"{dev}; use gloo for device='cpu'")
    return dev


def _slice(n: int, group) -> slice:
    """This rank's contiguous slice of a batch of ``n``."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if n % world:
        raise ValueError(f"batch {n} not divisible by the group size "
                         f"{world}")
    k = n // world
    return slice(rank * k, (rank + 1) * k)


def shard_batch(P, group=None, shared: tuple = (), device=None):
    """This rank's contiguous shard of a batched QP or LP, on its device:
    the batched leaves sliced, the shared ones whole. ``P`` is the global
    batch (the same on every rank)."""
    fields = QP_FIELDS if isinstance(P, QP) else LP_FIELDS
    dev = local_device(group, device)
    B = P.batch_size
    if B is None:
        raise ValueError("shard_batch takes a batched problem")
    sl = _slice(B, group)
    leaves = {}
    for f in fields:
        t = getattr(P, f)
        if f not in shared:
            if not P.is_batched(f):
                raise ValueError(f"field {f!r} is unbatched but not in "
                                 f"shared={shared!r}")
            t = t[sl]
        leaves[f] = t.to(dev)
    return dataclasses.replace(P, **leaves)


def _reduce(stats: dict, ops: dict, group) -> dict:
    for k, t in stats.items():
        dist.all_reduce(t, op=ops[k], group=group)
    return stats


@highest_matmul
def solve_qp_sharded(Q: QP, settings: Settings, group=None,
                     shared: tuple = (), waves="auto", device=None):
    """Solve a QP batch sharded over the ranks of a process group.

    ``Q`` is the global batch, the same on every rank; its leading batch
    size must be divisible by the group size. Each rank solves its
    contiguous shard (:func:`shard_batch`) with ``waves="auto"``
    (``solve_qp_batch_auto`` per shard: waves, compaction or the tail by
    local width and N), ``waves > 1`` (``solve_qp_batch_waves``, q-only
    sorted grids, local shard divisible by ``waves``) or ``waves=0`` (the
    plain batch). Returns ``(Result, stats)``: this rank's shard of the
    result and group-wide 0-dim tensors on its device, ``solved``
    (#status > 0), ``iters_max`` (max |status|) and ``infeasible``
    (#status == 0)."""
    from ssqp_tpu_torch.parallel.batch import (
        settings_for_shared, solve_qp_batch, solve_qp_batch_auto,
        solve_qp_batch_waves)

    dev = local_device(group, device)
    settings = settings_for_shared(settings, shared)
    Qs = shard_batch(Q, group, shared, dev)
    if waves == "auto":
        res = solve_qp_batch_auto(Qs, settings, shared)
    elif waves > 1:
        res = solve_qp_batch_waves(Qs, settings, shared, waves=waves)
    else:
        res = solve_qp_batch(Qs, settings, shared=shared)
    st = res.status
    stats = dict(solved=(st > 0).sum(), iters_max=st.abs().max().to(
        torch.int64), infeasible=(st == 0).sum())
    ops = dict(solved=dist.ReduceOp.SUM, iters_max=dist.ReduceOp.MAX,
               infeasible=dist.ReduceOp.SUM)
    return res, _reduce(stats, ops, group)


@highest_matmul
def solve_lp_sharded(P: LP, settings: Settings, group=None,
                     shared: tuple = (), engine: str = "auto",
                     waves: Optional[int] = None, minimize: bool = True,
                     device=None):
    """Solve an LP batch sharded over the ranks of a process group, the LP
    twin of :func:`solve_qp_sharded`.

    ``engine``: ``"auto"`` (``solve_lp_batch_auto`` per shard: c-grids to
    the warm waves, rhs grids to the dual-simplex waves, else the plain
    two-phase batch), ``"simplex"`` (plain two-phase, or waves with an
    explicit ``waves > 1``) or ``"cclp"`` (criss-cross, minimize only).
    Returns ``(Result, stats)`` with this rank's shard and group-wide
    ``solved`` (#status > 0) and ``infeasible`` (#status == 0)."""
    from ssqp_tpu_torch.parallel.batch import (
        solve_lp_batch, solve_lp_batch_auto, solve_lp_batch_cclp,
        solve_lp_batch_waves)

    if engine not in ("auto", "simplex", "cclp"):
        raise ValueError(f"unknown engine {engine!r}: "
                         "expected 'auto', 'simplex' or 'cclp'")
    if engine == "cclp" and not minimize:
        # criss-cross has no sense flag (the reference's solveLP only
        # minimizes): a maximize request would return the minimizer
        raise ValueError("engine='cclp' only minimizes; negate c or use "
                         "engine='simplex'/'auto' for maximize")
    dev = local_device(group, device)
    Ps = shard_batch(P, group, shared, dev)
    if engine == "cclp":
        res = solve_lp_batch_cclp(Ps, settings, shared=shared)
    elif engine == "auto":
        res = solve_lp_batch_auto(Ps, settings, shared, waves=waves,
                                  minimize=minimize)
    elif waves is not None and waves > 1:
        res = solve_lp_batch_waves(Ps, settings, shared, waves=waves,
                                   minimize=minimize)
    else:
        res = solve_lp_batch(Ps, settings, shared=shared, minimize=minimize)
    st = res.status
    stats = dict(solved=(st > 0).sum(), infeasible=(st == 0).sum())
    ops = dict(solved=dist.ReduceOp.SUM, infeasible=dist.ReduceOp.SUM)
    return res, _reduce(stats, ops, group)


def solve_qp_sharded_2d(Q: QP, settings: Settings, group=None,
                        shared: tuple = (), waves="auto", device=None):
    """The 2-D (host, chip) alias of :func:`solve_qp_sharded`. The JAX
    package shards the batch over both axes of a (host, chip) mesh,
    host-major; a process group over every card of every host, ranked
    host-major (as ``torchrun`` ranks them), is that layout, and NCCL
    routes the reductions over NVLink within a host and the network across
    hosts."""
    return solve_qp_sharded(Q, settings, group, shared=shared, waves=waves,
                            device=device)
