"""A batch of linear terms on one shared problem through
``solve_qp_batch_auto`` (every leaf but q shared)."""

import dataclasses

SHARED = ("V", "A", "G", "b", "g", "d", "u")


def run(p, req, settings):
    from ssqp_tpu_torch.parallel.batch import solve_qp_batch_auto

    return solve_qp_batch_auto(dataclasses.replace(p.qp, q=req["q"]),
                               settings, SHARED)


def view(p, req, out) -> dict:
    return dict(x=out.x, S=out.S, status=out.status, lam=out.lam,
                gamma=out.gamma)
