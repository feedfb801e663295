"""One problem at a time through ``solvers/refine.py::solve_qp_refined``:
the active-set search in the problem's own precision, then refinement of
the final KKT system against the problem's data."""

import dataclasses


def run(p, req, settings):
    from ssqp_tpu_torch.solvers.refine import solve_qp_refined

    return solve_qp_refined(dataclasses.replace(p.qp, q=req["q"]),
                            settings=settings)


def view(p, req, out) -> dict:
    one = lambda t: t.unsqueeze(0)
    return dict(x=one(out.x), S=one(out.S), status=one(out.status),
                lam=one(out.lam), gamma=one(out.gamma))
