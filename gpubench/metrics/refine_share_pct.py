"""Host time inside the refinement calls (``solvers/refine.py::
refine_result_cg`` and ``refine_result``: the tail of
``solve_qp_batch_tail_refined`` and the refinement of
``solve_qp_refined``) over the requests' host time, in percent."""

from gpubench.trace import Span

SPANS = [Span("refine", "ssqp_tpu_torch.solvers.refine", "refine_result_cg"),
         Span("refine", "ssqp_tpu_torch.solvers.refine", "refine_result")]


def read(ctx):
    t = ctx.trace
    if t is None or not t.host_s.get("refine") or not t.host_s.get("request"):
        return None
    return 100.0 * t.host_s["refine"] / t.host_s["request"]
