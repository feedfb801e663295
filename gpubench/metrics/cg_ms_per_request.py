"""Device milliseconds launched inside ``ops/cg.py::cg_padded_rows`` (the
CG kernel and what surrounds it), per request of the traced window."""

from gpubench.trace import Span

SPANS = [Span("cg", "ssqp_tpu_torch.ops.cg", "cg_padded_rows")]


def read(ctx):
    t = ctx.trace
    if t is None or not t.requests or not t.device_s.get("cg"):
        return None
    return 1e3 * t.device_s["cg"] / t.requests
