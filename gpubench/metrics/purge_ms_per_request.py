"""Device milliseconds launched inside the row purge that
``ops/masked_gj.py::select_purge`` returns (the QR purge at M + J >= 16),
per request of the traced window."""

from gpubench.trace import Span

SPANS = [Span("purge", "ssqp_tpu_torch.ops.masked_gj", "select_purge",
              returns=True)]


def read(ctx):
    t = ctx.trace
    if t is None or not t.requests or not t.device_s.get("purge"):
        return None
    return 1e3 * t.device_s["purge"] / t.requests
