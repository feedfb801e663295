"""The CG kernel's share of its roofline: the least time of the traced
window's CG launches, from the program's launch records (each record's
rows, width, precision and the steps its rows ran, summed on the device;
``program.cg_least_s``), over the device time launched inside
``ops/cg.py::cg_padded_rows`` (the kernel and the few copies around it),
in percent."""

from gpubench import program
from gpubench.trace import Span

SPANS = [Span("cg", "ssqp_tpu_torch.ops.cg", "cg_padded_rows")]


def read(ctx):
    t = ctx.trace
    launches = program.registry().get("cg.launches")
    if t is None or not launches or not t.device_s.get("cg"):
        return None
    least = sum(program.cg_least_s(k, r) for k, r in launches.items())
    return 100.0 * least / t.device_s["cg"]
