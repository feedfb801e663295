"""The SPD factor-and-solve's share of its roofline: the least time of
every ``ops/kkt.py::spd_solve`` call of the traced window (from its
(B, n, K), ``peaks.chol_bound``) over the device time launched inside those
calls, in percent."""

from gpubench import peaks
from gpubench.trace import Span


def _shape(args, kwargs):
    A, rhs = args[0], args[1]
    K = 1 if rhs.dim() == A.dim() - 1 else rhs.shape[-1]
    return (A.shape[0], A.shape[-1], K, A.element_size())


SPANS = [Span("spd", "ssqp_tpu_torch.ops.kkt", "spd_solve", record=_shape)]


def read(ctx):
    t = ctx.trace
    calls = t.calls.get("spd") if t is not None else None
    if not calls or not t.device_s.get("spd"):
        return None
    least = sum(peaks.chol_bound(*c)[0] for c in calls) / 1e3
    return 100.0 * least / t.device_s["spd"]
