"""The 90th percentile of every request's latency in the window: from the
call into the entry until its outputs are complete on the card (host
clock, after ``torch.cuda.synchronize()``)."""

import numpy as np


def read(ctx):
    return 1e3 * float(np.percentile(np.asarray(ctx.latencies_s), 90))
