"""Host waits on the device (cudaStreamSynchronize, cudaDeviceSynchronize,
cudaEventSynchronize, blocking cudaMemcpy) inside the entry calls, per
request, from the profiler's runtime records."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.requests or t.busy_s <= 0:
        return None
    return t.syncs / t.requests
