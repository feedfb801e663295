"""Mean ``Result.status`` (the S-loop iteration count on success) over the
instances the window solved (the program's own count)."""


def read(ctx):
    if ctx.solved <= 0:
        return None
    return ctx.s_iters_sum / ctx.solved
