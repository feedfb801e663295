"""Seconds from the start of the process to the start of the window:
imports, the kernel library's build or load, the problem drawn from the
seed, and the warm-up requests (host clock)."""


def read(ctx):
    return ctx.setup_s
