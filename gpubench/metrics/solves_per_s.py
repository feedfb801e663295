"""Instances solved (status > 0) in the requests the window completed,
over the window's whole length (host clock)."""


def read(ctx):
    return ctx.solved / ctx.window_s
