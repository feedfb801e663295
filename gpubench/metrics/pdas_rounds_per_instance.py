"""PDAS identification rounds per instance attempted in the traced window:
the program's ``pdas.instance_rounds`` counter (the batch at the
closed-form round, then each round's still-changing instances)."""

from gpubench import program


def read(ctx):
    c = program.registry()
    if ctx.trace is None or not c or ctx.attempted <= 0:
        return None
    return c.get("pdas.instance_rounds", 0) / ctx.attempted
