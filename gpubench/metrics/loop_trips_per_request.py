"""Trips of the solver's two host loops per request of the traced window:
the program's ``ssqp.s_loop_trip`` and ``ssqp.pdas_round`` ranges (each
counted by the program as it opens). Each trip ends in the ``nonzero``
that decides the next one, so this is the part of
``host_syncs_per_request`` that these loops set."""

from gpubench import program


def read(ctx):
    t = ctx.trace
    c = program.registry()
    if t is None or not c or not t.requests:
        return None
    return (c.get("s_loop_trip", 0) + c.get("pdas_round", 0)) / t.requests
