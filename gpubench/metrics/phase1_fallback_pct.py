"""Instances re-solved cold through Phase 1 (a rejected PDAS guess, the
grid protocols' rescue, a warm sweep's failed point: the program's
``phase1.fallback_instances``) over the instances attempted in the traced
window, in percent; 0 is a reading."""

from gpubench import program


def read(ctx):
    c = program.registry()
    if ctx.trace is None or not c or ctx.attempted <= 0:
        return None
    return 100.0 * c.get("phase1.fallback_instances", 0) / ctx.attempted
