"""``solves_per_s`` in the cells whose rate the device sets (the card busy
nearly all the window, so the rate is steady from run to run): instances
solved in the requests the window completed, over the window's whole
length (host clock). Its own, tighter bound catches a loss there that the
host-bound cells' spread would hide."""


def read(ctx):
    return ctx.solved / ctx.window_s
