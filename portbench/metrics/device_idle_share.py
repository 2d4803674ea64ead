"""Share of the traced window's wall time in which no operation ran on the
device (the profiler's own host overhead is in that wall time)."""


def read(ctx):
    if ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.wall_s)
