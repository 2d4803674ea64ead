"""Device idle time inside the LCP solve: the idle stretches that the
program's `solve` spans or their children (`bbpgd.iter`,
`read:bbpgd.exit`) cover, per step, over the block that
`portbench/spans.py` traces after the window."""

from portbench import spans


def read(ctx):
    return spans.idle_ms_per_step(ctx, "solve")
