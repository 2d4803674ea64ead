"""Device idle time inside the between-block refits of the LCP run loop
(`_refit_broad`, `_resize_active`: their reads, the positions' copy to the
host and its bincount, a rebuild they decide): the idle stretches that the
program's `refit` spans or their children cover, per step, over the block
that `portbench/spans.py` traces after the window."""

from portbench import spans


def read(ctx):
    return spans.idle_ms_per_step(ctx, "refit")
