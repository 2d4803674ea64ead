"""Device time of the broad phase's rebuilds (cell list or rows with K2,
the pair list, the warm-start remap): the ops launched inside the program's
`rebuild` spans, per step, over the block that `portbench/spans.py` traces
after the window."""

from portbench import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, "rebuild")
