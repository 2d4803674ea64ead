"""Device time of the LCP step's assembly (collision setup, the strided
active set, the band apply's build): the ops launched inside the program's
`assemble` spans, per step, over the block that `portbench/spans.py` traces
after the window."""

from portbench import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, "assemble")
