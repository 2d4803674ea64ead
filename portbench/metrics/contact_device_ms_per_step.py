"""Device time of the (N, K) Hertz contact forces: the ops launched inside
the program's `forces` spans, per step, over the block that
`portbench/spans.py` traces after the window."""

from portbench import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, "forces")
