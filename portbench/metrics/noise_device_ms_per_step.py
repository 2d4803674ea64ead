"""Device time of the step's keyed noise: the ops launched inside the
program's `noise` spans, per step, over the block that `portbench/spans.py`
traces after the window (the noise the step itself draws, where
`noise_ms_per_step` times a call made alone)."""

from portbench import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, "noise")
