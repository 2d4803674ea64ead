"""Device time of the LCP solve (BBPGD's iterations and exit tests, the
force assembly through K3 and the velocities): the ops launched inside the
program's `solve` spans and their children, per step, over the block that
`portbench/spans.py` traces after the window."""

from portbench import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, "solve")
