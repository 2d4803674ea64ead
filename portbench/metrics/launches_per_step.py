"""Kernel launches per step of the traced window, counted by the launch
calls of the CUDA runtime and driver that the profiler records, the hand
kernels' launches included."""

from portbench import devtrace


def read(ctx):
    v = ctx.trace.per_step(devtrace.LAUNCHES)
    return v if v > 0 else None
