"""Host reads of a device value (`aten::_local_scalar_dense`, each a wait
for the device) per step of the traced window: the run loop's syncs."""

from portbench import devtrace


def read(ctx):
    return ctx.trace.per_step(devtrace.HOST_READS)
