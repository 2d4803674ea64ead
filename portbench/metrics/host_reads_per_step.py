"""Scalar host reads of the program per step (`host_read` in
`mundy_tpu_torch.io.telemetry`, each a wait for the device, counted by
site whether traced or not), over the block that `portbench/spans.py`
traces after the window: the count `host_syncs_per_step` takes from the
profiler's events, made where the program reads."""

from portbench import spans


def read(ctx):
    t = spans.of(ctx)
    return None if t is None else t.reads / t.steps
