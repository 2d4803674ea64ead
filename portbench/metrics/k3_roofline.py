"""K3's share of its roofline: the frozen byte and operation count of its
strided layout at the final state (`portbench/bounds.py`) over K3's device
time per launch in the traced window (`seg_sum_kernel`)."""

from portbench import bounds


def read(ctx):
    launches, seconds = ctx.trace.kernel("seg_sum_kernel")
    counted = ctx.trace.counters[1]["k3_launches"] - ctx.trace.counters[0]["k3_launches"]
    if launches == 0 or launches != counted:
        return None
    nb, W, B, n_act = ctx.driver.k3_shape(ctx.state)
    isz = ctx.state.pos.element_size()
    bound_ms = bounds.k3_bound(nb, W, B, n_act, isz, ctx.state.pos.dtype)[0]
    return 100.0 * bound_ms / (1e3 * seconds / launches)
