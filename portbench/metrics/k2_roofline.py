"""K2's share of its roofline: the frozen count on the row layout of the
final positions (`portbench/bounds.py`; the grid as the broad phase sizes
it) over K2's device time per launch in the traced window
(`row_extract_kernel`)."""

from portbench import bounds


def read(ctx):
    launches, seconds = ctx.trace.kernel("row_extract_kernel")
    counted = ctx.trace.counters[1]["k2_launches"] - ctx.trace.counters[0]["k2_launches"]
    if launches == 0 or launches != counted:
        return None
    pos, cutoff, K, slack, box = ctx.driver.k2_layout(ctx.state)
    rpos, valid = bounds.row_layout(pos, box, cutoff, slack)
    bound_ms = bounds.k2_bound(rpos, valid, (box,) * 3, cutoff, K)[0]
    return 100.0 * bound_ms / (1e3 * seconds / launches)
