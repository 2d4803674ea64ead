"""Broad-phase rebuilds per step, from the state's `rebuild_count` across
the measured window and the traced blocks."""


def read(ctx):
    done = ctx.per_block[-1]["rebuilds"] - ctx.first_counters["rebuilds"]
    steps = len(ctx.per_block) * ctx.driver.block_steps
    return done / steps
