"""BBPGD iterations of the last solve of each block (`state.lcp_iters` at
the block's end), averaged over the blocks of the window."""


def read(ctx):
    its = [c["lcp_iters"] for c in ctx.per_block if "lcp_iters" in c]
    return sum(its) / len(its) if its else None
