"""dual_ms_per_iter (ms): the window's re-solve walls over their iterations."""

from portbench.readers import ratio, walls


def read(ctx):
    return ratio(sum(walls(ctx)), sum(r["iterations"] for r in ctx.records), 1e3)
