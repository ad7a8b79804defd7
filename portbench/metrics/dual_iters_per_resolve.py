"""dual_iters_per_resolve (count): the re-solves' iterations, the mean over the
window."""

from portbench.readers import mean


def read(ctx):
    return mean([r["iterations"] for r in ctx.records])
