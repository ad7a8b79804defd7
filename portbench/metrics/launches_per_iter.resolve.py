"""launches_per_iter.resolve (count): kernel launches in the traced re-solves
over their dual iterations."""

from portbench.readers import launches_per_iter


def read(ctx):
    return launches_per_iter(ctx, "iterations")
