"""dual_dispatch_ms_per_iter (ms): the host's seconds in the program's
``dual.step`` spans (the dispatch of one dual iteration's operations) over
the iterations of the re-solves traced with device activity only."""

from portbench.spans import ms_per_iter


def read(ctx):
    return ms_per_iter(ctx, "dual.step")
