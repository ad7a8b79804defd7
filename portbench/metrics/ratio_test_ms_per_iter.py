"""ratio_test_ms_per_iter (ms): the host's seconds in the program's
``dual.ratio`` spans (the candidates, their ratios and the ratio test) over
the iterations of the re-solves traced with device activity only."""

from portbench.spans import ms_per_iter


def read(ctx):
    return ms_per_iter(ctx, "dual.ratio")
