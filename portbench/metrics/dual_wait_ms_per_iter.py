"""dual_wait_ms_per_iter (ms): the host's seconds in the program's
``dual.read`` spans (the read of the loop's flags, where the host waits for
the device) over the iterations of the re-solves traced with device activity
only."""

from portbench.spans import ms_per_iter


def read(ctx):
    return ms_per_iter(ctx, "dual.read")
