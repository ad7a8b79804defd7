"""mip_root_ms_per_solve (ms): the host's milliseconds in the program's
``mip.root`` span (the root LP's cold solve) per MIP solve traced with
device activity only."""

from portbench.mips import ms_per_solve


def read(ctx):
    return ms_per_solve(ctx, "mip.root")
