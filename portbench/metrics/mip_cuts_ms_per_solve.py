"""mip_cuts_ms_per_solve (ms): the host's milliseconds in the program's
``mip.cuts`` spans (each Gomory round: its tableau rows, the cuts'
derivation and the warm re-solve of the cut LP) per MIP solve traced with
device activity only."""

from portbench.mips import ms_per_solve


def read(ctx):
    return ms_per_solve(ctx, "mip.cuts")
