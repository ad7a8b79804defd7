"""base_solve_s (s): the wall of the base solve that set-up makes, as the
program's record of it says (``wall_s`` of the last driver solve; a run
makes one, before its re-solves)."""

from portbench.spans import records


def read(ctx):
    recs = records("solve")
    return recs[-1].wall_s if recs else None
