"""mip_tree_ms_per_node (ms): the host's milliseconds in the program's
``mip.tree`` spans (the heap, the branching choice and the pseudo-costs
between re-solves) over the nodes (the records' ``nodes``) of the MIP
solves traced with device activity only."""

from portbench.mips import span_ms, traced_mips
from portbench.readers import ratio


def read(ctx):
    recs = traced_mips(ctx)
    if recs is None:
        return None
    return ratio(span_ms(recs, "mip.tree"), sum(r.nodes for r in recs))
