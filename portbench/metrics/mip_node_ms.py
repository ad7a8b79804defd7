"""mip_node_ms (ms): the host's milliseconds in the program's ``mip.node``
spans (a child's warm re-solve and its host copies) over their entries, the
child re-solves, of the MIP solves traced with device activity only."""

from portbench.mips import span_ms, traced_mips
from portbench.readers import ratio


def read(ctx):
    recs = traced_mips(ctx)
    if recs is None:
        return None
    return ratio(span_ms(recs, "mip.node"),
                 sum(r.spans.get("mip.node", (0, 0.0))[0] for r in recs))
