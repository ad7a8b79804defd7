"""dual_graph_share (%): the share of the traced re-solves' dual iterations
that the program replayed from a CUDA graph of its step: the records'
``graph_steps`` over their ``iterations``.  A program whose records keep no
such counter gives None."""

from portbench.readers import ratio
from portbench.spans import traced_resolves


def read(ctx):
    recs = traced_resolves(ctx)
    if recs is None or any(getattr(r, "graph_steps", None) is None for r in recs):
        return None
    return ratio(sum(r.graph_steps for r in recs), sum(r.iterations for r in recs), 100.0)
