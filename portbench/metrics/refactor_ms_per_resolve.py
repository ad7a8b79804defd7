"""refactor_ms_per_resolve (ms): the host's seconds in the program's
``dual.refactor`` spans (each refactorization, its polish read included) per
re-solve traced with device activity only."""

from portbench.readers import ratio
from portbench.spans import seconds, traced_resolves


def read(ctx):
    recs = traced_resolves(ctx)
    if recs is None:
        return None
    return ratio(seconds(recs, "dual.refactor"), len(recs), 1e3)
