"""start_inverse_hit_share (%): the share of the traced re-solves that
started from the B⁻¹ the program kept from the last start on its operator:
the records' ``start_inverse_hits`` over their count.  A program whose
records keep no such counter gives None."""

from portbench.readers import ratio
from portbench.spans import traced_resolves


def read(ctx):
    recs = traced_resolves(ctx)
    if recs is None or any(getattr(r, "start_inverse_hits", None) is None for r in recs):
        return None
    return ratio(sum(r.start_inverse_hits for r in recs), len(recs), 100.0)
