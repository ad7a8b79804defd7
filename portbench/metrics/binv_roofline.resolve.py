"""binv_roofline.resolve (%): the least time of the traffic over the explicit
B⁻¹ in the traced re-solves over their device busy time.  A step that holds
an explicit inverse reads it once and writes it once at the least, so the
least time is Σ iterations · 2 · ``inverse_bytes`` (the program's record of
each re-solve: the bytes of the B⁻¹ its device dual held) at the card's
peak bandwidth; the busy time is the union of kernels, copies and sets in
those calls (as ``idle_share.resolve`` sums it).  None where a record keeps
no ``inverse_bytes`` or holds 0: then no reading can pass 100 %."""

from portbench.readers import ratio
from portbench.spans import traced_resolves


def binv_bytes(iterations: int, inverse_bytes: int) -> int:
    """B⁻¹ read once and written once in each iteration."""
    return iterations * 2 * inverse_bytes


def read(ctx):
    recs = traced_resolves(ctx)
    if recs is None or any(not getattr(r, "inverse_bytes", 0) for r in recs):
        return None
    least = sum(binv_bytes(r.iterations, r.inverse_bytes) for r in recs) / ctx.peak_bytes_per_s
    return ratio(least, sum(s.busy_s for s in ctx.summaries()), 100.0)
