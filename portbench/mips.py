"""What the readers of a branch and bound's spans and counters share: the
program's records with ``call == "mip"`` (``solve_mip``'s, one a solve;
``relp_tpu_torch.utils.metrics.recent()``).  A program that keeps no such
records gives None, and nothing raises."""

from __future__ import annotations

from typing import List, Optional

from portbench import spans
from portbench.readers import ratio


def traced_mips(ctx) -> Optional[List]:
    """The program's records of the MIP solves traced with device activity
    only: the last ``len(ctx.traced)`` ``mip`` records less the last, the
    host-traced call.  None unless each has spans and its traced call's
    node count."""
    n = len(ctx.traced)
    recs = spans.records("mip")
    if n < 2 or len(recs) < n:
        return None
    pairs = list(zip(recs[-n:-1], ctx.traced[:-1]))
    if any(not rec.spans or rec.nodes != call.get("nodes") for rec, call in pairs):
        return None
    return [rec for rec, _ in pairs]


def span_ms(recs, span: str) -> float:
    """Host milliseconds in ``span`` over ``recs``."""
    return 1e3 * sum(r.spans.get(span, (0, 0.0))[1] for r in recs)


def ms_per_solve(ctx, span: str) -> Optional[float]:
    """Host milliseconds in ``span`` per traced MIP solve."""
    recs = traced_mips(ctx)
    if recs is None:
        return None
    return ratio(span_ms(recs, span), len(recs))
