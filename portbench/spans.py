"""What the readers of the program's own spans and counters share: the solve
records that ``relp_tpu_torch.utils.metrics.recent()`` keeps (one per
``solve_computational_form`` and per ``reoptimize_with_bounds``).  A program
that keeps no such records gives None, and nothing raises."""

from __future__ import annotations

from typing import List, Optional

from portbench.readers import ratio


def records(call: str) -> list:
    """The program's kept records of entry point ``call``, oldest first."""
    from relp_tpu_torch.utils import metrics

    recent = getattr(metrics, "recent", None)
    if recent is None:
        return []
    return [r for r in recent() if getattr(r, "call", None) == call]


def traced_resolves(ctx) -> Optional[List]:
    """The program's records of the re-solves traced with device activity
    only (the calls ``idle_share.resolve`` reads): the last
    ``len(ctx.traced)`` re-solve records less the last, the host-traced call.
    None unless each has spans and its traced call's iterations."""
    n = len(ctx.traced)
    recs = records("reoptimize")
    if n < 2 or len(recs) < n:
        return None
    pairs = list(zip(recs[-n:-1], ctx.traced[:-1]))
    if any(not rec.spans or rec.iterations != call["iterations"] for rec, call in pairs):
        return None
    return [rec for rec, _ in pairs]


def seconds(recs, span: str) -> float:
    return sum(r.spans.get(span, (0, 0.0))[1] for r in recs)


def ms_per_iter(ctx, span: str) -> Optional[float]:
    """Host milliseconds in ``span`` over the traced re-solves' iterations."""
    recs = traced_resolves(ctx)
    if recs is None:
        return None
    return ratio(seconds(recs, span), sum(r.iterations for r in recs), 1e3)
