"""What several metric readers share.  Each reader in ``metrics/`` takes a
``harness.Context`` and returns a number, or None where it finds nothing
to read (no request, no iteration, no launch of its kernels)."""

from __future__ import annotations

from typing import List, Optional

from portbench.roofline import elem_of


def mean(values: List[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None


def ratio(num: float, den: float, scale: float = 1.0) -> Optional[float]:
    return scale * num / den if den > 0 else None


def idle_share(ctx) -> Optional[float]:
    """Percent of the traced calls' wall in which the device ran nothing
    (None where the trace holds no device operation)."""
    sums = ctx.summaries()
    if not any(s.kernels for s in sums):
        return None
    window = sum(s.window_s for s in sums)
    return ratio(window - sum(s.busy_s for s in sums), window, 100.0)


def launches_per_iter(ctx, iterations: str) -> Optional[float]:
    """Kernel launches in the trace per iteration the traced calls counted."""
    sums = ctx.summaries()
    if not any(s.launches for s in sums):
        return None
    return ratio(sum(s.launches for s in sums),
                 sum(r[iterations] for r in ctx.traced if r.get("device") is not None))


def roofline(ctx, parts: dict) -> Optional[float]:
    """Percent of the least time in the device time of the kernels whose
    names hold a key of ``parts``; ``parts[key](record, elem)`` gives the
    least bytes of one launch of that kernel in that traced call."""
    least = spent = 0.0
    for rec in ctx.traced:
        summary = rec.get("device")
        if summary is None:
            continue
        for part, nbytes in parts.items():
            for name, n, sec in summary.launches_of(part):
                least += n * nbytes(rec, elem_of(name)) / ctx.peak_bytes_per_s
                spent += sec
    return ratio(least, spent, 100.0)


def walls(ctx) -> List[float]:
    return [r["wall"] for r in ctx.records]

