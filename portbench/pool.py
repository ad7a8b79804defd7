"""Requests drawn from a pool that the cell or configuration fixes, so that
every seed does the same work in another order.

Request ``k ≥ 1`` lies in cycle ``(k − 1) // size``; each cycle takes every
member of the pool once, in an order drawn from ``(seed, cycle)``, and the
harness ends a window only with a whole cycle.  Request 0, the warm-up,
takes member 0.
"""

from __future__ import annotations

import numpy as np


def member(seed: int, k: int, size: int) -> int:
    if k <= 0:
        return 0
    cycle, slot = divmod(k - 1, size)
    return int(np.random.default_rng([seed, cycle]).permutation(size)[slot])
