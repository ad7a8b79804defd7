"""Row-filtering provider wrapper (a copy of ``relp_tpu/providers/filters.py``):
present a pool minus a set of rows.  The engines keep redundant rows with
their artificial basic at level 0; this host-side filter exists for
composing problems and for tests."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from relp_tpu_torch.providers.base import ColumnPool


def remove_rows(pool: ColumnPool, rows: Sequence[int]) -> ColumnPool:
    keep = np.ones(pool.nr_rows, dtype=bool)
    keep[np.asarray(list(rows), dtype=int)] = False
    return ColumnPool(
        A=pool.A[keep, :],
        b=pool.b[keep],
        c=pool.c,
        lb=pool.lb,
        ub=pool.ub,
        names=pool.names,
        active=pool.active,
    )
