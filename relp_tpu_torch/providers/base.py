"""MatrixProvider protocol and the dense column pool.

A copy of ``relp_tpu/providers/base.py`` (host numpy): a provider's job is to
materialize a pool ``(A, b, c, lb, ub)`` that the engine prices in one pass
over its columns; ``column(j)`` remains for host-side composition (filters,
tests).  The pool is the user's data and stays on the host: the column
generation loop (providers/column_generation.py) puts each round's padded
pool on the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class MatrixProvider(Protocol):
    """Anything that can present an LP in standard equality form."""

    @property
    def nr_rows(self) -> int: ...

    @property
    def nr_columns(self) -> int: ...

    def column(self, j: int) -> np.ndarray: ...

    def cost_value(self, j: int) -> float: ...

    def right_hand_side(self) -> np.ndarray: ...

    def pool(self) -> "ColumnPool": ...


@dataclass
class ColumnPool:
    """A dense standard-form LP snapshot:  min c@x, A@x == b, lb <= x <= ub.

    ``active`` masks which columns participate in pricing: inactive columns
    get lb = ub = 0, which the engine's entering mask excludes.
    """

    A: np.ndarray
    b: np.ndarray
    c: np.ndarray
    lb: np.ndarray
    ub: np.ndarray
    names: List[str] = field(default_factory=list)
    active: Optional[np.ndarray] = None  # bool mask over columns; None = all

    @property
    def nr_rows(self) -> int:
        return self.A.shape[0]

    @property
    def nr_columns(self) -> int:
        return self.A.shape[1]

    def column(self, j: int) -> np.ndarray:
        return self.A[:, j]

    def cost_value(self, j: int) -> float:
        return float(self.c[j])

    def right_hand_side(self) -> np.ndarray:
        return self.b

    def pool(self) -> "ColumnPool":
        return self

    def masked_arrays(self):
        """Arrays with inactive columns pinned to lb = ub = 0, c = 0."""
        if self.active is None:
            return self.A, self.b, self.c, self.lb, self.ub
        act = self.active
        c = np.where(act, self.c, 0.0)
        lb = np.where(act, self.lb, 0.0)
        ub = np.where(act, self.ub, 0.0)
        return self.A, self.b, c, lb, ub

    def with_columns(self, A_new, c_new, lb_new, ub_new, names=None) -> "ColumnPool":
        """Append generated columns (column-generation growth step)."""
        k = A_new.shape[1]
        return ColumnPool(
            A=np.concatenate([self.A, A_new], axis=1),
            b=self.b,
            c=np.concatenate([self.c, np.asarray(c_new, float)]),
            lb=np.concatenate([self.lb, np.asarray(lb_new, float)]),
            ub=np.concatenate([self.ub, np.asarray(ub_new, float)]),
            names=self.names + list(names or [f"gen{j}" for j in range(k)]),
            active=None
            if self.active is None
            else np.concatenate([self.active, np.ones(k, dtype=bool)]),
        )
