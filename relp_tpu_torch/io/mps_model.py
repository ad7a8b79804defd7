"""In-memory MPS program representation.

Counterpart of reference ``src/io/mps/mod.rs:66-198`` (the ``MPS<F>`` struct
with Row/Column/Rhs/Range/Bound sections) and the 10-variant ``BoundType``
enum (mod.rs:175-198).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from relp_tpu_torch.model.elements import ConstraintRelation, Objective, VariableType


class BoundType(enum.Enum):
    """MPS BOUNDS row kinds (LO/UP/FX/FR/MI/PL/BV/LI/UI/SC)."""

    LOWER_CONTINUOUS = "LO"
    UPPER_CONTINUOUS = "UP"
    FIXED = "FX"
    FREE = "FR"
    LOWER_MINUS_INFINITY = "MI"
    UPPER_INFINITY = "PL"
    BINARY = "BV"
    LOWER_INTEGER = "LI"
    UPPER_INTEGER = "UI"
    SEMI_CONTINUOUS = "SC"

    @property
    def takes_value(self) -> bool:
        return self in (
            BoundType.LOWER_CONTINUOUS,
            BoundType.UPPER_CONTINUOUS,
            BoundType.FIXED,
            BoundType.LOWER_INTEGER,
            BoundType.UPPER_INTEGER,
            BoundType.SEMI_CONTINUOUS,
        )


@dataclass
class MpsRow:
    name: str
    constraint_type: ConstraintRelation


@dataclass
class MpsColumn:
    name: str
    variable_type: VariableType
    values: List[Tuple[int, float]] = field(default_factory=list)  # (row index, value)


@dataclass
class MpsRhs:
    name: str
    values: List[Tuple[int, float]] = field(default_factory=list)


@dataclass
class MpsRange:
    name: str
    values: List[Tuple[int, float]] = field(default_factory=list)


@dataclass
class MpsBound:
    name: str
    values: List[Tuple[int, BoundType, Optional[float]]] = field(default_factory=list)
    # (column index, bound type, value-or-None)


@dataclass
class MPS:
    """A parsed MPS program (not yet converted to GeneralForm)."""

    name: str
    objective: Objective
    cost_row_name: str
    cost_values: List[Tuple[int, float]]  # (column index, cost)
    objective_constant: float  # from an RHS entry on the cost row (negated)
    rows: List[MpsRow]
    columns: List[MpsColumn]
    rhss: List[MpsRhs]
    ranges: List[MpsRange]
    bounds: List[MpsBound]

    @property
    def nr_rows(self) -> int:
        return len(self.rows)

    @property
    def nr_columns(self) -> int:
        return len(self.columns)
