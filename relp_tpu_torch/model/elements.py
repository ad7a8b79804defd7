"""Core enums and small value types of the LP domain.

Counterpart of reference ``src/data/linear_program/elements.rs`` (the
``InequalityRelation`` / ``ConstraintRelation`` / ``RangedConstraintRelation`` /
``BoundDirection`` / ``VariableType`` / ``LinearProgramType`` / ``Objective``
enums, elements.rs:34-223).  Here these are plain Python enums used on the
host side only; on device everything is encoded as integer codes (see
``relp_tpu_torch.simplex.status``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Union


class Objective(enum.Enum):
    """Optimization direction (reference elements.rs: `Objective{Minimize,Maximize}`)."""

    MINIMIZE = "min"
    MAXIMIZE = "max"


class ConstraintRelation(enum.Enum):
    """Direction of a constraint row as read from MPS ROWS section."""

    EQUAL = "E"
    LESS = "L"
    GREATER = "G"


class BoundDirection(enum.Enum):
    """Lower or upper (reference elements.rs `BoundDirection`)."""

    LOWER = "lower"
    UPPER = "upper"

    def flip(self) -> "BoundDirection":
        return BoundDirection.UPPER if self is BoundDirection.LOWER else BoundDirection.LOWER


class VariableType(enum.Enum):
    """Continuous or integer (integer only tracked; relaxation is solved)."""

    CONTINUOUS = "continuous"
    INTEGER = "integer"


@dataclass(frozen=True)
class RangedConstraintRelation:
    """A constraint relation that may carry a range width.

    Mirrors the semantics of the reference's
    ``RangedConstraintRelation{Equal, Range(r), Less, Greater}``
    (elements.rs:122-182): a ``RANGE`` row with stored right-hand side ``b``
    (the *upper* end of the activity interval) and width ``w`` means
    ``b - w <= a@x <= b``.

    ``kind`` is a `ConstraintRelation` for plain rows; ``range_width`` is
    ``None`` unless this is a range row.
    """

    kind: ConstraintRelation
    range_width: Union[float, None] = None

    @property
    def is_range(self) -> bool:
        return self.range_width is not None

    @staticmethod
    def equal() -> "RangedConstraintRelation":
        return RangedConstraintRelation(ConstraintRelation.EQUAL)

    @staticmethod
    def less() -> "RangedConstraintRelation":
        return RangedConstraintRelation(ConstraintRelation.LESS)

    @staticmethod
    def greater() -> "RangedConstraintRelation":
        return RangedConstraintRelation(ConstraintRelation.GREATER)

    @staticmethod
    def range(width) -> "RangedConstraintRelation":
        if width < 0:
            raise ValueError("range width must be non-negative")
        # A zero-width range degenerates to equality, matching the reference's
        # `compute_constraint_types` (io/mps/convert.rs: r == 0 => Equal).
        if width == 0:
            return RangedConstraintRelation.equal()
        return RangedConstraintRelation(ConstraintRelation.LESS, range_width=width)


class LinearProgramType(enum.Enum):
    """Solve outcome classification (reference elements.rs `LinearProgramType`)."""

    FINITE_OPTIMUM = "finite_optimum"
    INFEASIBLE = "infeasible"
    UNBOUNDED = "unbounded"
    # Extra states for the float solver that the exact reference cannot hit.
    ITERATION_LIMIT = "iteration_limit"
    NUMERICAL_ERROR = "numerical_error"
