"""Named solution container.

Counterpart of reference ``src/data/linear_program/solution.rs:15-21`` with the
fuzzy comparator ``is_probably_equal_to`` (solution.rs:47-78) used for
degenerate alternative optima in tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class Solution:
    objective_value: float
    solution_values: List[Tuple[str, float]] = field(default_factory=list)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.solution_values)

    def value_of(self, name: str) -> float:
        for n, v in self.solution_values:
            if n == name:
                return v
        raise KeyError(name)

    def is_probably_equal_to(
        self, other: "Solution", tol: float = 1e-6, min_equal: float = 0.5
    ) -> bool:
        """Fuzzy equality for degenerate problems with multiple optimal bases.

        Float adaptation of reference ``Solution::is_probably_equal_to``
        (solution.rs:47-78): objectives must match within ``tol``
        (relative), the variable-name sets must coincide, and — once there
        are at least 10 variables — the fraction of per-variable values
        matching within ``tol`` must exceed ``min_equal`` (the reference
        compares exact rationals; here "equal" is relative-``tol`` equal).
        """
        a, b = self.objective_value, other.objective_value
        scale = max(1.0, abs(a), abs(b))
        if abs(a - b) > tol * scale:
            return False
        mine, theirs = self.as_dict(), other.as_dict()
        if len(self.solution_values) != len(other.solution_values):
            return False
        if set(mine) != set(theirs):
            return False
        nr_total = len(self.solution_values)
        if nr_total < 10:
            return True
        nr_equal = sum(
            1
            for name, v in mine.items()
            if abs(v - theirs[name]) <= tol * max(1.0, abs(v), abs(theirs[name]))
        )
        return nr_equal / nr_total > min_equal

    def __repr__(self) -> str:  # compact, solver-log friendly
        head = ", ".join(f"{n}={v:.6g}" for n, v in self.solution_values[:8])
        more = "" if len(self.solution_values) <= 8 else f", … ({len(self.solution_values)} vars)"
        return f"Solution(obj={self.objective_value:.10g}; {head}{more})"
