"""Variable feasibility logic — the branch-and-bound hook.

A copy of ``relp_tpu/providers/variable.py`` (host code, no device):
``FeasibilityLogic{is_feasible, closest_feasible}`` per variable, consumed by
:mod:`relp_tpu_torch.models.branch_bound`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from relp_tpu_torch.model.elements import VariableType


@dataclass(frozen=True)
class FeasibilityLogic:
    """Integrality check/rounding for one variable (continuous = always
    feasible)."""

    variable_type: VariableType
    tol: float = 1e-6

    def is_feasible(self, v: float) -> bool:
        if self.variable_type is not VariableType.INTEGER:
            return True
        return abs(v - round(v)) <= self.tol * (1 + abs(v))

    def closest_feasible(self, v: float) -> float:
        """The nearest feasible value (reference closest_feasible)."""
        if self.variable_type is not VariableType.INTEGER:
            return v
        return float(round(v))


def fractional_mask(x: np.ndarray, integer_mask: np.ndarray, tol: float = 1e-6):
    """Boolean mask of integer variables at fractional values."""
    frac = np.abs(x - np.round(x)) > tol * (1 + np.abs(x))
    return integer_mask & frac
