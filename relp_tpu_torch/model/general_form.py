"""GeneralForm: the mutable host-side LP model.

Counterpart of reference ``src/data/linear_program/general_form/mod.rs:39-103``.
Differences by design (SURVEY §7 architecture mapping):

- Bounds are kept as ``±inf`` floats instead of ``Option`` values; the device
  solver is a *bounded-variable* revised simplex, so the reference's
  ``transform_variables`` machinery (split free variables x = x⁺ − x⁻, flip
  upper-bounded-only variables, shift lower bounds to zero,
  general_form/mod.rs:488-569) and ``make_b_non_negative``
  (general_form/mod.rs:574-613) are unnecessary: general bounds and negative
  right-hand sides are handled natively by the engine.  This removes the
  m-inflation of virtual bound rows and the shift/flip bookkeeping.
- The constraint matrix is a scipy CSC matrix (column-major, like the
  reference's ``ColumnMajor`` ``Sparse`` storage, matrix.rs:23-77).
- Removed-variable records for solution reconstruction
  (reference ``OriginalVariable::Removed{Solved, FunctionOfOthers}``,
  general_form/mod.rs:946-994) live in ``removed_variables`` and are resolved
  by :meth:`compute_full_solution` (topological, memoized — the reference does
  the same recursively, general_form/mod.rs:898-942).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import scipy.sparse as sp

from relp_tpu_torch.model.elements import (
    ConstraintRelation,
    LinearProgramType,
    Objective,
    RangedConstraintRelation,
    VariableType,
)
from relp_tpu_torch.model.solution import Solution

INF = float("inf")


@dataclass
class Variable:
    """An active decision variable (reference general_form/mod.rs:997-1021)."""

    name: str
    cost: float = 0.0
    lower: float = -INF
    upper: float = INF
    variable_type: VariableType = VariableType.CONTINUOUS

    def is_fixed(self) -> Optional[float]:
        """The fixed value if lower == upper (reference Variable::is_fixed)."""
        return self.lower if self.lower == self.upper else None

    def is_free(self) -> bool:
        return math.isinf(self.lower) and math.isinf(self.upper)

    def has_feasible_value(self) -> bool:
        return self.lower <= self.upper

    def update_lower_bound(self, value: float) -> bool:
        """Monotone tightening; returns True if the bound changed."""
        if value > self.lower:
            self.lower = value
            return True
        return False

    def update_upper_bound(self, value: float) -> bool:
        if value < self.upper:
            self.upper = value
            return True
        return False


@dataclass
class LinearCombination:
    """value = constant + sum(coeff * other_variable) — a removed variable
    defined in terms of others (reference ``FunctionOfOthers``)."""

    constant: float
    terms: List[Tuple[str, float]] = field(default_factory=list)  # (var name, coeff)


# A removed variable is either solved to a constant or a function of others.
RemovedVariable = Union[float, LinearCombination]


class GeneralForm:
    """A general-form LP:  optimize c@x + fixed_cost  s.t. row relations, bounds.

    For a range row i (``constraint_types[i].is_range``), ``b[i]`` holds the
    *upper* end of the activity interval and ``range_width`` its width:
    ``b[i] - w <= A[i]@x <= b[i]`` — matching how the reference flattens MPS
    RANGES (io/mps/convert.rs ``compute_b``; table at io/mps/mod.rs:238-245).
    """

    def __init__(
        self,
        objective: Objective,
        A: sp.csc_matrix,
        constraint_types: List[RangedConstraintRelation],
        b: np.ndarray,
        variables: List[Variable],
        name: str = "",
        fixed_cost: float = 0.0,
        row_names: Optional[List[str]] = None,
    ):
        self.objective = objective
        self.A = sp.csc_matrix(A, dtype=np.float64)
        self.constraint_types = list(constraint_types)
        self.b = np.asarray(b, dtype=np.float64).reshape(-1)
        self.variables = list(variables)
        self.name = name
        self.fixed_cost = float(fixed_cost)
        self.row_names: List[str] = (
            list(row_names)
            if row_names is not None
            else [f"r{i}" for i in range(self.A.shape[0])]
        )
        # Reconstruction data for variables eliminated by presolve.
        self.removed_variables: Dict[str, RemovedVariable] = {}
        assert self.A.shape == (len(self.constraint_types), len(self.variables))
        assert self.b.shape[0] == self.A.shape[0]

    # -- basic queries -------------------------------------------------------

    @property
    def nr_constraints(self) -> int:
        return self.A.shape[0]

    @property
    def nr_variables(self) -> int:
        return self.A.shape[1]

    def variable_names(self) -> List[str]:
        return [v.name for v in self.variables]

    def is_consistent(self) -> bool:
        """Structural invariants (lightweight analogue of the reference's
        ``is_consistent`` checker, general_form/mod.rs:136-201, including
        acyclicity of the substitution graph)."""
        m, n = self.A.shape
        if len(self.constraint_types) != m or len(self.b) != m:
            return False
        if len(self.variables) != n:
            return False
        names = set(v.name for v in self.variables)
        if len(names) != n:
            return False
        if names & set(self.removed_variables):
            return False  # a variable cannot be both active and removed
        return self._substitutions_acyclic()

    def _substitutions_acyclic(self) -> bool:
        # DFS cycle check over the FunctionOfOthers dependency graph
        # (the reference uses `daggy` for this, general_form/mod.rs:159-172).
        WHITE, GRAY, BLACK = 0, 1, 2
        color: Dict[str, int] = {}

        def visit(node: str) -> bool:
            color[node] = GRAY
            entry = self.removed_variables.get(node)
            if isinstance(entry, LinearCombination) or hasattr(entry, "terms"):
                for dep, _ in entry.terms:
                    c = color.get(dep, WHITE)
                    if c == GRAY:
                        return False
                    if c == WHITE and dep in self.removed_variables and not visit(dep):
                        return False
            color[node] = BLACK
            return True

        for name in self.removed_variables:
            if color.get(name, WHITE) == WHITE:
                if not visit(name):
                    return False
        return True

    # -- solution reconstruction --------------------------------------------

    def compute_full_solution(self, reduced: Dict[str, float]) -> Solution:
        """Combine solver values for the *active* variables with the removed-
        variable records into a full named solution, and add ``fixed_cost``
        to the objective (reference
        ``compute_full_solution_with_reduced_solution``,
        general_form/mod.rs:728-806,817-942)."""
        values: Dict[str, float] = dict(reduced)

        def resolve(name: str) -> float:
            if name in values:
                return values[name]
            entry = self.removed_variables[name]
            if isinstance(entry, LinearCombination):
                v = entry.constant + sum(c * resolve(dep) for dep, c in entry.terms)
            elif hasattr(entry, "coefficient"):  # SlackValue (presolve slack)
                t = sum(c * resolve(dep) for dep, c in entry.terms)
                a, bnd = (entry.row_lower - t) / entry.coefficient, (
                    entry.row_upper - t
                ) / entry.coefficient
                lo, hi = (a, bnd) if a <= bnd else (bnd, a)
                lo, hi = max(lo, entry.lower), min(hi, entry.upper)
                if lo > hi:  # tolerance slack: pick midpoint of the conflict
                    v = 0.5 * (lo + hi)
                else:
                    v = min(max(0.0, lo), hi)
            else:
                v = float(entry)
            values[name] = v
            return v

        for name in self.removed_variables:
            resolve(name)

        cost = self.fixed_cost
        for var in self.variables:
            cost += var.cost * values[var.name]
        if self.objective is Objective.MAXIMIZE:
            # internal cost vector is stored as given; caller minimizes
            # -c for MAX, so report from raw data directly:
            pass
        ordered = [(n, values[n]) for n in sorted(values)]
        return Solution(objective_value=cost, solution_values=ordered)

    def resolve_removed_where_possible(self) -> List[str]:
        """Resolve removed-variable records to explicit constants wherever
        their dependencies are already solved, *in place* — even when the
        problem is not fully presolved (reference
        ``compute_solution_where_possible``, general_form/mod.rs:728-771,
        which rewrites ``FunctionOfOthers`` to ``Solved`` values).

        A record depending (transitively) on a still-active variable stays
        symbolic.  Returns the names newly resolved by this call.
        """
        active = set(v.name for v in self.variables)
        resolved: Dict[str, Optional[float]] = {}

        def value_of(name: str) -> Optional[float]:
            if name in active:
                return None
            if name in resolved:
                return resolved[name]
            entry = self.removed_variables.get(name)
            if entry is None:
                return None
            resolved[name] = None  # cycle guard (is_consistent forbids cycles)
            if isinstance(entry, LinearCombination):
                acc = entry.constant
                for dep, coeff in entry.terms:
                    dv = value_of(dep)
                    if dv is None:
                        return None
                    acc += coeff * dv
                resolved[name] = acc
            elif hasattr(entry, "coefficient"):  # SlackValue
                t = 0.0
                for dep, coeff in entry.terms:
                    dv = value_of(dep)
                    if dv is None:
                        return None
                    t += coeff * dv
                a = (entry.row_lower - t) / entry.coefficient
                bnd = (entry.row_upper - t) / entry.coefficient
                lo, hi = (a, bnd) if a <= bnd else (bnd, a)
                lo, hi = max(lo, entry.lower), min(hi, entry.upper)
                resolved[name] = (
                    0.5 * (lo + hi) if lo > hi else min(max(0.0, lo), hi)
                )
            else:
                resolved[name] = float(entry)
            return resolved[name]

        changed = []
        for name, entry in list(self.removed_variables.items()):
            if isinstance(entry, float):
                continue
            v = value_of(name)
            if v is not None:
                self.removed_variables[name] = v
                changed.append(name)
        return changed

    def compute_solution_where_possible(self) -> Optional[Solution]:
        """If no active variables remain (presolve solved the problem), emit
        the full solution (reference ``get_solution``,
        general_form/mod.rs:789-806); resolves removable records first."""
        self.resolve_removed_where_possible()
        if self.nr_variables > 0:
            return None
        return self.compute_full_solution({})

    # -- trivial checks ------------------------------------------------------

    def trivial_infeasibility(self) -> Optional[LinearProgramType]:
        for v in self.variables:
            if not v.has_feasible_value():
                return LinearProgramType.INFEASIBLE
        return None

    def __repr__(self) -> str:
        return (
            f"GeneralForm(name={self.name!r}, {self.nr_constraints}x{self.nr_variables}, "
            f"{self.objective.value}, nnz={self.A.nnz})"
        )
