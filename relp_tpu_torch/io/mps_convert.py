"""Convert a parsed MPS program into a GeneralForm.

Counterpart of reference ``src/io/mps/convert.rs`` (``TryInto<GeneralForm>``):
- cost values merged into variables (convert.rs `compute_variable_info:91`),
- GLPK-compatible bound processing (convert.rs `process_bound:201`): LO/UP/FX
  tighten, FR conflicts with any other bound, MI implies an explicit upper
  bound of 0, PL implies an explicit lower bound of 0, BV = integer in [0,1],
  a default lower bound of 0 is substituted for variables that only ever saw
  UP/UI bounds (or none at all),
- RANGES flattening and validation (convert.rs `compute_ranges:337`; at most
  one range per row; rhs duplicates on ranged rows must agree) with the
  interval table of io/mps/mod.rs:238-245:

      row type | sign of r |    h    |    u
      ---------|-----------|---------|---------
      G        |  + or -   |    b    | b + |r|
      L        |  + or -   | b - |r| |   b
      E        |     +     |    b    | b + |r|
      E        |     -     | b - |r| |   b

  stored as (upper end u, width |r|) on the GeneralForm,
- b assembly (convert.rs `compute_b:444`): missing rhs → 0; duplicate rhs
  entries must agree for E rows, take the max for G, the min for L.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import scipy.sparse as sp

from relp_tpu_torch.io.errors import InconsistencyError
from relp_tpu_torch.io.mps_model import MPS, BoundType
from relp_tpu_torch.model.elements import (
    ConstraintRelation,
    RangedConstraintRelation,
    VariableType,
)
from relp_tpu_torch.model.general_form import INF, GeneralForm, Variable


def mps_to_general_form(mps: MPS) -> GeneralForm:
    variables = _compute_variables(mps)
    constraint_types, b = _compute_constraints(mps)

    m, n = len(mps.rows), len(mps.columns)
    data, rows_idx, cols_idx = [], [], []
    for j, col in enumerate(mps.columns):
        for i, v in col.values:
            if v != 0.0:
                data.append(v)
                rows_idx.append(i)
                cols_idx.append(j)
    A = sp.csc_matrix(
        (data, (rows_idx, cols_idx)), shape=(m, n), dtype=np.float64
    )

    return GeneralForm(
        objective=mps.objective,
        A=A,
        constraint_types=constraint_types,
        b=b,
        variables=variables,
        name=mps.name,
        fixed_cost=mps.objective_constant,
        row_names=[r.name for r in mps.rows],
    )


def _compute_variables(mps: MPS) -> List[Variable]:
    variables = [
        Variable(name=c.name, cost=0.0, lower=-INF, upper=INF,
                 variable_type=c.variable_type)
        for c in mps.columns
    ]
    for j, cost in mps.cost_values:
        variables[j].cost += cost

    lower: List[Optional[float]] = [None] * len(variables)
    upper: List[Optional[float]] = [None] * len(variables)
    needs_default_lower = [True] * len(variables)
    is_free = [False] * len(variables)

    def tighten_lower(j: int, v: float) -> None:
        lower[j] = v if lower[j] is None else max(lower[j], v)

    def tighten_upper(j: int, v: float) -> None:
        upper[j] = v if upper[j] is None else min(upper[j], v)

    for bound in mps.bounds:
        for j, btype, value in bound.values:
            var = variables[j]
            if btype is BoundType.LOWER_CONTINUOUS:
                tighten_lower(j, value)
                needs_default_lower[j] = False
            elif btype is BoundType.UPPER_CONTINUOUS:
                tighten_upper(j, value)
            elif btype is BoundType.FIXED:
                tighten_lower(j, value)
                tighten_upper(j, value)
                needs_default_lower[j] = False
            elif btype is BoundType.FREE:
                if lower[j] is not None or upper[j] is not None:
                    raise InconsistencyError("Variable can't be bounded and free")
                is_free[j] = True
                needs_default_lower[j] = False
            elif btype is BoundType.LOWER_MINUS_INFINITY:
                # MI: lower bound is -inf (modern GLPK semantics).  The
                # reference additionally takes the implied zero as an
                # explicit *upper* bound (process_bound), which makes
                # (-inf, u] inexpressible; we deviate deliberately —
                # a bare MI keeps its default-free upper bound.
                needs_default_lower[j] = False
            elif btype is BoundType.UPPER_INFINITY:
                tighten_lower(j, 0.0)
                needs_default_lower[j] = False
            elif btype is BoundType.BINARY:
                tighten_lower(j, 0.0)
                tighten_upper(j, 1.0)
                var.variable_type = VariableType.INTEGER
                needs_default_lower[j] = False
            elif btype is BoundType.LOWER_INTEGER:
                tighten_lower(j, value)
                var.variable_type = VariableType.INTEGER
                needs_default_lower[j] = False
            elif btype is BoundType.UPPER_INTEGER:
                tighten_upper(j, value)
                var.variable_type = VariableType.INTEGER
            elif btype is BoundType.SEMI_CONTINUOUS:
                raise NotImplementedError("SC bounds are not supported (as in the reference)")

    for j, var in enumerate(variables):
        if is_free[j] and (lower[j] is not None or upper[j] is not None):
            raise InconsistencyError("A variable is both free and bounded.")
        if needs_default_lower[j] and not is_free[j] and lower[j] is None:
            lower[j] = 0.0
        var.lower = -INF if lower[j] is None else lower[j]
        var.upper = INF if upper[j] is None else upper[j]
    return variables


def _compute_constraints(mps: MPS):
    m = len(mps.rows)

    # --- flatten + validate ranges ---
    # Within one range set a duplicate row with a DIFFERENT value is
    # inconsistent; an equal duplicate is accepted — the semantic the
    # reference leaves unimplemented (burkardt empstest is #[ignore]d with
    # "The same range value occurring twice for a single row while being
    # equal should be accepted", tests/burkardt/test.rs fn empstest;
    # reference compute_ranges, convert.rs:337, rejects both).  Across
    # *different* sets the first set's value wins (GLPK-style superset).
    range_by_row: Dict[int, float] = {}
    for rng in mps.ranges:
        seen_in_set: Dict[int, float] = {}
        for i, r in rng.values:
            if i in seen_in_set and seen_in_set[i] != r:
                raise InconsistencyError("Only one range per row can be specified.")
            seen_in_set[i] = r
            if i not in range_by_row:
                range_by_row[i] = r

    # rhs duplicates on ranged rows must agree (within the governing set)
    if range_by_row:
        seen: Dict[int, float] = {}
        for s_idx, rhs in enumerate(mps.rhss):
            if s_idx > 0:
                break  # later sets are alternative scenarios (see below)
            for i, v in rhs.values:
                if i in range_by_row:
                    if i in seen and seen[i] != v:
                        raise InconsistencyError(
                            "Multiple rhs values for a constraint with a range"
                        )
                    seen[i] = v

    # --- b assembly ---
    # Duplicates *within* one rhs set follow the reference's merge rules
    # (compute_b, convert.rs:444: E must agree, G takes max, L takes min);
    # additional *sets* are alternative scenarios — the first set that
    # touches a row wins (GLPK-style; the reference merges across sets and
    # rejects scenario files like unicamp model_data_5).
    b_opt: List[Optional[float]] = [None] * m
    b_set: List[Optional[int]] = [None] * m
    for s_idx, rhs in enumerate(mps.rhss):
        for i, v in rhs.values:
            if b_opt[i] is None:
                b_opt[i] = v
                b_set[i] = s_idx
            elif b_set[i] == s_idx:
                kind = mps.rows[i].constraint_type
                if kind is ConstraintRelation.EQUAL:
                    if b_opt[i] != v:
                        raise InconsistencyError(
                            f"Trivial infeasibility: a constraint can't equal "
                            f"both {b_opt[i]} and {v}"
                        )
                elif kind is ConstraintRelation.GREATER:
                    b_opt[i] = max(b_opt[i], v)
                else:
                    b_opt[i] = min(b_opt[i], v)
            # else: later set, row already bound — ignore

    constraint_types: List[RangedConstraintRelation] = []
    b = np.zeros(m, dtype=np.float64)
    for i, row in enumerate(mps.rows):
        base = 0.0 if b_opt[i] is None else b_opt[i]
        if i in range_by_row:
            r = range_by_row[i]
            if r == 0.0:
                constraint_types.append(RangedConstraintRelation.equal())
                b[i] = base
            else:
                width = abs(r)
                kind = row.constraint_type
                if kind is ConstraintRelation.GREATER:
                    upper = base + width
                elif kind is ConstraintRelation.LESS:
                    upper = base
                else:  # EQUAL
                    upper = base + r if r > 0 else base
                constraint_types.append(RangedConstraintRelation.range(width))
                b[i] = upper
        else:
            constraint_types.append(RangedConstraintRelation(row.constraint_type))
            b[i] = base
    return constraint_types, b
