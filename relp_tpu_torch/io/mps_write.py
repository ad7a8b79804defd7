"""MPS writer: GeneralForm → free-format MPS text.

The reference stores row/column/set names explicitly "for writing the
problem to disk" (io/mps/mod.rs Row/Rhs/Range/Bound doc comments) but never
ships a writer; this completes the intent.  Output is GLPK-compatible
free format; ranged constraints emit RHS + RANGES rows (the converter's
interval table in reverse), bounds emit the minimal LO/UP/FX/FR/MI set.
"""

from __future__ import annotations

import math
from typing import List

from relp_tpu_torch.model.elements import ConstraintRelation, Objective
from relp_tpu_torch.model.general_form import GeneralForm

INF = float("inf")


def _num(v: float) -> str:
    return f"{v:.17g}"


def write_mps(general: GeneralForm) -> str:
    lines: List[str] = []
    lines.append(f"NAME          {general.name or 'PROBLEM'}")
    if general.objective is Objective.MAXIMIZE:
        lines.append("OBJSENSE")
        lines.append("    MAX")
    lines.append("ROWS")
    lines.append(" N  COST")
    kinds = []
    for i, rel in enumerate(general.constraint_types):
        if rel.is_range:
            kind = "L"  # range written as L row + RANGES entry
        else:
            kind = rel.kind.value
        kinds.append(kind)
        lines.append(f" {kind}  {general.row_names[i]}")

    lines.append("COLUMNS")
    csc = general.A.tocsc()
    from relp_tpu_torch.model.elements import VariableType

    in_int = False  # INTORG/INTEND marker state — integrality must
    # survive the roundtrip or an exported MIP silently becomes an LP
    for j, var in enumerate(general.variables):
        is_int = var.variable_type is VariableType.INTEGER
        if is_int != in_int:
            marker = "INTORG" if is_int else "INTEND"
            lines.append(
                f"    MARKER                 'MARKER'                 "
                f"'{marker}'"
            )
            in_int = is_int
        pairs = []
        if var.cost != 0.0:
            pairs.append(("COST", var.cost))
        s, e = csc.indptr[j], csc.indptr[j + 1]
        for i, v in zip(csc.indices[s:e], csc.data[s:e]):
            if v != 0.0:
                pairs.append((general.row_names[int(i)], float(v)))
        if not pairs:
            # a variable with zero cost and no matrix entries must still
            # appear in COLUMNS or its BOUNDS lines fail to re-parse
            # ("Column not known"); a zero cost entry is a no-op
            pairs.append(("COST", 0.0))
        for k in range(0, len(pairs), 2):
            chunk = pairs[k : k + 2]
            body = "   ".join(f"{rn:<10} {_num(v):>15}" for rn, v in chunk)
            lines.append(f"    {var.name:<10} {body}")
    if in_int:
        lines.append(
            "    MARKER                 'MARKER'                 'INTEND'"
        )

    lines.append("RHS")
    if general.fixed_cost != 0.0:
        lines.append(f"    RHS       COST      {_num(-general.fixed_cost):>15}")
    for i, rel in enumerate(general.constraint_types):
        if general.b[i] != 0.0 or rel.is_range:
            lines.append(
                f"    RHS       {general.row_names[i]:<10} {_num(general.b[i]):>15}"
            )

    if any(rel.is_range for rel in general.constraint_types):
        lines.append("RANGES")
        for i, rel in enumerate(general.constraint_types):
            if rel.is_range:
                lines.append(
                    f"    RNG       {general.row_names[i]:<10}"
                    f"{_num(rel.range_width):>15}"
                )

    bound_lines: List[str] = []
    for var in general.variables:
        lo, hi = var.lower, var.upper
        if lo == 0.0 and hi == INF:
            continue  # default
        if lo == hi:
            bound_lines.append(f" FX BND       {var.name:<10} {_num(lo):>15}")
            continue
        if math.isinf(lo) and lo < 0 and math.isinf(hi):
            bound_lines.append(f" FR BND       {var.name}")
            continue
        if math.isinf(lo) and lo < 0:
            # the reader (mps_convert) keeps the upper at +inf for bare MI
            # (GLPK semantics), so every finite upper must be written
            # explicitly — including 0 — or the roundtrip silently relaxes
            # (-inf, hi] to (-inf, +inf)
            bound_lines.append(f" MI BND       {var.name}")
            if not math.isinf(hi):
                bound_lines.append(f" UP BND       {var.name:<10} {_num(hi):>15}")
            continue
        if lo != 0.0:
            bound_lines.append(f" LO BND       {var.name:<10} {_num(lo):>15}")
        if not math.isinf(hi):
            bound_lines.append(f" UP BND       {var.name:<10} {_num(hi):>15}")
    if bound_lines:
        lines.append("BOUNDS")
        lines.extend(bound_lines)

    lines.append("ENDATA")
    return "\n".join(lines) + "\n"


def export_mps(general: GeneralForm, path) -> None:
    with open(path, "w") as fh:
        fh.write(write_mps(general))
