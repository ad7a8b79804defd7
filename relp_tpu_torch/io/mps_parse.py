"""MPS section parser, free and fixed format.

Counterpart of reference ``src/io/mps/parse/mod.rs`` (single-pass,
never-look-back section parser, sections NAME → (OBJSENSE) → ROWS →
COLUMNS(+INTORG/INTEND markers) → RHS → RANGES → BOUNDS → ENDATA) generic
over a column retriever: free format splits on whitespace
(parse/free.rs:13-95), fixed format extracts the classic character ranges
``[0..1, 1..3, 4..12, 14..22, 24..36, 39..47, 49..61]`` needed for SIF files
whose names contain spaces (parse/fixed.rs:121-128).

Deviations (documented supersets):
- an RHS entry on the cost row is accepted as an objective constant
  (``objective_constant = -value``); the reference rejects it.
- a free-format RHS/RANGES line with an even token count is treated as
  having no set-name field (GLPK tolerates these).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

from relp_tpu_torch.io.errors import InconsistencyError, ParseError
from relp_tpu_torch.io.mps_model import (
    MPS,
    BoundType,
    MpsBound,
    MpsColumn,
    MpsRange,
    MpsRhs,
    MpsRow,
)
from relp_tpu_torch.io.numbers import parse_number
from relp_tpu_torch.model.elements import ConstraintRelation, Objective, VariableType

SECTIONS = ("NAME", "OBJSENSE", "ROWS", "COLUMNS", "RHS", "RANGES", "BOUNDS", "ENDATA")

# Fixed-format character ranges (start, end), 0-indexed end-exclusive.
FIXED_FIELDS = [(0, 1), (1, 3), (4, 12), (14, 22), (24, 36), (39, 47), (49, 61)]


def _lines(text: str) -> Iterator[Tuple[int, str]]:
    """Meaningful (line_number, line) pairs: skip blanks, '*' comments and
    SIF '&' comment-continuation lines (column 1; used by the Kennington
    netlib files, e.g. KEN-07.SIF line 12)."""
    for i, raw in enumerate(text.splitlines(), start=1):
        line = raw.rstrip("\r\n")
        if not line.strip() or line.lstrip().startswith("*") or line.startswith("&"):
            continue
        yield i, line


def _is_section_header(line: str) -> bool:
    # Section headers start at column 0; data lines are indented.
    return not line[0].isspace()


class FreeFields:
    """Whitespace-tokenized field retrieval (reference parse/free.rs)."""

    @staticmethod
    def fields(line: str) -> List[str]:
        return line.split()


class FixedFields:
    """Character-range field retrieval (reference parse/fixed.rs).

    Returns the non-empty fields in order.  Names keep interior spaces but
    are trimmed at the edges of their field window.
    """

    @staticmethod
    def fields(line: str) -> List[str]:
        out = []
        for start, end in FIXED_FIELDS:
            if start >= len(line):
                break
            piece = line[start : min(end, len(line))].strip()
            if piece:
                out.append(piece)
        return out


def parse(text: str, fixed: bool = False, exact: bool = False) -> MPS:
    """Parse MPS text into an :class:`MPS` (reference mps::parse /
    mps::parse_fixed, io/mps/mod.rs:36-60).

    ``exact=True`` parses numbers into ``fractions.Fraction`` (the
    reference's exact decimal parse, io/mps/number/parse.rs:11-66) for the
    CPU-side exact verifier.
    """
    retriever = FixedFields if fixed else FreeFields
    lines = _lines(text)

    program_name = ""
    objective = Objective.MINIMIZE

    # --- NAME (and optional OBJSENSE) ---
    section = None
    for number, line in lines:
        if _is_section_header(line):
            toks = line.split(None, 1)
            head = toks[0].upper()
            if head == "NAME":
                program_name = toks[1].strip() if len(toks) > 1 else ""
                continue
            if head == "OBJSENSE":
                if len(toks) > 1:
                    objective = _parse_objsense(toks[1], (number, line))
                    continue
                # direction is on the following indented line
                number2, line2 = next(lines)
                objective = _parse_objsense(line2, (number2, line2))
                continue
            if head == "ROWS":
                section = "ROWS"
                break
            raise ParseError(f"Unexpected section {head!r} before ROWS", (number, line))
    if section != "ROWS":
        raise ParseError("File has no ROWS section")

    # --- ROWS ---
    cost_row_name: Optional[str] = None
    free_rows: set = set()  # extra N rows: ignored (GLPK-compatible superset;
    #                         the reference rejects a second cost row)
    rows: List[MpsRow] = []
    for number, line in lines:
        if _is_section_header(line):
            section = _expect_section(line, ("COLUMNS",), (number, line))
            break
        f = retriever.fields(line)
        if len(f) < 2:
            raise ParseError("ROWS line needs a type and a name", (number, line))
        rtype = f[0][0].upper()
        name = f[1]
        if rtype == "N":
            if cost_row_name is None:
                cost_row_name = name
            else:
                free_rows.add(name)
        elif rtype in ("L", "E", "G"):
            rows.append(MpsRow(name, ConstraintRelation(rtype)))
        else:
            raise ParseError(f"Row type {f[0]!r} unknown", (number, line))
    if cost_row_name is None:
        raise InconsistencyError("No cost row read.")
    row_index: Dict[str, int] = {}
    for i, row in enumerate(rows):
        if row.name in row_index or row.name == cost_row_name:
            raise InconsistencyError(f"Duplicate row name {row.name!r}")
        row_index[row.name] = i

    # --- COLUMNS ---
    columns: List[MpsColumn] = []
    col_index: Dict[str, int] = {}
    cost_values: List[Tuple[int, float]] = []
    active_type = VariableType.CONTINUOUS
    for number, line in lines:
        if _is_section_header(line):
            section = _expect_section(line, ("RHS", "RANGES", "BOUNDS", "ENDATA"), (number, line))
            break
        f = retriever.fields(line)
        if "'MARKER'" in f:
            if "'INTORG'" in f:
                active_type = VariableType.INTEGER
            elif "'INTEND'" in f:
                active_type = VariableType.CONTINUOUS
            else:
                raise ParseError("Unknown MARKER kind", (number, line))
            continue
        if len(f) < 3 or len(f) % 2 == 0:
            raise ParseError("Malformed COLUMNS line", (number, line))
        col_name = f[0]
        if col_name in col_index and col_index[col_name] != len(columns) - 1:
            # non-contiguous reappearance: merge into the existing column
            j = col_index[col_name]
        elif col_name in col_index:
            j = col_index[col_name]
        else:
            j = len(columns)
            col_index[col_name] = j
            columns.append(MpsColumn(col_name, active_type))
        for k in range(1, len(f), 2):
            row_name, value_text = f[k], f[k + 1]
            value = parse_number(value_text, exact)
            if row_name == cost_row_name:
                cost_values.append((j, value))
            elif row_name in row_index:
                columns[j].values.append((row_index[row_name], value))
            elif row_name in free_rows:
                pass  # coefficient on an ignored free row
            else:
                raise InconsistencyError(f"Row {row_name!r} not known (line {number})")

    # duplicate row entries within a column are inconsistent
    for col in columns:
        col.values.sort(key=lambda t: t[0])
        seen = set()
        for i, _ in col.values:
            if i in seen:
                raise InconsistencyError(f"Duplicate row for column {col.name!r}")
            seen.add(i)

    # --- RHS / RANGES / BOUNDS ---
    rhss: List[MpsRhs] = []
    ranges: List[MpsRange] = []
    bounds: List[MpsBound] = []
    objective_constant = 0.0

    while section not in ("ENDATA", None):
        if section == "RHS":
            section, objective_constant = _parse_value_section(
                lines, retriever, row_index, rhss, MpsRhs,
                ("RANGES", "BOUNDS", "ENDATA"), cost_row_name, objective_constant,
                exact, free_rows,
            )
        elif section == "RANGES":
            section, objective_constant = _parse_value_section(
                lines, retriever, row_index, ranges, MpsRange,
                ("BOUNDS", "ENDATA"), None, objective_constant, exact, free_rows,
            )
        elif section == "BOUNDS":
            section = _parse_bounds_section(lines, retriever, col_index, bounds, exact)
        else:  # pragma: no cover
            raise ParseError(f"Unhandled section {section!r}")

    return MPS(
        name=program_name,
        objective=objective,
        cost_row_name=cost_row_name,
        cost_values=sorted(cost_values),
        objective_constant=objective_constant,
        rows=rows,
        columns=columns,
        rhss=rhss,
        ranges=ranges,
        bounds=bounds,
    )


def _parse_objsense(text: str, loc) -> Objective:
    word = text.split()[0].upper() if text.split() else ""
    if word.startswith("MAX"):
        return Objective.MAXIMIZE
    if word.startswith("MIN"):
        return Objective.MINIMIZE
    raise ParseError(f"Unknown OBJSENSE {text!r}", loc)


def _expect_section(line: str, allowed: Tuple[str, ...], loc) -> str:
    head = line.split()[0].upper()
    if head == "OBJECT":
        # SIF "OBJECT BOUND" metadata section: always trailing, solution
        # bounds in comments only — treat as end of data
        return "ENDATA"
    if head not in allowed:
        raise ParseError(f"Unexpected section {head!r}; expected one of {allowed}", loc)
    return head


def _parse_value_section(lines, retriever, row_index, collector, cls,
                         next_sections, cost_row_name, objective_constant,
                         exact=False, free_rows=frozenset()):
    """Shared RHS/RANGES parsing (reference parse_optional_section,
    parse/mod.rs:535+).  Groups by set name; values attach to rows."""
    current = None
    for number, line in lines:
        if _is_section_header(line):
            return _expect_section(line, next_sections, (number, line)), objective_constant
        f = retriever.fields(line)
        if len(f) % 2 == 0:
            # no set-name field (tolerated superset; see module docstring)
            name, pairs = "", f
        else:
            name, pairs = f[0], f[1:]
        if len(pairs) < 2:
            raise ParseError("Malformed RHS/RANGES line", (number, line))
        if current is None or current.name != name:
            current = cls(name)
            collector.append(current)
        for k in range(0, len(pairs), 2):
            row_name, value_text = pairs[k], pairs[k + 1]
            value = parse_number(value_text, exact)
            if row_name in row_index:
                current.values.append((row_index[row_name], value))
            elif cost_row_name is not None and row_name == cost_row_name:
                # RHS on the objective row: objective constant (negated).
                objective_constant = -value
            elif row_name in free_rows:
                pass  # value on an ignored free row
            else:
                raise InconsistencyError(f"Row {row_name!r} not known (line {number})")
    return None, objective_constant


def _parse_bounds_section(lines, retriever, col_index, bounds: List[MpsBound], exact=False):
    current: Optional[MpsBound] = None
    for number, line in lines:
        if _is_section_header(line):
            return _expect_section(line, ("ENDATA",), (number, line))
        f = retriever.fields(line)
        if len(f) < 3:
            raise ParseError("Malformed BOUNDS line", (number, line))
        try:
            btype = BoundType(f[0].upper())
        except ValueError as e:
            raise ParseError(f"Bound type {f[0]!r} unknown", (number, line)) from e
        # Heuristic for a missing bound-set-name field: for valued bounds the
        # line is TYPE [SET] COL VALUE; for non-valued, TYPE [SET] COL.
        if btype.takes_value:
            if len(f) >= 4:
                set_name, col_name, value_text = f[1], f[2], f[3]
            else:
                set_name, col_name, value_text = "", f[1], f[2]
            value = parse_number(value_text, exact)
        else:
            # FR/MI/PL/BV: value field optional and ignored
            set_name, col_name = f[1], f[2]
            if col_name not in col_index and set_name in col_index:
                set_name, col_name = "", set_name
            value = None
        if col_name not in col_index:
            raise InconsistencyError(f"Column {col_name!r} not known (line {number})")
        if current is None or current.name != set_name:
            current = MpsBound(set_name)
            bounds.append(current)
        current.values.append((col_index[col_name], btype, value))
    return None


def parse_free(text: str, exact: bool = False) -> MPS:
    return parse(text, fixed=False, exact=exact)


def parse_fixed(text: str, exact: bool = False) -> MPS:
    return parse(text, fixed=True, exact=exact)
