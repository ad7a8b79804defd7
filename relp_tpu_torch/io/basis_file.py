"""MPS basis-file reader (the standard warm-start interchange format).

Port of ``relp_tpu/io/basis_file.py``.  Lines carry basis statuses (an
example is the unicamp corpus's ``basis_data_1.mps``):

    XU col row [vals]   column basic, row's logical nonbasic at upper
    XL col row [vals]   column basic, row's logical nonbasic at lower
    UL col [val]        column nonbasic at upper bound
    LL col [val]        column nonbasic at lower bound
    BS name [val]       name (column or row logical) basic

Defaults: every row's logical is basic, every column nonbasic at its lower
bound.  Trailing numeric values (activity levels, a common extension) are
accepted and ignored — statuses are enough to refactorize, exactly like the
reference rebuilds an ``InverseMaintener`` from a basis (``IM::from_basis``,
carry/mod.rs:428-463).
"""

from __future__ import annotations

import enum
import os
from dataclasses import dataclass, field
from typing import Dict, Union

from relp_tpu_torch.io.errors import ParseError


class BasisStatus(enum.Enum):
    BASIC = "BS"
    AT_LOWER = "LL"
    AT_UPPER = "UL"


@dataclass
class MpsBasis:
    """Parsed basis: statuses by name; unknown names resolved by the
    applier against a problem's row/column names."""

    name: str = ""
    column_status: Dict[str, BasisStatus] = field(default_factory=dict)
    row_status: Dict[str, BasisStatus] = field(default_factory=dict)

    def status_of_column(self, name: str) -> BasisStatus:
        return self.column_status.get(name, BasisStatus.AT_LOWER)

    def status_of_row(self, name: str) -> BasisStatus:
        return self.row_status.get(name, BasisStatus.BASIC)


def _is_number(tok: str) -> bool:
    try:
        float(tok.replace("D", "e").replace("d", "e"))
        return True
    except ValueError:
        return False


def parse_basis(text: str) -> MpsBasis:
    basis = MpsBasis()
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = raw.rstrip()
        if not line.strip() or line.lstrip().startswith("*"):
            continue
        if not line[0].isspace():
            toks = line.split(None, 1)
            head = toks[0].upper()
            if head == "NAME":
                basis.name = toks[1].strip() if len(toks) > 1 else ""
                continue
            if head == "ENDATA":
                break
            raise ParseError(f"Unknown basis section {head!r}", (lineno, line))
        toks = line.split()
        kind = toks[0].upper()
        if kind in ("XU", "XL"):
            if len(toks) < 3:
                raise ParseError("XU/XL needs column and row names", (lineno, line))
            col, row = toks[1], toks[2]
            basis.column_status[col] = BasisStatus.BASIC
            basis.row_status[row] = (
                BasisStatus.AT_UPPER if kind == "XU" else BasisStatus.AT_LOWER
            )
        elif kind in ("UL", "LL", "BS"):
            if len(toks) < 2:
                raise ParseError(f"{kind} needs a name", (lineno, line))
            name = toks[1]
            status = {
                "UL": BasisStatus.AT_UPPER,
                "LL": BasisStatus.AT_LOWER,
                "BS": BasisStatus.BASIC,
            }[kind]
            # BS may name a row logical; rows and columns share a namespace
            # here — the applier disambiguates against the problem
            basis.column_status[name] = status
        else:
            raise ParseError(f"Unknown basis line kind {kind!r}", (lineno, line))
    return basis


def import_basis(path: Union[str, os.PathLike]) -> MpsBasis:
    with open(path) as fh:
        return parse_basis(fh.read())
