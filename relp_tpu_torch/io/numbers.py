"""Numeric field parsing for MPS files.

Counterpart of reference ``src/io/mps/number/parse.rs:11-80``: the reference
parses decimal text *exactly* into rationals (digits / 10^k, no float
round-trip).  Here the default target is float64 (Python's ``float`` performs
correctly-rounded decimal→binary conversion), with an optional exact
``fractions.Fraction`` path (``parse_exact``).

Fortran-style ``D`` exponents (``1.5D+02``) found in some SIF files are
accepted.
"""

from __future__ import annotations

import re
from fractions import Fraction
from typing import Union

from relp_tpu_torch.io.errors import ParseError

_D_EXP = re.compile(r"^([+-]?[\d.]+)[dD]([+-]?\d+)$")


def parse_float(text: str) -> float:
    t = text.strip()
    m = _D_EXP.match(t)
    if m:
        t = f"{m.group(1)}e{m.group(2)}"
    try:
        return float(t)
    except ValueError as e:
        raise ParseError(f"Could not parse number {text!r}") from e


def parse_exact(text: str) -> Fraction:
    """Exact decimal parse (reference ``Rational64::parse``: value = digits/10^k)."""
    t = text.strip()
    m = _D_EXP.match(t)
    if m:
        t = f"{m.group(1)}e{m.group(2)}"
    try:
        return Fraction(t)
    except ValueError as e:
        raise ParseError(f"Could not parse number {text!r}") from e


Number = Union[float, Fraction]


def parse_number(text: str, exact: bool = False) -> Number:
    return parse_exact(text) if exact else parse_float(text)
