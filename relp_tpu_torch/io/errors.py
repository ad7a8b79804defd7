"""Typed import error hierarchy.

Counterpart of reference ``src/io/error.rs:15-33`` (``Import{FileExtension,
IO, Parse, LinearProgram}``, nested parse errors with file location, and
``Inconsistency``).
"""

from __future__ import annotations

from typing import Optional, Tuple


class ImportError_(Exception):
    """Base class for all import failures."""


class FileExtensionError(ImportError_):
    pass


class ParseError(ImportError_):
    """Syntax-level failure; carries (line_number, line_text) when known."""

    def __init__(self, message: str, location: Optional[Tuple[int, str]] = None):
        self.location = location
        if location is not None:
            message = f"{message} (line {location[0]}: {location[1]!r})"
        super().__init__(message)


class InconsistencyError(ImportError_):
    """The file parsed but describes contradictory data (reference
    ``Inconsistency``)."""
