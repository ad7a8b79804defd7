"""I/O layer: MPS/SIF import and MPS export (host code).

``import_lp(path)`` dispatches on the file extension — ``.mps`` (free
format) and ``.sif`` (fixed format) — and uses the native C++ scanner
(io/native.py) where its build is available, the Python parser otherwise
or under ``RELP_TPU_NO_NATIVE=1``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Union

from relp_tpu_torch.io.errors import (
    FileExtensionError,
    ImportError_,
    InconsistencyError,
    ParseError,
)
from relp_tpu_torch.io.mps_convert import mps_to_general_form
from relp_tpu_torch.io.mps_model import MPS
from relp_tpu_torch.io.mps_parse import parse, parse_fixed, parse_free
from relp_tpu_torch.model.general_form import GeneralForm


def import_mps(path: Union[str, os.PathLike]) -> MPS:
    """Read a problem file into an MPS structure (not yet a GeneralForm).

    Uses the native C++ scanner when available (differentially tested
    against the Python parser); set RELP_TPU_NO_NATIVE=1 to force Python.
    """
    p = Path(path)
    ext = p.suffix.lower()
    if ext not in (".mps", ".sif"):
        raise FileExtensionError(
            f"Could not import file with extension {ext!r}; expected .mps or .sif"
        )
    fixed = ext == ".sif"
    if not os.environ.get("RELP_TPU_NO_NATIVE"):
        from relp_tpu_torch.io import native

        if native.native_available():
            return native.parse_file_native(str(p), fixed)
    text = p.read_text()
    return parse_fixed(text) if fixed else parse_free(text)


def import_lp(path: Union[str, os.PathLike]) -> GeneralForm:
    """Read a problem file straight into a GeneralForm."""
    return mps_to_general_form(import_mps(path))


__all__ = [
    "FileExtensionError",
    "ImportError_",
    "InconsistencyError",
    "MPS",
    "ParseError",
    "import_lp",
    "import_mps",
    "mps_to_general_form",
    "parse",
    "parse_fixed",
    "parse_free",
]
