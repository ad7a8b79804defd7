"""Build and load the host C++ libraries under ``native/`` (plain C ABI).

``native/ftlu.cpp`` (the Forrest–Tomlin LU of simplex/ftlu.py) and
``native/mps_scan.cpp`` (the MPS scanner of io/native.py) are shared with the
JAX package, which builds them into ``native/_build/``; this package builds
its own copies into ``relp_tpu_torch/_build/``, under a name that carries a
hash of the source and flags.  ``g++`` writes to a temporary name in that
directory and the finished file is renamed into place, so a process that
finds the library finds a whole one, however many build at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Optional

NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

_lock = threading.Lock()
_loaded: dict[str, Optional[ctypes.CDLL]] = {}


def load_native(source: str, flags: tuple[str, ...], bind: Callable[[ctypes.CDLL], None],
                timeout: int = 180) -> Optional[ctypes.CDLL]:
    """The shared library of ``native/<source>``, built on first use and
    handed once to ``bind`` (which declares its functions' types); None when
    the source or ``g++`` is missing or the build fails (callers then take
    their pure-Python route).  The answer is kept for the process."""
    with _lock:
        if source not in _loaded:
            lib = _build_and_load(NATIVE_DIR / source, flags, timeout)
            if lib is not None:
                bind(lib)
            _loaded[source] = lib
        return _loaded[source]


def _build_and_load(src: Path, flags: tuple[str, ...], timeout: int) -> Optional[ctypes.CDLL]:
    if not src.exists():
        return None
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    try:
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                tmp_lib = Path(tmp) / lib_path.name
                subprocess.run(["g++", *flags, "-shared", "-fPIC", "-std=c++17", str(src),
                                "-o", str(tmp_lib)],
                               check=True, capture_output=True, timeout=timeout)
                os.replace(tmp_lib, lib_path)
        return ctypes.CDLL(str(lib_path))
    except (OSError, subprocess.SubprocessError):
        return None
