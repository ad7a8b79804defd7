"""Build and load the hand-written CUDA kernels (``relp_tpu_torch/csrc``).

The sources are compiled at first use, on the machine with the card, by
``nvcc`` into a shared library with a plain C interface, which is loaded
with ``ctypes``.  The library lands in ``relp_tpu_torch/_build/`` under a
name that carries a hash of the sources, so an edited source is rebuilt
and an unchanged one is loaded as it is.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_PRICE_ARGS = [_P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int, _P]
_SPMV_ARGS = [_P, _P, _P, _P, ctypes.c_int64, ctypes.c_int, _P]


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_s: float  # seconds spent compiling in this process (0 if cached)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under $CUDA_HOME/bin); the CUDA "
        "kernels of relp_tpu_torch are built from source at first use"
    )


def _sources() -> list[Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


@functools.cache
def load_sparse_kernels() -> KernelLibrary:
    """Build (if needed) and load the sparse-operator kernels."""
    srcs = _sources()
    digest = hashlib.sha256()
    for s in srcs:
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"libsparse_kernels_{digest.hexdigest()[:16]}.so"
    build_s = 0.0
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name in ("relp_ell_price_f32", "relp_ell_price_f64"):
        fn = getattr(lib, name)
        fn.argtypes = _PRICE_ARGS
        fn.restype = ctypes.c_int
    for name in ("relp_ell_spmv_f32", "relp_ell_spmv_f64"):
        fn = getattr(lib, name)
        fn.argtypes = _SPMV_ARGS
        fn.restype = ctypes.c_int
    return KernelLibrary(lib=lib, path=lib_path, build_s=build_s)
