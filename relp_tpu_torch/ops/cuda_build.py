"""Build and load the hand-written CUDA kernels (``relp_tpu_torch/csrc``).

Every ``csrc/*.cu`` is compiled at first use, on the machine with the card,
by ``nvcc`` (one process per source, all started together, then one link)
into a single shared library with a plain C interface, which is loaded
with ``ctypes``; :data:`SIGNATURES` binds every kernel's entry points.  The
library lands in ``relp_tpu_torch/_build/`` under a name that carries a
hash of the sources (``*.cu`` and the ``*.cuh`` they include) and flags, so
an edited source is rebuilt and an unchanged one is loaded as it is.
Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ARCH_FLAGS + ["-shared"]

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# entry point -> argument types (each returns its cudaError_t as an int)
SIGNATURES = {
    # sparse_kernels.cu: data, idx, y, c, out, n, j0, w, K, m, blocks, stage,
    # SelectArgs* (select_epilogue.cuh; null: write out), stream
    "relp_ell_price_f32": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I32, _I64, _I32, _I32, _P, _P],
    "relp_ell_price_f64": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I32, _I64, _I32, _I32, _P, _P],
    # sparse_kernels.cu: rdata, rcols, x, y, m, K, segments, slots of a segment,
    # row threads, rows of a thread (ops/sparse_kernels.py: spmv_plan), stream
    "relp_ell_spmv_f32": [_P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32, _P],
    "relp_ell_spmv_f64": [_P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32, _P],
    # dense_kernels.cu: A, v, c, out, partial, counters, m, lda, j0, w, slices,
    # rows_per_slice, SelectArgs* (null: write out), LaneArgs* (null: one
    # vector), lanes, lanes a block serves (ops/dense_kernels.py: lane_plan), stream
    "relp_dense_price_f32": [_P, _P, _P, _P, _P, _P, _I32, _I64, _I64, _I64, _I32, _I32, _P,
                             _P, _I32, _I32, _P],
    "relp_dense_price_f64": [_P, _P, _P, _P, _P, _P, _I32, _I64, _I64, _I64, _I32, _I32, _P,
                             _P, _I32, _I32, _P],
    # brick_kernels.cu: ptr, vals, pos, tile_of (null: identity), v, c (null:
    # the sum alone; brick_spmv ignores it), out, tiles, lanes a tile
    # (ops/brick_kernels.py: tile_lanes), stream
    "relp_brick_spmv_f32": [_P, _P, _P, _P, _P, _P, _P, _I64, _I32, _P],
    "relp_brick_spmv_f64": [_P, _P, _P, _P, _P, _P, _P, _I64, _I32, _P],
    "relp_brick_price_f32": [_P, _P, _P, _P, _P, _P, _P, _I64, _I32, _P],
    "relp_brick_price_f64": [_P, _P, _P, _P, _P, _P, _P, _I64, _I32, _P],
    # dual_kernels.cu: DualUpdateArgs* (ops/dual_kernels.py), devex, stream
    "relp_dual_update": [_P, _I32, _P],
    # probe_kernels.cu: x, out, n, stream
    "relp_probe_scale_f32": [_P, _P, _I64, _P],
    "relp_probe_scale_f64": [_P, _P, _I64, _P],
}


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_s: float  # seconds spent compiling in this process (0 if cached)
    log: str        # nvcc's output (ptxas register and spill lines); "" if cached


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


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands concurrently; raise on the first failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


def _build(srcs: list[Path], lib_path: Path) -> str:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{s.stem}.o" for s in srcs]
        log = _run_all([[nvcc, *COMPILE_FLAGS, "-c", "-o", str(o), str(s)]
                        for s, o in zip(srcs, objs)])
        tmp_lib = Path(tmp) / lib_path.name
        log += _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp_lib), *map(str, objs)]])
        os.replace(tmp_lib, lib_path)
    return log


@functools.cache
def load_kernels() -> KernelLibrary:
    """Build (if needed) and load every kernel of ``csrc/``."""
    srcs = _sources()
    digest = hashlib.sha256()
    for s in srcs + sorted(CSRC_DIR.glob("*.cuh")):  # the headers they include too
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    digest.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    lib_path = BUILD_DIR / f"librelp_kernels_{digest.hexdigest()[:16]}.so"
    build_s, log = 0.0, ""
    if not lib_path.exists():
        t0 = time.perf_counter()
        log = _build(srcs, lib_path)
        build_s = time.perf_counter() - t0
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return KernelLibrary(lib=lib, path=lib_path, build_s=build_s, log=log)


def raise_on(name: str, err: int) -> None:
    """Raise if a kernel's entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
