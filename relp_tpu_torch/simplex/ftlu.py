"""ctypes bindings for the native Forrest–Tomlin LU engine (native/ftlu.cpp).

A sparse ``PBQ = LU`` factorization with Markowitz pivoting and
Forrest–Tomlin spike updates, in C++, for the host simplex and crossover
engines (simplex/lu_host.py): ``ftran``/``btran`` solves plus a true FT column
update, numerically stable over thousands of degenerate pivots where
product-form etas compound error.  The interface is that of
``relp_tpu/simplex/ftlu.py``; the source is shared with the JAX package and
the library is this package's own build (utils/native_build.py).

Built on demand with g++ (plain C ABI); callers fall back to the SuperLU +
product-form-eta engine when the build fails.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from relp_tpu_torch.utils.native_build import load_native

_P_I32 = ctypes.POINTER(ctypes.c_int32)
_P_F64 = ctypes.POINTER(ctypes.c_double)


def _bind(lib: ctypes.CDLL) -> None:
    lib.ftlu_create.restype = ctypes.c_void_p
    lib.ftlu_create.argtypes = [ctypes.c_int32, _P_I32, _P_I32, _P_F64]
    lib.ftlu_ok.restype = ctypes.c_int32
    lib.ftlu_ok.argtypes = [ctypes.c_void_p]
    lib.ftlu_ftran.argtypes = [ctypes.c_void_p, _P_F64]
    lib.ftlu_btran.argtypes = [ctypes.c_void_p, _P_F64]
    lib.ftlu_update.restype = ctypes.c_int32
    lib.ftlu_update.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, _P_I32, _P_F64,
    ]
    lib.ftlu_nupdates.restype = ctypes.c_int32
    lib.ftlu_nupdates.argtypes = [ctypes.c_void_p]
    lib.ftlu_fill.restype = ctypes.c_int64
    lib.ftlu_fill.argtypes = [ctypes.c_void_p]
    lib.ftlu_free.argtypes = [ctypes.c_void_p]


def load() -> Optional[ctypes.CDLL]:
    """The shared library, built on first use; None when unavailable."""
    return load_native("ftlu.cpp", ("-O3",), _bind)


class FtLU:
    """Sparse LU of an m×m CSC matrix with Forrest–Tomlin column updates.

    Same surface as lu_host's product-form engine (``ftran``/``btran``)
    plus :meth:`update`, which replaces basis column ``slot`` with a new
    matrix column and restores U's triangularity with one row eta.
    """

    def __init__(self, B_csc):
        lib = load()
        if lib is None:
            raise RuntimeError("native ftlu unavailable")
        B = B_csc.tocsc()
        B.sort_indices()
        m = B.shape[0]
        indptr = np.ascontiguousarray(B.indptr, np.int32)
        indices = np.ascontiguousarray(B.indices, np.int32)
        data = np.ascontiguousarray(B.data, np.float64)
        self._lib = lib
        self._m = m
        self._h = lib.ftlu_create(
            m,
            indptr.ctypes.data_as(_P_I32),
            indices.ctypes.data_as(_P_I32),
            data.ctypes.data_as(_P_F64),
        )
        if not lib.ftlu_ok(self._h):
            lib.ftlu_free(self._h)
            self._h = None
            raise RuntimeError("ftlu: singular basis matrix")
        self.unstable = False  # set when an update reports loss of accuracy

    def __del__(self):  # pragma: no cover - destructor timing
        h = getattr(self, "_h", None)
        if h is not None:
            self._lib.ftlu_free(h)
            self._h = None

    def ftran(self, v: np.ndarray) -> np.ndarray:
        w = np.ascontiguousarray(v, np.float64).copy()
        self._lib.ftlu_ftran(self._h, w.ctypes.data_as(_P_F64))
        return w

    def btran(self, v: np.ndarray) -> np.ndarray:
        w = np.ascontiguousarray(v, np.float64).copy()
        self._lib.ftlu_btran(self._h, w.ctypes.data_as(_P_F64))
        return w

    def update(self, slot: int, col_rows: np.ndarray, col_vals: np.ndarray) -> int:
        """Basis column ``slot`` := sparse column (rows, vals).

        Returns 0 on success, 1 when the update succeeded but accuracy is
        degraded (refactorize soon), -1 on a structurally bad column.
        """
        rows = np.ascontiguousarray(col_rows, np.int32)
        vals = np.ascontiguousarray(col_vals, np.float64)
        rc = self._lib.ftlu_update(
            self._h, int(slot), len(rows),
            rows.ctypes.data_as(_P_I32), vals.ctypes.data_as(_P_F64),
        )
        if rc == 1:
            self.unstable = True
        return int(rc)

    @property
    def nupdates(self) -> int:
        return int(self._lib.ftlu_nupdates(self._h))

    @property
    def fill(self) -> int:
        return int(self._lib.ftlu_fill(self._h))


def available() -> bool:
    return load() is not None
