"""ctypes bindings for the native C++ MPS scanner (native/mps_scan.cpp).

The pure-Python parser (io/mps_parse.py) is the semantic source of truth; this
native scanner is the fast path for large files.  The interface is that of
``relp_tpu/io/native.py``; the source is shared with the JAX package and the
library is this package's own build (utils/native_build.py, g++, plain C
ABI).  ``import_mps`` falls back to the Python parser when it is unavailable.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

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
from relp_tpu_torch.model.elements import ConstraintRelation, Objective, VariableType
from relp_tpu_torch.utils.native_build import load_native


def _bind(lib: ctypes.CDLL) -> None:
    lib.mps_scan.restype = ctypes.c_void_p
    lib.mps_scan.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.mps_free.argtypes = [ctypes.c_void_p]
    for name, res in [
        ("mps_error", ctypes.c_char_p),
        ("mps_problem_name", ctypes.c_char_p),
        ("mps_row_name", ctypes.c_char_p),
        ("mps_col_name", ctypes.c_char_p),
        ("mps_rhs_group_name", ctypes.c_char_p),
        ("mps_range_group_name", ctypes.c_char_p),
        ("mps_bound_group_name", ctypes.c_char_p),
    ]:
        getattr(lib, name).restype = res
    lib.mps_error.argtypes = [ctypes.c_void_p]
    lib.mps_problem_name.argtypes = [ctypes.c_void_p]
    P_I32 = ctypes.POINTER(ctypes.c_int32)
    P_F64 = ctypes.POINTER(ctypes.c_double)
    lib.mps_get_entries.argtypes = [ctypes.c_void_p, P_I32, P_I32, P_F64]
    lib.mps_get_entries.restype = None
    lib.mps_get_cost.argtypes = [ctypes.c_void_p, P_I32, P_F64]
    lib.mps_get_cost.restype = None
    lib.mps_get_rhs.argtypes = [ctypes.c_void_p, P_I32, P_I32, P_F64]
    lib.mps_get_rhs.restype = None
    lib.mps_get_ranges.argtypes = [ctypes.c_void_p, P_I32, P_I32, P_F64]
    lib.mps_get_ranges.restype = None
    lib.mps_get_bounds.argtypes = [
        ctypes.c_void_p,
        P_I32,
        ctypes.POINTER(ctypes.c_char),
        P_F64,
        ctypes.POINTER(ctypes.c_uint8),
        P_I32,
    ]
    lib.mps_get_bounds.restype = None
    lib.mps_row_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mps_col_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mps_rhs_group_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mps_range_group_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mps_bound_group_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mps_row_type.restype = ctypes.c_char
    lib.mps_row_type.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mps_col_is_int.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mps_objsense.argtypes = [ctypes.c_void_p]
    lib.mps_obj_constant.restype = ctypes.c_double
    lib.mps_obj_constant.argtypes = [ctypes.c_void_p]
    for name in ("mps_nr_entries", "mps_nr_cost", "mps_nr_rhs",
                 "mps_nr_ranges", "mps_nr_bounds"):
        getattr(lib, name).restype = ctypes.c_int64
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    for name in ("mps_nr_rows", "mps_nr_cols", "mps_nr_rhs_groups",
                 "mps_nr_range_groups", "mps_nr_bound_groups"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]


def _load() -> Optional[ctypes.CDLL]:
    return load_native("mps_scan.cpp", ("-O2",), _bind, timeout=120)


def native_available() -> bool:
    return _load() is not None


def parse_file_native(path: str, fixed: bool) -> MPS:
    """Parse via the C++ scanner; raises on scanner errors."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native scanner unavailable")
    h = lib.mps_scan(str(path).encode(), 1 if fixed else 0)
    try:
        err = lib.mps_error(h)
        if err:
            msg = err.decode()
            if "not known" in msg or "Duplicate" in msg or "No cost row" in msg:
                raise InconsistencyError(msg)
            raise ParseError(msg)

        nrows = lib.mps_nr_rows(h)
        ncols = lib.mps_nr_cols(h)
        rows = [
            MpsRow(
                lib.mps_row_name(h, i).decode(),
                ConstraintRelation(lib.mps_row_type(h, i).decode()),
            )
            for i in range(nrows)
        ]
        columns = [
            MpsColumn(
                lib.mps_col_name(h, j).decode(),
                VariableType.INTEGER if lib.mps_col_is_int(h, j) else VariableType.CONTINUOUS,
            )
            for j in range(ncols)
        ]

        ne = lib.mps_nr_entries(h)
        col = np.empty(ne, np.int32)
        row = np.empty(ne, np.int32)
        val = np.empty(ne, np.float64)
        if ne:
            lib.mps_get_entries(
                h,
                col.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                row.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                val.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            )
        for k in range(ne):
            columns[col[k]].values.append((int(row[k]), float(val[k])))
        for c in columns:
            c.values.sort(key=lambda t: t[0])
            seen = set()
            for i, _ in c.values:
                if i in seen:
                    raise InconsistencyError(f"Duplicate row for column {c.name!r}")
                seen.add(i)

        nc = lib.mps_nr_cost(h)
        ccol = np.empty(nc, np.int32)
        cval = np.empty(nc, np.float64)
        if nc:
            lib.mps_get_cost(
                h,
                ccol.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                cval.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            )
        cost_values = sorted((int(ccol[k]), float(cval[k])) for k in range(nc))

        def read_groups(nr_fn, get_fn, ngroups_fn, gname_fn, cls):
            n = nr_fn(h)
            g = np.empty(n, np.int32)
            r = np.empty(n, np.int32)
            v = np.empty(n, np.float64)
            if n:
                get_fn(
                    h,
                    g.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    r.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                )
            out = [cls(gname_fn(h, i).decode()) for i in range(ngroups_fn(h))]
            for k in range(n):
                out[g[k]].values.append((int(r[k]), float(v[k])))
            return out

        rhss = read_groups(lib.mps_nr_rhs, lib.mps_get_rhs,
                           lib.mps_nr_rhs_groups, lib.mps_rhs_group_name, MpsRhs)
        ranges = read_groups(lib.mps_nr_ranges, lib.mps_get_ranges,
                             lib.mps_nr_range_groups, lib.mps_range_group_name, MpsRange)

        nb = lib.mps_nr_bounds(h)
        bcol = np.empty(nb, np.int32)
        btypes = np.empty(2 * nb, np.uint8)
        bval = np.empty(nb, np.float64)
        bhas = np.empty(nb, np.uint8)
        bgrp = np.empty(nb, np.int32)
        if nb:
            lib.mps_get_bounds(
                h,
                bcol.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                btypes.ctypes.data_as(ctypes.POINTER(ctypes.c_char)),
                bval.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                bhas.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                bgrp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
        bounds = [
            MpsBound(lib.mps_bound_group_name(h, i).decode())
            for i in range(lib.mps_nr_bound_groups(h))
        ]
        for k in range(nb):
            t = bytes(btypes[2 * k : 2 * k + 2]).decode()
            bounds[bgrp[k]].values.append(
                (int(bcol[k]), BoundType(t), float(bval[k]) if bhas[k] else None)
            )

        return MPS(
            name=lib.mps_problem_name(h).decode(),
            objective=Objective.MAXIMIZE if lib.mps_objsense(h) else Objective.MINIMIZE,
            cost_row_name="",  # not used downstream
            cost_values=cost_values,
            objective_constant=lib.mps_obj_constant(h),
            rows=rows,
            columns=columns,
            rhss=rhss,
            ranges=ranges,
            bounds=bounds,
        )
    finally:
        lib.mps_free(h)
