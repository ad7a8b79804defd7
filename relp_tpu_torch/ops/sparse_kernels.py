"""Wrappers and plain versions of the sparse-operator CUDA kernels.

``ell_price`` replaces ``brick_pricing_pallas`` and ``ell_spmv`` replaces
``brick_spmv_pallas`` (both in ``relp_tpu/ops/pallas_kernels.py``).  The
kernels are in ``relp_tpu_torch/csrc/sparse_kernels.cu``.  Both are gathers
bound by bytes (a value and an index per slot, 8 bytes in f32 and 12 in f64,
nothing reused but the gathered vector); at the main path's shapes (n ≈ 32k
columns, K = 2) a launch moves under 1 MB, so the launch and the chain
index load → gather bound them.  ``ell_price`` stages the gathered vector in
shared memory when it fits (the TPU kernel's whole-vector VMEM residency),
runs a few blocks per SM that stride over the columns, and reads 4
neighbouring columns a thread with 16-byte loads.  ``ell_spmv`` has few rows,
each many slots deep (Kr = 31 at m = 4,096): it cuts a row's slots into S
segments that different threads sum (:func:`spmv_plan`), so the launch fills
the card, issues a batch of a segment's loads before the first gather, and
adds a row's S partial sums in shared memory in a fixed order, without
atomics.  It does not stage ``x``: with many blocks and an ``x`` of n
elements (256 KB in f64 at n = 32,768, more than a block's shared memory)
staging would move more bytes than the gathers, so ``x`` is gathered through
the read-only path and lives in L2.

``ell_price_select`` is the pricing pass with the selection epilogue
(``ops/select_epilogue.py``): the entering column ``(q, has, d_q)`` comes
out of the kernel and ``d`` is never written.

An ELL pool here is K-major: ``data_t[K, n]`` values and ``idx_t[K, n]``
int32 indices, padding slots holding (index 0, value 0).  Every index must
lie inside the gathered vector; the operator constructors check that once.
``ell_price`` prices a column window ``[j0, j0+w)`` of the pool in place
(partial pricing), with no copy of the strided slice.

A wrapper given CPU tensors computes the plain PyTorch version.  Given CUDA
tensors it launches the kernel or raises: there is no fallback.  Each
wrapper counts its launches in a plain integer attribute, ``launches``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from relp_tpu_torch.ops.select_epilogue import (
    Selection,
    check_selection,
    drop_workspace,
    select_args,
    select_outputs,
    select_plain,
    workspace,
)

_FLOATS = (torch.float32, torch.float64)
_PRICE_CHUNK = 128 * 4         # columns a block of ell_price takes at a time (csrc)
_PRICE_BLOCKS = 264            # at most two blocks per SM of an H100 (132 SMs)
_STAGE_BYTES = 227 * 1024 - 2048  # dynamic shared memory a block may ask for
_SPMV_THREADS = 256            # threads of an ell_spmv block (row threads x segments)
_SPMV_FILL = 16384             # threads of a launch below which a row's slots are split
_SPMV_WIDE_ROWS = 131072       # rows from which a thread takes 4 of them


def ell_price_plain(data_t: torch.Tensor, idx_t: torch.Tensor, y: torch.Tensor,
                    c: Optional[torch.Tensor] = None, j0: int = 0,
                    w: Optional[int] = None) -> torch.Tensor:
    """``c − Σ_k data_t[k]·y[idx_t[k]]`` over the columns ``[j0, j0+w)``
    (or the sum alone when ``c`` is None)."""
    w = data_t.shape[1] - j0 if w is None else w
    data_t, idx_t = data_t[:, j0:j0 + w], idx_t[:, j0:j0 + w]
    acc = (data_t * y[idx_t]).sum(0)
    return acc if c is None else c - acc


def ell_spmv_plain(rdata_t: torch.Tensor, rcols_t: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """``Σ_k rdata_t[k]·x[rcols_t[k]]`` — A·x over the row-major twin."""
    return (rdata_t * x[rcols_t]).sum(0)


def _check(name, data_t, idx_t, vec, c=None, c_len=None):
    tensors = [data_t, idx_t, vec] + ([] if c is None else [c])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devices))}")
    if data_t.dtype not in _FLOATS:
        raise TypeError(f"{name}: values must be float32 or float64, got {data_t.dtype}")
    if vec.dtype != data_t.dtype or (c is not None and c.dtype != data_t.dtype):
        raise TypeError(f"{name}: vectors must have the values' dtype {data_t.dtype}")
    if idx_t.dtype != torch.int32:
        raise TypeError(f"{name}: indices must be int32, got {idx_t.dtype}")
    if data_t.dim() != 2 or idx_t.shape != data_t.shape:
        raise ValueError(
            f"{name}: values and indices must both be [K, n], got "
            f"{tuple(data_t.shape)} and {tuple(idx_t.shape)}"
        )
    if data_t.shape[0] < 1:
        raise ValueError(f"{name}: the pool needs K >= 1 slots")
    c_len = data_t.shape[1] if c_len is None else c_len
    if vec.dim() != 1 or (c is not None and c.shape != (c_len,)):
        raise ValueError(f"{name}: bad vector shapes")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: all tensors must be contiguous")
    return devices.pop()


def window(n: int, j0: int, w: Optional[int]) -> int:
    """Width of the column window ``[j0, j0+w)`` of an ``n``-column pool
    (``w=None``: to the end); raises when it does not fit."""
    w = n - j0 if w is None else w
    if j0 < 0 or w < 0 or j0 + w > n:
        raise ValueError(f"column window [{j0}, {j0 + w}) outside [0, {n})")
    return w


def price_plan(w: int, m: int, itemsize: int) -> tuple[int, bool]:
    """``(blocks, stage)`` of an ``ell_price`` launch over ``w`` columns that
    gathers from a vector of ``m`` elements: the grid, and whether the vector
    is staged in shared memory (it is whenever it fits)."""
    blocks = max(1, min(-(-w // _PRICE_CHUNK), _PRICE_BLOCKS))
    return blocks, m * itemsize <= _STAGE_BYTES


class SpmvPlan(NamedTuple):
    """Launch shape of ``ell_spmv``: a block is ``row_threads × segments``
    threads over ``row_threads · rows_per_thread`` rows; segment ``s`` holds
    the slots ``[s · seg_len, min(Kr, (s + 1) · seg_len))``."""

    segments: int
    seg_len: int
    row_threads: int
    rows_per_thread: int


def spmv_plan(m: int, Kr: int, itemsize: int) -> SpmvPlan:
    """The launch shape of ``ell_spmv`` over ``m`` rows of ``Kr`` slots.

    With ``_SPMV_WIDE_ROWS`` rows or more a thread takes 4 neighbouring rows
    (16-byte loads), else one row: below that, wide loads leave too few
    threads to hide the gathers' latency (4 rows a thread loses at 32,768
    rows and is 1-2 % ahead at 131,072).  The slots of a row are then cut
    into the fewest segments (a power of two, at most 16, at least 2 slots
    each) that bring the launch to ``_SPMV_FILL`` threads; a block has
    ``_SPMV_THREADS`` threads, at least a warp of them along the rows.  The
    block's partial sums (one of ``itemsize`` bytes per row and segment)
    must fit the 48 KB of shared memory a launch gets without opting in."""
    rows = 4 if m % 4 == 0 and m >= _SPMV_WIDE_ROWS else 1
    segments = 1
    while segments < 16 and 4 * segments <= Kr and -(-m // rows) * segments < _SPMV_FILL:
        segments *= 2
    seg_len = -(-Kr // segments)
    segments = -(-Kr // seg_len)       # no empty segment
    plan = SpmvPlan(segments, seg_len, max(32, _SPMV_THREADS // segments), rows)
    if segments * plan.row_threads * rows * itemsize > 48 * 1024:
        raise ValueError(f"spmv_plan: {plan} needs more than 48 KB of shared memory")
    return plan


def _launch_price(name, data_t, idx_t, y, c, j0, w, out, sel, outs):
    """One launch of the pricing kernel: ``out`` (a tensor) or the selection."""
    from relp_tpu_torch.ops.cuda_build import load_kernels, raise_on

    lib = load_kernels().lib
    dev = data_t.device
    K, n = data_t.shape
    blocks, stage = price_plan(w, y.shape[0], data_t.element_size())
    fn = lib.relp_ell_price_f32 if data_t.dtype == torch.float32 else lib.relp_ell_price_f64
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = None
        if sel is not None:
            ws = workspace(dev, stream, 1, blocks)
            args = ctypes.byref(select_args(sel, ws, outs))
        err = fn(
            data_t.data_ptr(), idx_t.data_ptr(), y.data_ptr(),
            None if c is None else c.data_ptr(),
            None if out is None else out.data_ptr(),
            n, j0, w, K, y.shape[0], blocks, int(stage), args, stream,
        )
    if err != 0 and sel is not None:
        drop_workspace(dev, stream)
    raise_on(name, err)


def ell_price(data_t: torch.Tensor, idx_t: torch.Tensor, y: torch.Tensor,
              c: Optional[torch.Tensor] = None, j0: int = 0,
              w: Optional[int] = None) -> torch.Tensor:
    """Pricing over the column window ``[j0, j0+w)`` (default: all) of a
    K-major ELL column pool: ``out[j] = c[j] − Σ_k data_t[k,j0+j]·
    y[idx_t[k,j0+j]]`` with ``c`` of length ``w``; without ``c`` the sum
    alone (the devex pivot row).  float32 or float64."""
    w = window(data_t.shape[1] if data_t.dim() == 2 else 0, j0, w)
    dev = _check("ell_price", data_t, idx_t, y, c, c_len=w)
    if dev.type == "cpu":
        return ell_price_plain(data_t, idx_t, y, c, j0, w)
    if dev.type != "cuda":
        raise ValueError(f"ell_price: unsupported device {dev}")
    out = torch.empty(w, dtype=data_t.dtype, device=dev)
    _launch_price("ell_price", data_t, idx_t, y, c, j0, w, out, None, None)
    ell_price.launches += 1
    return out


ell_price.launches = 0


def ell_price_select_plain(data_t, idx_t, y, c, vstat, can_enter, w, bland, eps_dual,
                           devex, j0: int = 0, w_cols: Optional[int] = None):
    """The plain price followed by the plain selection: ``(q, has, d_q)``."""
    sel = Selection(vstat, can_enter, w, bland, eps_dual, devex)
    return select_plain(ell_price_plain(data_t, idx_t, y, c, j0, w_cols), sel, j0)


def ell_price_select(data_t: torch.Tensor, idx_t: torch.Tensor, y: torch.Tensor,
                     c: torch.Tensor, vstat: torch.Tensor, can_enter: torch.Tensor,
                     w: torch.Tensor, bland: torch.Tensor, eps_dual: float, devex: bool,
                     j0: int = 0, w_cols: Optional[int] = None):
    """The entering column of the window ``[j0, j0+w_cols)`` priced as
    ``ell_price(data_t, idx_t, y, c, j0, w_cols)`` prices it: ``(q, has,
    d_q)`` as 0-dim tensors, ``q`` (int64) counted from column 0, ``has``
    whether it improves, ``d_q`` its reduced cost in the pool's type.
    ``vstat`` (int64), ``can_enter`` (bool) and the devex weights ``w``
    (float64) are indexed by pool column, ``bland`` is a 0-dim bool tensor
    read on the device."""
    w_cols = window(data_t.shape[1] if data_t.dim() == 2 else 0, j0, w_cols)
    if c is None or w_cols < 1:
        raise ValueError("ell_price_select: needs costs c and a window of >= 1 column")
    dev = _check("ell_price_select", data_t, idx_t, y, c, c_len=w_cols)
    sel = Selection(vstat, can_enter, w, bland, eps_dual, devex)
    check_selection("ell_price_select", sel, dev, data_t.shape[1])
    if dev.type == "cpu":
        return ell_price_select_plain(data_t, idx_t, y, c, *sel, j0, w_cols)
    if dev.type != "cuda":
        raise ValueError(f"ell_price_select: unsupported device {dev}")
    outs = select_outputs(dev, data_t.dtype)
    _launch_price("ell_price_select", data_t, idx_t, y, c, j0, w_cols, None, sel, outs)
    ell_price_select.launches += 1
    return outs


ell_price_select.launches = 0


def ell_spmv(rdata_t: torch.Tensor, rcols_t: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """A·x over a K-major row-major ELL twin: ``y[i] = Σ_k
    rdata_t[k,i]·x[rcols_t[k,i]]``.  float32 or float64."""
    dev = _check("ell_spmv", rdata_t, rcols_t, x)
    if dev.type == "cpu":
        return ell_spmv_plain(rdata_t, rcols_t, x)
    if dev.type != "cuda":
        raise ValueError(f"ell_spmv: unsupported device {dev}")
    from relp_tpu_torch.ops.cuda_build import load_kernels, raise_on

    lib = load_kernels().lib
    K, m = rdata_t.shape
    out = torch.empty(m, dtype=rdata_t.dtype, device=dev)
    fn = lib.relp_ell_spmv_f32 if rdata_t.dtype == torch.float32 else lib.relp_ell_spmv_f64
    plan = spmv_plan(m, K, rdata_t.element_size())
    with torch.cuda.device(dev):
        err = fn(
            rdata_t.data_ptr(), rcols_t.data_ptr(), x.data_ptr(),
            out.data_ptr(), m, K, *plan, torch.cuda.current_stream(dev).cuda_stream,
        )
    raise_on("ell_spmv", err)
    ell_spmv.launches += 1
    return out


ell_spmv.launches = 0
