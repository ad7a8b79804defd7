"""Wrappers and plain versions of the dense-operator CUDA kernel.

``dense_price`` replaces ``pricing_kernel`` (``tools/probe_pallas.py``), the
fused ``c − π@A`` over a grid of column blocks; the kernel is in
``relp_tpu_torch/csrc/dense_kernels.cu``.  It reads a row-major, contiguous
``A[m, n]`` (the ``DenseMatrix`` layout) once per call and reuses only the
vector, so bytes bound it: ``m·w·itemsize`` over the card's memory rate at
large shapes, the launch and one chain of loads at the solver's dense
shapes.  A thread owns 4 (f32) or 2 (f64) neighbouring columns and reads
them with 16-byte loads, several rows in flight; narrow windows split the
rows over a second grid dimension, and the row slices meet inside the one
launch through a per-column-block ticket.  Every sum runs in an order fixed
by the shapes, never through an atomic, so pivot choices repeat from run to
run.  A window that is not 16-byte aligned takes scalar loads in the same
kernel.

``dense_price_select`` is the same pass with the selection epilogue
(``ops/select_epilogue.py``): the entering column ``(q, has, d_q)`` comes
out of the kernel and ``d`` is never written.

``dense_price_lanes`` and ``dense_price_select_lanes`` price L lanes (the
iterates of a fleet, one per scenario) in one launch, against a stacked
``A[L, m, n]`` (the kernel above, a third grid dimension of lanes) or one
shared ``A[m, n]``: there a block reads each tile of A once for a group of
4, 8 or 16 lanes (:func:`lane_plan`), so A is read once per group and not
once per lane.  Each lane keeps the row plan and the order of sums of a
single-vector launch, so lane ``s`` equals ``dense_price(A_s, V[s], C[s])``
bit for bit.  A bool mask ``live[L]`` lets finished lanes cost nothing (a
group with none live returns at once); their outputs are left as they were
(pass ``out``/``outs`` to keep them).

A wrapper given CPU tensors computes the plain PyTorch version.  Given CUDA
tensors it launches the kernel or raises: there is no fallback.  Each
wrapper counts its launches in a plain integer attribute, ``launches``;
``dense_price_select_lanes`` also counts those on a window narrower than
A (partial pricing) in ``window_launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from relp_tpu_torch.ops.select_epilogue import (
    LaneArgs,
    Selection,
    check_selection,
    drop_workspace,
    select_args,
    select_outputs,
    select_plain,
    workspace,
)
from relp_tpu_torch.ops.sparse_kernels import window

_FLOATS = (torch.float32, torch.float64)
_WARPS = 8            # warps of a kernel block, which split its rows (csrc kWarps)
_MIN_SLICE_ROWS = 16 * _WARPS  # at least sixteen rows a warp: four rounds of loads
_SMS = 132            # an H100's SMs
_TARGET_BLOCKS = 2 * _SMS  # two blocks per SM
_GROUPS = (16, 8, 4)  # lanes a block of the group kernel may serve (csrc G)
_GROUP_COST = 6       # what a block's fixed work weighs, in lanes' worth of FMAs


def dense_price_plain(A: torch.Tensor, v: torch.Tensor, c: Optional[torch.Tensor] = None,
                      j0: int = 0, w: Optional[int] = None) -> torch.Tensor:
    """``c − v @ A[:, j0:j0+w]`` (or the product alone when ``c`` is None)."""
    w = A.shape[1] - j0 if w is None else w
    acc = v @ A[:, j0:j0 + w]
    return acc if c is None else c - acc


def _check(A, v, c, w):
    tensors = [A, v] + ([] if c is None else [c])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"dense_price: tensors on several devices {sorted(map(str, devices))}")
    if A.dtype not in _FLOATS:
        raise TypeError(f"dense_price: A must be float32 or float64, got {A.dtype}")
    if v.dtype != A.dtype or (c is not None and c.dtype != A.dtype):
        raise TypeError(f"dense_price: vectors must have A's dtype {A.dtype}")
    if A.dim() != 2 or v.shape != (A.shape[0],) or (c is not None and c.shape != (w,)):
        raise ValueError(
            f"dense_price: A must be [m, n], v [m] and c [w]; got {tuple(A.shape)}, "
            f"{tuple(v.shape)}, {None if c is None else tuple(c.shape)} (w={w})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("dense_price: all tensors must be contiguous")
    return devices.pop()


def block_cols(itemsize: int) -> int:
    """Columns of a kernel block: a warp of 16-byte loads (csrc kBlockCols)."""
    return 32 * (16 // itemsize)


def slices_for(m: int, w: int, itemsize: int = 4) -> tuple[int, int]:
    """``(slices, rows_per_slice)``: how many row slices the kernel's grid
    splits ``m`` rows into, so that a narrow window still fills the card."""
    col_blocks = max(1, -(-w // block_cols(itemsize)))
    slices = 1
    if col_blocks < _TARGET_BLOCKS:
        slices = max(1, min(-(-m // _MIN_SLICE_ROWS), -(-_TARGET_BLOCKS // col_blocks)))
    rows = max(1, -(-m // slices))
    return max(1, -(-m // rows)), rows


class LanePlan(NamedTuple):
    """How one launch covers ``L`` lanes: blocks of ``group`` lanes (1: the
    lane-by-lane kernel) in ``groups`` grid rows, each lane's rows in
    ``slices`` of ``rows_per_slice`` (the single launch's plan), and the
    scratch it takes from the stream's workspace."""

    group: int
    groups: int
    slices: int
    rows_per_slice: int
    col_blocks: int
    n_counters: int     # a ticket per lane, then the column blocks' counters
    n_slots: int        # one selection slot per lane and column block
    partial_bytes: int  # per lane and slice, a row of sums (whole blocks in a group)


def lane_group(lanes: int, blocks_per_group: int, shared: bool = True) -> int:
    """Lanes a block serves: 1 for one vector or a stacked A (nothing is
    shared).  Else 16 or 8 where ``lanes`` fills such a group and the grid
    still gives every SM a block, and 4 otherwise; among those, the one
    whose groups cost least, a group weighing its lanes (padding included)
    and a fixed ``_GROUP_COST`` (``tools/sweep_torch_pricing.py --only
    lanes`` measures the choice)."""
    if lanes < 2 or not shared:
        return 1
    fits = [g for g in _GROUPS
            if g == _GROUPS[-1] or (lanes >= g and -(-lanes // g) * blocks_per_group >= _SMS)]
    return min(fits, key=lambda g: (-(-lanes // g) * (g + _GROUP_COST), -g))


@functools.lru_cache(maxsize=256)
def lane_plan(lanes: int, m: int, w: int, itemsize: int, shared: bool = True) -> LanePlan:
    """The launch plan of ``lanes`` lanes over an ``m``-row window of ``w``
    columns (one vector: ``lanes=1``).  The rows are split as
    :func:`slices_for` splits them for one vector, whatever the group."""
    slices, rows = slices_for(m, w, itemsize)
    col_blocks = max(1, -(-w // block_cols(itemsize)))
    group = lane_group(lanes, col_blocks * slices, shared)
    groups = -(-lanes // group)
    counters = (lanes if group == 1 else groups) * col_blocks if slices > 1 else 0
    row = w if group == 1 else col_blocks * block_cols(itemsize)
    return LanePlan(group, groups, slices, rows, col_blocks, lanes + counters,
                    lanes * col_blocks, lanes * slices * row * itemsize if slices > 1 else 0)


def _launch(name, A, v, c, j0, w, out, sel, outs, n_lanes=1, lanes=None):
    """One launch of the kernel: ``out`` (a tensor) or the selection, for
    one vector or ``n_lanes`` lanes (``lanes``: their ``LaneArgs``)."""
    from relp_tpu_torch.ops.cuda_build import load_kernels, raise_on

    lib = load_kernels().lib
    dev = A.device
    m, n = A.shape[-2:]
    plan = lane_plan(n_lanes, m, w, A.element_size(), A.dim() == 2)
    fn = lib.relp_dense_price_f32 if A.dtype == torch.float32 else lib.relp_dense_price_f64
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws = None
        if plan.slices > 1 or sel is not None:
            ws = workspace(dev, stream, plan.n_counters, plan.n_slots, plan.partial_bytes)
        args = None if sel is None else ctypes.byref(select_args(sel, ws, outs))
        err = fn(
            A.data_ptr(), v.data_ptr(), None if c is None else c.data_ptr(),
            None if out is None else out.data_ptr(),
            ws.partial.data_ptr() if plan.slices > 1 else None,
            ws.counters_ptr(n_lanes) if plan.slices > 1 else None,
            m, n, j0, w, plan.slices, plan.rows_per_slice, args,
            None if lanes is None else ctypes.byref(lanes), n_lanes, plan.group, stream,
        )
    if err != 0:
        drop_workspace(dev, stream)
    raise_on(name, err)


def dense_price(A: torch.Tensor, v: torch.Tensor, c: Optional[torch.Tensor] = None,
                j0: int = 0, w: Optional[int] = None) -> torch.Tensor:
    """Dense pricing over the column window ``[j0, j0+w)`` (default: all)
    of a row-major ``A[m, n]``: ``out[j] = c[j] − Σ_i v[i]·A[i, j0+j]`` with
    ``c`` of length ``w``; without ``c`` the sum alone (``vᵀA``, the devex
    pivot row).  float32 or float64."""
    w = window(A.shape[1] if A.dim() == 2 else 0, j0, w)
    dev = _check(A, v, c, w)
    if dev.type == "cpu":
        return dense_price_plain(A, v, c, j0, w)
    if dev.type != "cuda":
        raise ValueError(f"dense_price: unsupported device {dev}")
    out = torch.empty(w, dtype=A.dtype, device=dev)
    _launch("dense_price", A, v, c, j0, w, out, None, None)
    dense_price.launches += 1
    return out


dense_price.launches = 0


def dense_price_select_plain(A, v, c, vstat, can_enter, w, bland, eps_dual, devex,
                             j0: int = 0, w_cols: Optional[int] = None):
    """The plain price followed by the plain selection: ``(q, has, d_q)``."""
    sel = Selection(vstat, can_enter, w, bland, eps_dual, devex)
    return select_plain(dense_price_plain(A, v, c, j0, w_cols), sel, j0)


def dense_price_select(A: torch.Tensor, v: torch.Tensor, c: torch.Tensor,
                       vstat: torch.Tensor, can_enter: torch.Tensor, w: torch.Tensor,
                       bland: torch.Tensor, eps_dual: float, devex: bool,
                       j0: int = 0, w_cols: Optional[int] = None):
    """The entering column of the window ``[j0, j0+w_cols)`` priced as
    ``dense_price(A, v, c, j0, w_cols)`` prices it: ``(q, has, d_q)`` as
    0-dim tensors, ``q`` (int64) counted from column 0, ``has`` whether it
    improves, ``d_q`` its reduced cost in ``A``'s type.  ``vstat`` (int64),
    ``can_enter`` (bool) and the devex weights ``w`` (float64) are indexed by
    pool column, ``bland`` is a 0-dim bool tensor read on the device."""
    w_cols = window(A.shape[1] if A.dim() == 2 else 0, j0, w_cols)
    if c is None or w_cols < 1:
        raise ValueError("dense_price_select: needs costs c and a window of >= 1 column")
    dev = _check(A, v, c, w_cols)
    sel = Selection(vstat, can_enter, w, bland, eps_dual, devex)
    check_selection("dense_price_select", sel, dev, A.shape[1])
    if dev.type == "cpu":
        return dense_price_select_plain(A, v, c, *sel, j0, w_cols)
    if dev.type != "cuda":
        raise ValueError(f"dense_price_select: unsupported device {dev}")
    outs = select_outputs(dev, A.dtype)
    _launch("dense_price_select", A, v, c, j0, w_cols, None, sel, outs)
    dense_price_select.launches += 1
    return outs


dense_price_select.launches = 0


# ---- lanes: L right-hand sides against one shared or a stacked A ----

def _lane_window(A, j0, w):
    return window(A.shape[-1] if A.dim() in (2, 3) else 0, j0, w)


def dense_price_lanes_plain(A: torch.Tensor, V: torch.Tensor, C: Optional[torch.Tensor] = None,
                            j0: int = 0, w: Optional[int] = None,
                            live: Optional[torch.Tensor] = None,
                            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``C − V·A_s[:, j0:j0+w]`` per lane ``s`` (``addmm`` for a shared
    ``A``, ``einsum`` over a stack), or the products alone when ``C`` is
    None; with ``live`` and ``out``, the rows of dead lanes are ``out``'s."""
    w = A.shape[-1] - j0 if w is None else w
    Aw = A[..., j0:j0 + w]
    if A.dim() == 2:
        res = V @ Aw if C is None else torch.addmm(C, V, Aw, alpha=-1)
    else:
        acc = torch.einsum("si,sij->sj", V, Aw)
        res = acc if C is None else C - acc
    if live is not None and out is not None:
        res = torch.where(live[:, None], res, out)
    return res


def _check_lanes(name, A, V, C, w, live, out):
    tensors = [A, V] + [t for t in (C, live, out) if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devices))}")
    if A.dtype not in _FLOATS:
        raise TypeError(f"{name}: A must be float32 or float64, got {A.dtype}")
    if V.dtype != A.dtype or any(t is not None and t.dtype != A.dtype for t in (C, out)):
        raise TypeError(f"{name}: V, C and out must have A's dtype {A.dtype}")
    L = V.shape[0] if V.dim() == 2 else -1
    if (A.dim() not in (2, 3) or V.dim() != 2 or V.shape[1] != A.shape[-2]
            or (A.dim() == 3 and A.shape[0] != L)
            or (C is not None and C.shape != (L, w))
            or (out is not None and out.shape != (L, w))
            or (live is not None and (live.dtype != torch.bool or live.shape != (L,)))):
        raise ValueError(
            f"{name}: A must be [m, n] or [L, m, n], V [L, m], C and out [L, w] and live "
            f"bool [L]; got {tuple(A.shape)}, {tuple(V.shape)}, "
            f"{None if C is None else tuple(C.shape)}, {None if out is None else tuple(out.shape)}, "
            f"{None if live is None else (live.dtype, tuple(live.shape))} (w={w})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: all tensors must be contiguous")
    if L > 65535:
        raise ValueError(f"{name}: at most 65,535 lanes, got {L}")
    return devices.pop(), L


def _lane_args(A, V, C, out, sel=None, live=None) -> LaneArgs:
    m, n = A.shape[-2:]
    args = LaneArgs(a=m * n if A.dim() == 3 else 0, v=V.shape[1],
                    c=0 if C is None else C.shape[1], out=0 if out is None else out.shape[1],
                    live=None if live is None else live.data_ptr())
    if sel is not None:
        args.vstat = sel.vstat.shape[-1]
        args.can_enter = sel.can_enter.shape[-1] if sel.can_enter.dim() == 2 else 0
        args.w = sel.w.shape[-1]
    return args


def dense_price_lanes(A: torch.Tensor, V: torch.Tensor, C: Optional[torch.Tensor] = None,
                      j0: int = 0, w: Optional[int] = None,
                      live: Optional[torch.Tensor] = None,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``dense_price`` of L lanes in one launch: ``out[s, j] = C[s, j] −
    Σ_i V[s, i]·A_s[i, j0+j]`` (the sum alone when ``C`` is None), where
    ``A_s`` is the shared ``A[m, n]`` or lane ``s`` of ``A[L, m, n]``.
    ``live`` (bool ``[L]``) skips dead lanes; their rows of ``out`` (when
    given, else unspecified) are left as they were."""
    w = _lane_window(A, j0, w)
    dev, L = _check_lanes("dense_price_lanes", A, V, C, w, live, out)
    if dev.type == "cpu":
        return dense_price_lanes_plain(A, V, C, j0, w, live, out)
    if dev.type != "cuda":
        raise ValueError(f"dense_price_lanes: unsupported device {dev}")
    if out is None:
        out = torch.empty((L, w), dtype=A.dtype, device=dev)
    _launch("dense_price_lanes", A, V, C, j0, w, out, None, None, L,
            _lane_args(A, V, C, out, live=live))
    dense_price_lanes.launches += 1
    return out


dense_price_lanes.launches = 0


def dense_price_select_lanes_plain(A, V, C, vstat, can_enter, w, bland, eps_dual, devex,
                                   j0: int = 0, w_cols: Optional[int] = None,
                                   live: Optional[torch.Tensor] = None, outs=None):
    """The plain lane price followed by the plain selection of every lane:
    ``(q, has, d_q)``, each ``[L]``; with ``live`` and ``outs``, dead lanes
    keep ``outs``' entries."""
    sel = Selection(vstat, can_enter, w, bland, eps_dual, devex)
    res = select_plain(dense_price_lanes_plain(A, V, C, j0, w_cols), sel, j0)
    if live is not None and outs is not None:
        res = tuple(torch.where(live, r, o) for r, o in zip(res, outs))
    return res


def dense_price_select_lanes(A: torch.Tensor, V: torch.Tensor, C: torch.Tensor,
                             vstat: torch.Tensor, can_enter: torch.Tensor, w: torch.Tensor,
                             bland: torch.Tensor, eps_dual: float, devex: bool,
                             j0: int = 0, w_cols: Optional[int] = None,
                             live: Optional[torch.Tensor] = None, outs=None):
    """``dense_price_select`` of L lanes in one launch: each lane's entering
    column of the window, priced as ``dense_price_lanes`` prices it, as
    ``(q, has, d_q)`` of shape ``[L]`` (int64, bool, A's type).  ``vstat``
    is ``[L, >= n]`` (int64), ``w`` ``[L, n]`` (float64), ``can_enter``
    ``[n]`` (shared) or ``[L, n]`` (bool), ``bland`` ``[L]`` (bool).
    ``live`` skips dead lanes, whose entries of ``outs`` (when given, else
    unspecified) are left as they were."""
    w_cols = _lane_window(A, j0, w_cols)
    if C is None or w_cols < 1:
        raise ValueError("dense_price_select_lanes: needs costs C and a window of >= 1 column")
    dev, L = _check_lanes("dense_price_select_lanes", A, V, C, w_cols, live, None)
    sel = Selection(vstat, can_enter, w, bland, eps_dual, devex)
    check_selection("dense_price_select_lanes", sel, dev, A.shape[-1], lanes=L)
    if outs is not None and (len(outs) != 3 or any(
            t.shape != (L,) or t.dtype != dt or t.device != dev
            for t, dt in zip(outs, (torch.int64, torch.bool, A.dtype)))):
        raise ValueError("dense_price_select_lanes: outs must be (q, has, d_q), each [L], "
                         "of int64, bool and A's dtype")
    if dev.type == "cpu":
        return dense_price_select_lanes_plain(A, V, C, *sel, j0, w_cols, live, outs)
    if dev.type != "cuda":
        raise ValueError(f"dense_price_select_lanes: unsupported device {dev}")
    if outs is None:
        outs = select_outputs(dev, A.dtype, L)
    _launch("dense_price_select_lanes", A, V, C, j0, w_cols, None, sel, outs, L,
            _lane_args(A, V, C, None, sel, live))
    dense_price_select_lanes.launches += 1
    if w_cols < A.shape[-1]:
        dense_price_select_lanes.window_launches += 1
    return outs


dense_price_select_lanes.launches = 0
dense_price_select_lanes.window_launches = 0
