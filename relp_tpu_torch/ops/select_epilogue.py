"""The entering-column selection that the pricing kernels fuse into their
pass (``relp_tpu_torch/csrc/select_epilogue.cuh``): its plain PyTorch
version, the argument block the kernels take, and their scratch.

``select_plain`` is the arithmetic of ``PrimalKernel._select``
(``simplex/core.py``; ``pick`` in ``relp_tpu/simplex/core.py``) over a priced
window ``d``, in f64: the violation of each column from its status,
``can_enter`` and ``eps_dual``; the score ``viol²/w`` (devex) or ``viol``
(Dantzig); the argmax, or under Bland's rule the smallest improving index;
ties to the lowest index, a NaN score the greatest, as ``torch.argmax``
has them.

The kernels reduce over the grid through one slot per block and a ticket
counter that must be zero before every launch.  :func:`workspace` hands out
that scratch: one per (device, stream), allocated zeroed at first use and
set back to zero by the kernel that used it, so launches on one stream
share it in order and launches on two streams never share it.  A launch
that fails drops its workspace (:func:`drop_workspace`), so the next one
starts from fresh zeros; a CUDA graph keeps the workspace it was captured
with (:func:`current_workspace`).  Nothing here synchronises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

_SLOT_BYTES = 32  # sizeof(relp::Cand): two doubles, an int64 and an int, padded
# the vstat codes of simplex/status.py (which imports this package's operators)
NB_LOWER, NB_UPPER, BASIC, NB_FREE = 0, 1, 2, 3


class Selection(NamedTuple):
    """What a selection reads besides the reduced costs, by pool column."""

    vstat: torch.Tensor      # i64[>= n]
    can_enter: torch.Tensor  # bool[n]
    w: torch.Tensor          # f64[n] — devex reference weights
    bland: torch.Tensor      # bool, 0-dim — Bland's rule active
    eps_dual: float
    devex: bool              # score viol²/w, else viol


def select_plain(d: torch.Tensor, sel: Selection, j0: int = 0):
    """``(q, has, d_q)`` for the reduced costs ``d`` of the pool columns
    ``[j0, j0+len(d))``: ``q`` counts from the pool's first column, ``d_q``
    has ``d``'s type.  0-dim tensors for one vector; for lanes (``d`` of
    shape ``[L, w]``, the selection's tensors with a leading lane axis,
    ``can_enter`` shared or per lane) each is ``[L]``."""
    hi = j0 + d.shape[-1]
    d64 = d.to(torch.float64)
    vs = sel.vstat[..., j0:hi]
    free = vs == NB_FREE
    imp_l = ((vs == NB_LOWER) | free) & (d64 < -sel.eps_dual)
    imp_u = ((vs == NB_UPPER) | free) & (d64 > sel.eps_dual)
    viol = torch.where(imp_l, -d64, 0.0) + torch.where(imp_u, d64, 0.0)
    viol = torch.where(sel.can_enter[..., j0:hi] & (vs != BASIC), viol, 0.0)
    score = viol * viol / sel.w[..., j0:hi] if sel.devex else viol
    j_best = torch.argmax(score, dim=-1)
    ids = torch.arange(d.shape[-1], device=d.device)
    j_bland = torch.argmin(torch.where(viol > 0, ids, d.shape[-1]), dim=-1)
    # gather: a 0-dim tensor used as a plain index would be read by the host
    j = torch.where(sel.bland, j_bland, j_best).unsqueeze(-1)
    return j[..., 0] + j0, viol.gather(-1, j)[..., 0] > 0, d.gather(-1, j)[..., 0]


def check_selection(name: str, sel: Selection, dev: torch.device, n: int,
                    lanes: int | None = None) -> None:
    """Raise unless ``sel`` fits an ``n``-column pool on ``dev`` (for
    ``lanes`` lanes: ``vstat [L, >= n]``, ``w [L, n]``, ``bland [L]`` and
    ``can_enter`` shared ``[n]`` or ``[L, n]``)."""
    for field, t, dtype in (("vstat", sel.vstat, torch.int64),
                            ("can_enter", sel.can_enter, torch.bool),
                            ("w", sel.w, torch.float64),
                            ("bland", sel.bland, torch.bool)):
        if not torch.is_tensor(t) or t.dtype != dtype:
            raise TypeError(f"{name}: {field} must be a {dtype} tensor")
        if t.device != dev:
            raise ValueError(f"{name}: {field} on {t.device}, the operator on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {field} must be contiguous")
    lead = () if lanes is None else (lanes,)
    if (sel.vstat.shape[:-1] != lead or sel.vstat.shape[-1] < n
            or sel.can_enter.shape not in ((n,), lead + (n,))
            or sel.w.shape != lead + (n,) or sel.bland.shape != lead):
        raise ValueError(
            f"{name}: vstat must be {list(lead)} + [>= {n}], can_enter [{n}] or w's shape, "
            f"w {list(lead + (n,))} and bland {list(lead)}; got {tuple(sel.vstat.shape)}, "
            f"{tuple(sel.can_enter.shape)}, {tuple(sel.w.shape)}, {tuple(sel.bland.shape)}")


class SelectArgs(ctypes.Structure):
    """``relp::SelectArgs`` of ``csrc/select_epilogue.cuh``."""

    _fields_ = [
        ("vstat", ctypes.c_void_p), ("can_enter", ctypes.c_void_p),
        ("w", ctypes.c_void_p), ("bland", ctypes.c_void_p),
        ("eps_dual", ctypes.c_double), ("devex", ctypes.c_int),
        ("slots", ctypes.c_void_p), ("ticket", ctypes.c_void_p),
        ("q", ctypes.c_void_p), ("has", ctypes.c_void_p), ("d_q", ctypes.c_void_p),
    ]


class LaneArgs(ctypes.Structure):
    """``LaneArgs`` of ``csrc/dense_kernels.cu``: element strides between
    lanes (0: shared) and the mask of live lanes (null: all)."""

    _fields_ = [
        ("a", ctypes.c_int64), ("v", ctypes.c_int64), ("c", ctypes.c_int64),
        ("out", ctypes.c_int64), ("vstat", ctypes.c_int64), ("can_enter", ctypes.c_int64),
        ("w", ctypes.c_int64), ("live", ctypes.c_void_p),
    ]


class Workspace:
    """Scratch of the kernels on one stream.  A launch of L lanes (1 for
    one vector) takes ``counters[:L]`` as the selections' tickets, one a
    lane, and ``counters[L:]`` as ``dense_price``'s per-column-block
    counters, lane after lane (group after group when lanes share A:
    ``dense_kernels.lane_plan``); all are zero between launches."""

    def __init__(self, dev, n_counters: int, n_slots: int, partial_bytes: int):
        self.counters = torch.zeros(n_counters, dtype=torch.int32, device=dev)
        self.slots = torch.empty(n_slots * _SLOT_BYTES, dtype=torch.uint8, device=dev)
        self.partial = torch.empty(partial_bytes, dtype=torch.uint8, device=dev)

    def fits(self, n_counters, n_slots, partial_bytes) -> bool:
        return (self.counters.shape[0] >= n_counters
                and self.slots.shape[0] >= n_slots * _SLOT_BYTES
                and self.partial.shape[0] >= partial_bytes)

    @property
    def ticket_ptr(self) -> int:
        return self.counters.data_ptr()

    def counters_ptr(self, lanes: int = 1) -> int:
        """The first column-block counter of a launch of ``lanes`` lanes."""
        return self.counters.data_ptr() + 4 * lanes


_workspaces: dict[tuple[int, int], Workspace] = {}


def workspace(dev: torch.device, stream: int, n_counters: int = 1, n_slots: int = 0,
              partial_bytes: int = 0) -> Workspace:
    """The scratch of ``stream`` on ``dev``, at least as large as asked
    (sizes round up to powers of two, so it is seldom replaced).  A replaced
    workspace stays alive until the launches that use it have run: the
    allocator reuses its memory only for later work of the same stream."""
    key = (dev.index if dev.index is not None else torch.cuda.current_device(), stream)
    ws = _workspaces.get(key)
    if ws is None or not ws.fits(n_counters, n_slots, partial_bytes):
        def up(k, least):
            return max(least, 1 << max(k - 1, 0).bit_length())
        with torch.cuda.device(dev):  # the caller's current stream is `stream`
            ws = Workspace(dev, up(n_counters, 1024), up(n_slots, 1024),
                           up(partial_bytes, 1 << 20))
        _workspaces[key] = ws
    return ws


def current_workspace(dev: torch.device, stream: int) -> Workspace | None:
    """The scratch ``stream`` has now, if any.  A CUDA graph captured on
    ``stream`` keeps it: its kernels point at it, and a larger workspace
    may replace it for later launches."""
    key = (dev.index if dev.index is not None else torch.cuda.current_device(), stream)
    return _workspaces.get(key)


def drop_workspace(dev: torch.device, stream: int) -> None:
    """Forget the scratch of ``stream``: a failed launch may have left its
    counters anywhere."""
    key = (dev.index if dev.index is not None else torch.cuda.current_device(), stream)
    _workspaces.pop(key, None)


def select_outputs(dev: torch.device, dtype: torch.dtype, lanes: int | None = None):
    """Uninitialised ``(q, has, d_q)`` for a kernel to fill: 0-dim, or
    ``[lanes]``."""
    shape = () if lanes is None else (lanes,)
    return (torch.empty(shape, dtype=torch.int64, device=dev),
            torch.empty(shape, dtype=torch.bool, device=dev),
            torch.empty(shape, dtype=dtype, device=dev))


def select_args(sel: Selection, ws: Workspace, outs) -> SelectArgs:
    q, has, d_q = outs
    return SelectArgs(
        vstat=sel.vstat.data_ptr(), can_enter=sel.can_enter.data_ptr(),
        w=sel.w.data_ptr(), bland=sel.bland.data_ptr(),
        eps_dual=float(sel.eps_dual), devex=int(bool(sel.devex)),
        slots=ws.slots.data_ptr(), ticket=ws.ticket_ptr,
        q=q.data_ptr(), has=has.data_ptr(), d_q=d_q.data_ptr(),
    )
