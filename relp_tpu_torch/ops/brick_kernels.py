"""Wrappers and plain versions of the brick-layout CUDA kernels.

``brick_spmv`` replaces ``brick_spmv_pallas`` and ``brick_price`` replaces
``brick_pricing_pallas`` (both in ``relp_tpu/ops/pallas_kernels.py``); the
kernels are in ``relp_tpu_torch/csrc/brick_kernels.cu``.  Both compute the
brick contraction of ``ops/bricks.py`` over one or more groups of tiles:

    out[tile_of[s]·8 + r] = Σ_{b,l} data_g[s − s_g, b, r, l] · v[idx_g[s − s_g, b]·128 + l]

for the sorted tile position ``s`` in group ``g`` (whose first position is
``s_g``), with ``c − `` in front under ``brick_price`` when ``c`` is given.
``groups`` is a sequence of ``(data[Tg, Bg, 8, 128], idx[Tg, Bg])``: one
group for the flat layout (``BrickMatrix``), several for the grouped one
(``GroupedBrickMatrix``); ``tile_of`` (int32, the original tile of each
sorted position) is None for the identity.  float32 or float64.  Both are
bound by bytes: every brick is 4 or 8 KB read once, its 128-lane row of
``v`` a gather that L2 serves, and empty slots (zero bricks on block 0) are
read like full ones.

A wrapper given CPU tensors computes the plain PyTorch version (the JAX
package's contraction: gather the 128-lane rows, multiply, sum).  Given
CUDA tensors it launches the kernel or raises: there is no fallback.  Each
wrapper counts its launches in a plain integer attribute, ``launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

TR = 8           # rows of a tile
TC = 128         # columns of a block (the lanes of a brick)
MAX_GROUPS = 16  # csrc/brick_kernels.cu: kMaxGroups


class _Group(ctypes.Structure):
    # csrc/brick_kernels.cu: BrickGroup
    _fields_ = [("data", ctypes.c_void_p), ("idx", ctypes.c_void_p),
                ("tiles", ctypes.c_int64), ("slots", ctypes.c_int64)]


def _contract_plain(groups, v, c, tile_of):
    tab = v.reshape(-1, TC)
    outs = [(data * tab[idx.long()][:, :, None, :]).sum((1, 3)) for data, idx in groups]
    y = torch.cat(outs, 0)                           # [T, 8], sorted order
    if tile_of is not None:
        placed = torch.empty_like(y)
        placed[tile_of.long()] = y                   # = take(y, inv)
        y = placed
    y = y.reshape(-1)
    return y if c is None else c - y


def brick_spmv_plain(groups, x: torch.Tensor,
                     tile_of: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``A·x`` over the row-tile bricks (see the module docstring)."""
    return _contract_plain(groups, x, None, tile_of)


def brick_price_plain(groups, y: torch.Tensor, c: Optional[torch.Tensor] = None,
                      tile_of: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``c − Aᵀy`` (or ``Aᵀy`` without ``c``) over the transposed bricks."""
    return _contract_plain(groups, y, c, tile_of)


def _check(name, groups, v, c, tile_of):
    if not 1 <= len(groups) <= MAX_GROUPS:
        raise ValueError(f"{name}: 1 to {MAX_GROUPS} groups of tiles, got {len(groups)}")
    tensors = [v] + [t for g in groups for t in g] + [t for t in (c, tile_of) if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devices))}")
    dtype = groups[0][0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: bricks must be float32 or float64, got {dtype}")
    tiles = 0
    for data, idx in groups:
        if data.dtype != dtype or idx.dtype != torch.int32:
            raise TypeError(f"{name}: bricks of one dtype and int32 block ids")
        if data.dim() != 4 or data.shape[2:] != (TR, TC) or idx.shape != data.shape[:2] \
                or data.shape[1] < 1:
            raise ValueError(f"{name}: a group is data[Tg, Bg >= 1, 8, 128] with idx[Tg, Bg], "
                             f"got {tuple(data.shape)} and {tuple(idx.shape)}")
        tiles += data.shape[0]
    if v.dtype != dtype or (c is not None and c.dtype != dtype):
        raise TypeError(f"{name}: vectors must have the bricks' dtype {dtype}")
    if v.dim() != 1 or v.shape[0] % TC or (c is not None and c.shape != (tiles * TR,)):
        raise ValueError(f"{name}: bad vector shapes")
    if tile_of is not None and (tile_of.dtype != torch.int32 or tile_of.shape != (tiles,)):
        raise ValueError(f"{name}: tile_of must be int32[{tiles}]")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: all tensors must be contiguous")
    return devices.pop(), tiles


def _launch(name, entry, groups, v, c, tile_of, tiles):
    from relp_tpu_torch.ops.cuda_build import load_kernels, raise_on

    lib = load_kernels().lib
    dev = v.device
    f32 = groups[0][0].dtype == torch.float32
    fn = getattr(lib, f"relp_{entry}_{'f32' if f32 else 'f64'}")
    out = torch.empty(tiles * TR, dtype=v.dtype, device=dev)
    with torch.cuda.device(dev):
        table = (_Group * len(groups))(*(_Group(d.data_ptr(), i.data_ptr(), *d.shape[:2])
                                         for d, i in groups))
        err = fn(table, len(groups), None if tile_of is None else tile_of.data_ptr(),
                 v.data_ptr(), None if c is None else c.data_ptr(), out.data_ptr(), tiles,
                 torch.cuda.current_stream(dev).cuda_stream)
    raise_on(name, err)
    return out


def brick_spmv(groups: Sequence, x: torch.Tensor,
               tile_of: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``A·x`` over the row-tile brick groups, every tile stored at
    ``tile_of`` (the identity when None): one launch."""
    dev, tiles = _check("brick_spmv", groups, x, None, tile_of)
    if dev.type == "cpu":
        return brick_spmv_plain(groups, x, tile_of)
    if dev.type != "cuda":
        raise ValueError(f"brick_spmv: unsupported device {dev}")
    out = _launch("brick_spmv", "brick_spmv", groups, x, None, tile_of, tiles)
    brick_spmv.launches += 1
    return out


brick_spmv.launches = 0


def brick_price(groups: Sequence, y: torch.Tensor, c: Optional[torch.Tensor] = None,
                tile_of: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``c − Aᵀy`` over the transposed brick groups (``Aᵀy`` without ``c``),
    every tile stored at ``tile_of``: one launch."""
    dev, tiles = _check("brick_price", groups, y, c, tile_of)
    if dev.type == "cpu":
        return brick_price_plain(groups, y, c, tile_of)
    if dev.type != "cuda":
        raise ValueError(f"brick_price: unsupported device {dev}")
    out = _launch("brick_price", "brick_price", groups, y, c, tile_of, tiles)
    brick_price.launches += 1
    return out


brick_price.launches = 0
