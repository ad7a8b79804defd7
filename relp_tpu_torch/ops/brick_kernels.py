"""Wrappers and plain versions of the brick-operator CUDA kernels.

``brick_spmv`` replaces ``brick_spmv_pallas`` and ``brick_price`` replaces
``brick_pricing_pallas`` (both in ``relp_tpu/ops/pallas_kernels.py``); the
kernels are in ``relp_tpu_torch/csrc/brick_kernels.cu``.  Both compute the
brick contraction of ``ops/bricks.py`` over one orientation's **compacted
bricks** (:class:`BrickTiles`): the tiles of 8 rows in the layout's order
and, per tile, its nonzeros in the bricks' slot order (row-major inside
each brick), each a value and one int32 position word ``col·8 + row``
(``col`` = block id·128 + lane, the element of the vector it multiplies;
``row`` the row inside the tile, 3 bits):

    out[tile_of[s]·8 + r] = Σ_{k ∈ [ptr[s], ptr[s+1]), pos[k] & 7 = r} vals[k] · v[pos[k] >> 3]

with ``c − `` in front under ``brick_price`` when ``c`` is given.
``tile_of`` (int32, the original tile of each layout position) is None for
the identity.  float32 or float64.  An empty padded slot of the dense
layout has no entry here, so slot padding never adds to what a product
reads: the values, the position words, the tile offsets, ``tile_of``, the
vector and the output, each once.

A wrapper given CPU tensors computes the plain PyTorch version (gather,
multiply, segment sum).  Given CUDA tensors it launches the kernel or
raises: there is no fallback.  Each wrapper counts its launches in a plain
integer attribute, ``launches``.  The kernels index without bounds checks,
so :func:`brick_tiles` checks what they index once, where an operator is
built; a call checks devices, dtypes and shapes only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

TR = 8           # rows of a tile
TC = 128         # columns of a block (the lanes of a brick)
LANES = (8, 16, 32)      # lanes that share a tile (csrc/brick_kernels.cu)
_MAX_NNZ = 2**31 - 256   # the kernels' int32 offsets, a batch past the end included
_MAX_WIDTH = 2**28       # col·8 + row in an int32 position word


class BrickTiles(NamedTuple):
    """One orientation of a brick operator in compact form (module docstring).
    Build it with :func:`brick_tiles`, which checks it."""

    ptr: torch.Tensor                # int32[T + 1]: first nonzero of each tile
    vals: torch.Tensor               # float[nnz]
    pos: torch.Tensor                # int32[nnz]: col·8 + row
    tile_of: Optional[torch.Tensor]  # int32[T]: original tile of each position; None: identity
    width: int                       # length of the vector the columns index
    lanes: int                       # lanes of a tile in the kernel (tile_lanes)

    @property
    def tiles(self) -> int:
        return self.ptr.shape[0] - 1

    def astype(self, dtype) -> "BrickTiles":
        """The same tiles with their values in ``dtype`` (the ints shared)."""
        if dtype == self.vals.dtype:
            return self
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"brick values must be float32 or float64, got {dtype}")
        return self._replace(vals=self.vals.to(dtype))


def tile_lanes(nnz: int, tiles: int) -> int:
    """Lanes a tile takes in the kernel: the least of 8, 16, 32 that gives a
    lane about one nonzero of a mean tile (32 past that)."""
    mean = nnz / max(tiles, 1)
    return next((g for g in LANES if g >= mean), LANES[-1])


def brick_tiles(ptr, vals, pos, tile_of, width: int) -> BrickTiles:
    """Check one orientation's compact form (what the kernels index without a
    bounds check: offsets from 0, monotone, ending at the value count;
    columns inside the vector; ``tile_of`` a permutation; the row, 3 bits of
    the word, is < 8 by construction) and pick its lanes."""
    tensors = [t for t in (ptr, vals, pos, tile_of) if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("brick tiles: tensors on several devices")
    if vals.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"brick tiles: values must be float32 or float64, got {vals.dtype}")
    if any(t.dtype != torch.int32 for t in tensors if t is not vals):
        raise TypeError("brick tiles: offsets, position words and tile_of must be int32")
    if any(t.dim() != 1 or not t.is_contiguous() for t in tensors):
        raise ValueError("brick tiles: contiguous 1-D tensors")
    tiles, nnz = ptr.shape[0] - 1, vals.shape[0]
    if tiles < 1 or pos.shape != (nnz,) or nnz > _MAX_NNZ:
        raise ValueError(f"brick tiles: ptr[T + 1 >= 2] and vals, pos of one length "
                         f"< {_MAX_NNZ}, got {ptr.shape[0]}, {nnz}, {pos.shape[0]}")
    if not 0 < width <= _MAX_WIDTH or width % TC:
        raise ValueError(f"brick tiles: the vector's length must be a multiple of {TC} "
                         f"up to {_MAX_WIDTH}, got {width}")
    p = ptr.long()
    if int(p[0]) != 0 or int(p[-1]) != nnz or bool((p[1:] < p[:-1]).any()):
        raise ValueError("brick tiles: offsets must rise from 0 to the value count")
    if nnz and (int(pos.min()) < 0 or int(pos.max()) >> 3 >= width):
        raise ValueError(f"brick tiles: a column outside the vector [0, {width})")
    if tile_of is not None:
        if tile_of.shape != (tiles,):
            raise ValueError(f"brick tiles: tile_of must be int32[{tiles}]")
        seen = torch.zeros(tiles, dtype=torch.int32, device=tile_of.device)
        t = tile_of.long()
        if int(t.min()) < 0 or int(t.max()) >= tiles or \
                not bool(seen.index_fill_(0, t, 1).all()):
            raise ValueError("brick tiles: tile_of must be a permutation of the tiles")
    return BrickTiles(ptr, vals, pos, tile_of, int(width), tile_lanes(nnz, tiles))


def _contract_plain(t: BrickTiles, v, c):
    # the tile of each nonzero, found without reading a size back from the device
    k = torch.arange(t.vals.shape[0], dtype=torch.int32, device=v.device)
    tile = torch.searchsorted(t.ptr[1:], k, right=True)
    if t.tile_of is not None:
        tile = t.tile_of.long()[tile]
    seg = tile * TR + (t.pos & 7).long()
    y = torch.zeros(t.tiles * TR, dtype=v.dtype, device=v.device)
    y.index_add_(0, seg, t.vals * v[(t.pos >> 3).long()])
    return y if c is None else c - y


def brick_spmv_plain(tiles: BrickTiles, x: torch.Tensor) -> torch.Tensor:
    """``A·x`` over the row tiles (see the module docstring)."""
    return _contract_plain(tiles, x, None)


def brick_price_plain(tiles: BrickTiles, y: torch.Tensor,
                      c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``c − Aᵀy`` (or ``Aᵀy`` without ``c``) over the column tiles."""
    return _contract_plain(tiles, y, c)


def _check(name, t: BrickTiles, v, c):
    dev = t.vals.device
    if v.device != dev or (c is not None and c.device != dev):
        raise ValueError(f"{name}: tensors on several devices ({t.vals.device}, {v.device})")
    if v.dtype != t.vals.dtype or (c is not None and c.dtype != t.vals.dtype):
        raise TypeError(f"{name}: vectors must have the values' dtype {t.vals.dtype}")
    if v.shape != (t.width,) or (c is not None and c.shape != (t.tiles * TR,)):
        raise ValueError(f"{name}: the vector must be [{t.width}] and c [{t.tiles * TR}]")
    if not v.is_contiguous() or (c is not None and not c.is_contiguous()):
        raise ValueError(f"{name}: vectors must be contiguous")
    return dev


def _launch(name, entry, t: BrickTiles, v, c):
    from relp_tpu_torch.ops.cuda_build import load_kernels, raise_on

    fn = getattr(load_kernels().lib,
                 f"relp_{entry}_{'f32' if v.dtype == torch.float32 else 'f64'}")
    dev = v.device
    out = torch.empty(t.tiles * TR, dtype=v.dtype, device=dev)
    with torch.cuda.device(dev):
        err = fn(t.ptr.data_ptr(), t.vals.data_ptr(), t.pos.data_ptr(),
                 None if t.tile_of is None else t.tile_of.data_ptr(), v.data_ptr(),
                 None if c is None else c.data_ptr(), out.data_ptr(), t.tiles, t.lanes,
                 torch.cuda.current_stream(dev).cuda_stream)
    raise_on(name, err)
    return out


def brick_spmv(tiles: BrickTiles, x: torch.Tensor) -> torch.Tensor:
    """``A·x`` over the row tiles, every tile stored at ``tile_of``: one launch."""
    dev = _check("brick_spmv", tiles, x, None)
    if dev.type == "cpu":
        return brick_spmv_plain(tiles, x)
    if dev.type != "cuda":
        raise ValueError(f"brick_spmv: unsupported device {dev}")
    out = _launch("brick_spmv", "brick_spmv", tiles, x, None)
    brick_spmv.launches += 1
    return out


brick_spmv.launches = 0


def brick_price(tiles: BrickTiles, y: torch.Tensor,
                c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``c − Aᵀy`` over the column tiles (``Aᵀy`` without ``c``), every tile
    stored at ``tile_of``: one launch."""
    dev = _check("brick_price", tiles, y, c)
    if dev.type == "cpu":
        return brick_price_plain(tiles, y, c)
    if dev.type != "cuda":
        raise ValueError(f"brick_price: unsupported device {dev}")
    out = _launch("brick_price", "brick_price", tiles, y, c)
    brick_price.launches += 1
    return out


brick_price.launches = 0
