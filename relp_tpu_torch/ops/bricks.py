"""Tiled-brick sparse operator: the 8 × 128 brick layout of A, compacted.

Port of ``relp_tpu/ops/bricks.py``.  The JAX package groups the nonzeros
into (tr × tc) = (8 × 128) dense **bricks** on the (row-tile, column-block)
grid; per row tile the touched column blocks' bricks sit in a padded slot
array ``data[T, B, 8, 128]`` with block ids ``idx[T, B]`` (empty slots are
zero bricks pointing at block 0), and ``A·x`` contracts the bricks with
128-lane rows of ``x``; ``Aᵀy`` uses an independently built transposed
brick set (column tiles of 8, row blocks of 128).  That layout is the TPU's
answer to serial element gathers.  On the card an element gather is an L2
hit, and a brick of the max flows holds 2-3 nonzeros of its 1,024 values,
so the operator here keeps the bricks **compacted**: per orientation the
tiles in the layout's order, the offset of each tile's first nonzero, and
per nonzero its value and one int32 position word ``col·8 + row`` in the
bricks' slot order, row-major inside each brick (``ops/brick_kernels.py``,
:class:`BrickTiles`).  An empty padded slot costs nothing: ``bucket``,
``br_pad`` and ``bc_pad`` change only the layout's slot counts, never the
bytes a product reads.  :func:`dense_bricks` expands the compact form back
to the JAX package's arrays.

The layout is built on the host in numpy and scipy as the JAX package builds
it (``_slot_layout``, ``_grouped_layout``, ``_group_breaks`` and
``bandwidth_perm`` return its arrays); the operator classes hold the compact
leaves on one explicit device (values f64, ints int32; the dense bricks are
never copied there) and offer the interface the first-order engine calls:
``shape``, ``dtype``, ``device``, ``matvec``, ``rmatvec``, ``price(c, y)``
(``c − Aᵀy``) and ``astype``.  Each product is one launch of
``brick_spmv`` or ``brick_price``.  :class:`GroupedBrickMatrix` sorts the
tiles by brick count (heaviest first) and cuts them into a few tight groups;
the groups stay a fact of the layout (their breaks and slot counts), and a
launch stores every tile at its original place (the JAX package's un-sort
``take(y, inv)`` folded into the store).  :func:`bandwidth_perm` is the
bipartite reverse Cuthill-McKee order that clusters the nonzeros into fewer
bricks; callers apply it to the problem before building.
"""

from __future__ import annotations

import numpy as np
import torch

from relp_tpu_torch.ops.brick_kernels import (
    TC, TR, BrickTiles, brick_price, brick_spmv, brick_tiles,
)


def _slot_index(r, c, n_rows_pad: int, n_cols_pad: int):
    """The index part of the slot layout: the order of the nonzeros (by tile,
    by block inside the tile, row-major inside each brick), the distinct
    (tile, block) keys, each key's slot (its rank among its tile's blocks),
    and each sorted nonzero's key number."""
    T = n_rows_pad // TR
    NB = n_cols_pad // TC
    key = (r // TR).astype(np.int64) * NB + (c // TC).astype(np.int64)
    order = np.argsort((key * TR + r % TR) * TC + c % TC, kind="stable")
    uniq, inv_s = np.unique(key[order], return_inverse=True)
    tile_of = (uniq // NB).astype(np.int64)
    starts = np.searchsorted(tile_of, np.arange(T))
    slot_of_uniq = np.arange(len(uniq)) - starts[tile_of]
    return order, uniq, slot_of_uniq, inv_s


def _slot_layout(r, c, v, n_rows_pad: int, n_cols_pad: int, b_pad=None):
    """Pack COO triplets into (data[T, B, TR, TC], idx[T, B]) numpy arrays."""
    T = n_rows_pad // TR
    NB = n_cols_pad // TC
    order, uniq, slot_of_uniq, inv_s = _slot_index(r, c, n_rows_pad, n_cols_pad)
    b_true = int(slot_of_uniq.max()) + 1 if len(uniq) else 1
    B = max(b_true, 1) if b_pad is None else b_pad
    if b_true > B:
        raise ValueError(f"tile with {b_true} bricks exceeds B={B}")
    data = np.zeros((T, B, TR, TC), dtype=np.float64)
    idx = np.zeros((T, B), dtype=np.int32)
    idx[uniq // NB, slot_of_uniq] = (uniq % NB).astype(np.int32)
    slot = slot_of_uniq[inv_s]
    ro, co, vo = r[order], c[order], v[order]
    data[ro // TR, slot, ro % TR, co % TC] = vo
    return data, idx


def _compact(r, c, v, n_rows_pad: int, n_cols_pad: int, rank=None):
    """One orientation's compact form in numpy, without the dense bricks:
    ``(ptr int32[T + 1], vals f64[nnz], pos int32[nnz], bricks int64[T])``
    with tile ``t`` at layout position ``rank[t]`` (None: ``t``), its
    nonzeros in the slot order of :func:`_slot_index`, and the bricks each
    position's tile touches."""
    T = n_rows_pad // TR
    s = (r // TR).astype(np.int64)
    if rank is not None:
        s = rank[s].astype(np.int64)
    order, uniq, _, _ = _slot_index(s * TR + r % TR, c, n_rows_pad, n_cols_pad)
    ptr = np.zeros(T + 1, np.int64)
    np.cumsum(np.bincount(s, minlength=T), out=ptr[1:])
    pos = c[order].astype(np.int64) * TR + r[order] % TR
    bricks = np.bincount(uniq // (n_cols_pad // TC), minlength=T)
    return ptr.astype(np.int32), v[order], pos.astype(np.int32), bricks


def _tiles(ptr, vals, pos, tile_of, width: int, device) -> BrickTiles:
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return brick_tiles(t(ptr), t(vals), t(pos), None if tile_of is None else t(tile_of), width)


class BrickMatrix:
    """Brick-tiled A (see the module docstring), on one device, flat layout.

    ``rtiles``: the row tiles in their natural order, for A·x; ``ctiles``:
    the column tiles (8 columns, row blocks of 128), for Aᵀy.  ``rslots`` /
    ``cslots``: the dense layout's slots per tile (``B``; padded by
    ``br_pad``/``bc_pad``/``bucket``), which only :func:`dense_bricks`
    reads.  ``m``/``n`` are the padded dims, multiples of 128."""

    def __init__(self, rtiles: BrickTiles, rslots: int, ctiles: BrickTiles, cslots: int,
                 m: int, n: int):
        if rtiles.tiles * TR != m or ctiles.tiles * TR != n or rtiles.width != n \
                or ctiles.width != m or rtiles.vals.device != ctiles.vals.device:
            raise ValueError("inconsistent brick shapes")
        if rtiles.tile_of is not None or ctiles.tile_of is not None:
            raise ValueError("the flat layout keeps its tiles in their order")
        self.rtiles = rtiles
        self.rslots = int(rslots)
        self.ctiles = ctiles
        self.cslots = int(cslots)
        self.m = m
        self.n = n

    @property
    def shape(self):
        return (self.m, self.n)

    @property
    def dtype(self):
        return self.rtiles.vals.dtype

    @property
    def device(self):
        return self.rtiles.vals.device

    def astype(self, dtype) -> "BrickMatrix":
        """The same operator with its values in ``dtype`` (the ints shared)."""
        if dtype == self.dtype:
            return self
        return BrickMatrix(self.rtiles.astype(dtype), self.rslots, self.ctiles.astype(dtype),
                           self.cslots, self.m, self.n)

    def matvec(self, x):
        return brick_spmv(self.rtiles, x)

    def rmatvec(self, pi):
        return brick_price(self.ctiles, pi)

    def price(self, c, pi):
        return brick_price(self.ctiles, pi, c)


def _group_breaks(counts: np.ndarray, max_groups: int):
    """Optimal partition of DESC-sorted per-tile brick counts into at most
    ``max_groups`` contiguous groups minimizing total padded slots
    Σ len_g·max_g.  DP over the distinct count values (few), exact."""
    uniq = np.unique(counts)[::-1]          # distinct values, descending
    ends = np.searchsorted(-counts, -uniq, side="right")  # prefix lengths
    k = len(uniq)
    INFC = float("inf")
    # dp[g][i]: min slots covering the first ends[i] tiles with g+1 groups
    dp = [[INFC] * k for _ in range(max_groups)]
    arg = [[0] * k for _ in range(max_groups)]
    for i in range(k):
        dp[0][i] = int(ends[i]) * int(uniq[0])
    for g in range(1, max_groups):
        for i in range(k):
            dp[g][i] = dp[g - 1][i]
            arg[g][i] = -1  # "fewer groups suffice"
            for j in range(i):
                cand = dp[g - 1][j] + (int(ends[i]) - int(ends[j])) * int(uniq[j + 1])
                if cand < dp[g][i]:
                    dp[g][i] = cand
                    arg[g][i] = j
    # walk back the boundaries for the full range (i = k-1)
    bounds = []
    g, i = max_groups - 1, k - 1
    while True:
        if g == 0:
            bounds.append((0, int(ends[i])))
            break
        j = arg[g][i]
        if j == -1:  # dp[g][i] == dp[g-1][i]: fewer groups suffice
            g -= 1
            continue
        bounds.append((int(ends[j]), int(ends[i])))
        i = j
        g -= 1
    bounds.reverse()
    return bounds  # [(start_tile, end_tile)] over the sorted tile order


class GroupedBrickMatrix:
    """Brick operator with per-tile slot padding removed (tight packing).

    Tiles are sorted by brick count (heaviest first) and cut into a few
    contiguous groups (DP-optimal boundaries, ``_group_breaks``).
    ``rtiles``/``ctiles`` hold every tile in that sorted order, with
    ``tile_of`` the original tile of each sorted position, where a launch
    stores it.  ``rgroups``/``cgroups``: the groups as ``(first, end,
    slots)`` over the sorted positions, ``slots`` the group's ``Bg``;
    ``rinv``/``cinv``: the JAX package's un-sort gathers (``y = take(y_sorted,
    inv)``), the inverses of ``tile_of``.  The groups shape only the dense
    layout of :func:`dense_bricks`; a product reads the compact tiles."""

    def __init__(self, rtiles: BrickTiles, rgroups, rinv, ctiles: BrickTiles, cgroups, cinv,
                 m: int, n: int):
        self.rtiles = rtiles
        self.rgroups = tuple(tuple(int(k) for k in g) for g in rgroups)
        self.rinv = rinv
        self.ctiles = ctiles
        self.cgroups = tuple(tuple(int(k) for k in g) for g in cgroups)
        self.cinv = cinv
        self.m = m
        self.n = n
        for name, tiles, groups, inv, rows, cols in (
                ("rows", rtiles, self.rgroups, rinv, m, n),
                ("columns", ctiles, self.cgroups, cinv, n, m)):
            T = rows // TR
            if tiles.tiles != T or tiles.width != cols or tiles.tile_of is None \
                    or inv.shape != (T,) or inv.device != tiles.vals.device:
                raise ValueError(f"inconsistent brick shapes ({name})")
            if [g[0] for g in groups] != [0] + [g[1] for g in groups[:-1]] \
                    or not groups or groups[-1][1] != T or min(g[2] for g in groups) < 1:
                raise ValueError(f"{name}: the groups must cut the tiles [0, {T}) in order")
            if not torch.equal(inv.long()[tiles.tile_of.long()],
                               torch.arange(T, device=inv.device)):
                raise ValueError(f"{name}: inv must invert tile_of")

    @property
    def shape(self):
        return (self.m, self.n)

    @property
    def dtype(self):
        return self.rtiles.vals.dtype

    @property
    def device(self):
        return self.rtiles.vals.device

    def astype(self, dtype) -> "GroupedBrickMatrix":
        """The same operator with its values in ``dtype`` (the ints shared)."""
        if dtype == self.dtype:
            return self
        return GroupedBrickMatrix(self.rtiles.astype(dtype), self.rgroups, self.rinv,
                                  self.ctiles.astype(dtype), self.cgroups, self.cinv,
                                  self.m, self.n)

    def matvec(self, x):
        return brick_spmv(self.rtiles, x)

    def rmatvec(self, pi):
        return brick_price(self.ctiles, pi)

    def price(self, c, pi):
        return brick_price(self.ctiles, pi, c)


def _grouped_order(r, c, n_rows_pad: int, n_cols_pad: int, max_groups: int):
    """The grouped layout's tile order: ``(order, inv, groups)``, ``order``
    the original tile of each sorted position (heavy tiles first), ``inv``
    its inverse (int32), ``groups`` the non-empty ``(first, end, slots)``."""
    T = n_rows_pad // TR
    NB = n_cols_pad // TC
    key = (r // TR).astype(np.int64) * NB + (c // TC)
    uniq = np.unique(key)
    per_tile = np.bincount((uniq // NB).astype(np.int64), minlength=T)
    order = np.argsort(-per_tile, kind="stable")      # heavy tiles first
    inv = np.argsort(order).astype(np.int32)
    counts_sorted = per_tile[order]
    groups = [(s, e, max(int(counts_sorted[s]), 1))
              for s, e in _group_breaks(counts_sorted, max_groups) if e > s]
    return order, inv, groups


def _grouped_layout(r, c, v, n_rows_pad: int, n_cols_pad: int, max_groups: int):
    """Sorted-tile grouped slot layout; returns (groups, inv_perm)."""
    T = n_rows_pad // TR
    order, inv, bounds = _grouped_order(r, c, n_rows_pad, n_cols_pad, max_groups)
    groups = []
    for s, e, Bg in bounds:
        tiles = order[s:e]                            # original tile ids
        sel = np.isin(r // TR, tiles)
        rg, cg, vg = r[sel], c[sel], v[sel]
        # relabel rows into the group's local tile space
        local = np.full(T, -1, np.int64)
        local[tiles] = np.arange(len(tiles))
        rl = local[rg // TR] * TR + (rg % TR)
        data, idx = _slot_layout(rl, cg, vg, len(tiles) * TR, n_cols_pad, Bg)
        groups.append((data, idx))
    return groups, inv


def _coo(csc, m_pad: int, n_pad: int):
    if m_pad % TC or n_pad % TC:
        raise ValueError(f"brick dims must be multiples of {TC}, got ({m_pad}, {n_pad})")
    coo = csc.tocoo()
    coo.sum_duplicates()
    return (coo.row.astype(np.int64), coo.col.astype(np.int64),
            coo.data.astype(np.float64))


def grouped_bricks_from_csc(csc, m_pad: int, n_pad: int, max_groups: int = 4, *,
                            device) -> GroupedBrickMatrix:
    """Build the tight-packed grouped brick operator (both orientations) on
    ``device``: the compact tiles in the sorted order, never the bricks."""
    r, c, v = _coo(csc, m_pad, n_pad)
    sides = []
    for rows, cols, nr, nc in ((r, c, m_pad, n_pad), (c, r, n_pad, m_pad)):
        order, inv, groups = _grouped_order(rows, cols, nr, nc, max_groups)
        ptr, vals, pos, _ = _compact(rows, cols, v, nr, nc, rank=inv)
        tiles = _tiles(ptr, vals, pos, order.astype(np.int32), nc, device)
        sides += [tiles, groups, torch.from_numpy(inv).to(device)]
    return GroupedBrickMatrix(*sides, m_pad, n_pad)


def bricks_from_csc(csc, m_pad: int, n_pad: int, br_pad=None, bc_pad=None, bucket=None, *,
                    device) -> BrickMatrix:
    """Build both orientations of the flat layout from a scipy CSC matrix on
    ``device``: the compact tiles in their natural order, never the bricks.

    ``m_pad``/``n_pad`` must be multiples of 128.  ``br_pad``/``bc_pad``
    optionally pad the per-tile brick-slot counts; ``bucket`` (a callable on
    the true max count) derives them instead.  They change only the dense
    layout :func:`dense_bricks` expands to."""
    r, c, v = _coo(csc, m_pad, n_pad)
    if bucket is not None:
        br_pad = bucket(_slot_count(r, c, m_pad, n_pad))
        bc_pad = bucket(_slot_count(c, r, n_pad, m_pad))
    sides = []
    for rows, cols, nr, nc, b_pad in ((r, c, m_pad, n_pad, br_pad), (c, r, n_pad, m_pad, bc_pad)):
        ptr, vals, pos, bricks = _compact(rows, cols, v, nr, nc)
        b_true = max(int(bricks.max(initial=0)), 1)
        B = b_true if b_pad is None else b_pad
        if b_true > B:
            raise ValueError(f"tile with {b_true} bricks exceeds B={B}")
        sides += [_tiles(ptr, vals, pos, None, nc, device), B]
    return BrickMatrix(*sides, m_pad, n_pad)


def _slot_count(r, c, n_rows_pad: int, n_cols_pad: int) -> int:
    """Max bricks in any row-tile (the true B before padding)."""
    if len(r) == 0:
        return 1
    NB = n_cols_pad // TC
    key = (r // TR).astype(np.int64) * NB + (c // TC)
    uniq = np.unique(key)
    per_tile = np.bincount(uniq // NB, minlength=n_rows_pad // TR)
    return int(per_tile.max())


def _coo_of(tiles: BrickTiles):
    """The COO triplets of one orientation's compact form, numpy, with the
    rows at their layout positions."""
    ptr = tiles.ptr.cpu().numpy().astype(np.int64)
    pos = tiles.pos.cpu().numpy().astype(np.int64)
    s = np.repeat(np.arange(tiles.tiles), np.diff(ptr))
    return s * TR + (pos & 7), pos >> 3, tiles.vals.cpu().numpy()


def dense_bricks(op):
    """The JAX package's leaves of ``op``, expanded from its compact form on
    the host (numpy, the values in ``op``'s dtype): ``(rdata, ridx, cdata,
    cidx)`` for a :class:`BrickMatrix`; ``(rgroups, rinv, cgroups, cinv)``
    with groups ``((data[Tg, Bg, 8, 128], idx[Tg, Bg]), ...)`` for a
    :class:`GroupedBrickMatrix`."""
    out = []
    if isinstance(op, BrickMatrix):
        for tiles, slots in ((op.rtiles, op.rslots), (op.ctiles, op.cslots)):
            r, c, v = _coo_of(tiles)
            data, idx = _slot_layout(r, c, v, tiles.tiles * TR, tiles.width, slots)
            out += [data.astype(v.dtype), idx]
        return tuple(out)
    for tiles, groups, inv in ((op.rtiles, op.rgroups, op.rinv), (op.ctiles, op.cgroups, op.cinv)):
        r, c, v = _coo_of(tiles)
        dense = []
        for s, e, slots in groups:
            sel = (r >= s * TR) & (r < e * TR)
            data, idx = _slot_layout(r[sel] - s * TR, c[sel], v[sel], (e - s) * TR,
                                     tiles.width, slots)
            dense.append((data.astype(v.dtype), idx))
        out += [tuple(dense), inv.cpu().numpy()]
    return tuple(out)


def bandwidth_perm(csc):
    """Bipartite reverse-Cuthill-McKee row/column orders for A.

    Returns ``(row_perm, col_perm)`` such that ``A[row_perm][:, col_perm]``
    clusters nonzeros near the diagonal, so fewer bricks hold them.  One BFS
    over the bipartite adjacency (O(nnz))."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    m, n = csc.shape
    B = sp.bmat([[None, csc], [csc.T, None]], format="csr")
    perm = np.asarray(reverse_cuthill_mckee(B, symmetric_mode=True))
    row_perm = perm[perm < m]
    col_perm = perm[perm >= m] - m
    # isolated rows/columns (empty in A) may be missing from the BFS order
    if row_perm.size < m:
        seen = np.zeros(m, bool)
        seen[row_perm] = True
        row_perm = np.concatenate([row_perm, np.flatnonzero(~seen)])
    if col_perm.size < n:
        seen = np.zeros(n, bool)
        seen[col_perm] = True
        col_perm = np.concatenate([col_perm, np.flatnonzero(~seen)])
    return row_perm.astype(np.int64), col_perm.astype(np.int64)
