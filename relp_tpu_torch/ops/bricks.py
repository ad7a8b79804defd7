"""Tiled-brick sparse operator: the 8 × 128 brick layout of A.

Port of ``relp_tpu/ops/bricks.py``.  The nonzeros are grouped into
(tr × tc) = (8 × 128) dense **bricks** on the (row-tile, column-block)
grid; per row tile the touched column blocks' bricks sit in a padded slot
array ``data[T, B, 8, 128]`` with block ids ``idx[T, B]`` (empty slots are
zero bricks pointing at block 0).  ``A·x`` gathers x as 128-lane rows of
the table ``x.reshape(-1, 128)`` and contracts them with the bricks:
``y[t, r] = Σ_{b,l} data[t,b,r,l]·x[idx[t,b]·128 + l]``; ``Aᵀy`` uses an
independently built transposed brick set (column tiles of 8, row blocks of
128) with the same contraction.  The layout was the TPU's answer to serial
element gathers; on the card both products are the hand-written kernels
``brick_spmv`` and ``brick_price`` (ops/brick_kernels.py), which read it as
it is.

The layout is built on the host in numpy and scipy exactly as the JAX
package builds it (the same arrays); the operator classes then hold the
leaves as tensors on one explicit device (values f64, ids int32) and offer
the interface the first-order engine calls: ``shape``, ``dtype``,
``device``, ``matvec``, ``rmatvec``, ``price(c, y)`` (``c − Aᵀy``) and
``astype``.  :class:`GroupedBrickMatrix` sorts the tiles by brick count
and packs them into a few tight groups; its products are one launch each,
which writes every tile at its original place (the JAX package's un-sort
``take(y, inv)`` folded into the store).  :func:`bandwidth_perm` is the
bipartite reverse Cuthill-McKee order that clusters the nonzeros into
fewer bricks; callers apply it to the problem before building.
"""

from __future__ import annotations

import numpy as np
import torch

from relp_tpu_torch.ops.brick_kernels import TC, TR, brick_price, brick_spmv


def _slot_layout(r, c, v, n_rows_pad: int, n_cols_pad: int, b_pad=None):
    """Pack COO triplets into (data[T, B, TR, TC], idx[T, B]) numpy arrays."""
    T = n_rows_pad // TR
    NB = n_cols_pad // TC
    t = (r // TR).astype(np.int64)
    blk = (c // TC).astype(np.int64)
    key = t * NB + blk
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, inv_s = np.unique(key_s, return_inverse=True)
    tile_of = (uniq // NB).astype(np.int64)
    starts = np.searchsorted(tile_of, np.arange(T))
    slot_of_uniq = np.arange(len(uniq)) - starts[tile_of]
    b_true = int(slot_of_uniq.max()) + 1 if len(uniq) else 1
    B = max(b_true, 1) if b_pad is None else b_pad
    if b_true > B:
        raise ValueError(f"tile with {b_true} bricks exceeds B={B}")
    data = np.zeros((T, B, TR, TC), dtype=np.float64)
    idx = np.zeros((T, B), dtype=np.int32)
    idx[tile_of, slot_of_uniq] = (uniq % NB).astype(np.int32)
    slot = slot_of_uniq[inv_s]
    ro, co, vo = r[order], c[order], v[order]
    data[ro // TR, slot, ro % TR, co % TC] = vo
    return data, idx


def _check_ids(name, idx, n_blocks):
    """The kernels gather without bounds checks: check the block ids once."""
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n_blocks):
        raise ValueError(f"{name}: block id outside [0, {n_blocks})")


class BrickMatrix:
    """Brick-tiled A (see the module docstring), on one device.

    ``rdata[T, Br, 8, 128]``/``ridx[T, Br]``: row-tile bricks for A·x.
    ``cdata[Tc, Bc, 8, 128]``/``cidx[Tc, Bc]``: column-tile bricks (the 8 axis
    is columns, the 128 axis row lanes) for Aᵀy.  ``m``/``n`` are the padded
    dims, multiples of 128."""

    def __init__(self, rdata, ridx, cdata, cidx, m: int, n: int):
        if rdata.shape[0] * TR != m or cdata.shape[0] * TR != n:
            raise ValueError("inconsistent brick shapes")
        _check_ids("ridx", ridx, n // TC)
        _check_ids("cidx", cidx, m // TC)
        self.rdata = rdata
        self.ridx = ridx
        self.cdata = cdata
        self.cidx = cidx
        self.m = m
        self.n = n

    @property
    def shape(self):
        return (self.m, self.n)

    @property
    def dtype(self):
        return self.rdata.dtype

    @property
    def device(self):
        return self.rdata.device

    def astype(self, dtype) -> "BrickMatrix":
        """The same operator with its bricks in ``dtype`` (ids shared)."""
        if dtype == self.dtype:
            return self
        return BrickMatrix(self.rdata.to(dtype), self.ridx, self.cdata.to(dtype),
                           self.cidx, self.m, self.n)

    def matvec(self, x):
        return brick_spmv([(self.rdata, self.ridx)], x)

    def rmatvec(self, pi):
        return brick_price([(self.cdata, self.cidx)], pi)

    def price(self, c, pi):
        return brick_price([(self.cdata, self.cidx)], pi, c)


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
    contiguous groups, each with its own tight ``data[Tg, Bg, 8, 128]``
    (DP-optimal boundaries, ``_group_breaks``).  ``rinv``/``cinv`` are the
    JAX package's un-sort gathers (``y = take(y_sorted, inv)``);
    ``rtile``/``ctile`` their inverses, the original tile of each sorted
    position, by which a launch stores each tile in place."""

    def __init__(self, rgroups, rinv, cgroups, cinv, m: int, n: int):
        self.rgroups = tuple(rgroups)  # ((data, idx), ...) row-tile groups
        self.rinv = rinv               # i32[T] un-sort gather for A·x
        self.cgroups = tuple(cgroups)
        self.cinv = cinv
        self.m = m
        self.n = n
        for name, groups, inv, rows, cols in (("rgroups", self.rgroups, rinv, m, n),
                                              ("cgroups", self.cgroups, cinv, n, m)):
            if sum(d.shape[0] for d, _ in groups) * TR != rows or inv.shape != (rows // TR,):
                raise ValueError(f"inconsistent {name} shapes")
            for _, idx in groups:
                _check_ids(name, idx, cols // TC)
        self.rtile = torch.argsort(rinv.long()).to(torch.int32)
        self.ctile = torch.argsort(cinv.long()).to(torch.int32)

    @property
    def shape(self):
        return (self.m, self.n)

    @property
    def dtype(self):
        return self.rgroups[0][0].dtype

    @property
    def device(self):
        return self.rinv.device

    def astype(self, dtype) -> "GroupedBrickMatrix":
        """The same operator with its bricks in ``dtype`` (ids shared)."""
        if dtype == self.dtype:
            return self

        def cast(groups):
            return [(d.to(dtype), i) for d, i in groups]

        return GroupedBrickMatrix(cast(self.rgroups), self.rinv, cast(self.cgroups),
                                  self.cinv, self.m, self.n)

    def matvec(self, x):
        return brick_spmv(self.rgroups, x, self.rtile)

    def rmatvec(self, pi):
        return brick_price(self.cgroups, pi, None, self.ctile)

    def price(self, c, pi):
        return brick_price(self.cgroups, pi, c, self.ctile)


def _grouped_layout(r, c, v, n_rows_pad: int, n_cols_pad: int, max_groups: int):
    """Sorted-tile grouped slot layout; returns (groups, inv_perm)."""
    T = n_rows_pad // TR
    NB = n_cols_pad // TC
    key = (r // TR).astype(np.int64) * NB + (c // TC)
    uniq = np.unique(key)
    per_tile = np.bincount((uniq // NB).astype(np.int64), minlength=T)
    order = np.argsort(-per_tile, kind="stable")      # heavy tiles first
    inv = np.argsort(order).astype(np.int32)
    counts_sorted = per_tile[order]
    groups = []
    for s, e in _group_breaks(counts_sorted, max_groups):
        if e <= s:
            continue
        tiles = order[s:e]                            # original tile ids
        Bg = max(int(counts_sorted[s]), 1)
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
    ``device``."""
    r, c, v = _coo(csc, m_pad, n_pad)
    rgroups, rinv = _grouped_layout(r, c, v, m_pad, n_pad, max_groups)
    cgroups, cinv = _grouped_layout(c, r, v, n_pad, m_pad, max_groups)

    def t(a):
        return torch.from_numpy(a).to(device)

    def tg(groups):
        return [(t(d), t(i)) for d, i in groups]

    return GroupedBrickMatrix(tg(rgroups), t(rinv), tg(cgroups), t(cinv), m_pad, n_pad)


def bricks_from_csc(csc, m_pad: int, n_pad: int, br_pad=None, bc_pad=None, bucket=None, *,
                    device) -> BrickMatrix:
    """Build both brick orientations from a scipy CSC matrix on ``device``.

    ``m_pad``/``n_pad`` must be multiples of 128.  ``br_pad``/``bc_pad``
    optionally pad the per-tile brick-slot counts; ``bucket`` (a callable on
    the true max count) derives them instead."""
    r, c, v = _coo(csc, m_pad, n_pad)
    if bucket is not None:
        br_pad = bucket(_slot_count(r, c, m_pad, n_pad))
        bc_pad = bucket(_slot_count(c, r, n_pad, m_pad))
    rdata, ridx = _slot_layout(r, c, v, m_pad, n_pad, br_pad)
    cdata, cidx = _slot_layout(c, r, v, n_pad, m_pad, bc_pad)

    def t(a):
        return torch.from_numpy(a).to(device)

    return BrickMatrix(t(rdata), t(ridx), t(cdata), t(cidx), m_pad, n_pad)


def _slot_count(r, c, n_rows_pad: int, n_cols_pad: int) -> int:
    """Max bricks in any row-tile (the true B before padding)."""
    if len(r) == 0:
        return 1
    NB = n_cols_pad // TC
    key = (r // TR).astype(np.int64) * NB + (c // TC)
    uniq = np.unique(key)
    per_tile = np.bincount(uniq // NB, minlength=n_rows_pad // TR)
    return int(per_tile.max())


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
