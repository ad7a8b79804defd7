"""Device representations of the constraint matrix A.

Three interchangeable operator classes hold their tensors on one explicit
``torch.device`` and offer the engine one small interface (``matvec``,
``rmatvec``, ``rmatvec32``, ``rmatvec32_block``, ``price``, ``price32``,
``col``, ``ftran``, ``col_dot``, ``entries``, ``cols_matrix``), as in
``relp_tpu/ops/amatrix.py``:

- :class:`DenseMatrix` — padded f64 A plus an optional f32 shadow.  Pricing,
  ``Aᵀv`` and the devex row go through ``dense_price``
  (ops/dense_kernels.py); A·x, FTRAN and the column gathers stay
  ``torch.matmul``/indexing, as they are plain XLA products in the JAX
  package.
- :class:`EllMatrix` — ELL: per column up to K nonzeros, padded with
  (row 0, value 0), plus the same matrix per row (the row-major twin).
  Both pools are stored K-major (``[K, n_pad]`` and ``[Kr, m_pad]``,
  contiguous) so the CUDA kernels read coalesced; ``data``/``rows``/
  ``rdata``/``rcols`` are the ``[n, K]`` views the JAX package exposes.
  Pricing and the devex row go through ``ell_price``, A·x through
  ``ell_spmv`` (ops/sparse_kernels.py).
- :class:`HybridMatrix` — ELL for the sparse columns plus a small dense
  block of "spill" columns whose fill would blow up the ELL pad; the block
  prices through ``dense_price``.

``price(c, π)`` is ``c − πᵀA`` with the subtraction fused into the kernel;
the JAX package writes it as ``c − rmatvec(π)``.  ``rmatvec32_block`` and
``price32`` with ``bstart``/``bsize`` price one column window ``[bstart,
bstart+bsize)`` (partial pricing; ``c32`` then holds the window's entries),
with the window's bounds as host ints.
Indices that select one column or row (``q``) may be 0-dim tensors, so no
value has to leave the device to pick it.
"""

from __future__ import annotations

import numpy as np
import torch

from relp_tpu_torch.ops.dense_kernels import dense_price
from relp_tpu_torch.ops.sparse_kernels import ell_price, ell_spmv


def _sel(t: torch.Tensor, dim: int, q) -> torch.Tensor:
    """``t`` indexed by one position ``q`` (int or 0-dim tensor) along ``dim``."""
    if not torch.is_tensor(q):
        q = torch.tensor(q, device=t.device)
    return t.index_select(dim, q.reshape(1).long()).squeeze(dim)


class DenseMatrix:
    """Dense padded A (f64, row-major) with an optional f32 shadow for
    pricing."""

    def __init__(self, A: torch.Tensor, A32: torch.Tensor | None = None):
        self.A = A.contiguous()
        self.A32 = None if A32 is None else A32.contiguous()

    @property
    def shape(self):
        return tuple(self.A.shape)

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def device(self):
        return self.A.device

    def with_f32(self) -> "DenseMatrix":
        if self.A32 is not None:
            return self
        return DenseMatrix(self.A, self.A.float())

    def matvec(self, x):
        return self.A @ x

    def rmatvec(self, pi):
        return dense_price(self.A, pi)

    def rmatvec32(self, v32):
        return dense_price(self.A32, v32)

    def rmatvec32_block(self, v32, bstart: int, bsize: int):
        return dense_price(self.A32, v32, j0=bstart, w=bsize)

    def price(self, c, pi):
        return dense_price(self.A, pi, c)

    def price32(self, c32, v32, bstart: int = 0, bsize: int | None = None):
        return dense_price(self.A32, v32, c32, bstart, bsize)

    def col(self, q):
        return _sel(self.A, 1, q)

    def ftran(self, Binv, q):
        return Binv @ self.col(q)

    def col_dot(self, pi, q):
        return pi @ self.col(q)

    def entries(self, rows_i, cols_j):
        return self.A[rows_i.long(), cols_j.long()]

    def cols_matrix(self, idx):
        return self.A.index_select(1, idx.long())


class EllMatrix:
    """ELL column pool ``data_t[K, n]`` (f64) / ``rows_t[K, n]`` (int32),
    K-major, padded with (row 0, value 0), plus its row-major twin
    ``rdata_t[Kr, m]`` / ``rcols_t[Kr, m]`` (padded with (column 0, value 0))
    so A·x is a gather like pricing.  ``data32_t`` is the f32 shadow."""

    def __init__(self, data_t, rows_t, m: int, rdata_t, rcols_t, data32_t=None):
        K, n = data_t.shape
        if rows_t.shape != (K, n) or rdata_t.shape[1] != m or rcols_t.shape != rdata_t.shape:
            raise ValueError("inconsistent ELL shapes")
        # the kernels gather without bounds checks: check the indices once
        for name, idx, bound in (("rows", rows_t, m), ("rcols", rcols_t, n)):
            if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= bound):
                raise ValueError(f"ELL {name} index outside [0, {bound})")
        self.data_t = data_t
        self.rows_t = rows_t
        self.m = m
        self.rdata_t = rdata_t
        self.rcols_t = rcols_t
        self.data32_t = data32_t

    @property
    def data(self):
        return self.data_t.T

    @property
    def rows(self):
        return self.rows_t.T

    @property
    def rdata(self):
        return self.rdata_t.T

    @property
    def rcols(self):
        return self.rcols_t.T

    @property
    def shape(self):
        return (self.m, self.data_t.shape[1])

    @property
    def dtype(self):
        return self.data_t.dtype

    @property
    def device(self):
        return self.data_t.device

    def with_f32(self) -> "EllMatrix":
        if self.data32_t is not None:
            return self
        return EllMatrix(self.data_t, self.rows_t, self.m, self.rdata_t,
                         self.rcols_t, self.data_t.float())

    def matvec(self, x):
        return ell_spmv(self.rdata_t, self.rcols_t, x)

    def rmatvec(self, pi):
        return ell_price(self.data_t, self.rows_t, pi)

    def rmatvec32(self, v32):
        return ell_price(self.data32_t, self.rows_t, v32)

    def rmatvec32_block(self, v32, bstart: int, bsize: int):
        return ell_price(self.data32_t, self.rows_t, v32, j0=bstart, w=bsize)

    def price(self, c, pi):
        return ell_price(self.data_t, self.rows_t, pi, c)

    def price32(self, c32, v32, bstart: int = 0, bsize: int | None = None):
        return ell_price(self.data32_t, self.rows_t, v32, c32, bstart, bsize)

    def _col_slots(self, q):
        return _sel(self.rows_t, 1, q).long(), _sel(self.data_t, 1, q)

    def col(self, q):
        rq, dq = self._col_slots(q)
        return torch.zeros(self.m, dtype=self.dtype, device=self.device).index_add_(0, rq, dq)

    def ftran(self, Binv, q):
        rq, dq = self._col_slots(q)
        return Binv.index_select(1, rq) @ dq

    def col_dot(self, pi, q):
        rq, dq = self._col_slots(q)
        return pi.index_select(0, rq) @ dq

    def entries(self, rows_i, cols_j):
        cj = cols_j.long()
        rj = self.rows_t.index_select(1, cj)  # (K, k)
        dj = self.data_t.index_select(1, cj)
        return torch.where(rj == rows_i.reshape(1, -1), dj, 0.0).sum(0)

    def cols_matrix(self, idx):
        idx = idx.long()
        rows_b = self.rows_t.index_select(1, idx).long()  # (K, k)
        data_b = self.data_t.index_select(1, idx)
        cols_b = torch.arange(idx.shape[0], device=self.device).expand_as(rows_b)
        out = torch.zeros((self.m, idx.shape[0]), dtype=self.dtype, device=self.device)
        return out.index_put_((rows_b, cols_b), data_b, accumulate=True)


class HybridMatrix:
    """ELL for the sparse columns plus a dense ``(m_pad, d_pad)`` block ``D``
    of spill columns.  ``spill_idx[d_pad]`` maps slot → column (the real
    spill columns first, in ascending order; padded slots have zero
    columns), ``spill_pos[n_pad]`` maps column → slot or -1.  The dense
    block prices through ``dense_price``; its other products are plain
    ``torch.matmul``, as they are plain XLA products in the JAX package."""

    def __init__(self, ell: EllMatrix, D, spill_idx, spill_pos, D32=None):
        self.ell = ell
        self.D = D.contiguous()
        self.spill_idx = spill_idx
        self.spill_pos = spill_pos
        self.D32 = None if D32 is None else D32.contiguous()
        # host copy of the real spill columns (ascending): the slots of a
        # column window are one contiguous slot range
        self._spill_cols = spill_idx[: int((spill_pos >= 0).sum())].cpu().numpy()

    @property
    def shape(self):
        return self.ell.shape

    @property
    def dtype(self):
        return self.ell.dtype

    @property
    def device(self):
        return self.ell.device

    def with_f32(self) -> "HybridMatrix":
        if self.D32 is not None and self.ell.data32_t is not None:
            return self
        return HybridMatrix(self.ell.with_f32(), self.D, self.spill_idx,
                            self.spill_pos, self.D.float())

    def _spill_col(self, q):
        pos = _sel(self.spill_pos, 0, q)
        col = _sel(self.D, 1, pos.clamp_min(0))
        return torch.where(pos >= 0, col, 0.0)

    def matvec(self, x):
        return self.ell.matvec(x) + self.D @ x.index_select(0, self.spill_idx)

    def rmatvec(self, pi):
        return self.ell.rmatvec(pi).index_add_(0, self.spill_idx, dense_price(self.D, pi))

    def rmatvec32(self, v32):
        return self.ell.rmatvec32(v32).index_add_(
            0, self.spill_idx, dense_price(self.D32, v32))

    def price(self, c, pi):
        return self.ell.price(c, pi).index_add_(
            0, self.spill_idx, dense_price(self.D, pi), alpha=-1)

    def _add_spill_window(self, out, v32, bstart, bsize, alpha):
        """``out[spill − bstart] += alpha·(v32ᵀD)`` for the spill columns
        inside the window: one ``dense_price`` over their slot range."""
        s0, s1 = (int(k) for k in np.searchsorted(self._spill_cols, [bstart, bstart + bsize]))
        if s1 > s0:
            out.index_add_(0, self.spill_idx[s0:s1] - bstart,
                           dense_price(self.D32, v32, j0=s0, w=s1 - s0), alpha=alpha)
        return out

    def rmatvec32_block(self, v32, bstart: int, bsize: int):
        return self._add_spill_window(
            self.ell.rmatvec32_block(v32, bstart, bsize), v32, bstart, bsize, 1)

    def price32(self, c32, v32, bstart: int = 0, bsize: int | None = None):
        bsize = self.shape[1] - bstart if bsize is None else bsize
        return self._add_spill_window(
            self.ell.price32(c32, v32, bstart, bsize), v32, bstart, bsize, -1)

    def col(self, q):
        return self.ell.col(q) + self._spill_col(q)

    def ftran(self, Binv, q):
        return self.ell.ftran(Binv, q) + Binv @ self._spill_col(q)

    def col_dot(self, pi, q):
        return self.ell.col_dot(pi, q) + pi @ self._spill_col(q)

    def entries(self, rows_i, cols_j):
        base = self.ell.entries(rows_i, cols_j)
        pos = self.spill_pos.index_select(0, cols_j.long())
        dvals = self.D[rows_i.long(), pos.clamp_min(0)]
        return base + torch.where(pos >= 0, dvals, 0.0)

    def cols_matrix(self, idx):
        base = self.ell.cols_matrix(idx)
        pos = self.spill_pos.index_select(0, idx.long())
        dcols = self.D.index_select(1, pos.clamp_min(0))
        return base + torch.where(pos >= 0, dcols, 0.0)


def as_amatrix(A):
    """Wrap a raw tensor as :class:`DenseMatrix`; pass operators through."""
    if hasattr(A, "matvec"):
        return A
    return DenseMatrix(A)


def _ell_pool(major_ptr, minor_idx, values, n_major, n_pad, k):
    """K-major ELL arrays ``[k, n_pad]`` from a compressed (CSC/CSR) layout."""
    counts = np.diff(major_ptr)
    data = np.zeros((k, n_pad), dtype=np.float64)
    idx = np.zeros((k, n_pad), dtype=np.int32)
    nnz = int(major_ptr[-1])
    if nnz:
        owner = np.repeat(np.arange(n_major), counts)
        slot = np.arange(nnz) - np.repeat(major_ptr[:-1], counts)
        data[slot, owner] = values
        idx[slot, owner] = minor_idx
    return data, idx


def ell_from_csc(csc, m_pad: int, n_pad: int, k_pad: int | None = None, *,
                 device) -> EllMatrix:
    """Build an :class:`EllMatrix` on ``device`` from a scipy CSC matrix.

    ``k_pad`` pads the per-column nonzero count and defaults to the true
    maximum; a pad below it raises.  The row-major twin (A·x runs on it) is
    always built, padded to the true per-row maximum.
    """
    m, n = csc.shape
    if m > m_pad or n > n_pad:
        raise ValueError(f"({m}, {n}) does not fit the padding ({m_pad}, {n_pad})")
    csc = csc.tocsc()
    csr = csc.tocsr()
    k_true = int(np.diff(csc.indptr).max()) if n else 1
    K = max(1, k_pad if k_pad is not None else k_true)
    Kr = max(1, int(np.diff(csr.indptr).max()) if m else 1)
    if k_true > K:
        raise ValueError(f"column with {k_true} nnz exceeds K={K}")
    data, rows = _ell_pool(csc.indptr, csc.indices, csc.data, n, n_pad, K)
    rdata, rcols = _ell_pool(csr.indptr, csr.indices, csr.data, m, m_pad, Kr)

    def t(a):
        return torch.from_numpy(a).to(device)

    return EllMatrix(t(data), t(rows), m_pad, t(rdata), t(rcols))


def hybrid_from_csc(csc, m_pad: int, n_pad: int, k_pad: int, d_pad: int, *,
                    device) -> HybridMatrix:
    """Build a :class:`HybridMatrix` on ``device``: columns with more than
    ``k_pad`` nonzeros become dense spill columns (at most ``d_pad`` of
    them, padded with zero columns); the rest go to ELL with pad ``k_pad``."""
    import scipy.sparse as sp

    csc = csc.tocsc()
    m, n = csc.shape
    counts = np.diff(csc.indptr)
    spill = np.flatnonzero(counts > k_pad)
    if spill.size > d_pad:
        raise ValueError(f"{spill.size} spill columns exceed d_pad={d_pad}")
    csc_sparse = csc
    if spill.size:
        keep = np.ones(n, bool)
        keep[spill] = False
        csc_sparse = (csc @ sp.diags(keep.astype(csc.dtype))).tocsc()
        csc_sparse.eliminate_zeros()
    ell = ell_from_csc(csc_sparse, m_pad, n_pad, k_pad, device=device)
    D = np.zeros((m_pad, d_pad), dtype=np.float64)
    if spill.size:
        D[:m, : spill.size] = csc[:, spill].toarray()
    spill_idx = np.zeros(d_pad, dtype=np.int64)
    spill_idx[: spill.size] = spill
    spill_pos = np.full(n_pad, -1, dtype=np.int64)
    spill_pos[spill] = np.arange(spill.size)

    def t(a):
        return torch.from_numpy(a).to(device)

    return HybridMatrix(ell, t(D), t(spill_idx), t(spill_pos))
