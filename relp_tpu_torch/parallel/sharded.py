"""Column-sharded simplex solve (the pricing-parallel path).

Port of ``relp_tpu/parallel/sharded.py``.  The JAX package runs the one
``solve_core`` program with the column pool placed over the 'cols' mesh axis
and lets GSPMD insert the collectives.  PyTorch has no GSPMD, so the
placement is written out as an operator, :class:`ShardedMatrix`, with the
interface of ``ops/amatrix.py``; ``simplex/core.py`` and ``fom/pdhg.py`` run
on it unchanged.

- **Shards.**  Shard ``k`` holds the column block ``[j0, j1)`` of A on its
  device: a ``DenseMatrix`` block, the block of the ELL column pool, or, for
  a hybrid operator, the block's ELL part and its own spill columns.  Each
  prices its block with the kernels the single operator uses
  (``dense_price(_select)``, ``ell_price(_select)``).
- **The lead device** (the first of the 'cols' devices) holds B⁻¹, b, c, lb,
  ub and the row-indexed state, as the JAX package keeps them replicated
  (it shards c, lb and ub; here they are n floats on the lead device, with
  the same arithmetic).  For ELL and hybrid it keeps the row twin (and the
  spill block), and A·x runs there, as sharded.py:57-62 replicates them; a
  dense A·x sums the shards' products on the lead device.
- **Pricing.**  π goes to each shard; reduced costs come back concatenated
  in column order.  The dense and ELL operators choose the entering column
  inside the kernel (``price_select``): each shard chooses among its own
  columns, and the lead device chooses among the shards' candidates with the
  arithmetic of ``select_plain`` (global index = local + j0, the score
  recomputed from ``d_q``, the status and the devex weight; ties to the lowest
  index, NaN greatest; under Bland's rule the smallest improving index).  A
  hybrid shard has no fused route, so neither has the sharded hybrid
  operator, and the engine selects from the whole ``d``.
- **Column reads** (``col``, ``ftran``, ``col_dot``, ``entries``,
  ``cols_matrix``) take indices that stay on the device: every shard answers
  for the index clamped to its block, and the lead device keeps the owner's
  answer by a select on the mask, so no index is read by the host and a
  sharded iteration makes the host reads of a single one.
- Per column, a reduced cost is the sum the single operator's kernel forms
  (an ELL column's slots in order; a dense column's rows in the plan of
  ``dense_kernels.slices_for``, which on the card depends on the block's
  width), so on ELL, and wherever the dense plan matches, a sharded solve
  takes the single solve's pivots.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from relp_tpu_torch.ops.amatrix import DenseMatrix, EllMatrix, HybridMatrix, as_amatrix
from relp_tpu_torch.ops.select_epilogue import Selection, select_plain
from relp_tpu_torch.ops.sparse_kernels import ell_spmv
from relp_tpu_torch.utils.config import SolverConfig
from relp_tpu_torch.utils.device import DeviceLike, device_list
from relp_tpu_torch.utils.metrics import logger


class _RowTwin:
    """A·x on the lead device: the ELL row twin, and for a hybrid operator
    its dense spill block (the single operator's arithmetic, in its order)."""

    def __init__(self, rdata_t, rcols_t, D=None, spill_idx=None):
        self.rdata_t, self.rcols_t, self.D, self.spill_idx = rdata_t, rcols_t, D, spill_idx

    def matvec(self, x):
        y = ell_spmv(self.rdata_t, self.rcols_t, x)
        return y if self.D is None else y + self.D @ x.index_select(0, self.spill_idx)

    def astype(self, dtype):
        return _RowTwin(self.rdata_t.to(dtype), self.rcols_t,
                        None if self.D is None else self.D.to(dtype), self.spill_idx)


def _no_twin(m, dtype, dev):
    """An empty row twin (``[0, m]``): a shard never computes A·x."""
    return (torch.zeros((0, m), dtype=dtype, device=dev),
            torch.zeros((0, m), dtype=torch.int32, device=dev))


def _ell_block(ell: EllMatrix, j0, j1, dev) -> EllMatrix:
    def block(t):
        return None if t is None else t[:, j0:j1].contiguous().to(dev)

    return EllMatrix(block(ell.data_t), block(ell.rows_t), ell.m,
                     *_no_twin(ell.m, ell.dtype, dev), block(ell.data32_t))


def _hybrid_block(A: HybridMatrix, j0, j1, dev) -> HybridMatrix:
    """The hybrid operator of columns ``[j0, j1)``: its ELL block and the spill
    columns inside it (at least one slot; a padded slot is a zero column)."""
    slots = np.flatnonzero((A._spill_cols >= j0) & (A._spill_cols < j1))
    k, m = len(slots), A.shape[0]
    slot_t = torch.as_tensor(slots, dtype=torch.int64, device=A.D.device)

    def spill(D):
        out = torch.zeros((m, max(k, 1)), dtype=D.dtype, device=dev)
        out[:, :k] = D.index_select(1, slot_t).to(dev)
        return out

    spill_idx = np.zeros(max(k, 1), np.int64)
    spill_idx[:k] = A._spill_cols[slots] - j0
    spill_pos = np.full(j1 - j0, -1, np.int64)
    spill_pos[spill_idx[:k]] = np.arange(k)
    return HybridMatrix(_ell_block(A.ell, j0, j1, dev), spill(A.D),
                        torch.from_numpy(spill_idx).to(dev), torch.from_numpy(spill_pos).to(dev),
                        None if A.D32 is None else spill(A.D32))


class ShardedMatrix:
    """A's column blocks on the 'cols' devices (``shards[k]`` holds the
    columns ``bounds[k]``), with the operator interface of ``ops/amatrix.py``;
    every vector it takes or returns lies on the lead device ``lead``."""

    def __init__(self, shards: Sequence, bounds: Sequence, lead: torch.device, twin=None):
        self.shards = list(shards)
        self.bounds = [tuple(b) for b in bounds]
        self.lead = lead
        self.twin = twin
        self.m = self.shards[0].shape[0]

    def _like(self, shards, twin):
        return type(self)(shards, self.bounds, self.lead, twin)

    @property
    def shape(self):
        return (self.m, self.bounds[-1][1])

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def device(self):
        return self.lead

    def with_f32(self):
        return self._like([s.with_f32() for s in self.shards], self.twin)

    def astype(self, dtype):
        if dtype == self.dtype:
            return self
        return self._like([s.astype(dtype) for s in self.shards],
                          None if self.twin is None else self.twin.astype(dtype))

    # ---- per-shard work, results gathered on the lead device ----
    def _each(self, fn, *vecs):
        """``fn(shard, *vecs on its device)`` for every shard, concatenated on
        the lead device."""
        return torch.cat([fn(s, *(v.to(s.device) for v in vecs)).to(self.lead)
                          for s in self.shards])

    def _windows(self, bstart: int, bsize: Optional[int]):
        """``(shard, j0, lo, hi)`` of every shard that meets the columns
        ``[bstart, bstart+bsize)``."""
        bend = self.shape[1] if bsize is None else bstart + bsize
        for s, (j0, j1) in zip(self.shards, self.bounds):
            lo, hi = max(bstart, j0), min(bend, j1)
            if hi > lo:
                yield s, j0, lo, hi

    def matvec(self, x):
        if self.twin is not None:
            return self.twin.matvec(x)
        out = None
        for s, (j0, j1) in zip(self.shards, self.bounds):
            y = s.matvec(x[j0:j1].to(s.device)).to(self.lead)
            out = y if out is None else out + y
        return out

    def rmatvec(self, pi):
        return self._each(lambda s, v: s.rmatvec(v), pi)

    def rmatvec32(self, v32):
        return self._each(lambda s, v: s.rmatvec32(v), v32)

    def rmatvec32_block(self, v32, bstart: int, bsize: int):
        return torch.cat([s.rmatvec32_block(v32.to(s.device), lo - j0, hi - lo).to(self.lead)
                          for s, j0, lo, hi in self._windows(bstart, bsize)])

    def price(self, c, pi):
        return torch.cat([s.price(c[j0:j1].to(s.device), pi.to(s.device)).to(self.lead)
                          for s, (j0, j1) in zip(self.shards, self.bounds)])

    def price32(self, c32, v32, bstart: int = 0, bsize: int | None = None):
        return torch.cat([
            s.price32(c32[lo - bstart:hi - bstart].to(s.device), v32.to(s.device),
                      lo - j0, hi - lo).to(self.lead)
            for s, j0, lo, hi in self._windows(bstart, bsize)])

    # ---- column reads: the owning shard's answer, chosen on the device ----
    def _owned(self, idx, read):
        """``read(shard, local index)`` of the shard that owns each column of
        ``idx`` (a tensor on the lead device): every shard reads its clamped
        index, the owner's answer is kept by a select on the mask."""
        out = None
        for s, (j0, j1) in zip(self.shards, self.bounds):
            own = ((idx >= j0) & (idx < j1)).to(self.lead)
            local = (idx - j0).clamp(0, j1 - j0 - 1).to(s.device)
            parts = [p.to(self.lead) for p in read(s, local)]
            out = parts if out is None else [torch.where(own, p, o) for p, o in zip(parts, out)]
        return out

    def _q(self, q):
        return q if torch.is_tensor(q) else torch.tensor(q, device=self.lead)

    def entries(self, rows_i, cols_j):
        return self._owned(cols_j.long(), lambda s, j: (s.entries(rows_i.to(s.device), j),))[0]

    def cols_matrix(self, idx):
        return self._owned(idx.long(), lambda s, j: (s.cols_matrix(j),))[0]


class _SelectingShards(ShardedMatrix):
    """Shards whose kernels choose the entering column (dense and ELL)."""

    def _choose(self, sel: Selection, cands):
        """The best of the shards' candidates ``(global q, d_q)``, by
        ``select_plain``'s arithmetic over the candidates' own statuses and
        weights."""
        q = torch.stack([qk for qk, _ in cands])
        d_q = torch.stack([dk for _, dk in cands])
        one = Selection(sel.vstat.index_select(0, q), sel.can_enter.index_select(0, q),
                        sel.w.index_select(0, q), sel.bland, sel.eps_dual, sel.devex)
        i, has, d = select_plain(d_q, one)
        return q.index_select(0, i.reshape(1))[0], has, d

    def _select_window(self, price_one, sel, bstart, bsize):
        """Each shard's candidate in the window (``price_one(shard, its
        selection, j0, lo, hi)``), then the best of them."""
        cands = []
        for s, j0, lo, hi in self._windows(bstart, bsize):
            j1, dev = j0 + s.shape[1], s.device
            sub = Selection(sel.vstat[j0:j1].to(dev), sel.can_enter[j0:j1].to(dev),
                            sel.w[j0:j1].to(dev), sel.bland.to(dev), sel.eps_dual, sel.devex)
            q, _, d_q = price_one(s, sub, j0, lo, hi)
            cands.append((q.to(self.lead) + j0, d_q.to(self.lead)))
        return self._choose(sel, cands)

    def price_select(self, c, pi, sel):
        def one(s, sub, j0, lo, hi):
            return s.price_select(c[lo:hi].to(s.device), pi.to(s.device), sub)
        return self._select_window(one, sel, 0, None)

    def price32_select(self, c32, v32, sel, bstart: int = 0, bsize: int | None = None):
        def one(s, sub, j0, lo, hi):
            return s.price32_select(c32[lo - bstart:hi - bstart].to(s.device), v32.to(s.device),
                                    sub, lo - j0, hi - lo)
        return self._select_window(one, sel, bstart, bsize)


class DenseShards(_SelectingShards):
    """Column blocks of a dense A; A·x sums the blocks' products."""

    def col(self, q):
        return self._owned(self._q(q), lambda s, j: (s.col(j),))[0]

    def ftran(self, Binv, q):
        return Binv @ self.col(q)

    def col_dot(self, pi, q):
        return pi @ self.col(q)


class EllShards(_SelectingShards):
    """Blocks of the ELL column pool; the row twin on the lead device."""

    def _slots(self, q):
        return self._owned(self._q(q), lambda s, j: s._col_slots(j))

    def col(self, q):
        rq, dq = self._slots(q)
        return torch.zeros(self.m, dtype=self.dtype, device=self.lead).index_add_(0, rq, dq)

    def ftran(self, Binv, q):
        rq, dq = self._slots(q)
        return Binv.index_select(1, rq) @ dq

    def col_dot(self, pi, q):
        rq, dq = self._slots(q)
        return pi.index_select(0, rq) @ dq


class HybridShards(ShardedMatrix):
    """Blocks of a hybrid operator (each an ELL block with its own spill
    columns); the row twin and the spill block on the lead device.  No fused
    selection, as on the single hybrid operator."""

    def _parts(self, q):
        return self._owned(self._q(q), lambda s, j: (*s.ell._col_slots(j), s._spill_col(j)))

    def col(self, q):
        rq, dq, spill = self._parts(q)
        return torch.zeros(self.m, dtype=self.dtype, device=self.lead).index_add_(0, rq, dq) + spill

    def ftran(self, Binv, q):
        rq, dq, spill = self._parts(q)
        return Binv.index_select(1, rq) @ dq + Binv @ spill

    def col_dot(self, pi, q):
        rq, dq, spill = self._parts(q)
        return pi.index_select(0, rq) @ dq + pi @ spill


def shard_operator(A, devices: Sequence[torch.device]) -> ShardedMatrix:
    """``A`` (a dense tensor or an operator of ``ops/amatrix.py``) split into
    ``len(devices)`` equal column blocks, block ``k`` on ``devices[k]``; the
    lead device ``devices[0]`` keeps what A·x needs.  The column count must
    divide by the number of devices."""
    A = as_amatrix(A)
    m, n = A.shape
    k = len(devices)
    if n % k != 0:
        raise ValueError(f"column count {n} not divisible by 'cols' axis size {k}")
    lead = devices[0]
    bounds = [(i * n // k, (i + 1) * n // k) for i in range(k)]
    if isinstance(A, HybridMatrix):
        shards = [_hybrid_block(A, j0, j1, d) for (j0, j1), d in zip(bounds, devices)]
        twin = _RowTwin(A.ell.rdata_t.to(lead), A.ell.rcols_t.to(lead), A.D.to(lead),
                        A.spill_idx.to(lead))
        return HybridShards(shards, bounds, lead, twin)
    if isinstance(A, EllMatrix):
        shards = [_ell_block(A, j0, j1, d) for (j0, j1), d in zip(bounds, devices)]
        return EllShards(shards, bounds, lead, _RowTwin(A.rdata_t.to(lead), A.rcols_t.to(lead)))
    if isinstance(A, DenseMatrix):
        shards = [DenseMatrix(A.A[:, j0:j1].to(d), None if A.A32 is None else A.A32[:, j0:j1].to(d))
                  for (j0, j1), d in zip(bounds, devices)]
        return DenseShards(shards, bounds, lead)
    raise TypeError(f"shard_operator: cannot shard a {type(A).__name__}")


def _cols_devices(mesh) -> List[torch.device]:
    """The 'cols' devices of the mesh's first 'batch' row."""
    return list(mesh.devices[0])


def shard_inputs(mesh, A, b, c, lb, ub):
    """Place the problem: A column-sharded over the mesh's 'cols' devices,
    ``b``, ``c``, ``lb`` and ``ub`` as f64 tensors on the lead device.  ``A``
    may be a dense array or tensor (columns = axis 1), an ``EllMatrix`` (each
    device holds its block's slots, the lead device the row twin) or a
    ``HybridMatrix`` (ELL blocks with their own spill columns; the row twin
    and the spill block on the lead device)."""
    devices = _cols_devices(mesh)
    if not hasattr(A, "matvec"):
        A = DenseMatrix(torch.as_tensor(np.asarray(A, np.float64)).to(devices[0]))
    A = shard_operator(A, devices)

    def vec(v):
        return torch.as_tensor(np.asarray(v.cpu() if torch.is_tensor(v) else v, np.float64),
                               device=A.device)

    return (A, *(vec(v) for v in (b, c, lb, ub)))


def shard_devices(mesh_cols: int, n_pad: int, devices: Sequence[torch.device],
                  first_order_layout: Optional[str] = None):
    """The devices a ``config.mesh_cols`` request shards over, or None for one
    device: the one decision of the driver's two mesh branches.  0 and 1 ask
    for one device (the JAX driver's reading of 0; its ``maybe_shard`` alone
    would read 0 as every device), k > 1 for k devices, k < 0 for every
    device of ``devices``.  Skips, with the JAX package's log line, when
    ``n_pad`` does not divide by the count or ``devices`` holds too few; when
    the first-order engine will run on ``first_order_layout`` ("bricks" or
    "ell"), a skip logs its line as well, and the engine keeps that layout."""
    k_dev = mesh_cols if mesh_cols > 0 else len(devices)
    if mesh_cols == 0 or k_dev == 1:
        return None
    if n_pad % k_dev != 0 or k_dev > len(devices):
        logger.warning(
            "mesh_cols=%d skipped: n_pad=%d %% %d != 0 or only %d devices",
            mesh_cols, n_pad, k_dev, len(devices),
        )
        if first_order_layout is not None:
            logger.warning(
                "pdlp mesh_cols=%d skipped (n_pad=%d, %d devices) — keeping layout %s",
                mesh_cols, n_pad, len(devices), first_order_layout,
            )
        return None
    return list(devices[:k_dev])


def maybe_shard(mesh_cols: int, n_pad: int, A, b, c, lb, ub, devices=None,
                device: DeviceLike = None):
    """The JAX package's ``maybe_shard``: :func:`shard_devices`' decision
    applied to a problem's arrays.  Returns ``(A, b, c, lb, ub, sharded)``:
    the inputs as they were when it does not shard, else
    :func:`shard_inputs`' placement over the first devices of ``devices``
    (default: the visible devices of ``device``'s kind).  The driver makes
    the decision itself and shards the operator it builds."""
    from relp_tpu_torch.parallel.mesh import make_solver_mesh

    devices = device_list(devices, device)
    chosen = shard_devices(mesh_cols, n_pad, devices)
    if chosen is None:
        return A, b, c, lb, ub, False
    mesh = make_solver_mesh(batch=1, cols=len(chosen), devices=chosen)
    return (*shard_inputs(mesh, A, b, c, lb, ub), True)


def solve_sharded(mesh, A, b, c, lb, ub, cfg: SolverConfig, max_iter: int):
    """Run the primal core with A column-sharded over the mesh's 'cols'
    devices (:func:`shard_inputs`); the result lies on the lead device.  The
    'cols' size must divide the (padded) column count."""
    from relp_tpu_torch.simplex.core import solve_core

    n = A.shape[1] if hasattr(A, "matvec") else np.asarray(A).shape[1]
    n_shards = mesh.shape["cols"]
    if n % n_shards != 0:
        raise ValueError(f"column count {n} not divisible by 'cols' axis size {n_shards}")
    A, b, c, lb, ub = shard_inputs(mesh, A, b, c, lb, ub)
    with torch.no_grad():
        return solve_core(A, b, c, lb, ub, cfg, max_iter)
