"""A of an LP on a torch device: products with A and Aᵀ, and the normal
matrix A·diag(θ)·Aᵀ of an interior-point step."""

from __future__ import annotations

import numpy as np
import torch

from portbench.families.lp import LP


def _summed(size: int, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """A vector of ``size`` with ``values`` summed at ``index``."""
    return values.new_zeros(size).index_put_((index,), values, accumulate=True)


class Operator:
    """A in the given precision: held dense, ``[m, n]``, where the LP holds
    it dense, and from its nonzeros alone where the LP holds it sparse (no
    ``[m, n]`` array, on the host or the device)."""

    def __init__(self, lp: LP, dtype=torch.float64, device="cpu"):
        self.m, self.n = lp.m, lp.n
        self.dtype, self.device = dtype, torch.device(device)
        if lp.sparse is None:
            self.dense = torch.as_tensor(lp.dense, dtype=dtype, device=self.device)
            return
        self.dense = None
        A = lp.sparse.tocsc(copy=True)
        A.sum_duplicates()
        counts = np.diff(A.indptr)
        row = A.indices.astype(np.int64)
        col = np.repeat(np.arange(self.n), counts)  # each nonzero's column
        # every pair (k, l) of nonzeros of one column, Σ counts² of them: for
        # k, the column's nonzeros l in order
        reps = counts[col]
        first = np.repeat(np.arange(A.nnz), reps)
        second = (A.indptr[col[first]] + np.arange(first.size)
                  - np.repeat(np.cumsum(reps) - reps, reps))
        i64 = dict(dtype=torch.int64, device=self.device)
        self.rows = torch.as_tensor(row, **i64)
        self.cols = torch.as_tensor(col, **i64)
        self.vals = torch.as_tensor(A.data, dtype=dtype, device=self.device)
        self.pair_at = torch.as_tensor(row[first] * self.m + row[second], **i64)
        self.pair_col = torch.as_tensor(col[first], **i64)
        self.pair_val = torch.as_tensor(A.data[first] * A.data[second], dtype=dtype,
                                        device=self.device)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """A·x."""
        if self.dense is not None:
            return self.dense @ x
        return _summed(self.m, self.rows, self.vals * x[self.cols])

    def rmv(self, y: torch.Tensor) -> torch.Tensor:
        """Aᵀ·y."""
        if self.dense is not None:
            return self.dense.T @ y
        return _summed(self.n, self.cols, self.vals * y[self.rows])

    def normal(self, theta: torch.Tensor) -> torch.Tensor:
        """A·diag(θ)·Aᵀ as a dense ``[m, m]`` tensor."""
        if self.dense is not None:
            return (self.dense * theta) @ self.dense.T
        M = _summed(self.m * self.m, self.pair_at, self.pair_val * theta[self.pair_col])
        return M.view(self.m, self.m)
