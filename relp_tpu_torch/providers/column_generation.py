"""Lazy column generation: masked pricing over a growing column pool.

Port of ``relp_tpu/providers/column_generation.py``:

- the *master* LP is the current pool, padded to ``row_align``/``col_align``
  and solved on the device as the dense operator by ``solve_core`` (every
  iteration prices through ``dense_price_select``/``dense_price``);
- between device solves a host-side ``generator(pi, pool)`` prices the
  virtual column family against the optimal duals (read once per round) and
  returns improving columns (negative reduced cost), or None when priced
  out;
- each re-solve warm-starts from the previous basis, which stays feasible
  because the pool only grows; the artificial indices move with the padded
  column count.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from relp_tpu_torch.model.elements import LinearProgramType
from relp_tpu_torch.ops.amatrix import DenseMatrix
from relp_tpu_torch.providers.base import ColumnPool
from relp_tpu_torch.simplex import status as st
from relp_tpu_torch.simplex.core import solve_core
from relp_tpu_torch.utils.config import DEFAULT_CONFIG, SolverConfig
from relp_tpu_torch.utils.device import DeviceLike, resolve_device

# generator(pi, pool) -> None | (A_new, c_new, lb_new, ub_new, names)
Generator = Callable[[np.ndarray, ColumnPool], Optional[Tuple]]


@dataclass
class ColumnGenerationResult:
    kind: LinearProgramType
    objective: Optional[float]
    x: Optional[np.ndarray]  # over the final pool's columns
    pool: ColumnPool
    rounds: int
    total_iterations: int


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult if x > 0 else mult


def _pad(pool: ColumnPool, config: SolverConfig):
    A, b, c, lb, ub = pool.masked_arrays()
    m, n = A.shape
    mp = _round_up(m, config.row_align)
    npad = _round_up(n, config.col_align)
    Ap = np.zeros((mp, npad))
    Ap[:m, :n] = A
    bp = np.zeros(mp)
    bp[:m] = b
    cp = np.zeros(npad)
    cp[:n] = c
    lbp = np.zeros(npad)
    ubp = np.zeros(npad)
    lbp[:n] = lb
    ubp[:n] = ub
    return Ap, bp, cp, lbp, ubp, m, n, mp, npad


def solve_with_column_generation(
    pool: ColumnPool,
    generator: Generator,
    config: SolverConfig = DEFAULT_CONFIG,
    max_rounds: int = 100,
    device: DeviceLike = None,
) -> ColumnGenerationResult:
    """Solve the master over ``pool``, ask ``generator`` for columns, grow
    the pool, and re-solve warm until the generator prices out (or
    ``max_rounds``).  ``device=None`` reads ``RELP_TPU_TORCH_DEVICE``."""
    dev = resolve_device(device)
    total_iters = 0
    warm = None  # (basis over old layout, vstat over old layout, n_old, np_old)

    for round_idx in range(max_rounds):
        Ap, bp, cp, lbp, ubp, m, n, mp, npad = _pad(pool, config)
        max_iter = config.resolve_max_iter(mp, npad)
        A_t = DenseMatrix(torch.from_numpy(Ap).to(dev))
        b_t, c_t, lb_t, ub_t = (torch.as_tensor(v, dtype=torch.float64, device=dev)
                                for v in (bp, cp, lbp, ubp))
        warm_t = {}
        if warm is not None:
            basis_old, vstat_old, n_old, np_old = warm
            # structural indices are stable (the pool only appends);
            # artificial indices shift with the padded column count
            basis0 = np.where(basis_old >= np_old, basis_old - np_old + npad, basis_old)
            vstat0 = np.full(npad, st.NB_FIXED, np.int64)
            vstat0[:n] = np.where(
                lbp[:n] == ubp[:n], st.NB_FIXED,
                np.where(np.isfinite(lbp[:n]), st.NB_LOWER,
                         np.where(np.isfinite(ubp[:n]), st.NB_UPPER, st.NB_FREE)),
            )
            vstat0[:n_old] = vstat_old[:n_old]  # keep the at-upper statuses
            warm_t = dict(basis0=torch.as_tensor(basis0, dtype=torch.int64, device=dev),
                          vstat0=torch.as_tensor(vstat0, device=dev))
        out = solve_core(A_t, b_t, c_t, lb_t, ub_t, config, max_iter, **warm_t)

        total_iters += int(out.it)
        status = int(out.status)
        if status != st.OPTIMAL:
            return ColumnGenerationResult(
                kind=st.STATUS_TO_TYPE[status], objective=None, x=None, pool=pool,
                rounds=round_idx + 1, total_iterations=total_iters,
            )

        pi = out.pi[:m].cpu().numpy()
        new = generator(pi, pool)
        if new is None:
            x = out.x[: pool.nr_columns].cpu().numpy()
            return ColumnGenerationResult(
                kind=LinearProgramType.FINITE_OPTIMUM, objective=float(pool.c @ x), x=x,
                pool=pool, rounds=round_idx + 1, total_iterations=total_iters,
            )

        warm = (out.basis.cpu().numpy(), out.vstat.cpu().numpy(), n, npad)
        pool = pool.with_columns(*new)

    return ColumnGenerationResult(
        kind=LinearProgramType.ITERATION_LIMIT, objective=None, x=None, pool=pool,
        rounds=max_rounds, total_iterations=total_iters,
    )
