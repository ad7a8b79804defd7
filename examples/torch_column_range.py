"""Lazy column generation with warm starts, with the PyTorch port (the
counterpart of examples/column_range.py).

A cutting-stock LP whose pattern family is priced lazily: the master runs on
the device (the dense operator, priced by the ``dense_price*`` kernels), the
knapsack pricing runs on the host, and each re-solve warm-starts from the
previous basis.

Run:  python examples/torch_column_range.py            (on the GPU)
      RELP_TPU_TORCH_DEVICE=cpu python examples/torch_column_range.py
"""

import itertools
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from relp_tpu_torch.providers import ColumnPool, solve_with_column_generation  # noqa: E402
from relp_tpu_torch.utils.config import SolverConfig  # noqa: E402

INF = float("inf")
WIDTH = 100.0
SIZES = np.array([45.0, 36.0, 31.0, 14.0])
DEMAND = np.array([97.0, 610.0, 395.0, 211.0])


def pricing(pi, pool):
    best_val, best = -1.0, None
    maxes = (WIDTH // SIZES).astype(int)
    for combo in itertools.product(*[range(mx + 1) for mx in maxes]):
        a = np.array(combo, dtype=float)
        if a @ SIZES <= WIDTH:
            val = float(pi @ a)
            if val > best_val + 1e-12:
                best_val, best = val, a
    if best is None or best_val <= 1.0 + 1e-7:
        return None  # priced out: the current master is optimal
    return best.reshape(-1, 1), [1.0], [0.0], [INF], None


def main():
    m = len(DEMAND)
    init = np.diag((WIDTH // SIZES).astype(float))  # single-size patterns
    pool = ColumnPool(
        A=np.concatenate([init, -np.eye(m)], axis=1),
        b=DEMAND.copy(),
        c=np.concatenate([np.ones(m), np.zeros(m)]),
        lb=np.zeros(2 * m),
        ub=np.full(2 * m, INF),
        names=[f"p{j}" for j in range(m)] + [f"s{i}" for i in range(m)],
    )
    result = solve_with_column_generation(pool, pricing, SolverConfig(scale=False))
    print(f"status      {result.kind.value}")
    print(f"objective   {result.objective:.6f} rolls (LP bound)")
    print(f"cg rounds   {result.rounds}")
    print(f"simplex its {result.total_iterations}")
    print(f"pool size   {result.pool.nr_columns} columns")


if __name__ == "__main__":
    main()
