"""Post-optimal sensitivity analysis on a production-planning LP, with the
PyTorch port (the counterpart of examples/sensitivity.py).

Solve once, then read off how far each profit coefficient and each resource
capacity can move before the production plan (the optimal basis) changes,
and the exact marginal value (dual) of each resource inside that window.

Run:  python examples/torch_sensitivity.py            (on the GPU)
      RELP_TPU_TORCH_DEVICE=cpu python examples/torch_sensitivity.py
"""

import os
import sys

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from relp_tpu_torch.analysis import ranging  # noqa: E402
from relp_tpu_torch.model.computational_form import ComputationalForm  # noqa: E402
from relp_tpu_torch.simplex.driver import solve_computational_form  # noqa: E402
from relp_tpu_torch.utils.config import SolverConfig  # noqa: E402

INF = float("inf")

# max 25*doors + 34*windows
#   carpentry:  2 d + 4 w <= 80   (hours)
#   finishing:  3 d + 2 w <= 60   (hours)
#   demand cap: d <= 18
PRODUCTS = ["doors", "windows"]
ROWS = ["carpentry", "finishing"]
A = np.array([
    [2.0, 4.0, 1.0, 0.0],   # + slack per row
    [3.0, 2.0, 0.0, 1.0],
])
profit = np.array([25.0, 34.0])

cf = ComputationalForm(
    A=sp.csc_matrix(A),
    b=np.array([80.0, 60.0]),
    c=np.concatenate([-profit, np.zeros(2)]),  # internal min space
    lb=np.zeros(4),
    ub=np.array([18.0, INF, INF, INF]),
    n_structural=4,
    slack_rows=np.zeros(0, dtype=np.int64),
    col_names=PRODUCTS + [f"slack_{r}" for r in ROWS],
    maximize=True,
    fixed_cost=0.0,
    row_scale=np.ones(2),
    col_scale=np.ones(4),
)
cf._orig_cost = np.concatenate([profit, np.zeros(2)])

res = solve_computational_form(cf, SolverConfig())
print(f"optimal profit: {res.objective:.2f}  (on {res.metrics.device})")
for name, v in zip(PRODUCTS, res.x_structural[:2]):
    print(f"  make {v:.2f} {name}")

r = ranging(cf, res, row_names=ROWS)
print("\nprofit coefficient ranges (same plan stays optimal):")
for cr in r.cost[:2]:
    print(f"  {cr.name}: {cr.cost:g} can move within [{cr.lo:.3g}, {cr.hi:.3g}]")

print("\nresource capacity ranges and marginal values:")
for rr in r.rhs:
    print(f"  {rr.name}: {rr.rhs:g} hours, worth {rr.dual:.3f}/hour "
          f"over [{rr.lo:.3g}, {rr.hi:.3g}]")
