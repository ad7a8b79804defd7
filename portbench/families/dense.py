"""The dense resource-allocation LP: ``min c0·x  s.t.  A x = A·x0,  0 ≤ x ≤ 2``.

A plain NumPy copy of ``relp_tpu_torch/models/dense.py::dense_lp_data``
(bench.py's DENSE family): ``A ~ U(0.05, 1)`` 100 % dense, ``x0 ~ U(0.2, 1)``,
``c0 ~ U(0.1, 1)``, drawn in that order from ``default_rng(seed)``.  ``x0`` is
feasible, so the LP has an optimum; it rides along in ``LP.extra``.  The
configuration fixes the base LP (``base_seed``): a run's requests move its
bounds or its data, as the cell's traffic says.
"""

from __future__ import annotations

import numpy as np

from portbench.families.lp import LP


def dense_data(m: int, n: int, seed):
    """``(A, x0, c0)`` as the port's ``dense_lp_data`` draws them."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.05, 1.0, (m, n))
    x0 = rng.uniform(0.2, 1.0, n)
    c0 = rng.uniform(0.1, 1.0, n)
    return A, x0, c0


def dense_lp(A, x0, c, upper: float, name: str) -> LP:
    m, n = A.shape
    return LP(name=name, maximize=False, m=m, n=n, b=A @ x0, c=np.asarray(c, np.float64),
              lb=np.zeros(n), ub=np.full(n, float(upper)),
              row_names=[f"r{i}" for i in range(m)], col_names=[f"x{j}" for j in range(n)],
              dense=A, extra={"x0": x0})


def make(config: dict, seed: int, k: int) -> LP:
    """The configuration's base LP; the kinds draw their requests from it."""
    A, x0, c0 = dense_data(int(config["rows"]), int(config["cols"]), int(config["base_seed"]))
    return dense_lp(A, x0, c0, float(config["upper"]), f"dense_{A.shape[0]}x{A.shape[1]}")
