"""The dense resource-allocation LP (``bench.py``'s DENSE family).

    min c0ᵀx  s.t.  A x = A x0,  0 ≤ x ≤ 2

with a 100 %-dense seeded technology matrix ``A ~ U(0.05, 1)`` and
``x0 ~ U(0.2, 1)``, ``c0 ~ U(0.1, 1)``, drawn in that order from
``numpy.random.default_rng(seed)`` as ``bench.py`` draws its base problem
(its scenarios' perturbations are not applied).  ``b = A·x0`` makes the LP
feasible and the box bounded.  The default 768 × 1536 is ``bench.py``'s
default size; every column is longer than ``m/8``, so ``matrix_format=
"auto"`` picks the dense operator.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from relp_tpu_torch.model.elements import Objective, RangedConstraintRelation
from relp_tpu_torch.model.general_form import GeneralForm, Variable

SEED = 0xDE55E


def dense_lp_data(m: int = 768, n: int = 1536, seed: int = SEED):
    """``(A, b, c0)`` of the dense LP as numpy arrays."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.05, 1.0, (m, n))
    x0 = rng.uniform(0.2, 1.0, n)
    c0 = rng.uniform(0.1, 1.0, n)
    return A, A @ x0, c0


def dense_lp(m: int = 768, n: int = 1536, seed: int = SEED) -> GeneralForm:
    """The dense LP as a :class:`GeneralForm` (columns ``x0..``, equality
    rows)."""
    A, b, c0 = dense_lp_data(m, n, seed)
    return GeneralForm(
        objective=Objective.MINIMIZE,
        A=sp.csc_matrix(A),
        constraint_types=[RangedConstraintRelation.equal()] * m,
        b=b,
        variables=[Variable(f"x{j}", cost=c0[j], lower=0.0, upper=2.0) for j in range(n)],
        name=f"dense_{m}x{n}",
    )
