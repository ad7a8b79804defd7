"""ComputationalForm: the standard-form arrays consumed by the device solver.

Counterpart of the reference's ``MatrixData`` provider
(``src/algorithm/two_phase/matrix_provider/matrix_data.rs:53-616``), which
presents a standardized ``GeneralForm`` as a virtual block matrix with six
column groups and virtual bound rows.  The TPU design is deliberately
different (SURVEY §7): variable bounds are *not* materialized as rows —
the engine is a bounded-variable simplex — so the only appended columns are
one slack per non-equality row:

    row kind            slack bounds        meaning
    --------            ------------        -------
    ==      (Equal)     (no slack)          A[i]@x == b[i]
    <=      (Less)      [0, +inf)           A[i]@x + s == b[i]
    >=      (Greater)   (-inf, 0]           A[i]@x + s == b[i]
    range w             [0, w]              b[i]-w <= A[i]@x <= b[i]

This is equivalent to (but much smaller than) the reference's
Normal/RangeSlack/UpperInequalitySlack/LowerInequalitySlack/
VariableBoundSlack/SlackBoundSlack block layout (matrix_data.rs:39-52).

The struct also carries geometric-mean equilibration scaling factors
(reference has none — exact arithmetic needs no scaling) and knows how to
undo them on solution extraction.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import scipy.sparse as sp

from relp_tpu_torch.model.elements import ConstraintRelation, Objective
from relp_tpu_torch.model.general_form import GeneralForm

INF = float("inf")


@dataclass
class ComputationalForm:
    """min  c@x (+ fixed_cost, sign-adjusted)  s.t.  A@x == b,  lb <= x <= ub.

    Columns ``[0, n_structural)`` are the GeneralForm's active variables in
    order; columns ``[n_structural, n)`` are row slacks (``slack_row[j]`` maps
    slack column offset j to its row).  ``row_scale``/``col_scale`` record the
    equilibration applied to ``A``; solutions in scaled space are mapped back
    by ``x_original = x_scaled * col_scale``.
    """

    A: sp.csc_matrix  # (m, n) float64, scaled (sparse CSC; the reference's
    #                    L1 is sparse end-to-end, matrix.rs:23-77 — the device
    #                    representation is chosen later by simplex/driver.py)
    b: np.ndarray  # (m,)
    c: np.ndarray  # (n,)
    lb: np.ndarray  # (n,)
    ub: np.ndarray  # (n,)
    n_structural: int
    slack_rows: np.ndarray  # (n - n_structural,) int
    col_names: List[str]
    maximize: bool
    fixed_cost: float
    row_scale: np.ndarray  # (m,)
    col_scale: np.ndarray  # (n,)

    @property
    def m(self) -> int:
        return self.A.shape[0]

    @property
    def n(self) -> int:
        return self.A.shape[1]

    def unscale_solution(self, x_scaled: np.ndarray) -> np.ndarray:
        """Map a solution of the scaled problem back to original units."""
        return x_scaled * self.col_scale

    def structural_values(self, x_scaled: np.ndarray) -> np.ndarray:
        return self.unscale_solution(x_scaled)[: self.n_structural]

    def objective_of(self, x_scaled: np.ndarray) -> float:
        """Objective value in the problem's own sense (internal minimization
        is already baked into ``c``; report the original objective)."""
        x = self.unscale_solution(x_scaled)[: self.n_structural]
        return float(self._orig_cost @ x) + self.fixed_cost

    # filled by build_computational_form (original structural costs, unscaled, with the
    # original sense — not negated for MAX)
    _orig_cost: np.ndarray = None  # type: ignore[assignment]


def _equilibrate_sparse(rows, cols, data, m, n, passes: int = 2):
    """Geometric-mean row/column equilibration computed over the nonzero
    pattern only (the dense version took ~20s on FIT2P), rounded to powers
    of two so scaling is exact in binary floating point.

    Returns (row_scale, col_scale); callers apply them to whatever storage
    they use.
    """
    row_scale = np.ones(m)
    col_scale = np.ones(n)
    logv = np.log2(np.abs(data))
    row_cnt = np.maximum(np.bincount(rows, minlength=m), 1)
    col_cnt = np.maximum(np.bincount(cols, minlength=n), 1)
    for _ in range(passes):
        r = -np.round(np.bincount(rows, weights=logv, minlength=m) / row_cnt)
        logv = logv + r[rows]
        row_scale *= np.exp2(r)
        cc = -np.round(np.bincount(cols, weights=logv, minlength=n) / col_cnt)
        logv = logv + cc[cols]
        col_scale *= np.exp2(cc)
    return row_scale, col_scale


def build_computational_form(
    general: GeneralForm, scale: bool = True
) -> ComputationalForm:
    """Lower a GeneralForm to standard equality form with slack columns.

    Mirrors the *semantics* of reference ``GeneralForm::derive_matrix_data``
    (general_form/mod.rs:259-314) without its
    transform_variables/make_b_non_negative steps (bounds handled natively).
    """
    m, n_s = general.A.shape
    A_struct = general.A.tocsc()

    slack_rows: List[int] = []
    slack_lb: List[float] = []
    slack_ub: List[float] = []
    for i, rel in enumerate(general.constraint_types):
        if rel.is_range:
            slack_rows.append(i)
            slack_lb.append(0.0)
            slack_ub.append(float(rel.range_width))
        elif rel.kind is ConstraintRelation.LESS:
            slack_rows.append(i)
            slack_lb.append(0.0)
            slack_ub.append(INF)
        elif rel.kind is ConstraintRelation.GREATER:
            slack_rows.append(i)
            slack_lb.append(-INF)
            slack_ub.append(0.0)
        # EQUAL: no slack

    n_slack = len(slack_rows)
    n = n_s + n_slack
    if n_slack:
        S = sp.csc_matrix(
            (
                np.ones(n_slack),
                (np.array(slack_rows), np.arange(n_slack)),
            ),
            shape=(m, n_slack),
        )
        A = sp.hstack([A_struct, S], format="csc")
    else:
        A = A_struct.copy()

    orig_cost = np.array([v.cost for v in general.variables], dtype=np.float64)
    c = np.zeros(n, dtype=np.float64)
    c[:n_s] = -orig_cost if general.objective is Objective.MAXIMIZE else orig_cost

    lb = np.full(n, -INF)
    ub = np.full(n, INF)
    lb[:n_s] = [v.lower for v in general.variables]
    ub[:n_s] = [v.upper for v in general.variables]
    if n_slack:
        lb[n_s:] = slack_lb
        ub[n_s:] = slack_ub

    b = general.b.astype(np.float64).copy()

    if scale and m > 0 and n > 0:
        coo = general.A.tocoo()
        # include slack coefficients (value 1 → log2 = 0) in the pattern
        slack_rows_arr = np.asarray(slack_rows, dtype=np.int64)
        rows_all = np.concatenate([coo.row.astype(np.int64), slack_rows_arr])
        cols_all = np.concatenate(
            [coo.col.astype(np.int64), n_s + np.arange(n_slack, dtype=np.int64)]
        )
        data_all = np.concatenate([coo.data, np.ones(n_slack)])
        keep = data_all != 0
        row_scale, col_scale = _equilibrate_sparse(
            rows_all[keep], cols_all[keep], data_all[keep], m, n
        )
        A_scaled = (
            sp.diags(row_scale) @ A @ sp.diags(col_scale)
        ).tocsc()
    else:
        A_scaled = A
        row_scale = np.ones(m)
        col_scale = np.ones(n)

    # x_scaled = x / col_scale; constraint rows scaled by row_scale.
    b_scaled = b * row_scale
    with np.errstate(invalid="ignore"):
        lb_scaled = lb / col_scale
        ub_scaled = ub / col_scale
    c_scaled = c * col_scale

    names = [v.name for v in general.variables] + [
        f"__slack_r{i}" for i in slack_rows
    ]

    form = ComputationalForm(
        A=A_scaled,
        b=b_scaled,
        c=c_scaled,
        lb=lb_scaled,
        ub=ub_scaled,
        n_structural=n_s,
        slack_rows=np.array(slack_rows, dtype=np.int64),
        col_names=names,
        maximize=general.objective is Objective.MAXIMIZE,
        fixed_cost=general.fixed_cost,
        row_scale=row_scale,
        col_scale=col_scale,
    )
    form._orig_cost = orig_cost
    return form
