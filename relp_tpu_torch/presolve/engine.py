"""Queue-driven presolving.

Counterpart of the reference presolve framework
(``src/data/linear_program/general_form/presolve/``, SURVEY §2.3): the
``Index`` orchestrator with nnz counters, dedup queues and the four rules in
priority order —

1. substitute fixed variables (rule/fixed_variable.rs:20-55),
2. singleton rows → variable bounds (rule/bound_constraint.rs:26-91),
3. costless singleton columns = implicit slacks folded into the constraint
   relation (rule/slack.rs:40-215, the 2×4×4 case table),
4. activity-based domain propagation à la Achterberg alg. 7.1
   (rule/domain_propagation.rs).

Design difference: rows are held as *activity intervals* ``[L_i, U_i]``
instead of (relation, b, range) triples.  All four rules collapse to
interval arithmetic — e.g. the reference's whole slack case table is the
single line ``[L,U] -= c·[l,u]`` — and the relation enum is reconstructed
once at the end.  The constraint matrix itself never changes during
presolve (only activity masks, bounds and intervals do), so counters are
plain masked nnz counts over immutable CSC/CSR copies.

Removed variables are recorded for postsolve as either a constant, a
:class:`LinearCombination`, or a :class:`SlackValue` (clamped interval
reconstruction), resolved recursively by
``GeneralForm.compute_full_solution`` — same contract as the reference's
``OriginalVariable::Removed{Solved, FunctionOfOthers}``.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from relp_tpu_torch.model.elements import (
    ConstraintRelation,
    LinearProgramType,
    RangedConstraintRelation,
)
from relp_tpu_torch.model.general_form import (
    GeneralForm,
    LinearCombination,
    Variable,
)

INF = float("inf")


@dataclass
class SlackValue:
    """Postsolve record for an eliminated implicit slack  s  of row
    ``a@x + c*s ∈ [L, U]``:  given the final x, any s with
    ``(L - a@x)/c <= ... `` works; pick the feasible value closest to 0."""

    terms: List[Tuple[str, float]]  # (variable name, coefficient) of a@x
    row_lower: float
    row_upper: float
    coefficient: float
    lower: float
    upper: float


@dataclass
class PresolveResult:
    status: Optional[LinearProgramType] = None  # infeasible/unbounded if decided
    nr_variables_removed: int = 0
    nr_constraints_removed: int = 0
    nr_bounds_tightened: int = 0
    # True when the rule budget ran out with work still queued (the solver
    # proceeds correctly either way; this makes the early stop observable
    # instead of silent — VERDICT r01 weak #6)
    budget_exhausted: bool = False


class _Dedup:
    """FIFO queue with membership dedup (reference ActivityQueue,
    presolve/queues.rs:137-171)."""

    def __init__(self):
        self._q = deque()
        self._in = set()

    def push(self, x):
        if x not in self._in:
            self._in.add(x)
            self._q.append(x)

    def pop(self):
        x = self._q.popleft()
        self._in.discard(x)
        return x

    def __bool__(self):
        return bool(self._q)


class Presolver:
    def __init__(self, general: GeneralForm, tol: float = 1e-9):
        self.g = general
        self.tol = tol
        m, n = general.A.shape
        self.m, self.n = m, n
        self.csc = general.A.tocsc()
        self.csr = general.A.tocsr()
        self.active_row = np.ones(m, dtype=bool)
        self.active_col = np.ones(n, dtype=bool)
        self.row_nnz = np.diff(self.csr.indptr).astype(np.int64)
        self.col_nnz = np.diff(self.csc.indptr).astype(np.int64)

        # activity intervals per row
        self.L = np.empty(m)
        self.U = np.empty(m)
        for i, rel in enumerate(general.constraint_types):
            bi = general.b[i]
            if rel.is_range:
                self.L[i], self.U[i] = bi - rel.range_width, bi
            elif rel.kind is ConstraintRelation.EQUAL:
                self.L[i] = self.U[i] = bi
            elif rel.kind is ConstraintRelation.LESS:
                self.L[i], self.U[i] = -INF, bi
            else:
                self.L[i], self.U[i] = bi, INF

        # accumulated |coef*value| subtracted from each row interval by
        # substitutions — scales roundoff-residue feasibility checks
        self.shift_mag = np.zeros(m)

        self.lb = np.array([v.lower for v in general.variables])
        self.ub = np.array([v.upper for v in general.variables])
        # Speculative activity bounds (reference Updates.activity_bounds,
        # presolve/updates.rs:27-67): bounds *implied* by constraint
        # activities.  They sharpen propagation immediately (every
        # improvement is recorded here, however small) but are promoted
        # into the REAL bounds self.lb/self.ub — what write_back emits —
        # only when useful: a meaningful tightening, or the variable had no
        # finite bound on that side at all.
        self.act_lb = self.lb.copy()
        self.act_ub = self.ub.copy()
        self.cost = np.array([v.cost for v in general.variables])
        # minimization-sense costs drive direction decisions (empty columns)
        from relp_tpu_torch.model.elements import Objective

        self.min_cost = (
            -self.cost if general.objective is Objective.MAXIMIZE else self.cost
        )
        self.fixed_cost = general.fixed_cost
        self.result = PresolveResult()

        self.q_fixed = _Dedup()      # variables with lb == ub
        self.q_rows = _Dedup()       # candidate singleton/empty rows
        self.q_cols = _Dedup()       # candidate slack/empty columns
        self.q_activity = _Dedup()   # rows for domain propagation

        for j in range(n):
            if self.lb[j] > self.ub[j] + self.tol:
                self.result.status = LinearProgramType.INFEASIBLE
                return
            if self.lb[j] == self.ub[j]:
                self.q_fixed.push(j)
            elif self.col_nnz[j] <= 1:
                self.q_cols.push(j)
        for i in range(m):
            if self.row_nnz[i] <= 1:
                self.q_rows.push(i)
            self.q_activity.push(i)

    # ---- iteration helpers -------------------------------------------------

    def row_entries(self, i):
        s, e = self.csr.indptr[i], self.csr.indptr[i + 1]
        for j, v in zip(self.csr.indices[s:e], self.csr.data[s:e]):
            if self.active_col[j]:
                yield int(j), float(v)

    def col_entries(self, j):
        s, e = self.csc.indptr[j], self.csc.indptr[j + 1]
        for i, v in zip(self.csc.indices[s:e], self.csc.data[s:e]):
            if self.active_row[i]:
                yield int(i), float(v)

    # ---- removal primitives ------------------------------------------------

    def _deactivate_row(self, i):
        self.active_row[i] = False
        self.result.nr_constraints_removed += 1
        for j, _ in self.row_entries(i):
            self.col_nnz[j] -= 1
            if self.col_nnz[j] <= 1 and self.active_col[j]:
                self.q_cols.push(j)

    def _deactivate_col(self, j):
        self.active_col[j] = False
        self.result.nr_variables_removed += 1
        for i, _ in self.col_entries(j):
            self.row_nnz[i] -= 1
            if self.row_nnz[i] <= 1 and self.active_row[i]:
                self.q_rows.push(i)
            self.q_activity.push(i)

    # Chained derived bounds accumulate roundoff far beyond machine eps on
    # numerically wide instances (PILOT87): promotion to REAL bounds needs a
    # *substantial* improvement, and infeasibility keeps a safety margin.
    MEANINGFUL = 1e-6
    CROSSING = 1e-7

    def _record_fix(self, j, v):
        self.lb[j] = self.ub[j] = v
        self.act_lb[j] = self.act_ub[j] = v
        self.q_fixed.push(j)

    def _after_bound_change(self, j):
        """Shared crossing/fixing checks on the activity interval + requeue."""
        al, au = self.act_lb[j], self.act_ub[j]
        if al > au + self.CROSSING * (1 + abs(al)):
            self.result.status = LinearProgramType.INFEASIBLE
            return
        if al > au:
            # tiny crossing within tolerance: snap to the midpoint
            self._record_fix(j, 0.5 * (al + au))
        elif (
            math.isfinite(al)
            and math.isfinite(au)
            and au - al <= self.tol * (1 + abs(al))
        ):
            self._record_fix(j, 0.5 * (al + au))
        for i, _ in self.col_entries(j):
            self.q_activity.push(i)

    def _tighten(self, j, lower=None, upper=None) -> bool:
        """SPECULATIVE (activity-implied) tightening — reference
        ``Updates.activity_bounds`` (presolve/updates.rs:27-67).  Every
        beyond-noise improvement is recorded in the activity bounds (so
        propagation compounds); it is *promoted* into the real variable
        bounds only when useful — a meaningful tightening, or the variable
        had no finite bound on that side (was free there)."""
        changed = False
        if lower is not None and lower > self.act_lb[j] + self.tol * (1 + abs(lower)):
            self.act_lb[j] = lower
            changed = True
            if (not math.isfinite(self.lb[j])) or lower > self.lb[j] + self.MEANINGFUL * (
                1 + abs(lower)
            ):
                self.lb[j] = lower
                self.result.nr_bounds_tightened += 1
        if upper is not None and upper < self.act_ub[j] - self.tol * (1 + abs(upper)):
            self.act_ub[j] = upper
            changed = True
            if (not math.isfinite(self.ub[j])) or upper < self.ub[j] - self.MEANINGFUL * (
                1 + abs(upper)
            ):
                self.ub[j] = upper
                self.result.nr_bounds_tightened += 1
        if changed:
            self._after_bound_change(j)
        return changed

    def _impose(self, j, lower=None, upper=None) -> bool:
        """REAL bound merge from a *removed* constraint (singleton row).
        Unlike the speculative path this must always be recorded, however
        small the change — the row carrying the information is gone
        (reference rule/bound_constraint.rs:26-91 adds real bounds)."""
        changed = False
        if lower is not None and lower > self.lb[j]:
            self.lb[j] = lower
            self.act_lb[j] = max(self.act_lb[j], lower)
            changed = True
        if upper is not None and upper < self.ub[j]:
            self.ub[j] = upper
            self.act_ub[j] = min(self.act_ub[j], upper)
            changed = True
        if changed:
            self.result.nr_bounds_tightened += 1
            self._after_bound_change(j)
        return changed

    # ---- rule 1: fixed variable substitution ------------------------------

    def rule_fixed_variable(self, j):
        v = self.lb[j]
        for i, coef in self.col_entries(j):
            self.L[i] -= coef * v
            self.U[i] -= coef * v
            self.shift_mag[i] += abs(coef * v)
        self.fixed_cost += self.cost[j] * v
        name = self.g.variables[j].name
        self.g.removed_variables[name] = v
        self._deactivate_col(j)

    # ---- rule 2: singleton / empty rows -----------------------------------

    def rule_row(self, i):
        entries = list(self.row_entries(i))
        if len(entries) == 0:
            # empty row: 0 must lie in [L, U], up to the roundoff introduced
            # by the substitutions that emptied it
            rtol = 100 * self.tol * (1 + self.shift_mag[i])
            if self.L[i] > rtol or self.U[i] < -rtol:
                self.result.status = LinearProgramType.INFEASIBLE
                return
            self._deactivate_row(i)
            return
        if len(entries) != 1:
            return
        j, coef = entries[0]
        lo, hi = self.L[i] / coef, self.U[i] / coef
        if coef < 0:
            lo, hi = hi, lo
        self._deactivate_row(i)
        if self.L[i] == self.U[i]:
            v = self.L[i] / coef
            if v < self.act_lb[j] - self.tol * (1 + abs(v)) or v > self.act_ub[j] + self.tol * (
                1 + abs(v)
            ):
                self.result.status = LinearProgramType.INFEASIBLE
                return
            self._record_fix(j, v)
        else:
            # REAL bounds: the row is removed, so even a tiny merge must land
            self._impose(j, lower=None if lo == -INF else lo,
                         upper=None if hi == INF else hi)

    # ---- rule 3: empty columns and implicit slacks ------------------------

    def rule_col(self, j):
        entries = list(self.col_entries(j))
        name = self.g.variables[j].name
        if len(entries) == 0:
            # variable appears only in the objective (direction decided in
            # minimization sense; recorded cost stays in the original sense)
            cmin = self.min_cost[j]
            if cmin > 0:
                v = self.lb[j]
            elif cmin < 0:
                v = self.ub[j]
            else:
                v = min(max(0.0, self.lb[j]), self.ub[j])
            if not math.isfinite(v):
                self.result.status = LinearProgramType.UNBOUNDED
                return
            self.fixed_cost += self.cost[j] * v
            self.g.removed_variables[name] = v
            self._deactivate_col(j)
            return
        if len(entries) != 1 or self.cost[j] != 0.0:
            return
        # costless singleton column: implicit slack of its row.
        # Interval view of the reference's whole case table
        # (rule/slack.rs:40-54): [L, U] -= coef * [lb_j, ub_j].
        i, coef = entries[0]
        # activity bounds: implied-by-constraints, tighter than the real
        # ones — sharper interval fold (the promotion machinery guarantees
        # they are valid implications of still-active rows)
        l, u = self.act_lb[j], self.act_ub[j]
        if coef > 0:
            newL, newU = self.L[i] - coef * u, self.U[i] - coef * l
        else:
            newL, newU = self.L[i] - coef * l, self.U[i] - coef * u
        terms = [
            (self.g.variables[k].name, c)
            for k, c in self.row_entries(i)
            if k != j
        ]
        self.g.removed_variables[name] = SlackValue(
            terms=terms,
            row_lower=self.L[i],
            row_upper=self.U[i],
            coefficient=coef,
            lower=l,
            upper=u,
        )
        self._deactivate_col(j)
        if newL == -INF and newU == INF:
            self._deactivate_row(i)
        else:
            self.L[i], self.U[i] = newL, newU
            self.q_activity.push(i)
            self.q_rows.push(i)  # may have become a singleton

    # ---- rule 4: activity-based domain propagation ------------------------

    def _activities(self, i):
        """(finite sum, #inf) for the min and max activity of row i."""
        smin = smax = 0.0
        n_inf_min = n_inf_max = 0
        for j, c in self.row_entries(i):
            lo = c * self.act_lb[j] if c > 0 else c * self.act_ub[j]
            hi = c * self.act_ub[j] if c > 0 else c * self.act_lb[j]
            if lo == -INF:
                n_inf_min += 1
            else:
                smin += lo
            if hi == INF:
                n_inf_max += 1
            else:
                smax += hi
        return smin, n_inf_min, smax, n_inf_max

    def rule_activity(self, i):
        L, U = self.L[i], self.U[i]
        smin, n_inf_min, smax, n_inf_max = self._activities(i)
        amin = -INF if n_inf_min else smin
        amax = INF if n_inf_max else smax
        # Tolerance direction matters.  Declaring INFEASIBLE must be
        # *conservative*: generous tolerance scaled by the (finite) activity
        # magnitudes, since the sums carry their roundoff.  Redundancy
        # removal and forcing are *aggressive* actions: they need a tight
        # tolerance scaled only by the row bound — the activity-scaled
        # tolerance once "forced" whole PILOT87 rows that were merely close.
        ftol = self.tol * (1 + abs(smin) + abs(smax))
        tight_L = self.tol * (1 + abs(L)) if math.isfinite(L) else 0.0
        tight_U = self.tol * (1 + abs(U)) if math.isfinite(U) else 0.0

        # constraint-level checks (domain_propagation.rs:242-315)
        if amin > U + ftol or amax < L - ftol:
            self.result.status = LinearProgramType.INFEASIBLE
            return
        if amin >= L - tight_L and amax <= U + tight_U:
            self._deactivate_row(i)  # redundant
            return
        if amin >= U - tight_U and not n_inf_min and math.isfinite(U):
            # forcing: every variable pinned at its min-activity bound
            for j, c in list(self.row_entries(i)):
                v = self.act_lb[j] if c > 0 else self.act_ub[j]
                self._record_fix(j, v)
            self._deactivate_row(i)
            return
        if amax <= L + tight_L and not n_inf_max and math.isfinite(L):
            for j, c in list(self.row_entries(i)):
                v = self.act_ub[j] if c > 0 else self.act_lb[j]
                self._record_fix(j, v)
            self._deactivate_row(i)
            return

        # per-variable residual-activity tightening
        # (domain_propagation.rs:326-455, incl. the 1-missing-bound case)
        for j, c in list(self.row_entries(i)):
            lo = c * self.act_lb[j] if c > 0 else c * self.act_ub[j]
            hi = c * self.act_ub[j] if c > 0 else c * self.act_lb[j]
            # residual min activity excluding j
            if lo == -INF:
                res_min = smin if n_inf_min == 1 else -INF
            else:
                res_min = smin - lo if n_inf_min == 0 else -INF
            if hi == INF:
                res_max = smax if n_inf_max == 1 else INF
            else:
                res_max = smax - hi if n_inf_max == 0 else INF
            # c*x_j <= U - res_min  and  c*x_j >= L - res_max
            if U < INF and res_min > -INF:
                v = (U - res_min) / c
                if c > 0:
                    self._tighten(j, upper=v)
                else:
                    self._tighten(j, lower=v)
            if L > -INF and res_max < INF:
                v = (L - res_max) / c
                if c > 0:
                    self._tighten(j, lower=v)
                else:
                    self._tighten(j, upper=v)
            if self.result.status is not None:
                return

    # ---- main loop ---------------------------------------------------------

    def run(self, max_ops: Optional[int] = None) -> PresolveResult:
        if self.result.status is not None:
            return self.result
        budget = max_ops if max_ops is not None else 40 * (self.m + self.n) + 1000
        while budget > 0 and self.result.status is None:
            budget -= 1
            if self.q_fixed:
                j = self.q_fixed.pop()
                if self.active_col[j]:
                    self.rule_fixed_variable(j)
            elif self.q_rows:
                i = self.q_rows.pop()
                if self.active_row[i]:
                    self.rule_row(i)
            elif self.q_cols:
                j = self.q_cols.pop()
                if self.active_col[j]:
                    self.rule_col(j)
            elif self.q_activity:
                i = self.q_activity.pop()
                if self.active_row[i]:
                    self.rule_activity(i)
            else:
                break
        if budget <= 0 and (
            self.q_fixed or self.q_rows or self.q_cols or self.q_activity
        ):
            self.result.budget_exhausted = True
            import logging

            logging.getLogger("relp_tpu_torch").info(
                "presolve budget exhausted with reductions still queued "
                "(m=%d n=%d, removed %d rows / %d cols so far)",
                self.m, self.n,
                self.result.nr_constraints_removed,
                self.result.nr_variables_removed,
            )
        if self.result.status is not None:
            return self.result
        self._write_back()
        return self.result

    # ---- write the reduced problem back into the GeneralForm ---------------

    def _write_back(self):
        rows = np.flatnonzero(self.active_row)
        cols = np.flatnonzero(self.active_col)
        A = self.csc[:, cols][rows, :]

        constraint_types: List[RangedConstraintRelation] = []
        b = np.empty(len(rows))
        for out_i, i in enumerate(rows):
            L, U = self.L[i], self.U[i]
            if L == U:
                constraint_types.append(RangedConstraintRelation.equal())
                b[out_i] = U
            elif U == INF:
                constraint_types.append(RangedConstraintRelation.greater())
                b[out_i] = L
            elif L == -INF:
                constraint_types.append(RangedConstraintRelation.less())
                b[out_i] = U
            else:
                constraint_types.append(RangedConstraintRelation.range(U - L))
                b[out_i] = U

        variables = []
        for j in cols:
            v = self.g.variables[j]
            variables.append(
                Variable(
                    name=v.name,
                    cost=v.cost,
                    lower=self.lb[j],
                    upper=self.ub[j],
                    variable_type=v.variable_type,
                )
            )

        g = self.g
        g.A = sp.csc_matrix(A)
        g.constraint_types = constraint_types
        g.b = b
        g.variables = variables
        g.fixed_cost = self.fixed_cost
        g.row_names = [g.row_names[i] for i in rows]


def presolve(general: GeneralForm, tol: float = 1e-9) -> PresolveResult:
    """Presolve ``general`` in place; returns the outcome summary.

    On INFEASIBLE/UNBOUNDED status the GeneralForm is left unreduced.
    """
    return Presolver(general, tol=tol).run()
