"""The plain reference of a mixed-integer LP over binary columns: the exact
optimum by enumeration, and the LP with the columns its bounds and rows fix
substituted out, which is what the interior point of ``ipm.py`` takes (it
takes no fixed column).

``fixed_out`` substitutes every column whose bounds meet, then drops each
row left without a free column (its right-hand side must then be 0) and
fixes the one free column of each row that has one, again and again.  The
rows it drops hold fixed columns alone, so every kept column's reduced
costs stay those of the whole LP.

``enumerate_optimum`` solves, for every ``y`` in {0, 1}^k over the binary
columns, the LP that fixes ``y`` (``fixed_out``, then the interior point),
and keeps the best; an LP whose solve ends above ``tol`` counts as
infeasible.  It runs at the tests' sizes (2^k LPs).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from portbench.families.lp import LP
from portbench.reference import ipm


@dataclass
class Reduced:
    lp: LP                 # the free columns and the kept rows
    cols: np.ndarray       # the free columns of the whole LP, in order
    rows: np.ndarray       # the kept rows, in order
    value: np.ndarray      # every column's fixed value (NaN where free)
    constant: float        # c·value over the fixed columns


def fixed_out(lp: LP, lb: np.ndarray, ub: np.ndarray, name: str,
              tol: float = 1e-9) -> Optional[Reduced]:
    """``lp`` under the bounds ``lb``, ``ub`` with its fixed columns out, or
    None where a row cannot hold (a dropped row's right-hand side off 0, or
    a column fixed outside its bounds, by more than ``tol`` relative)."""
    A = lp.dense if lp.sparse is None else lp.sparse.toarray()
    nz = A != 0.0
    value = np.where(lb == ub, lb, np.nan)
    kept = np.ones(lp.m, bool)
    scale = 1.0 + np.abs(lp.b).max(initial=0.0)
    while True:
        fixed = ~np.isnan(value)
        rest = lp.b - A[:, fixed] @ value[fixed]
        count = (nz[:, ~fixed]).sum(1)
        empty = kept & (count == 0)
        if np.any(np.abs(rest[empty]) > tol * scale):
            return None
        kept &= ~empty
        single = np.flatnonzero(kept & (count == 1))
        if single.size == 0:
            break
        for r in single:
            j = int(np.flatnonzero(nz[r] & ~fixed)[0])
            if not np.isnan(value[j]):
                continue  # fixed by another row of this pass: r is empty next pass
            v = rest[r] / A[r, j]
            if v < lb[j] - tol * (1 + abs(lb[j])) or v > ub[j] + tol * (1 + abs(ub[j])):
                return None
            value[j] = min(max(v, lb[j]), ub[j])
            kept[r] = False
    cols = np.flatnonzero(np.isnan(value))
    rows = np.flatnonzero(kept)
    fixed = ~np.isnan(value)
    rest = lp.b - A[:, fixed] @ value[fixed]
    sub = LP(name=name, maximize=lp.maximize, m=rows.size, n=cols.size, b=rest[rows],
             c=lp.c[cols], lb=lb[cols], ub=ub[cols],
             row_names=[lp.row_names[i] for i in rows],
             col_names=[lp.col_names[j] for j in cols],
             dense=np.ascontiguousarray(A[np.ix_(rows, cols)]))
    return Reduced(lp=sub, cols=cols, rows=rows, value=value,
                   constant=float(lp.c[fixed] @ value[fixed]))


def enumerate_optimum(lp: LP, binary: np.ndarray, device="cpu", tol: float = 1e-8):
    """``(objective, y)``: the least objective over every setting of the
    binary columns (``binary``, their indices) and the setting that reaches
    it; ``(inf, None)`` where none is feasible."""
    best, best_y = np.inf, None
    for bits in itertools.product((0.0, 1.0), repeat=len(binary)):
        lb, ub = lp.lb.copy(), lp.ub.copy()
        lb[binary] = ub[binary] = bits
        red = fixed_out(lp, lb, ub, f"{lp.name}_fixed")
        if red is None:
            continue
        if red.lp.n == 0:
            obj = red.constant
        else:
            try:
                sol = ipm.solve(red.lp, torch.float64, device)
            except FloatingPointError:
                continue
            if sol.kkt > tol:
                continue
            obj = red.constant + sol.objective
        if obj < best:
            best, best_y = obj, np.array(bits)
    return best, best_y
