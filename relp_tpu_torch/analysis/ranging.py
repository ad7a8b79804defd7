"""Sensitivity ranging from an optimal basis (post-optimal analysis).

Classic simplex ranging: for each structural variable, the interval its
objective coefficient can move while the current basis stays optimal; for
each constraint, the interval its right-hand side can move while the basis
stays primal feasible (over which the dual value is the exact objective
slope).  The reference (rust-lp) has no ranging — its roadmap stops at
"a convenient API" (README.md:15-28); this module is a beyond-reference
capability enabled by the fact that every solve already returns its final
basis and variable statuses (SimplexResult.basis/vstat).

All algebra runs host-side in numpy/scipy off the *scaled* computational
form, then maps back to original units (the inverse of the equilibration
applied in model/computational_form.py):

    A_s = R A C,  b_s = R b,  x = C x_s,  c_s = sigma * C c_orig

with sigma = -1 for maximization (the engine minimizes).  A delta on the
original cost c_j is sigma * C_j times a delta on the scaled cost; a delta
on the original rhs b_i is 1/r_i times a delta on the scaled rhs.  Dual
values reported here follow the driver's convention (original row units,
original objective sense).

Ranging is only defined at a vertex: results from the first-order or
interior-point engine without crossover carry no basis and are rejected.

A copy of ``relp_tpu/analysis/ranging.py`` (host numpy and scipy, no device
call): it reads this package's ``ComputationalForm`` and ``SimplexResult``,
whose basis state is numpy already.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import splu

from relp_tpu_torch.simplex import status as st

INF = float("inf")


@dataclass
class CostRange:
    """Objective-coefficient range for one structural variable."""

    name: str
    value: float        # optimal activity (original units)
    cost: float         # current objective coefficient (original units)
    lo: float           # smallest coefficient keeping this basis optimal
    hi: float           # largest coefficient keeping this basis optimal
    reduced_cost: float  # original-sense reduced cost (0 for basic)
    basic: bool
    computed: bool = True  # False: range skipped (problem above dense_limit),
    # NOT a genuine (-inf, +inf) — callers must check before trusting lo/hi


@dataclass
class RhsRange:
    """Right-hand-side range for one constraint row."""

    name: str           # row name when known, else "r{i}"
    rhs: float          # current right-hand side (original units)
    lo: float           # smallest rhs keeping this basis feasible
    hi: float           # largest rhs keeping this basis feasible
    dual: float         # objective slope d(obj)/d(rhs) over [lo, hi]


@dataclass
class RangingResult:
    cost: List[CostRange]
    rhs: List[RhsRange]

    def cost_by_name(self) -> Dict[str, CostRange]:
        return {r.name: r for r in self.cost}

    def rhs_by_name(self) -> Dict[str, RhsRange]:
        return {r.name: r for r in self.rhs}


def _basis_in_cf_space(cf, basis, n_pad):
    """Map padded basis slots to real-row basis columns.

    Padded rows are all-zero with b=0, so their artificials never leave the
    basis; every remaining slot holds either a real column (< cf.n) or a
    real row's artificial.  Returns (cols, kinds) where kinds[k] is the
    column index j < cf.n, or -(r+1) for the artificial of real row r.
    """
    m = cf.m
    kinds = []
    for j in basis:
        j = int(j)
        if j < cf.n:
            kinds.append(j)
        elif j >= n_pad:
            r = j - n_pad
            if r < m:
                kinds.append(-(r + 1))
            # else: padded-row artificial — not part of the real block
        else:
            raise ValueError(
                f"basis contains padded structural column {j} (n={cf.n})"
            )
    if len(kinds) != m:
        raise ValueError(
            f"basis maps to {len(kinds)} real slots, expected m={m}"
        )
    return kinds


def ranging(cf, result, row_names: Optional[List[str]] = None,
            dense_limit: float = 5e7) -> RangingResult:
    """Compute cost and rhs ranging from a finished optimal solve.

    ``cf`` is the ComputationalForm the solve ran on; ``result`` is its
    SimplexResult (must be optimal and carry ``basis``/``vstat``).  Two
    size gates share ``dense_limit``: when m*m exceeds it, the dense B^-1
    is not formed (rhs ranging falls back to per-row LU solves); when m*m
    or m*n exceeds it, basic-variable cost ranging (which needs rows of
    B^-1 A) is skipped and those entries carry ``computed=False`` — their
    (lo, hi) is a placeholder, not a genuine unbounded range.
    """
    if not result.is_optimal:
        raise ValueError("ranging requires an optimal result")
    if result.basis is None or result.vstat is None:
        raise ValueError(
            "result carries no basis (first-order solve without crossover?)"
        )
    A = sp.csc_matrix(cf.A)
    m, n = cf.m, cf.n
    n_pad = result.metrics.n_padded if result.metrics else n
    basis = np.asarray(result.basis)
    vstat = np.asarray(result.vstat)
    art_sign = (
        np.asarray(result.art_sign)
        if getattr(result, "art_sign", None) is not None
        else np.ones(m)
    )
    sigma = -1.0 if cf.maximize else 1.0

    kinds = _basis_in_cf_space(cf, basis, n_pad)
    cols = []
    cB = np.zeros(m)
    basic_slot_of_col: Dict[int, int] = {}
    slot_lb = np.zeros(m)
    slot_ub = np.zeros(m)
    for k, kind in enumerate(kinds):
        if kind >= 0:
            cols.append(A[:, [kind]])
            cB[k] = cf.c[kind]
            basic_slot_of_col[kind] = k
            slot_lb[k] = cf.lb[kind]
            slot_ub[k] = cf.ub[kind]
        else:
            r = -kind - 1
            e = sp.csc_matrix(
                (np.array([art_sign[r] or 1.0]), (np.array([r]), np.array([0]))),
                shape=(m, 1),
            )
            cols.append(e)
            # a basic artificial sits at 0 on a redundant row and must stay
            # there: zero-width bounds (rhs ranging of that row is pinned)
            slot_lb[k] = 0.0
            slot_ub[k] = 0.0
    B = sp.hstack(cols).tocsc()
    lu = splu(B)

    # duals and reduced costs in the scaled (min) space
    y = lu.solve(cB, trans="T")
    d = np.asarray(cf.c) - A.T @ y

    # basic values: B xB = b - A x_N (nonbasic columns at their bound)
    x_nb = np.zeros(n)
    vs = vstat[:n]
    at_lo = (vs == st.NB_LOWER) | (vs == st.NB_FIXED)
    at_up = vs == st.NB_UPPER
    x_nb[at_lo] = cf.lb[at_lo]
    x_nb[at_up] = cf.ub[at_up]
    xB = lu.solve(np.asarray(cf.b) - A @ x_nb)

    # full B^-1 (and rows of B^-1 A) only when affordable
    Binv = None
    W = None
    if float(m) * m <= dense_limit:
        Binv = lu.solve(np.eye(m))
    if Binv is not None and float(m) * n <= dense_limit:
        W = A.T @ Binv.T  # W[i, k] = e_k^T B^-1 a_i = (B^-1 A)_{k, i}

    nb_lo = at_lo & ~(vs == st.NB_FIXED)   # at-lower: d >= 0 must hold
    nb_up = at_up                           # at-upper: d <= 0 must hold

    cost_ranges: List[CostRange] = []
    x_full = np.zeros(n)
    x_full[:] = x_nb
    for j, k in basic_slot_of_col.items():
        x_full[j] = xB[k]
    values = cf.unscale_solution(x_full)[: cf.n_structural]

    for j in range(cf.n_structural):
        cj = float(cf._orig_cost[j])
        Cj = float(cf.col_scale[j])
        s = int(vs[j])
        computed = True
        if s == st.BASIC:
            k = basic_slot_of_col.get(j)
            if W is None or k is None:
                # range not computed (size gate, or basis/vstat mismatch) —
                # flagged so callers can't mistake it for a genuine (-inf,inf)
                lo_s, hi_s = -INF, INF
                computed = False
            else:
                w = np.asarray(W[:, k]).ravel()  # d_i - delta * w_i
                lo_s, hi_s = -INF, INF
                pos = nb_lo & (w > 1e-12)
                neg = nb_lo & (w < -1e-12)
                if pos.any():
                    hi_s = min(hi_s, float(np.min(d[pos] / w[pos])))
                if neg.any():
                    lo_s = max(lo_s, float(np.max(d[neg] / w[neg])))
                posu = nb_up & (w < -1e-12)
                negu = nb_up & (w > 1e-12)
                if posu.any():
                    hi_s = min(hi_s, float(np.min(d[posu] / w[posu])))
                if negu.any():
                    lo_s = max(lo_s, float(np.max(d[negu] / w[negu])))
                # a nonbasic FREE column needs d_i == 0: any w_i != 0 pins.
                # looser cutoff than the 1e-12 ratio-denominator guard above:
                # here w multiplies an EQUALITY (pin to a point), so noise-
                # level w must not collapse the range to {0}
                free = (vs == st.NB_FREE) & (np.abs(w) > 1e-9)
                if free.any():
                    lo_s, hi_s = max(lo_s, 0.0), min(hi_s, 0.0)
            basic = True
            rc = 0.0
        elif s == st.NB_FIXED:
            lo_s, hi_s = -INF, INF
            basic = False
            rc = sigma * float(d[j]) / Cj
        elif s == st.NB_UPPER:
            lo_s, hi_s = -INF, -float(d[j])
            basic = False
            rc = sigma * float(d[j]) / Cj
        elif s == st.NB_FREE:
            lo_s, hi_s = -float(d[j]), -float(d[j])
            basic = False
            rc = sigma * float(d[j]) / Cj
        else:  # NB_LOWER
            lo_s, hi_s = -float(d[j]), INF
            basic = False
            rc = sigma * float(d[j]) / Cj
        # scaled delta -> original delta: delta_orig = sigma * delta_s / C_j
        a, b = sigma * lo_s / Cj, sigma * hi_s / Cj
        if a > b:
            a, b = b, a
        cost_ranges.append(CostRange(
            name=cf.col_names[j],
            value=float(values[j]),
            cost=cj,
            lo=cj + a,
            hi=cj + b,
            reduced_cost=rc,
            basic=basic,
            computed=computed,
        ))

    rhs_ranges: List[RhsRange] = []
    b_orig = np.asarray(cf.b) / cf.row_scale
    room_up = slot_ub - xB
    room_dn = slot_lb - xB

    def _rhs_interval(H):
        """Vectorized ratio test over B^-1 columns: H[k, i] = (B^-1)_{k,i}.

        xB(delta) = xB + delta*h must stay in [slot_lb, slot_ub]; the
        binding k's are those with |h_k| beyond noise.  Returns (lo, hi)
        arrays over the i axis (masked ratios, no Python inner loop).
        """
        pos = H > 1e-12
        neg = H < -1e-12
        with np.errstate(divide="ignore", invalid="ignore"):
            up = np.where(pos, room_up[:, None] / H, INF)
            up = np.where(neg, room_dn[:, None] / H, up)
            dn = np.where(pos, room_dn[:, None] / H, -INF)
            dn = np.where(neg, room_up[:, None] / H, dn)
        return dn.max(axis=0), up.min(axis=0)

    if Binv is not None:
        lo_all, hi_all = _rhs_interval(Binv)
    else:
        # above the dense gate: per-row LU solves, batched in strips so
        # memory stays O(m * strip) while the ratio test stays vectorized
        lo_all = np.empty(m)
        hi_all = np.empty(m)
        strip = max(1, int(dense_limit // max(m, 1)))
        for i0 in range(0, m, strip):
            cols = np.arange(i0, min(i0 + strip, m))
            E = np.zeros((m, len(cols)))
            E[cols, np.arange(len(cols))] = 1.0
            H = lu.solve(E)
            lo_all[cols], hi_all[cols] = _rhs_interval(H)

    for i in range(m):
        ri = float(cf.row_scale[i])
        a, b = lo_all[i] / ri, hi_all[i] / ri
        bi = float(b_orig[i])
        name = row_names[i] if row_names and i < len(row_names) else f"r{i}"
        rhs_ranges.append(RhsRange(
            name=name,
            rhs=bi,
            lo=bi + a,
            hi=bi + b,
            dual=sigma * float(y[i]) * ri,
        ))

    return RangingResult(cost=cost_ranges, rhs=rhs_ranges)
