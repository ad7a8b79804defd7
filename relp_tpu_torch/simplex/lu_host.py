"""Sparse-LU bounded-variable dual simplex and crossover tools on the host.

A copy of ``relp_tpu/simplex/lu_host.py`` (numpy and scipy only) with its
imports pointed at this package; it is a host module, so it has no kernel
and takes no device.  Design:

- refactorization = ``scipy.sparse.linalg.splu`` on the (hyper-sparse)
  basis matrix (SuperLU's COLAMD ordering is the sparsity-preserving pivot
  order);
- between refactorizations the inverse action is the product form
  ``B⁻¹ = E_k ⋯ E_1 B₀⁻¹`` with dense-vector eta files (``_LuEta``);
- the iteration is the bounded-variable dual simplex: devex row pricing,
  bound-flipping ratio test with Harris near-tie selection, incremental
  reduced costs.

Why host: a sequential pivot on a hyper-sparse basis updates O(nnz) data
per step, far below any useful device dispatch, and sparse triangular
solves are serial DAG traversals.  The device owns the first-order path
(fom/pdhg.py); this module supplies exact-vertex capability for its
crossover: ``triangular_crash``, ``reduced_costs``, ``primal_push`` and the
dual-simplex cleanup ``solve_dual_lu``.

Where its build is available the update engine is the native
Forrest–Tomlin LU (``_FtEngine`` over simplex/ftlu.py), as in the JAX
package; otherwise, or under ``RELP_TPU_NO_FTLU=1``, the product form.
``lu_engine()`` names the one ``_make_lu`` gives.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import splu

from relp_tpu_torch.simplex import status as st
from relp_tpu_torch.utils.config import SolverConfig
from relp_tpu_torch.utils.metrics import logger as _log

INF = np.inf


class _LuEta:
    """B₀ = LU (SuperLU) plus product-form eta files: B⁻¹ = E_k⋯E_1 B₀⁻¹.

    Product-form etas compound error over long degenerate pivot runs where
    a Forrest–Tomlin spike update stays stable."""

    def __init__(self, B_csc, A_csc=None):
        self.lu = splu(B_csc.tocsc(), permc_spec="COLAMD")
        self.etas: list[tuple[int, np.ndarray, float]] = []  # (r, u, pivot)

    @property
    def nupdates(self) -> int:
        return len(self.etas)

    def ftran(self, v: np.ndarray) -> np.ndarray:
        """B⁻¹ v (forward: LU solve, then etas in push order)."""
        w = self.lu.solve(v)
        for r, u, p in self.etas:
            wr = w[r] / p
            if wr != 0.0:
                w -= u * wr
                w[r] = wr
        return w

    def btran(self, v: np.ndarray) -> np.ndarray:
        """B⁻ᵀ v (transposed etas in reverse order, then LU trans solve)."""
        y = v.copy()
        for r, u, p in reversed(self.etas):
            y[r] -= (u @ y - y[r]) / p
        return self.lu.solve(y, trans="T")

    def replace(self, r: int, q: int, u: np.ndarray) -> int:
        """Basis slot ``r`` := column ``q``; ``u = B⁻¹ a_q`` (precomputed).

        Returns 0 (the product form has no stability telemetry)."""
        self.etas.append((r, u.copy(), float(u[r])))
        return 0


class _FtEngine:
    """Native Forrest–Tomlin engine behind the lu_host call surface: spike
    column, rotate-to-back and one row eta keeping U triangular
    (native/ftlu.cpp).  ``replace`` consumes the ORIGINAL entering column (FT
    updates factor structure, not the solved column), so it needs the
    problem matrix at hand."""

    def __init__(self, B_csc, A_csc):
        from relp_tpu_torch.simplex.ftlu import FtLU

        self.ft = FtLU(B_csc)  # raises RuntimeError when singular
        self.A = A_csc
        self.nupdates = 0

    def ftran(self, v: np.ndarray) -> np.ndarray:
        return self.ft.ftran(v)

    def btran(self, v: np.ndarray) -> np.ndarray:
        return self.ft.btran(v)

    def replace(self, r: int, q: int, u: np.ndarray) -> int:
        lo, hi = self.A.indptr[q], self.A.indptr[q + 1]
        rc = self.ft.update(r, self.A.indices[lo:hi], self.A.data[lo:hi])
        self.nupdates += 1
        return rc


def lu_engine() -> str:
    """The update engine ``_make_lu`` gives: ``"forrest-tomlin"`` when the
    native library is available, else ``"product-form"`` (also under
    ``RELP_TPU_NO_FTLU=1``)."""
    import os

    if not os.environ.get("RELP_TPU_NO_FTLU"):
        from relp_tpu_torch.simplex import ftlu as _ftlu

        if _ftlu.available():
            return "forrest-tomlin"
    return "product-form"


def _make_lu(B_csc, A_csc):
    """The factorized basis with its update engine (``lu_engine()``)."""
    if lu_engine() == "forrest-tomlin":
        return _FtEngine(B_csc, A_csc)
    return _LuEta(B_csc, A_csc)


def _basis_matrix(A_csc, basis, art_sign, n_pad):
    """Sparse basis matrix in slot order (structural columns of A plus
    ±e_r artificial columns, matching the device convention)."""
    m = A_csc.shape[0]
    rows, cols, vals = [], [], []
    struct = basis < n_pad
    if struct.any():
        S = A_csc[:, basis[struct]].tocoo()
        slot_of = np.flatnonzero(struct)
        rows.append(S.row)
        cols.append(slot_of[S.col])
        vals.append(S.data)
    art = ~struct
    if art.any():
        r_art = (basis[art] - n_pad).astype(np.int64)
        rows.append(r_art)
        cols.append(np.flatnonzero(art))
        vals.append(np.where(art_sign[r_art] != 0, art_sign[r_art], 1.0))
    return sp.csc_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(m, m),
    )


def solve_dual_lu(
    A_csc, b, c, lb, ub, basis0, vstat0, art_sign, cfg: SolverConfig,
    max_iter: int, n_pad: int,
):
    """Run the dual simplex from (basis0, vstat0) on the padded problem.

    ``A_csc`` is the (m_pad × n_pad) scipy matrix; vectors are the padded
    scaled arrays the device cores consume.  Returns a SolveOutput-shaped
    SimpleNamespace (same fields the driver's XL paths produce).
    """
    m_pad = A_csc.shape[0]
    A_csc = A_csc.tocsc()
    A_t = A_csc.T.tocsr()  # csr transpose: O(nnz) πᵀA / ρᵀA products
    basis = np.asarray(basis0, np.int64).copy()
    vstat = np.asarray(vstat0, np.int32).copy()
    if len(vstat) < n_pad + m_pad:
        vstat = np.concatenate(
            [vstat, np.full(n_pad + m_pad - len(vstat), st.NB_LOWER, np.int32)]
        )
    vstat[basis] = st.BASIC  # basis slots must read BASIC everywhere below
    art_sign = np.asarray(art_sign, np.float64)
    lb_tot = np.concatenate([lb, np.zeros(m_pad)])
    ub_tot = np.concatenate([ub, np.zeros(m_pad)])
    boxed_range = ub - lb

    eps_p = float(cfg.eps_pivot)
    eps_f = float(cfg.eps_feas)
    eps_d = float(cfg.eps_dual)
    period = max(int(cfg.refactor_period), 8)

    it = 0
    pivots = 0
    flips_total = 0
    status = st.RUNNING
    lu = None
    beta = np.ones(m_pad)

    def nonbasic_x():
        xn = np.where(
            (vstat[:n_pad] == st.NB_LOWER) | (vstat[:n_pad] == st.NB_FIXED),
            lb,
            np.where(vstat[:n_pad] == st.NB_UPPER, ub, 0.0),
        )
        return np.where(vstat[:n_pad] == st.BASIC, 0.0, xn)

    def refactor():
        nonlocal lu, beta
        B = _basis_matrix(A_csc, basis, art_sign, n_pad)
        try:
            lu = _make_lu(B, A_csc)
        except RuntimeError as e:  # singular basis
            _log.warning("dual-lu: singular basis at refactorization (%s)", e)
            return None, None
        xn = nonbasic_x()
        xB = lu.ftran(b - A_csc @ xn)
        cB = np.where(basis < n_pad, c[np.minimum(basis, n_pad - 1)], 0.0)
        pi = lu.btran(cB)
        d = c - A_t @ pi
        beta = np.ones(m_pad)  # devex reference framework reset
        return xB, d

    xB, d = refactor()
    if xB is None:
        return None
    since = 0
    stalled = 0

    while it < max_iter and status == st.RUNNING:
        if since >= period:
            xB2, d2 = refactor()
            if xB2 is None:
                status = st.NUMERICAL
                break
            xB, d = xB2, d2
            since = 0
        fresh = since == 0
        it += 1

        k = basis
        lbk = lb_tot[k]
        ubk = ub_tot[k]
        below = lbk - xB
        above = xB - ubk
        viol = np.maximum(np.maximum(below, above), 0.0)
        vmax = float(viol.max()) if m_pad else 0.0
        if vmax <= eps_f:
            if fresh:
                status = st.OPTIMAL
                break
            since = period  # verify on a fresh factorization
            continue
        r = int(np.argmax(viol * viol / np.maximum(beta, 1e-12)))
        if viol[r] <= eps_f:
            r = int(np.argmax(viol))

        rho = lu.btran(_unit(m_pad, r))
        alpha = A_t @ rho  # length n_pad, O(nnz)
        vs = vstat[:n_pad]

        leaving_below = below[r] > above[r]
        alpha_eff = alpha if leaving_below else -alpha
        at_l = (vs == st.NB_LOWER) | (vs == st.NB_FREE)
        at_u = (vs == st.NB_UPPER) | (vs == st.NB_FREE)
        cand = (
            ((at_l & (alpha_eff < -eps_p)) | (at_u & (alpha_eff > eps_p)))
            & (lb < ub)
            & (vs != st.BASIC)
        )
        cand_idx = np.flatnonzero(cand)
        if cand_idx.size == 0:
            if fresh:
                status = st.INFEASIBLE
                break
            since = period
            continue
        abs_alpha = np.abs(alpha_eff[cand_idx])
        ratio = np.abs(d[cand_idx]) / np.maximum(abs_alpha, 1e-300)
        order = np.argsort(ratio, kind="stable")
        with np.errstate(invalid="ignore"):
            cap = boxed_range[cand_idx][order] * abs_alpha[order]
        slope_after = viol[r] - np.cumsum(np.where(np.isfinite(cap), cap, INF))
        blocked = slope_after <= 0
        if not blocked.any():
            if fresh:
                status = st.INFEASIBLE  # dual unbounded
                break
            since = period
            continue
        kq_block = int(np.argmax(blocked))
        ratio_block = ratio[order[kq_block]]
        near = (np.arange(len(order)) <= kq_block) & (
            ratio[order] >= ratio_block - eps_d
        )
        kq = int(np.argmax(np.where(near, abs_alpha[order], -1.0)))
        q = int(cand_idx[order[kq]])
        flip_cols = cand_idx[order[:kq]]
        flip_cols = flip_cols[np.isfinite(boxed_range[flip_cols])]

        u = lu.ftran(np.asarray(A_csc[:, q].todense()).ravel())
        p = float(u[r])
        if abs(p) <= eps_p:
            # numerical: refactor and retry; repeated tiny pivots stall out
            stalled += 1
            if stalled >= 3 and fresh:
                status = st.NUMERICAL
                break
            since = period
            continue
        stalled = 0

        # batch bound flips: xB -= B⁻¹ A Δx over the flipped columns
        if flip_cols.size:
            dx = np.where(
                vs[flip_cols] == st.NB_LOWER,
                boxed_range[flip_cols],
                -boxed_range[flip_cols],
            )
            xB = xB - lu.ftran(A_csc[:, flip_cols] @ dx)
            vstat[flip_cols] = np.where(
                vs[flip_cols] == st.NB_LOWER, st.NB_UPPER, st.NB_LOWER
            )
            flips_total += int(flip_cols.size)

        bound_r = lbk[r] if leaving_below else ubk[r]
        theta_p = (xB[r] - bound_r) / p
        start_val = (
            ub[q] if vstat[q] == st.NB_UPPER
            else (lb[q] if vstat[q] in (st.NB_LOWER, st.NB_FIXED) else 0.0)
        )
        xB = xB - theta_p * u
        xB[r] = start_val + theta_p
        theta_d = d[q] / p
        d = d - theta_d * alpha
        d[q] = 0.0

        # devex (dual form): γ' = max(γ, (u/p)²·γ_r); γ_r' = max(γ_r/p², 1)
        ru = u / p
        beta = np.maximum(beta, ru * ru * beta[r])
        beta[r] = max(beta[r] / (p * p), 1.0)
        np.clip(beta, 1e-12, 1e12, out=beta)

        kr = int(k[r])
        leave_stat = st.NB_LOWER if leaving_below else st.NB_UPPER
        if lb_tot[kr] == ub_tot[kr]:
            leave_stat = st.NB_FIXED
        vstat[kr] = leave_stat
        vstat[q] = st.BASIC
        basis[r] = q
        if lu.replace(r, q, u) != 0:
            since = period  # FT reports degraded accuracy: refactor next
        since += 1
        pivots += 1

        if it % 4096 == 0 and _log.isEnabledFor(20):
            _log.info(
                "dual-lu it=%d viol=%.3e etas=%d flips=%d",
                it, vmax, lu.nupdates, flips_total,
            )

    if status == st.RUNNING:
        status = st.ITERATION_LIMIT

    # finalize: fresh factorization values for the report
    xn = nonbasic_x()
    x = xn.copy()
    struct_slots = basis < n_pad
    x[basis[struct_slots]] = xB[struct_slots]
    cB = np.where(basis < n_pad, c[np.minimum(basis, n_pad - 1)], 0.0)
    pi = lu.btran(cB)
    k = basis
    art_inf = float(
        np.maximum(
            np.maximum(lb_tot[k] - xB, xB - ub_tot[k]), 0.0
        ).sum()
    )
    return SimpleNamespace(
        x=x,
        status=np.int32(status),
        it=np.int32(it),
        phase=np.int32(2),
        basis=basis.astype(np.int32),
        vstat=vstat.astype(np.int32),
        art_inf=np.float64(art_inf),
        pi=np.asarray(pi),
        obj=np.float64(c @ x),
        art_sign=art_sign,
        trace=np.zeros((0, 8), np.float32),
        viol=np.float64(0.0),
        pivots=pivots,
        bound_flips=flips_total,
    )


def _unit(m: int, r: int) -> np.ndarray:
    e = np.zeros(m)
    e[r] = 1.0
    return e


def triangular_crash(A_csc, cand_cols, n_pad):
    """Build a provably-nonsingular basis from candidate columns.

    Processes ``cand_cols`` in the given priority order and accepts a
    column iff ALL of its nonzero rows are still unassigned (each accepted
    column then introduces only new rows, so with rows ordered by
    assignment the basis is permuted triangular with nonzero diagonal —
    the strict form of Bixby's crash).  Unassigned rows are filled with
    their artificial.  Returns the slot-ordered basis array.
    """
    A_csc = A_csc.tocsc()
    m = A_csc.shape[0]
    assigned = np.zeros(m, bool)
    slots = []
    for j in cand_cols:
        lo, hi = A_csc.indptr[j], A_csc.indptr[j + 1]
        rows = A_csc.indices[lo:hi]
        vals = A_csc.data[lo:hi]
        nz = vals != 0
        rows = rows[nz]
        if rows.size == 0 or assigned[rows].any():
            continue
        pivot_r = rows[np.argmax(np.abs(vals[nz]))]
        assigned[rows] = True  # every touched row is now off-limits
        slots.append((int(pivot_r), int(j)))
    basis = np.empty(m, np.int64)
    used_rows = {r for r, _ in slots}
    free_rows = [r for r in range(m) if r not in used_rows]
    # slot order is arbitrary (the engine refactors immediately); put each
    # accepted column at its pivot row's slot, artificials elsewhere
    for r, j in slots:
        basis[r] = j
    for r in free_rows:
        basis[r] = n_pad + r
    return basis


def reduced_costs(A_csc, c, basis, art_sign, n_pad):
    """One factorization: (d, pi) at a basis, or (None, None) if singular.

    Used to repair arbitrary warm-start statuses into a dual-feasible
    start (nonbasic at the bound matching sign(d_j)) before handing the
    basis to :func:`solve_dual_lu`."""
    A_csc = A_csc.tocsc()
    basis = np.asarray(basis, np.int64)
    B = _basis_matrix(A_csc, basis, np.asarray(art_sign, np.float64), n_pad)
    try:
        lu = splu(B.tocsc(), permc_spec="COLAMD")
    except RuntimeError:
        return None, None
    cB = np.where(basis < n_pad, c[np.minimum(basis, n_pad - 1)], 0.0)
    pi = lu.solve(cB, trans="T")
    d = c - A_csc.T.tocsr() @ pi
    return d, pi


def primal_push(
    A_csc, b, basis, vstat, lb, ub, push_cols, x_push, art_sign, n_pad,
    d=None, eps_piv: float = 1e-9, refactor_every: int = 64, log=None,
):
    """Crossover primal PUSH phase: walk superbasic columns to a bound or
    into the basis while keeping A x = b and basic-bound feasibility.

    The restricted-crossover scheme (driver crossover block) fixes the
    interior columns the triangular crash could not take basic at their
    first-order values; at the restricted optimum those columns are
    *superbasic* for the true problem — a vertex needs each one at a bound
    or basic.  Classic crossover finishes them sequentially: per column,
    one FTRAN + one ratio test, moving it toward its nearest bound (0 for
    free columns — the nonbasic-free convention value) until either it
    arrives (snap nonbasic) or a basic variable blocks (that basic leaves
    at its bound, the pushed column enters).  Reduced costs are ≈0 on the
    optimal face, so the walk leaves the objective unchanged to tolerance;
    the caller's final warm re-solve certifies optimality exactly.

    Returns ``(basis, vstat, pivots)`` or ``None`` on numerical failure.
    """
    m = A_csc.shape[0]
    A_csc = A_csc.tocsc()
    basis = np.asarray(basis, np.int64).copy()
    vstat = np.asarray(vstat, np.int32).copy()
    lb_tot = np.concatenate([lb, np.zeros(m)])
    ub_tot = np.concatenate([ub, np.zeros(m)])

    x_n = np.where(
        (vstat[:n_pad] == st.NB_LOWER) | (vstat[:n_pad] == st.NB_FIXED), lb,
        np.where(vstat[:n_pad] == st.NB_UPPER, ub, 0.0),
    )
    x_n[push_cols] = x_push[push_cols]
    x_n[vstat[:n_pad] == st.BASIC] = 0.0

    lu = _make_lu(_basis_matrix(A_csc, basis, art_sign, n_pad), A_csc)
    xB = lu.ftran(b - A_csc @ x_n)
    pivots = 0
    since = 0
    forced = 0
    period_ = refactor_every
    pending = np.asarray(push_cols, bool).copy()  # walks not yet finished

    def _refresh(j_cur, xj_cur):
        """Refactorize mid-push (drift control / tiny-pivot retries)."""
        nonlocal lu, xB, since
        xn = np.where(
            (vstat[:n_pad] == st.NB_LOWER) | (vstat[:n_pad] == st.NB_FIXED),
            lb, np.where(vstat[:n_pad] == st.NB_UPPER, ub, 0.0),
        )
        xn[pending] = x_push[pending]
        xn[j_cur] = xj_cur
        xn[vstat[:n_pad] == st.BASIC] = 0.0
        lu = _make_lu(_basis_matrix(A_csc, basis, art_sign, n_pad), A_csc)
        xB_new = lu.ftran(b - A_csc @ xn)
        drift = float(np.max(np.abs(xB_new - xB)))
        # adaptive cycle: eta-solve drift beyond tolerance means the ratio
        # tests ran on stale values — shorten the cycle (floor 8)
        nonlocal period_
        if drift > 1e-7 and period_ > 8:
            period_ = max(8, period_ // 2)
        elif drift < 1e-10 and period_ < refactor_every:
            period_ = min(refactor_every, period_ * 2)
        if log and log.isEnabledFor(10):
            viol = float(np.maximum(
                np.maximum(lb_tot[basis] - xB_new, xB_new - ub_tot[basis]),
                0.0,
            ).max())
            if drift > 1e-6:
                slot = int(np.argmax(np.abs(xB_new - xB)))
                log.debug(
                    "push refresh @%d pivots: drift=%.3e viol=%.3e slot=%d "
                    "col=%d walked=%.6e exact=%.6e", pivots, drift, viol,
                    slot, int(basis[slot]), float(xB[slot]),
                    float(xB_new[slot]),
                )
            else:
                log.debug(
                    "push refresh @%d pivots: |xB drift|=%.3e bound_viol=%.3e "
                    "period=%d", pivots, drift, viol, period_,
                )
        xB = xB_new
        since = 0

    # shortest walks first: the tiny dual-snap corrections (≤1e-3) finish
    # while the basis is crisp; the long free-column walks — the ones that
    # pivot and degrade conditioning — run last, bounding how much error
    # the degenerate ejections can compound into later walks
    idxs = np.flatnonzero(push_cols)
    with np.errstate(invalid="ignore"):
        dist = np.minimum(
            np.abs(x_push[idxs] - np.where(np.isfinite(lb[idxs]), lb[idxs], 0.0)),
            np.abs(np.where(np.isfinite(ub[idxs]), ub[idxs], 0.0) - x_push[idxs]),
        )
    for j in idxs[np.argsort(dist, kind="stable")]:
        pending[j] = False  # j's walk happens NOW (mid-walk value below)
        if vstat[j] == st.BASIC:
            continue
        xj = float(x_push[j])
        # direction: the bound the DUAL wants first (d_j > 0 ⇒ lower,
        # d_j < 0 ⇒ upper) — parking on the nearest bound regardless of
        # d-sign builds a dual-inconsistent vertex whose certification
        # re-solve grinds thousands of degenerate pivots (25FV47: 7181);
        # |d_j| ≈ 0 falls back to the nearest bound (cheapest walk)
        want = 0
        if d is not None and abs(float(d[j])) > 1e-9:
            want = 1 if float(d[j]) > 0 else -1
        if want == 1 and np.isfinite(lb[j]):
            tgt = lb[j]
        elif want == -1 and np.isfinite(ub[j]):
            tgt = ub[j]
        elif np.isfinite(lb[j]) and np.isfinite(ub[j]):
            tgt = lb[j] if (xj - lb[j] <= ub[j] - xj) else ub[j]
        elif np.isfinite(lb[j]):
            tgt = lb[j]
        elif np.isfinite(ub[j]):
            tgt = ub[j]
        else:
            tgt = 0.0  # nonbasic FREE sits at 0
        retried = False
        while True:
            delta = tgt - xj
            if delta == 0.0:
                break
            sigma = 1.0 if delta > 0 else -1.0
            a_j = np.asarray(A_csc[:, j].todense()).ravel()
            u = lu.ftran(a_j)
            if not np.all(np.isfinite(u)):
                return None
            su = sigma * u
            lbB = lb_tot[basis]
            ubB = ub_tot[basis]
            with np.errstate(divide="ignore", invalid="ignore"):
                ratio = np.where(
                    su > eps_piv, (xB - lbB) / su,
                    np.where(su < -eps_piv, (xB - ubB) / su, np.inf),
                )
            ratio = np.maximum(ratio, 0.0)
            theta_block = float(ratio.min(initial=np.inf))
            theta_own = abs(delta)
            if theta_own <= theta_block + 1e-12:
                xB = xB - theta_own * su
                break  # arrived at tgt: snap below
            # Harris-lite leaving choice: biggest |pivot| among near-ties
            elig = ratio <= theta_block + 1e-9
            r = int(np.argmax(np.where(elig, np.abs(su), -1.0)))
            if abs(u[r]) <= 1e-6:
                # suspicious pivot on a degenerate tie: eta drift can
                # misjudge a TRUE zero as ~1e-9 and pivot into an exactly
                # singular basis (PILOT87: 1627-pivot push → SuperLU
                # "exactly singular").  Refactorize and retry once; a
                # persistently tiny pivot force-snaps j at its target and
                # leaves the (small, few-column) infeasibility to the
                # certification re-solve's phase 1.
                if not retried:
                    _refresh(j, xj)
                    retried = True
                    continue
                xB = xB - theta_own * su
                forced += 1
                break
            xB = xB - theta_block * su
            xj = xj + sigma * theta_block
            kr = basis[r]
            vstat[kr] = (
                st.NB_FIXED if lb_tot[kr] == ub_tot[kr]
                else (st.NB_LOWER if su[r] > 0 else st.NB_UPPER)
            )
            basis[r] = j
            vstat[j] = st.BASIC
            xB[r] = xj
            rc_up = lu.replace(r, j, u)
            pivots += 1
            since += 1
            # a relatively small accepted pivot makes its eta an error
            # amplifier (÷u[r] per application — PILOT87's degenerate
            # walks drifted 0.4 within 8 etas): refactorize immediately.
            # The FT engine measures this itself (rc_up != 0).
            if rc_up != 0 or since >= period_ or abs(u[r]) < 1e-3 * float(
                np.max(np.abs(u))
            ):
                _refresh(j, xj)
            break  # j entered the basis: its walk is over
        if vstat[j] != st.BASIC:
            vstat[j] = (
                st.NB_LOWER if (np.isfinite(lb[j]) and tgt == lb[j])
                else (st.NB_UPPER if np.isfinite(ub[j]) else st.NB_FREE)
            )
        if log and log.isEnabledFor(5):  # paranoid per-walk exactness
            xn_c = np.where(
                (vstat[:n_pad] == st.NB_LOWER) | (vstat[:n_pad] == st.NB_FIXED),
                lb, np.where(vstat[:n_pad] == st.NB_UPPER, ub, 0.0),
            )
            xn_c[pending] = x_push[pending]
            xn_c[vstat[:n_pad] == st.BASIC] = 0.0
            lu_c = _LuEta(_basis_matrix(A_csc, basis, art_sign, n_pad))
            xB_c = lu_c.ftran(b - A_csc @ xn_c)
            dd = float(np.max(np.abs(xB_c - xB)))
            if dd > 1e-8:
                log.log(
                    5, "walk j=%d tgt=%.6e xj=%.6e vstat=%d pivoted=%s "
                    "drift=%.3e", j, tgt, xj, int(vstat[j]),
                    vstat[j] == st.BASIC, dd,
                )
    if log:
        log.info(
            "crossover push: %d superbasics, %d pivots, %d forced snaps",
            int(push_cols.sum()), pivots, forced,
        )
    return basis, vstat, pivots
