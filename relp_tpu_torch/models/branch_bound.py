"""LP-based branch-and-bound for mixed-integer programs.

Port of ``relp_tpu/models/branch_bound.py``: every node re-solve is a *warm*
device solve — the dual simplex from the parent's basis (bounds changed,
costs untouched ⇒ the parent basis stays dual feasible), the workload of
:func:`relp_tpu_torch.simplex.reoptimize.reoptimize_with_bounds` — so a tree
search runs as a stream of short device solves against one resident dense
operator of the padded problem.

Search: best-first on the LP bound; branching variable: pseudo-cost product
rule or most fractional (``config.mip_branch``).

Root-node **Gomory mixed-integer cuts** (cut-and-branch): GMI cuts are
derived host-side from tableau rows of the optimal basis whose basic
variable is integer and fractional, written into the PADDING rows/columns
of the padded shapes (each cut = one row + one slack column), and the
augmented LP is re-solved warm with the dual simplex (the old basis plus
the new cut slacks stays dual feasible).
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from relp_tpu_torch.model.elements import LinearProgramType, VariableType
from relp_tpu_torch.model.general_form import GeneralForm
from relp_tpu_torch.providers.variable import FeasibilityLogic
from relp_tpu_torch.simplex import status as st
from relp_tpu_torch.simplex.core import solve_core
from relp_tpu_torch.simplex.reoptimize import reoptimize_with_bounds
from relp_tpu_torch.utils.config import DEFAULT_CONFIG, SolverConfig
from relp_tpu_torch.utils.device import DeviceLike, resolve_device

INF = float("inf")


@dataclass
class MipResult:
    kind: LinearProgramType
    objective: Optional[float] = None
    values: Optional[dict] = None           # name -> value (integral snapped)
    nodes: int = 0
    lp_iterations: int = 0
    best_bound: Optional[float] = None      # proven bound on the optimum

    @property
    def is_optimal(self) -> bool:
        return self.kind is LinearProgramType.FINITE_OPTIMUM


def _gomory_cuts(
    A, x, basis, vstat, art_sign, integer_mask, lb, ub,
    n_used, max_cuts,
):
    """Gomory mixed-integer (GMI) cuts from the optimal tableau.

    For each basis row whose basic variable is integer with fractional
    value, shift every nonbasic column to its active bound (t_j = x_j−lb_j
    at lower, ub_j−x_j at upper), apply the GMI formula to
    x_k + Σ ã_j t_j = x̄_k, and un-shift.  Returns (gammas, deltas): cuts
    Σ γ·x ≥ δ over the padded column space.  Conservative acceptance
    (fractionality ≥ 1e-4, bounded dynamic range) keeps float-derived
    cuts safe.
    """
    import scipy.linalg as sla

    m_pad, n_pad = A.shape
    x = np.asarray(x)
    basis = np.asarray(basis, int)
    vs = np.asarray(vstat, int)[:n_pad]

    cand = []
    for i in range(m_pad):
        k = basis[i]
        if k >= n_used or not integer_mask[k]:
            continue
        f0 = x[k] - math.floor(x[k])
        # SAFETY threshold, deliberately looser than the caller's int_tol:
        # float-derived cuts from barely-fractional values are numerically
        # dangerous (the ratio f0/(1-f0) degenerates)
        if f0 < 1e-4 or f0 > 1.0 - 1e-4:
            continue
        cand.append((min(f0, 1.0 - f0), i, k, f0))
    if not cand:
        return [], []
    cand.sort(reverse=True)
    cand = cand[:max_cuts]

    B = np.zeros((m_pad, m_pad))
    for i, kb in enumerate(basis):
        if kb >= n_pad:
            B[kb - n_pad, i] = art_sign[kb - n_pad]
        else:
            B[:, i] = A[:, kb]
    try:
        lu = sla.lu_factor(B)
    except Exception:
        return [], []

    nb_mask = vs != st.BASIC
    at_up = vs == st.NB_UPPER
    at_lo = (vs == st.NB_LOWER) | (vs == st.NB_FIXED)
    free_nb = vs == st.NB_FREE
    act_bound = np.where(at_up, ub, np.where(np.isfinite(lb), lb, 0.0))
    # t_j is integral only when x_j is integer AND its active bound is
    t_int = integer_mask & (
        np.abs(act_bound - np.round(act_bound)) < 1e-9
    )

    gammas, deltas = [], []
    for _, i, k, f0 in cand:
        e = np.zeros(m_pad)
        e[i] = 1.0
        w = sla.lu_solve(lu, e, trans=1)  # Bᵀ w = e_i
        row = w @ A  # tableau row over the padded columns
        # a free nonbasic with a real coefficient has no valid shift
        if np.any(free_nb & nb_mask & (np.abs(row) > 1e-9)):
            continue
        ratio = f0 / (1.0 - f0)
        a_t = np.where(at_up, -row, row)  # shifted coefficient ã_j
        fj = a_t - np.floor(a_t)
        coef_int = np.where(fj <= f0 + 1e-12, fj, ratio * (1.0 - fj))
        coef_cont = np.where(a_t >= 0.0, a_t, -ratio * a_t)
        coef = np.where(t_int, coef_int, coef_cont)
        coef = np.where(nb_mask, coef, 0.0)
        coef[np.abs(coef) < 1e-12] = 0.0
        nz = np.abs(coef[coef != 0.0])
        if nz.size == 0 or nz.max() > 1e7 or nz.max() / nz.min() > 1e8:
            continue  # numerically unsafe cut
        gamma = np.where(at_up, -coef, coef)
        delta = f0 + float(
            np.sum(np.where(at_lo & (coef != 0.0), coef * act_bound, 0.0))
            - np.sum(np.where(at_up & (coef != 0.0), coef * act_bound, 0.0))
        )
        # must actually cut off the current vertex
        if float(gamma @ x) > delta - 1e-6:
            continue
        gammas.append(gamma)
        deltas.append(delta)
    return gammas, deltas


def solve_mip(
    general: GeneralForm,
    config: SolverConfig = DEFAULT_CONFIG,
    max_nodes: int = 2000,
    int_tol: float = 1e-6,
    gap_tol: float = 1e-9,
    cut_rounds: int = 4,
    device: DeviceLike = None,
) -> MipResult:
    """Branch-and-bound on the INTEGER-typed variables of ``general``.

    Scaling is disabled (equilibration would destroy integrality of the
    branching bounds) and presolve is skipped (its continuous reductions —
    slack folds, midpoint fixings — are not valid for integer columns).
    ``device=None`` reads ``RELP_TPU_TORCH_DEVICE`` (default ``"cuda"``);
    the padded A lives there as the dense operator, and the host keeps the
    numpy copy that the cuts are derived from and written into.
    """
    import dataclasses as _dc

    from relp_tpu_torch.model.computational_form import build_computational_form
    from relp_tpu_torch.ops.amatrix import DenseMatrix
    from relp_tpu_torch.simplex.driver import _host, _round_up

    dev = resolve_device(device)
    config = _dc.replace(config, scale=False, presolve=False)

    logic = [
        FeasibilityLogic(v.variable_type, int_tol) for v in general.variables
    ]
    integer_mask_struct = np.array(
        [v.variable_type is VariableType.INTEGER for v in general.variables]
    )

    cf = build_computational_form(general, scale=False)
    m, n = cf.m, cf.n
    if m == 0 or n == 0 or not integer_mask_struct.any():
        # pure LP (or trivial): delegate
        from relp_tpu_torch.simplex.driver import solve_general_form

        res = solve_general_form(general, config, device=dev)
        values = (
            {k: v for k, v in res.solution.solution_values} if res.solution else None
        )
        return MipResult(
            kind=res.kind,
            objective=res.solution.objective_value if res.solution else None,
            values=values,
            nodes=1,
        )

    m_pad = _round_up(m, config.row_align)
    n_pad = _round_up(n, config.col_align)
    import scipy.sparse as sp

    A = np.zeros((m_pad, n_pad))
    A[:m, :n] = sp.csc_matrix(cf.A).toarray()
    b = np.zeros(m_pad)
    b[:m] = cf.b
    c = np.zeros(n_pad)
    c[:n] = cf.c
    lb0 = np.zeros(n_pad)
    ub0 = np.zeros(n_pad)
    lb0[:n] = cf.lb
    ub0[:n] = cf.ub

    integer_mask = np.zeros(n_pad, bool)
    integer_mask[: len(integer_mask_struct)] = integer_mask_struct

    sense = -1.0 if cf.maximize else 1.0  # internal obj is minimization
    max_iter = config.resolve_max_iter(m_pad, n_pad)

    def on_device(M):
        return DenseMatrix(torch.tensor(M, dtype=torch.float64, device=dev))

    def vec(v):
        return torch.tensor(v, dtype=torch.float64, device=dev)

    A_op, c_t = on_device(A), vec(c)
    root = solve_core(A_op, vec(b), c_t, vec(lb0), vec(ub0), config, max_iter)
    lp_iters = int(root.it)
    nodes = 1
    if int(root.status) == st.INFEASIBLE:
        return MipResult(kind=LinearProgramType.INFEASIBLE, nodes=nodes)
    if int(root.status) == st.UNBOUNDED:
        return MipResult(kind=LinearProgramType.UNBOUNDED, nodes=nodes)
    if int(root.status) != st.OPTIMAL:
        # unresolved root (iteration limit / numerical) is NOT a proof
        return MipResult(kind=LinearProgramType.ITERATION_LIMIT, nodes=nodes)

    def fractional(x):
        xi = x[:n][integer_mask[:n]]
        idxs = np.flatnonzero(integer_mask[:n])
        fr = np.abs(xi - np.round(xi))
        bad = fr > int_tol * (1 + np.abs(xi))
        return idxs[bad], fr[bad]

    # --- root-node Gomory cut rounds (cut-and-branch) -------------------
    # each cut occupies one padding row (the cut) and one padding column
    # (its surplus slack: γᵀx − s = δ, s ≥ 0); the prior basis plus the
    # new slack basic in the new row stays dual feasible, so each round
    # is one warm dual-simplex call against the same compiled shapes
    from relp_tpu_torch.simplex.dual import solve_core_dual

    m_used, n_used = m, n
    for _ in range(max(0, cut_rounds)):
        if m_used >= m_pad or n_used >= n_pad:
            break
        x_r = _host(root.x)
        bad_r, _ = fractional(x_r)
        if len(bad_r) == 0:
            break
        space = min(m_pad - m_used, n_pad - n_used, 16)
        gammas, deltas = _gomory_cuts(
            A, x_r, _host(root.basis), _host(root.vstat), _host(root.art_sign),
            integer_mask, lb0, ub0, n_used, space,
        )
        if not gammas:
            break
        A2, b2 = A.copy(), b.copy()
        lb2, ub2 = lb0.copy(), ub0.copy()
        basis2 = _host(root.basis).copy()
        vstat2 = _host(root.vstat).copy()
        for t, (g, d) in enumerate(zip(gammas, deltas)):
            r, js = m_used + t, n_used + t
            A2[r, :] = g
            A2[r, js] = -1.0
            b2[r] = d
            lb2[js], ub2[js] = 0.0, INF
            basis2[r] = js
            vstat2[js] = st.BASIC
        A2_op = on_device(A2)
        out = solve_core_dual(
            A2_op, b2, c_t, lb2, ub2, basis2, vstat2[:n_pad],
            cfg=config, max_iter=max_iter, art_sign0=root.art_sign,
        )
        lp_iters += int(out.it)
        # cuts only RAISE the LP minimum; anything else is numerical —
        # discard the round and branch from the last good state
        if int(out.status) != st.OPTIMAL or float(out.obj) < float(
            root.obj
        ) - 1e-6 * (1.0 + abs(float(root.obj))):
            break
        A, A_op, b, lb0, ub0 = A2, A2_op, b2, lb2, ub2
        m_used += len(gammas)
        n_used += len(gammas)
        root = out

    best_obj = INF  # internal (minimization) objective
    best_x: Optional[np.ndarray] = None
    complete = True  # every pruned branch was proved (not just dropped)

    # --- pseudo-cost branching (Achterberg's product rule) --------------
    # per-variable, per-direction average LP-bound degradation per unit of
    # fractional distance, learned from every solved child; a side with no
    # observations borrows the global average, and a fully-uninitialized
    # candidate is explored first.  config.mip_branch="fractional" keeps
    # the round-2 most-fractional rule.
    pc_sum: dict = {}   # (j, dir) -> summed degradation per unit distance
    pc_cnt: dict = {}   # (j, dir) -> observation count

    def _pc_avg(j: int, d: int):
        k = (j, d)
        if pc_cnt.get(k, 0) > 0:
            return pc_sum[k] / pc_cnt[k]
        n_obs = sum(pc_cnt.values())
        return (sum(pc_sum.values()) / n_obs) if n_obs else None

    def _select_branch(bad, fr, x):
        if config.mip_branch != "pseudo":
            return int(bad[np.argmax(np.minimum(fr, 1 - fr))])
        scores = []
        for jj in bad:
            vj = float(x[int(jj)])
            fj = vj - math.floor(vj)
            dn, up = _pc_avg(int(jj), 0), _pc_avg(int(jj), 1)
            if dn is None and up is None:
                scores.append(None)  # uninitialized: explore first
                continue
            dn = dn if dn is not None else up
            up = up if up is not None else dn
            scores.append(max(dn * fj, 1e-12) * max(up * (1.0 - fj), 1e-12))
        if all(s is None for s in scores):
            return int(bad[np.argmax(np.minimum(fr, 1 - fr))])
        mx = max(s for s in scores if s is not None)
        scores = [s if s is not None else mx * (1.0 + 1e-6) for s in scores]
        return int(bad[int(np.argmax(scores))])

    # best-first heap: (lp bound, tiebreak, lb, ub, prior SolveOutput)
    tick = 0
    heap: List[Tuple[float, int, np.ndarray, np.ndarray, object]] = []

    def push(bound, lb, ub, prior):
        nonlocal tick
        tick += 1
        heapq.heappush(heap, (bound, tick, lb, ub, prior))

    b_t = vec(b)
    push(float(root.obj), lb0, ub0, root)

    while heap and nodes < max_nodes:
        bound, _, lb_nd, ub_nd, prior = heapq.heappop(heap)
        if bound >= best_obj - gap_tol:
            continue  # pruned by bound
        x = _host(prior.x)
        bad, fr = fractional(x)
        if len(bad) == 0:
            if float(prior.obj) < best_obj:
                best_obj = float(prior.obj)
                best_x = x.copy()
            continue
        j = _select_branch(bad, fr, x)
        v = x[j]
        for lo_add, hi_add in (
            (None, math.floor(v)),  # x_j <= floor(v)
            (math.ceil(v), None),   # x_j >= ceil(v)
        ):
            lb2, ub2 = lb_nd.copy(), ub_nd.copy()
            if hi_add is not None:
                ub2[j] = min(ub2[j], hi_add)
            if lo_add is not None:
                lb2[j] = max(lb2[j], lo_add)
            if lb2[j] > ub2[j]:
                continue
            out = reoptimize_with_bounds(
                A_op, b_t, c_t, lb2, ub2, prior, config=config, max_iter=max_iter
            )
            nodes += 1
            lp_iters += int(out.it)
            if int(out.status) != st.OPTIMAL:
                if int(out.status) != st.INFEASIBLE:
                    complete = False  # unresolved child: no infeas. proof
                continue
            child_bound = float(out.obj)
            # pseudo-cost update: observed degradation per unit distance
            # (down branch distance f_j, up branch 1−f_j)
            dist = (
                v - math.floor(v) if hi_add is not None else math.ceil(v) - v
            )
            if dist > 1e-9:
                k = (j, 0 if hi_add is not None else 1)
                pc_sum[k] = pc_sum.get(k, 0.0) + max(
                    child_bound - bound, 0.0
                ) / dist
                pc_cnt[k] = pc_cnt.get(k, 0) + 1
            if child_bound >= best_obj - gap_tol:
                continue
            xc = _host(out.x)
            bad_c, _ = fractional(xc)
            if len(bad_c) == 0:
                if child_bound < best_obj:
                    best_obj = child_bound
                    best_x = xc.copy()
            else:
                push(child_bound, lb2, ub2, out)

    if best_x is None:
        # INFEASIBLE only when the search tree was exhausted with every
        # branch resolved; a node/LP-budget stop without an incumbent is
        # an unresolved ITERATION_LIMIT, not a proof
        # 'not heap and complete' IS exhaustion — a tree that empties
        # exactly as nodes reaches max_nodes is still a proof
        proved = complete and not heap
        return MipResult(
            kind=(
                LinearProgramType.INFEASIBLE
                if proved
                else LinearProgramType.ITERATION_LIMIT
            ),
            nodes=nodes,
            lp_iterations=lp_iters,
        )

    # remaining open bound (for gap reporting)
    open_bound = min([h[0] for h in heap], default=best_obj)
    values = {}
    for jj, var in enumerate(general.variables):
        vv = float(best_x[jj])
        values[var.name] = logic[jj].closest_feasible(vv) if logic[jj].is_feasible(
            vv
        ) else vv
    # objective in the problem's own sense, from integral-snapped values
    orig_cost = np.array([v.cost for v in general.variables])
    obj = float(
        orig_cost @ np.array([values[v.name] for v in general.variables])
    ) + cf.fixed_cost
    # proven bound on the optimum, reported in the problem's own sense
    internal_bound = min(best_obj, open_bound)
    bound_orig = (
        -internal_bound if cf.maximize else internal_bound
    ) + cf.fixed_cost
    return MipResult(
        kind=LinearProgramType.FINITE_OPTIMUM,
        objective=obj,
        values=values,
        nodes=nodes,
        lp_iterations=lp_iters,
        best_bound=bound_orig,
    )
