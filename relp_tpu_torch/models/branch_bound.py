"""LP-based branch-and-bound for mixed-integer programs.

Port of ``relp_tpu/models/branch_bound.py``: every node re-solve is a *warm*
device solve — the dual simplex from the parent's basis (bounds changed,
costs untouched ⇒ the parent basis stays dual feasible), the workload of
:func:`relp_tpu_torch.simplex.reoptimize.reoptimize_with_bounds` — so a tree
search runs as a stream of short device solves against one resident dense
operator of the padded problem.

The root LP is solved cold by the device dual under ``config.algorithm ==
"dual"`` (the driver's cold dual start, then ``solve_core_dual``: on a CUDA
device a replay of the step's graph an iteration), else by the primal core.
Under ``"dual"`` a child whose dual re-solve proves it infeasible is pruned
on that proof (``trust_infeasible``); otherwise the re-solve's warm primal
fallback decides it, as in the JAX package.
Search: best-first on the LP bound; branching variable: pseudo-cost product
rule or most fractional (``config.mip_branch``).

Root-node **Gomory mixed-integer cuts** (cut-and-branch): the tableau rows
of the optimal basis whose basic variable is integer and fractional come
from one LU of the basis on the device (:func:`device_tableau_rows`); the
GMI arithmetic of each cut runs on the host.  Cuts are written into
padding rows/columns that the padded shapes keep for them (``CUT_ROOM`` a
round; each cut = one row + one slack column), and the augmented LP is
re-solved warm with the dual simplex (the old basis plus the new cut slacks
stays dual feasible).  Each round's operator is a new one: on a CUDA device
its re-solve captures that operator's step graph anew.

A proven optimum carries its :class:`MipCertificate`: the incumbent node's
LP (bounds, cuts) with its vertex and row duals.  One ``SolveMetrics``
record (call ``"mip"``) counts the search; each node's re-solve emits a
``reoptimize`` record whose ``parent`` is its ``solve_id``.  Spans (on
while a profiler records): ``mip.solve``; in it ``mip.root``, ``mip.cuts``
(a round's derivation and re-solve), ``mip.node`` (a child's re-solve and
its host copies) and ``mip.tree`` (the heap, branching and pseudo-costs
between re-solves).
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
from relp_tpu_torch.utils.metrics import Timer, last_closed, recording, span

INF = float("inf")
CUT_ROOM = 16  # the most cuts a round adds: rows and columns the padding keeps for each round


@dataclass
class MipCertificate:
    """The LP of the incumbent's node, at which the incumbent is a vertex
    optimum: the padded problem's rows (the computational form's, then the
    cuts in force) under the node's bounds, in the internal minimisation.
    Cut ``t`` is row ``cut_rows[t]``: ``γ_t·x − x[cut_cols[t]] = δ_t`` with
    its surplus column in ``[0, ∞)``; users read ``pi`` as the fixed-MIP
    duals."""

    lb: np.ndarray          # [n_pad] the node's bounds (branching bounds, cut surpluses)
    ub: np.ndarray          # [n_pad]
    cut_rows: np.ndarray    # [K] each cut's row of the padded operator
    cut_cols: np.ndarray    # [K] its surplus column
    gammas: np.ndarray      # [K, n_pad] γ of each cut (without its surplus)
    deltas: np.ndarray      # [K]
    x: np.ndarray           # [n_pad] the node's vertex
    pi: np.ndarray          # [m_pad] its row duals, cut rows included
    objective: float        # c·x of the minimisation (padded c)


@dataclass
class MipResult:
    kind: LinearProgramType
    objective: Optional[float] = None
    values: Optional[dict] = None           # name -> value (integral snapped)
    nodes: int = 0
    lp_iterations: int = 0
    best_bound: Optional[float] = None      # proven bound on the optimum
    # a proven optimum's incumbent node LP (None otherwise)
    certificate: Optional[MipCertificate] = None

    @property
    def is_optimal(self) -> bool:
        return self.kind is LinearProgramType.FINITE_OPTIMUM


def _gmi_candidates(x, basis, integer_mask, n_used, max_cuts):
    """The rows of the basis whose basic variable is integer and fractional
    enough for a safe cut, the most fractional first: ``(f, i, k, f0)``."""
    cand = []
    for i in range(len(basis)):
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
    cand.sort(reverse=True)
    return cand[:max_cuts]


def _host_tableau_rows(A, basis, art_sign, rows):
    """Rows ``rows`` of B⁻¹A over the padded columns, by SciPy's LU of the
    dense basis on the host (one solve and one product per row), or None
    where the LU fails."""
    import scipy.linalg as sla

    m_pad, n_pad = A.shape
    B = np.zeros((m_pad, m_pad))
    for i, kb in enumerate(basis):
        if kb >= n_pad:
            B[kb - n_pad, i] = art_sign[kb - n_pad]
        else:
            B[:, i] = A[:, kb]
    try:
        lu = sla.lu_factor(B)
    except Exception:
        return None
    out = []
    for i in rows:
        e = np.zeros(m_pad)
        e[i] = 1.0
        w = sla.lu_solve(lu, e, trans=1)  # Bᵀ w = e_i
        out.append(w @ A)
    return out


def device_tableau_rows(A_op, basis, art_sign, rows):
    """Rows ``rows`` of B⁻¹A over the padded columns of the operator
    ``A_op`` (ops/amatrix.py), on its device: the basis matrix from the
    operator's columns, one ``torch.linalg.lu_factor`` of it, one
    ``lu_solve`` of Bᵀ·W = [e_i …] for every row at once and one product
    with A.  A ``[len(rows), n_pad]`` numpy array, or None where B is
    singular (one host read besides the rows' copy)."""
    from relp_tpu_torch.simplex.dual import _basis_matrix, _tensor

    dev = A_op.device
    basis, art_sign = _tensor(basis, torch.int64, dev), _tensor(art_sign, torch.float64, dev)
    B, _ = _basis_matrix(A_op, basis, art_sign)
    LU, piv, info = torch.linalg.lu_factor_ex(B)
    m = B.shape[0]
    E = torch.zeros((m, len(rows)), dtype=torch.float64, device=dev)
    E[torch.as_tensor(list(rows), device=dev), torch.arange(len(rows), device=dev)] = 1.0
    W = torch.linalg.lu_solve(LU, piv, E, adjoint=True)
    R = W.T @ A_op.A
    if int(info) != 0:
        return None
    return R.cpu().numpy()


def _gmi_cut(row, f0, x, at_up, at_lo, free_nb, nb_mask, act_bound, t_int):
    """The GMI cut of one tableau row, ``(γ, δ)`` with ``γ·x ≥ δ``, or None
    where it is unsafe or does not cut off ``x``."""
    # a free nonbasic with a real coefficient has no valid shift
    if np.any(free_nb & nb_mask & (np.abs(row) > 1e-9)):
        return None
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
        return None  # numerically unsafe cut
    gamma = np.where(at_up, -coef, coef)
    delta = f0 + float(
        np.sum(np.where(at_lo & (coef != 0.0), coef * act_bound, 0.0))
        - np.sum(np.where(at_up & (coef != 0.0), coef * act_bound, 0.0))
    )
    # must actually cut off the current vertex
    if float(gamma @ x) > delta - 1e-6:
        return None
    return gamma, delta


def _gomory_cuts(
    A, x, basis, vstat, art_sign, integer_mask, lb, ub,
    n_used, max_cuts, tableau_rows=None,
):
    """Gomory mixed-integer (GMI) cuts from the optimal tableau.

    For each basis row whose basic variable is integer with fractional
    value, shift every nonbasic column to its active bound (t_j = x_j−lb_j
    at lower, ub_j−x_j at upper), apply the GMI formula to
    x_k + Σ ã_j t_j = x̄_k, and un-shift.  Returns (gammas, deltas): cuts
    Σ γ·x ≥ δ over the padded column space.  Conservative acceptance
    (fractionality ≥ 1e-4, bounded dynamic range) keeps float-derived
    cuts safe.  ``tableau_rows(rows)`` gives the tableau rows of the
    candidates (None: no cut); by default SciPy's LU of the basis on the
    host, from ``A`` (:func:`device_tableau_rows` computes them on the
    device; then only ``A.shape`` is read, and ``A`` may be an operator).
    """
    m_pad, n_pad = A.shape
    x = np.asarray(x)
    basis = np.asarray(basis, int)
    vs = np.asarray(vstat, int)[:n_pad]

    cand = _gmi_candidates(x, basis, integer_mask, n_used, max_cuts)
    if not cand:
        return [], []
    rows = [i for _, i, _, _ in cand]
    if tableau_rows is None:
        tab = _host_tableau_rows(A, basis, art_sign, rows)
    else:
        tab = tableau_rows(rows)
    if tab is None:
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
    for (_, _, _, f0), row in zip(cand, tab):
        cut = _gmi_cut(np.asarray(row), f0, x, at_up, at_lo, free_nb, nb_mask, act_bound, t_int)
        if cut is not None:
            gammas.append(cut[0])
            deltas.append(cut[1])
    return gammas, deltas


def _root_solve(matvec, A_op, b, c, lb, ub, config, max_iter):
    """The root LP: under ``config.algorithm == "dual"`` the device dual from
    the driver's cold start (``driver.dual_cold_start``, ``matvec`` its A·v
    on the host; its temporary box verified inactive), the primal core from
    scratch where that cannot certify an optimum; otherwise the primal core.
    ``(output, engine, iterations)``."""
    from relp_tpu_torch.simplex.dual import solve_core_dual
    from relp_tpu_torch.simplex.driver import _host, dual_cold_start

    its = 0
    if config.algorithm == "dual":
        box = float(config.dual_box)
        lb_d, ub_d, warm, need_low, need_up = dual_cold_start(
            b, c, lb, ub, matvec, box)
        out = solve_core_dual(A_op, b, c, lb_d, ub_d, cfg=config, max_iter=max_iter, **warm)
        its = int(out.it)
        if int(out.status) == st.OPTIMAL:
            x = _host(out.x)
            if not np.any((need_low & (x <= -0.5 * box)) | (need_up & (x >= 0.5 * box))):
                return out, "dual", its
    b_t, c_t, lb_t, ub_t = (torch.tensor(v, dtype=torch.float64, device=A_op.device)
                            for v in (b, c, lb, ub))
    out = solve_core(A_op, b_t, c_t, lb_t, ub_t, config, max_iter)
    return out, ("dual→primal" if config.algorithm == "dual" else "primal"), its + int(out.it)


def _certificate(out, lb, ub, cuts, m_used0, n_used0) -> MipCertificate:
    """The incumbent node's LP and its solution on the host."""
    from relp_tpu_torch.simplex.driver import _host

    k = len(cuts)
    n_pad = len(lb)
    return MipCertificate(
        lb=np.asarray(lb, np.float64).copy(), ub=np.asarray(ub, np.float64).copy(),
        cut_rows=m_used0 + np.arange(k), cut_cols=n_used0 + np.arange(k),
        gammas=(np.array([g for g, _ in cuts]) if k else np.zeros((0, n_pad))),
        deltas=np.array([d for _, d in cuts], np.float64),
        x=_host(out.x).astype(np.float64), pi=_host(out.pi).astype(np.float64),
        objective=float(out.obj))


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
    the padded A is written there from the sparse form as the dense
    operator, and each cut round writes its rows into a copy of it there.
    ``config.algorithm == "dual"`` solves the root by the device dual, any
    other the primal core.
    The padded shapes keep room for ``CUT_ROOM`` cuts a round for
    ``cut_rounds`` rounds, rows and columns.  Emits one ``SolveMetrics``
    record (call ``"mip"``), whose ``engine`` names the root's engine.
    """
    with recording("mip") as rec, Timer() as t, span("mip.solve"):
        res = _solve_mip(general, config, max_nodes, int_tol, gap_tol, cut_rounds, device, rec)
        rec.nodes, rec.lp_iterations = res.nodes, res.lp_iterations
    rec.wall_s = t.elapsed
    rec.status = res.kind.value
    rec.emit()
    return res


def _solve_mip(general, config, max_nodes, int_tol, gap_tol, cut_rounds, device, rec):
    import dataclasses as _dc

    from relp_tpu_torch.model.computational_form import build_computational_form
    from relp_tpu_torch.ops.amatrix import DenseMatrix
    from relp_tpu_torch.simplex.driver import _host, _round_up

    dev = resolve_device(device)
    config = _dc.replace(config, scale=False, presolve=False)
    rec.device = str(dev)

    logic = [
        FeasibilityLogic(v.variable_type, int_tol) for v in general.variables
    ]
    integer_mask_struct = np.array(
        [v.variable_type is VariableType.INTEGER for v in general.variables]
    )

    cf = build_computational_form(general, scale=False)
    m, n = cf.m, cf.n
    rec.m, rec.n = m, n
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

    room = CUT_ROOM * max(0, cut_rounds)
    m_pad = _round_up(m + room, config.row_align)
    n_pad = _round_up(n + room, config.col_align)
    rec.m_padded, rec.n_padded, rec.matrix_format = m_pad, n_pad, DenseMatrix.format
    import scipy.sparse as sp

    # the dense operator is written on the device from the sparse form: no
    # dense copy of A on the host, none sent over
    S = sp.coo_matrix(cf.A)
    S.sum_duplicates()
    A_t = torch.zeros((m_pad, n_pad), dtype=torch.float64, device=dev)
    A_t[torch.as_tensor(S.row, device=dev), torch.as_tensor(S.col, device=dev)] = \
        torch.as_tensor(S.data, dtype=torch.float64, device=dev)
    S = S.tocsr()

    def matvec(v):  # A·v over the padded rows, on the host
        out = np.zeros(m_pad)
        out[:m] = S @ v[:n]
        return out

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

    max_iter = config.resolve_max_iter(m_pad, n_pad)

    def vec(v):
        return torch.tensor(v, dtype=torch.float64, device=dev)

    A_op, c_t = DenseMatrix(A_t), vec(c)
    with span("mip.root"):
        root, rec.engine, lp_iters = _root_solve(matvec, A_op, b, c, lb0, ub0, config, max_iter)
        root_status = int(root.status)
    rec.iterations += lp_iters
    nodes = 1
    if root_status == st.INFEASIBLE:
        return MipResult(kind=LinearProgramType.INFEASIBLE, nodes=nodes)
    if root_status == st.UNBOUNDED:
        return MipResult(kind=LinearProgramType.UNBOUNDED, nodes=nodes)
    if root_status != st.OPTIMAL:
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
    # is one warm dual-simplex call.  A round's tableau rows come from one
    # LU of its basis on the device; its operator is a new one, whose step
    # graph the re-solve captures anew on a CUDA device
    from relp_tpu_torch.simplex.dual import solve_core_dual

    m_used, n_used = m, n
    cuts: list = []  # (γ, δ) of every cut in force, in row order
    for _ in range(max(0, cut_rounds)):
        if m_used >= m_pad or n_used >= n_pad:
            break
        x_r = _host(root.x)
        bad_r, _ = fractional(x_r)
        if len(bad_r) == 0:
            break
        with span("mip.cuts"):
            rec.cut_rounds += 1
            space = min(m_pad - m_used, n_pad - n_used, CUT_ROOM)
            basis_r, art_r = root.basis, root.art_sign
            gammas, deltas = _gomory_cuts(
                A_op, x_r, _host(root.basis), _host(root.vstat), _host(root.art_sign),
                integer_mask, lb0, ub0, n_used, space,
                tableau_rows=lambda rows: device_tableau_rows(A_op, basis_r, art_r, rows),
            )
            if not gammas:
                break
            new_rows = np.zeros((len(gammas), n_pad))  # the round's rows of A
            b2 = b.copy()
            lb2, ub2 = lb0.copy(), ub0.copy()
            basis2 = _host(root.basis).copy()
            vstat2 = _host(root.vstat).copy()
            for t, (g, d) in enumerate(zip(gammas, deltas)):
                r, js = m_used + t, n_used + t
                new_rows[t] = g
                new_rows[t, js] = -1.0
                b2[r] = d
                lb2[js], ub2[js] = 0.0, INF
                basis2[r] = js
                vstat2[js] = st.BASIC
            A2 = A_op.A.clone()
            A2[m_used:m_used + len(gammas)] = torch.as_tensor(new_rows, device=dev)
            A2_op = DenseMatrix(A2)
            out = solve_core_dual(
                A2_op, b2, c_t, lb2, ub2, basis2, vstat2[:n_pad],
                cfg=config, max_iter=max_iter, art_sign0=root.art_sign,
            )
            status, its, obj = int(out.status), int(out.it), float(out.obj)
        lp_iters += its
        rec.iterations += its
        # cuts only RAISE the LP minimum; anything else is numerical —
        # discard the round and branch from the last good state
        if status != st.OPTIMAL or obj < float(
            root.obj
        ) - 1e-6 * (1.0 + abs(float(root.obj))):
            break
        A_op, b, lb0, ub0 = A2_op, b2, lb2, ub2
        cuts += list(zip(gammas, deltas))
        m_used += len(gammas)
        n_used += len(gammas)
        root = out
    rec.cuts = len(cuts)

    best_obj = INF  # internal (minimization) objective
    best_x: Optional[np.ndarray] = None
    best_at = None  # the incumbent's (output, lb, ub)
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
        with span("mip.tree"):
            bound, _, lb_nd, ub_nd, prior = heapq.heappop(heap)
            if bound >= best_obj - gap_tol:
                rec.pruned += 1
                continue  # pruned by bound
            x = _host(prior.x)
            bad, fr = fractional(x)
            if len(bad) == 0:
                if float(prior.obj) < best_obj:
                    best_obj = float(prior.obj)
                    best_x = x.copy()
                    best_at = (prior, lb_nd, ub_nd)
                    rec.incumbents += 1
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
            with span("mip.node"):
                out = reoptimize_with_bounds(
                    A_op, b_t, c_t, lb2, ub2, prior, config=config, max_iter=max_iter,
                    trust_infeasible=config.algorithm == "dual",
                )
                status, its, child_bound = int(out.status), int(out.it), float(out.obj)
                xc = _host(out.x) if status == st.OPTIMAL else None
            rec.node_start_misses += _start_missed()
            nodes += 1
            lp_iters += its
            with span("mip.tree"):
                if status != st.OPTIMAL:
                    if status != st.INFEASIBLE:
                        complete = False  # unresolved child: no infeas. proof
                    continue
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
                    rec.pruned += 1
                    continue
                bad_c, _ = fractional(xc)
                if len(bad_c) == 0:
                    if child_bound < best_obj:
                        best_obj = child_bound
                        best_x = xc.copy()
                        best_at = (out, lb2, ub2)
                        rec.incumbents += 1
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
    out_b, lb_b, ub_b = best_at
    return MipResult(
        kind=LinearProgramType.FINITE_OPTIMUM,
        objective=obj,
        values=values,
        nodes=nodes,
        lp_iterations=lp_iters,
        best_bound=bound_orig,
        certificate=_certificate(out_b, lb_b, ub_b, cuts, m, n),
    )


def _start_missed() -> int:
    """1 where the node re-solve just made on this thread (the record it
    closed) found no kept B⁻¹."""
    return int(last_closed().start_inverse_hits == 0)
