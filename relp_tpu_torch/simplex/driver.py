"""Host driver of the primal engine: pad, pick the operator, solve, map back.

Port of the primal branch of ``relp_tpu/simplex/driver.py``: a computational
form is padded (``row_align``/``col_align``, as the JAX package pads with
``bucket_shapes=False``), its constraint matrix goes to the device as a
dense, ELL or hybrid operator (``_device_matrix``), the core solves it from
the cold, slack-crash or caller's warm start in one call (no chunking: the
card has no execution watchdog), and the result is unscaled into a named
``Solution``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import scipy.sparse as sp
import torch

from relp_tpu_torch.model.computational_form import ComputationalForm
from relp_tpu_torch.model.elements import LinearProgramType
from relp_tpu_torch.model.general_form import GeneralForm
from relp_tpu_torch.model.solution import Solution
from relp_tpu_torch.ops.amatrix import DenseMatrix, ell_from_csc, hybrid_from_csc
from relp_tpu_torch.simplex import status as st
from relp_tpu_torch.simplex.core import solve_core
from relp_tpu_torch.utils.config import DEFAULT_CONFIG, SolverConfig
from relp_tpu_torch.utils.device import DeviceLike, resolve_device
from relp_tpu_torch.utils.metrics import SolveMetrics, Timer


@dataclass
class SimplexResult:
    kind: LinearProgramType
    objective: Optional[float] = None
    x_structural: Optional[np.ndarray] = None  # original units, structural columns
    iterations: int = 0
    art_residual: float = 0.0
    metrics: Optional[SolveMetrics] = None
    duals: Optional[np.ndarray] = None  # row duals in ORIGINAL row units
    # final basis state (padded space; None when the engine never ran)
    basis: Optional[np.ndarray] = None     # i32[m_pad] basis columns
    vstat: Optional[np.ndarray] = None     # i32[n_pad+m_pad] statuses
    art_sign: Optional[np.ndarray] = None  # f64[m_pad] artificial signs

    @property
    def is_optimal(self) -> bool:
        return self.kind is LinearProgramType.FINITE_OPTIMUM


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult if x > 0 else mult


def _device_matrix(cf: ComputationalForm, m_pad: int, n_pad: int,
                   config: SolverConfig, device: torch.device):
    """Choose and build the device operator of A.

    "auto" picks ELL when the problem is large (m_pad >= 1024) and its
    longest column is short (K·8 <= m_pad), dense otherwise — the JAX
    package's CPU rule, used here on every device.  ELL with at most 64
    very long ("spill") columns becomes hybrid.  ELL pads carry the true
    per-column / per-row maxima.
    """
    csc = sp.csc_matrix(cf.A)
    fmt = config.matrix_format
    counts = np.diff(csc.indptr)
    k_true = int(counts.max()) if counts.size else 1
    spill_thresh = max(64, m_pad // 32)
    n_spill = int((counts > spill_thresh).sum()) if counts.size else 0
    if fmt == "auto":
        fmt = "ell" if (m_pad >= 1024 and k_true * 8 <= m_pad) else "dense"
    if fmt == "ell" and 0 < n_spill <= 64:
        fmt = "hybrid"
    if fmt == "hybrid":
        sparse_counts = counts[counts <= spill_thresh]
        k_sparse = int(sparse_counts.max()) if sparse_counts.size else 1
        return hybrid_from_csc(csc, m_pad, n_pad, max(k_sparse, 1),
                               max(n_spill, 1), device=device), "hybrid"
    if fmt == "ell":
        return ell_from_csc(csc, m_pad, n_pad, device=device), "ell"
    A = np.zeros((m_pad, n_pad), dtype=np.float64)
    A[: cf.m, : cf.n] = csc.toarray()
    return DenseMatrix(torch.from_numpy(A).to(device)), "dense"


def _cold_vstat(lb, ub):
    return np.where(
        lb == ub, st.NB_FIXED,
        np.where(np.isfinite(lb), st.NB_LOWER,
                 np.where(np.isfinite(ub), st.NB_UPPER, st.NB_FREE)),
    ).astype(np.int32)


def solve_computational_form(
    cf: ComputationalForm,
    config: SolverConfig = DEFAULT_CONFIG,
    warm_start_builder=None,
    device: DeviceLike = None,
) -> SimplexResult:
    """``warm_start_builder(m_pad, n_pad) -> (basis0, vstat0)`` optionally
    provides an initial basis."""
    dev = resolve_device(device)
    m, n = cf.m, cf.n

    if np.any(cf.lb > cf.ub):
        return SimplexResult(kind=LinearProgramType.INFEASIBLE)
    if m == 0 or n == 0:
        return _solve_trivial(cf)

    m_pad = _round_up(m, config.row_align)
    n_pad = _round_up(n, config.col_align)
    b = np.zeros(m_pad)
    b[:m] = cf.b
    c = np.zeros(n_pad)
    c[:n] = cf.c
    lb = np.zeros(n_pad)
    ub = np.zeros(n_pad)  # padded columns fixed at 0
    lb[:n] = cf.lb
    ub[:n] = cf.ub
    max_iter = config.resolve_max_iter(m, n)

    # mixed-precision pricing only pays once the pricing product is large;
    # for small problems the extra casts and the confirmation outweigh it
    if config.mixed_pricing and m_pad * n_pad < 1 << 17:
        config = dataclasses.replace(config, mixed_pricing=False)

    A_csc = sp.csc_matrix(cf.A)

    def host_art_sign(vstat0):
        """Artificial signs from the residual at the nonbasic point."""
        at_lower = (vstat0 == st.NB_LOWER) | (vstat0 == st.NB_FIXED)
        x0 = np.where(at_lower, lb, np.where(vstat0 == st.NB_UPPER, ub, 0.0))
        x0 = np.where(vstat0 == st.BASIC, 0.0, x0)
        r0 = b.copy()
        r0[:m] -= np.asarray(A_csc @ x0[:n])
        return np.where(r0 >= 0, 1.0, -1.0)

    if warm_start_builder is not None:
        basis0, vstat0 = warm_start_builder(m_pad, n_pad)
        vstat0 = np.asarray(vstat0, np.int64)
        warm = dict(basis0=np.asarray(basis0, np.int64), vstat0=vstat0,
                    art_sign0=host_art_sign(vstat0), phase0=1)
    elif config.crash_basis and len(cf.slack_rows):
        slack_of_row = np.full(m_pad, -1, np.int64)
        slack_of_row[cf.slack_rows] = cf.n_structural + np.arange(len(cf.slack_rows))
        warm = dict(slack_of_row=slack_of_row)
    else:
        # the cold start goes through the warm-start path, as the JAX driver
        # sends it: all-artificial basis, refactorized first
        vstat_cold = _cold_vstat(lb, ub).astype(np.int64)
        warm = dict(basis0=n_pad + np.arange(m_pad), vstat0=vstat_cold,
                    art_sign0=host_art_sign(vstat_cold), phase0=1)

    A, fmt = _device_matrix(cf, m_pad, n_pad, config, dev)
    f64 = dict(dtype=torch.float64, device=dev)
    b_t, c_t, lb_t, ub_t = (torch.as_tensor(v, **f64) for v in (b, c, lb, ub))
    warm_t = {
        k: (v if k == "phase0" else torch.as_tensor(v, device=dev))
        for k, v in warm.items()
    }
    with Timer() as t:
        out = solve_core(A, b_t, c_t, lb_t, ub_t, config, max_iter, **warm_t)
        status = int(out.status)
        iterations = int(out.it)
        x = out.x.cpu().numpy()

    kind = st.STATUS_TO_TYPE[status]
    metrics = SolveMetrics(
        status=kind.value, iterations=iterations, wall_s=t.elapsed, m=m, n=n,
        m_padded=m_pad, n_padded=n_pad, art_residual=float(out.art_inf),
        phase=int(out.phase), nnz=int(A_csc.nnz), matrix_format=fmt,
        device=str(dev), host_reads=out.host_reads,
    )
    metrics.emit()
    # duals in original row units (y_orig = y_scaled · r_i); a maximization
    # flips the internal sign
    sense = -1.0 if cf.maximize else 1.0
    result = SimplexResult(
        kind=kind,
        iterations=iterations,
        art_residual=float(out.art_inf),
        metrics=metrics,
        duals=sense * out.pi.cpu().numpy()[:m] * cf.row_scale,
        basis=out.basis.cpu().numpy().astype(np.int32),
        vstat=out.vstat.cpu().numpy().astype(np.int32),
        art_sign=out.art_sign.cpu().numpy(),
    )
    if kind is LinearProgramType.FINITE_OPTIMUM:
        result.objective = cf.objective_of(x[:n])
        result.x_structural = cf.structural_values(x[:n])
    return result


def _solve_trivial(cf: ComputationalForm) -> SimplexResult:
    """LPs with no constraints (bounds only) or no columns."""
    if cf.n == 0:
        # no variables: feasible iff b ≈ 0 on every (equality) row
        if cf.m == 0 or np.all(np.abs(cf.b) <= 1e-9):
            return SimplexResult(
                kind=LinearProgramType.FINITE_OPTIMUM,
                objective=cf.fixed_cost,
                x_structural=np.zeros(0),
            )
        return SimplexResult(kind=LinearProgramType.INFEASIBLE)

    # m == 0: minimize c@x over the box alone
    x = np.zeros(cf.n)
    for j in range(cf.n):
        cj, lo, hi = cf.c[j], cf.lb[j], cf.ub[j]
        if cj > 0:
            if not np.isfinite(lo):
                return SimplexResult(kind=LinearProgramType.UNBOUNDED)
            x[j] = lo
        elif cj < 0:
            if not np.isfinite(hi):
                return SimplexResult(kind=LinearProgramType.UNBOUNDED)
            x[j] = hi
        else:
            x[j] = lo if np.isfinite(lo) else (hi if np.isfinite(hi) else 0.0)
    return SimplexResult(
        kind=LinearProgramType.FINITE_OPTIMUM,
        objective=cf.objective_of(x),
        x_structural=cf.structural_values(x),
    )


@dataclass
class GeneralFormResult:
    kind: LinearProgramType
    solution: Optional[Solution] = None
    simplex: Optional[SimplexResult] = None
    # the lowered problem the engine solved (None when presolve finished)
    cf: Optional[ComputationalForm] = None
    # row names of the (presolved) problem the engine saw
    row_names: Optional[list] = None


def solve_general_form(
    general: GeneralForm,
    config: SolverConfig = DEFAULT_CONFIG,
    device: DeviceLike = None,
) -> GeneralFormResult:
    """End-to-end: GeneralForm → presolve → computational form → device
    solve → Solution.  ``device=None`` reads ``RELP_TPU_TORCH_DEVICE``
    (default ``"cuda"``)."""
    from relp_tpu_torch.model.computational_form import build_computational_form

    dev = resolve_device(device)
    trivially = general.trivial_infeasibility()
    if trivially is not None:
        return GeneralFormResult(kind=trivially)

    if config.presolve:
        from relp_tpu_torch.presolve.engine import presolve

        outcome = presolve(general)
        if outcome.status is not None:
            return GeneralFormResult(kind=outcome.status)

    done = general.compute_solution_where_possible()
    if done is not None:
        return GeneralFormResult(kind=LinearProgramType.FINITE_OPTIMUM, solution=done)

    cf = build_computational_form(general, scale=config.scale)
    res = solve_computational_form(cf, config, device=dev)
    return _finish_general(general, cf, res)


def _finish_general(general: GeneralForm, cf, res: SimplexResult) -> GeneralFormResult:
    row_names = list(general.row_names)
    if not res.is_optimal:
        return GeneralFormResult(kind=res.kind, simplex=res, cf=cf, row_names=row_names)
    reduced: Dict[str, float] = {
        v.name: float(res.x_structural[j]) for j, v in enumerate(general.variables)
    }
    solution = general.compute_full_solution(reduced)
    # the (sense-adjusted) engine objective, which includes the fixed cost
    solution.objective_value = res.objective
    return GeneralFormResult(
        kind=LinearProgramType.FINITE_OPTIMUM, solution=solution, simplex=res,
        cf=cf, row_names=row_names,
    )
