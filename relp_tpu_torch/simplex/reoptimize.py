"""Reoptimization: re-solve a modified problem from a previous basis.

The branch-and-bound / scenario-update pattern: after solving an LP, change
variable bounds (the optimal basis stays *dual* feasible because costs are
untouched) and re-solve with the dual simplex in a handful of iterations;
falls back to a warm primal solve if the dual method fails, and to a cold
primal solve as the last resort.  With ``trust_infeasible`` the dual's
INFEASIBLE is an answer, not a failure: a leaving row that no candidate
blocks after a fresh factorization, every boxed candidate flipped, cannot
reach its bound under the new bounds, which proves them infeasible.  The ladder is the algorithm's: a failure
of a device call is not caught here, and nothing moves to another device.
"""

from __future__ import annotations

from typing import Optional

import torch

from relp_tpu_torch.simplex import status as st
from relp_tpu_torch.simplex.core import SolveOutput, solve_core
from relp_tpu_torch.simplex.dual import F64, _tensor, as_device_operator, solve_core_dual
from relp_tpu_torch.utils.config import DEFAULT_CONFIG, SolverConfig
from relp_tpu_torch.utils.device import DeviceLike
from relp_tpu_torch.utils.metrics import Timer, recording, span


def reoptimize_with_bounds(
    A,
    b,
    c,
    new_lb,
    new_ub,
    prior: SolveOutput,
    config: SolverConfig = DEFAULT_CONFIG,
    max_iter: Optional[int] = None,
    device: DeviceLike = None,
    trust_infeasible: bool = False,
) -> SolveOutput:
    """Re-solve ``min c@x, A@x=b, new_lb<=x<=new_ub`` starting from the
    basis of ``prior`` (a SolveOutput for the same padded shapes).  ``A`` is
    an operator of ops/amatrix.py, a tensor or a numpy matrix; the vectors
    are numpy arrays or tensors.  The solve runs on ``A``'s device when it
    has one, else on ``device``.  Emits one ``SolveMetrics`` record (call
    ``"reoptimize"``), which names the operator's ``matrix_format``.
    ``driver.device_problem`` gives a solved form's arrays and operator.
    ``trust_infeasible`` returns the dual's INFEASIBLE without the primal
    fallback (the default falls back, as the JAX package does)."""
    with recording("reoptimize") as rec, Timer() as t, span("reoptimize"):
        with span("reoptimize.prepare"):
            A = as_device_operator(A, device)
            m, n = A.shape
            dev = A.device
            if max_iter is None:
                max_iter = config.resolve_max_iter(m, n)
            b, c, new_lb, new_ub = (_tensor(v, F64, dev) for v in (b, c, new_lb, new_ub))
            basis0 = prior.basis.to(dev)
            # nonbasic statuses must remain consistent with the new bounds
            vstat0 = _repair_statuses(prior.vstat.to(dev)[:n], new_lb, new_ub)
            art_sign0 = prior.art_sign.to(dev)
        rec.m_padded, rec.n_padded, rec.device = m, n, str(dev)
        rec.matrix_format = getattr(A, "format", "")

        out = solve_core_dual(A, b, c, new_lb, new_ub, basis0, vstat0, config, max_iter,
                              art_sign0=art_sign0, keep_start=True)
        status = _tally(rec, out)
        rec.engine = "dual"
        if status != st.OPTIMAL and not (trust_infeasible and status == st.INFEASIBLE):
            with span("reoptimize.fallback"):
                # dual failed (e.g. the start was not dual feasible): warm primal
                out = solve_core(A, b, c, new_lb, new_ub, config, max_iter, basis0=basis0,
                                 vstat0=vstat0, art_sign0=art_sign0)
                status = _tally(rec, out)
                rec.engine = "dual→primal"
                if status not in (st.OPTIMAL, st.UNBOUNDED, st.INFEASIBLE):
                    # cold fallback
                    out = solve_core(A, b, c, new_lb, new_ub, config, max_iter)
                    status = _tally(rec, out)
                    rec.engine = "dual→primal-cold"
    rec.wall_s = t.elapsed
    rec.status = st.STATUS_TO_TYPE[status].value
    rec.emit()
    return out


def _tally(rec, out: SolveOutput) -> int:
    """Add an engine's iterations, host reads and flips to ``rec``, read
    with its status in one host read; returns the status."""
    counts = [out.status, out.it] + ([out.flips] if torch.is_tensor(out.flips) else [])
    status, it, *flips = torch.stack(counts).tolist()
    rec.iterations += it
    rec.host_reads += out.host_reads
    rec.bound_flips += flips[0] if flips else int(out.flips)
    return status


def _repair_statuses(vstat, lb, ub):
    """Nonbasic statuses (a tensor) consistent with the bounds ``lb``/``ub``."""
    nb_lower = vstat == st.NB_LOWER
    fixed = lb == ub
    vstat = torch.where(fixed & (vstat != st.BASIC), st.NB_FIXED, vstat)
    vstat = torch.where(nb_lower & ~torch.isfinite(lb), st.NB_UPPER, vstat)
    return torch.where(
        (vstat == st.NB_UPPER) & ~torch.isfinite(ub),
        torch.where(torch.isfinite(lb), st.NB_LOWER, st.NB_FREE),
        vstat,
    )
