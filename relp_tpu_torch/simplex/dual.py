"""Bounded-variable dual simplex (device core).

Port of ``relp_tpu/simplex/dual.py``: given a *dual-feasible* basis (the
optimal basis of a related problem whose bounds were since tightened, or the
all-artificial basis with every nonbasic on the bound sign(c_j) asks for),
iterate on primal feasibility while keeping dual feasibility.  Dense
maintained inverse with one in-place rank-1 update per pivot and periodic
refactorization; the dual update reuses ``π' = π + (d_q/u_r)·B⁻¹[r,:]``.

Per iteration (the arithmetic of the JAX loop body, in its order):
  1. leaving row r: largest bound violation of xB scaled by the dual
     steepest-edge weights β_i = ‖B⁻¹[i,:]‖² (OPTIMAL when no violation; the
     termination decision itself is norm-free),
  2. pivot row α = B⁻¹[r]·A through the operator's ``rmatvec`` (the sum mode
     of the pricing kernels) and the bound-flipping ratio test ("long
     step"): in ratio order |d_j/α_j|, passing a boxed candidate flips it to
     its opposite bound and takes (ub_j−lb_j)·|α_j| off the rate at which
     row r's infeasibility shrinks; the entering q is the candidate at which
     that slope crosses zero, a Harris-style tolerance picking the largest
     |α| among near-ties (primal INFEASIBLE when no candidate blocks),
  3. the batch of flips (one ``A.matvec`` and one product with B⁻¹), then the
     pivot: u = B⁻¹a_q, update of xB, B⁻¹, π, d, the weights and statuses;
     all of it after the products with A and B⁻¹, but for B⁻¹'s own update,
     is :func:`pivot_update`: one launch of ``ops/dual_kernels.py::
     dual_update`` on a CUDA device, :func:`dual_update_plain` elsewhere.

The loop has the shape of the JAX package's externally refactorized form
(``_make_kernel(external=True)``), as the primal's has: :meth:`DualKernel.
step` is straight-line and never refactorizes; the HOST runs
:meth:`DualKernel.refactor` when ``since_refactor`` reaches
``refactor_period``.  The batch of flips, a ``lax.cond`` there, is computed
every iteration and selected, so it costs no host read.

Host reads: one per iteration (the packed flags *running* and *refactor
due* that the step returns), one before the first, and one per
refactorization under ``refactor_mode="polish"`` (its residual check); the
LU's minimum pivot is judged on the device.

What an operator keeps across solves is one record (:class:`Kept`), dying
with it: one :class:`StepGraph` per set of options (on a CUDA device) and
one :class:`StartInverse` (after a warm re-solve, ``keep_start``, which
``reoptimize_with_bounds`` asks for).  On a CUDA device an iteration is one
replay of the graph of :meth:`DualKernel.step`, captured at the first
refactorization of the first solve; every B⁻¹ is row-major, so one graph
serves every refactorization.  The CPU steps eagerly.  A warm re-solve from
the kept start's basis and artificial signs, under its ``refactor_mode`` and
``singular_tol``, installs its B⁻¹ (:meth:`DualKernel.start`) in place of
the start's refactorization; whether it matches rides on the read before
the first iteration, and a miss's basis, if sound, is kept at the next.
Graphed solves on one device run one at a time, whatever thread starts
them: a graph steps one static state, and the graphs of a device share one
capture stream and its pricing scratch.

Spans (utils/metrics.py, on while a profiler records): ``dual.solve`` over
the whole solve; in it ``dual.capture`` (a step's graph captured),
``dual.refactor``, ``dual.start`` (a kept start inverse installed),
``dual.step``, ``dual.read`` (a read of the loop's flags:
the host waits for the device there) and ``dual.extract``; in an eager step
``dual.leaving`` (1.), ``dual.row`` (ρ and α), ``dual.ratio`` (the
candidates and the ratio test) and ``dual.pivot`` (3.), none of which a
replay enters.  The kernel counts its refactorizations, LU rebuilds,
kept start inverses taken, replayed iterations, captures and launches of
the ``dual_update`` kernel (each made from the host, and each recorded in a
graph once per replay) on the host and adds them to the open solve record.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
import weakref

import numpy as np
import torch

from relp_tpu_torch.ops import dual_kernels
from relp_tpu_torch.ops.amatrix import DenseMatrix
from relp_tpu_torch.ops.dual_kernels import Pivot
from relp_tpu_torch.ops.linalg import inverse_residual, lu_inverse, rank_one_basis_update
from relp_tpu_torch.ops.select_epilogue import current_workspace
from relp_tpu_torch.simplex import status as st
from relp_tpu_torch.simplex.core import SolveOutput, _at, _nonbasic_values, _put
from relp_tpu_torch.utils.config import SolverConfig
from relp_tpu_torch.utils.device import DeviceLike, resolve_device
from relp_tpu_torch.utils.metrics import count, span

F64 = torch.float64
F32 = torch.float32
I64 = torch.int64
INF = float("inf")
BISECT_STEPS = 64


@dataclasses.dataclass
class DState:
    """Loop state; every field is a tensor on the solve's device."""

    basis: torch.Tensor           # i64[m]
    vstat: torch.Tensor           # i64[n+m] — statuses incl. artificial slots
    xB: torch.Tensor              # f64[m]
    Binv: torch.Tensor            # f64[m, m] — updated in place
    pi: torch.Tensor              # f64[m]
    d: torch.Tensor               # f64[n] — reduced costs, maintained
    #                               incrementally (d' = d − θ_D·α; recomputed
    #                               at refactorization)
    beta: torch.Tensor            # f64[m] — dual steepest-edge row weights
    #                               (exact under "dse", reference weights
    #                               under "devex"; reset at refactorization)
    status: torch.Tensor          # i64 scalar
    it: torch.Tensor              # i64
    since_refactor: torch.Tensor  # i64
    repairs: torch.Tensor         # i64 (kept for the JAX state's shape; unused)
    flips: torch.Tensor           # i64 — bound flips applied by the ratio test


def _basis_matrix(A, basis, art_sign):
    """The (m, m) basis matrix and the mask of its artificial slots;
    artificial column ``n + i`` is the virtual ``art_sign[i]·e_i``."""
    m, n = A.shape
    is_art = basis >= n
    struct_cols = A.cols_matrix(basis.clamp(0, n - 1))
    k = (basis - n).clamp(0, m - 1)
    rows = torch.arange(m, device=basis.device)
    art_cols = (rows[:, None] == k[None, :]) * art_sign[k][None, :]
    return torch.where(is_art[None, :], art_cols, struct_cols), is_art


def _derived_state(A, b, c, lb_tot, ub_tot, basis, vstat, Binv):
    """The loop state derived from (basis, vstat, B⁻¹): xB, π, the reduced
    costs ``c − Aᵀπ`` and the exact row norms of B⁻¹."""
    m, n = A.shape
    is_art = basis >= n
    nb = _nonbasic_values(vstat, lb_tot, ub_tot)
    nb = torch.where(vstat == st.BASIC, 0.0, nb)
    r = b - A.matvec(nb[:n])
    xB = Binv @ r
    cB = torch.where(is_art, 0.0, c[basis.clamp(0, n - 1)])
    pi = cB @ Binv
    d = A.price(c, pi)
    beta = (Binv * Binv).sum(1)
    return xB, pi, d, beta


class DualKernel:
    """The dual engine over one fixed, padded problem: :meth:`refactor` and
    :meth:`step`, with the loop's host-side read counter."""

    def __init__(self, A, b, c, lb, ub, art_sign, cfg: SolverConfig, max_iter: int):
        self.A, self.b, self.c, self.lb, self.ub = A, b, c, lb, ub
        self.art_sign = art_sign
        self.cfg = cfg
        self.max_iter = max_iter
        self.m, self.n = A.shape
        self.dev = A.device
        zeros_m = torch.zeros(self.m, dtype=F64, device=self.dev)
        self.lb_tot = torch.cat([lb, zeros_m])
        self.ub_tot = torch.cat([ub, zeros_m])
        self.boxed_range = ub - lb  # flip capacity of each column (inf when unboxed)
        self.can_enter = lb < ub
        self.pos_ids = torch.arange(self.n, device=self.dev)
        self.host_reads = 0
        self.refactorizations = 0
        self.inverse_rebuilds = 0
        self.start_inverse_hits = 0
        self.graph_steps = 0
        self.graph_captures = 0
        self.update_kernel_steps = 0

    def _read(self, t: torch.Tensor):
        """Bring a small tensor to the host (one synchronisation)."""
        self.host_reads += 1
        return t.tolist()

    def flags(self, s: DState) -> torch.Tensor:
        """The packed loop condition of ``s``: (running, refactorization due)."""
        running = (s.status == st.RUNNING) & (s.it < self.max_iter)
        return torch.stack([running, s.since_refactor >= self.cfg.refactor_period])

    # ---- refactorization ----
    def refactor(self, s: DState) -> DState:
        with span("dual.refactor"):
            cfg = self.cfg
            B, _ = _basis_matrix(self.A, s.basis, self.art_sign)
            Binv = None
            status = s.status
            if cfg.refactor_mode == "polish":
                # one Newton-Schulz step on the maintained inverse against the
                # clean basis columns, X1 = X(2I − BX); a failed residual check
                # (singular basis, placeholder warm inverse) rebuilds instead
                X = s.Binv
                X1 = X @ (2.0 * torch.eye(self.m, dtype=F64, device=self.dev) - B @ X)
                resid = inverse_residual(B, X1)
                if self._read(torch.isfinite(resid) & (resid < 1e-9)):
                    Binv = X1
            self.refactorizations += 1
            if Binv is None:
                self.inverse_rebuilds += 1
                Binv, min_piv = lu_inverse(B)
                # NaN-safe (NaN >= tol is False): a singular basis ends the solve
                status = torch.where(min_piv >= cfg.singular_tol, status, st.NUMERICAL)
            return self._with_inverse(s, Binv, status)

    def start(self, s: DState, Binv: torch.Tensor) -> DState:
        """The start state ``s`` on a kept start inverse ``Binv`` of its
        basis: what :meth:`refactor` gives from it, without rebuilding it."""
        with span("dual.start"):
            self.start_inverse_hits += 1
            return self._with_inverse(s, Binv, s.status)

    def _with_inverse(self, s: DState, Binv: torch.Tensor, status) -> DState:
        xB, pi, d, beta = _derived_state(
            self.A, self.b, self.c, self.lb_tot, self.ub_tot, s.basis, s.vstat, Binv)
        return dataclasses.replace(
            s, Binv=Binv, xB=xB, pi=pi, d=d, beta=beta, status=status,
            since_refactor=torch.zeros_like(s.since_refactor))

    # ---- the two bound-flipping ratio tests ----
    def _ratio_bisect(self, cand, ratio, cap, abs_alpha, viol_r):
        """Sort-free form: the blocking ratio is the step-function crossing
        t* = min{t : Σ_{cand, ratio≤t} cap ≥ viol_r}, located by scalar
        bisection (64 masked O(n) reductions)."""
        any_block = cap.sum() >= viol_r
        hi = torch.where(cand, ratio, 0.0).max()
        lo = torch.full_like(hi, -1.0)
        for _ in range(BISECT_STEPS):
            mid = 0.5 * (lo + hi)
            pred = torch.where(ratio <= mid, cap, 0.0).sum() >= viol_r
            lo, hi = torch.where(pred, lo, mid), torch.where(pred, mid, hi)
        ratio_block = torch.where(cand & (ratio > lo), ratio, INF).min()
        near = cand & (ratio <= ratio_block) & (ratio >= ratio_block - self.cfg.eps_dual)
        q = torch.argmax(torch.where(near, abs_alpha, -1.0))
        has_entering = any_block & torch.isfinite(ratio_block)
        # flips: candidates whose reduced cost crosses zero strictly before
        # the chosen q's (their cap sum stays < viol_r, so the row's
        # infeasibility keeps shrinking after the flips)
        flip_mask = cand & (ratio < _at(ratio, q))
        return q, has_entering, flip_mask

    def _ratio_sort(self, cand, ratio, cap, abs_alpha, viol_r):
        """Sorted form: candidates in ratio order (stable, as ``jnp.argsort``
        is), the slope after each by one cumulative sum."""
        order = torch.argsort(torch.where(cand, ratio, INF), stable=True)
        cap_sorted = cap[order]
        cand_sorted = cand[order]
        slope_after = viol_r - torch.cumsum(cap_sorted, 0)
        blocked = cand_sorted & (slope_after <= 0)
        any_block = blocked.any()
        kq_block = torch.argmax(blocked.to(torch.int8))  # first True (0 if none)
        # Harris-style tie tolerance: among candidates at sorted positions
        # up to the blocker whose ratio is within the dual tolerance of the
        # blocker's, take the largest |α|
        ratio_sorted = torch.where(cand_sorted, ratio[order], INF)
        ratio_block = _at(ratio_sorted, kq_block)
        near = (cand_sorted & (self.pos_ids <= kq_block)
                & (ratio_sorted >= ratio_block - self.cfg.eps_dual))
        kq = torch.argmax(torch.where(near, abs_alpha[order], -1.0))
        q = _at(order, kq)
        has_entering = any_block & torch.isfinite(_at(ratio_sorted, kq))
        # flips: all candidates strictly before the chosen position
        flip_mask = torch.zeros_like(cand).index_copy_(
            0, order, cand_sorted & (self.pos_ids < kq))
        return q, has_entering, flip_mask

    # ---- one iteration ----
    def step(self, s: DState):
        """One dual pivot (with its batch of bound flips) or a no-op that
        sets the status or asks for a refactorization.  ``s.Binv`` is updated
        in place.  Returns ``(state, flags)`` with :meth:`flags` of the new
        state."""
        A, cfg, n = self.A, self.cfg, self.n
        lb_tot, ub_tot = self.lb_tot, self.ub_tot
        with span("dual.step"):
            with span("dual.leaving"):
                broken = ~torch.isfinite(s.xB.sum() + s.pi.sum())
                fresh = s.since_refactor == 0

                k = s.basis
                lbk = lb_tot[k]
                ubk = ub_tot[k]
                below = lbk - s.xB
                above = s.xB - ubk
                viol = torch.maximum(below, above).clamp_min(0.0)
                # dual steepest edge: largest infeasibility scaled by the row norm
                # of B⁻¹; the termination decision stays norm-free
                r = torch.argmax(viol * viol / s.beta.clamp_min(1e-12))
                primal_feasible = viol.max() <= cfg.eps_feas
                r = torch.where(primal_feasible, torch.argmax(viol), r)
                r1 = r.reshape(1)
            with span("dual.row"):
                # pivot row and (incrementally maintained) reduced costs
                rho = s.Binv.index_select(0, r1)[0]
                alpha = A.rmatvec(rho)
                d = s.d
                vs = s.vstat[:n]
            with span("dual.ratio"):
                leaving_below = _at(below, r) > _at(above, r)  # xB_r under its lower bound
                # sign-compatible entering candidates keep dual feasibility:
                #   below-lower: at-lower with α<0, at-upper with α>0, free either
                # (mirrored when above-upper; fold by flipping α's sign)
                alpha_eff = torch.where(leaving_below, alpha, -alpha)
                is_free = vs == st.NB_FREE
                at_l = (vs == st.NB_LOWER) | is_free
                at_u = (vs == st.NB_UPPER) | is_free
                cand = (at_l & (alpha_eff < -cfg.eps_pivot)) | (at_u & (alpha_eff > cfg.eps_pivot))
                cand = cand & self.can_enter & (vs != st.BASIC)
                abs_alpha = alpha_eff.abs()
                ratio = torch.where(cand, d.abs() / abs_alpha.clamp_min(1e-300), INF)

                # ---- bound-flipping ratio test (long-step dual, vectorized) ----
                # passing candidate j takes its flip capacity (ub_j−lb_j)·|α_j| off the
                # slope; unboxed candidates have infinite capacity and always block
                cap = torch.where(cand, self.boxed_range * abs_alpha, 0.0)
                viol_r = _at(viol, r)
                ratio_test = self._ratio_bisect if cfg.dual_ratio == "bisect" else self._ratio_sort
                q, has_entering, flip_mask = ratio_test(cand, ratio, cap, abs_alpha, viol_r)
                n_flips = flip_mask.sum()
            with span("dual.pivot"):
                u = A.ftran(s.Binv, q)
                # the batch of bound flips: one A·dx and one product with B⁻¹,
                # computed every iteration (dx is zero without flips) and
                # selected by the update
                dx = torch.where(flip_mask, torch.where(vs == st.NB_LOWER, self.boxed_range,
                                                        -self.boxed_range), 0.0)
                bdx = s.Binv @ A.matvec(dx)
                # DSE's τ = B⁻¹·(B⁻¹[r,:])ᵀ
                tau = None if cfg.dual_pricing == "devex" else s.Binv @ rho
                # xB, π, d, the weights, statuses, basis, counters and flags
                s_out, flags, do_pivot = pivot_update(self, s, Pivot(
                    r, q, has_entering, n_flips, flip_mask, primal_feasible, broken, fresh,
                    leaving_below, u, bdx, tau, rho, alpha))
                # B⁻¹ last: everything above reads the pre-pivot inverse
                rank_one_basis_update(s.Binv, u, r, apply=do_pivot)
            return s_out, flags


def dual_update_plain(K: DualKernel, s: DState, piv: Pivot):
    """The update of state ``s`` by the pivot ``piv`` under ``K``'s bounds,
    options and iteration cap, in PyTorch: ``(state, flags, do_pivot)``, the
    state a new one whose ``Binv`` is ``s.Binv``, not yet updated."""
    cfg, n = K.cfg, K.n
    lb, ub, lb_tot, ub_tot = K.lb, K.ub, K.lb_tot, K.ub_tot
    r, q, u, rho, alpha = piv.r, piv.q, piv.u, piv.rho, piv.alpha
    primal_feasible, broken, has_entering = piv.primal_feasible, piv.broken, piv.has_entering
    leaving_below, n_flips, flip_mask = piv.leaving_below, piv.n_flips, piv.flip_mask
    k, d, vs = s.basis, s.d, s.vstat[:n]

    p = _at(u, r)
    ok_pivot = p.abs() > cfg.eps_pivot
    p_safe = torch.where(p.abs() > 1e-300, p, 1.0)
    do_pivot = ~primal_feasible & has_entering & ~broken & ok_pivot

    at_lower = vs == st.NB_LOWER
    xB_f = torch.where(do_pivot & (n_flips > 0), s.xB - piv.bdx, s.xB)
    flip_to = torch.where(at_lower, st.NB_UPPER, st.NB_LOWER)
    vstat_flip = torch.where(flip_mask, flip_to, vs)

    kr = _at(k, r)
    bound_r = torch.where(leaving_below, _at(lb_tot, kr), _at(ub_tot, kr))
    theta_p = (_at(xB_f, r) - bound_r) / p_safe
    vq = _at(vs, q)
    start_val = torch.where(vq == st.NB_UPPER, _at(ub, q),
                            torch.where(vq == st.NB_LOWER, _at(lb, q), 0.0))

    xB_new = _put(xB_f - theta_p * u, r, start_val + theta_p)
    d_q = _at(d, q)
    theta_d = d_q / p_safe
    pi_new = s.pi + theta_d * rho
    # incremental reduced costs: d' = d − θ_D·α (the entering column's d
    # becomes 0, the leaving column's −θ_D)
    d_new = _put(d - theta_d * alpha, q, torch.zeros_like(d_q))
    ratio_u = u / p_safe
    beta_r = _at(s.beta, r)
    if cfg.dual_pricing == "devex":
        # devex reference weights (dual form): γ_i' = max(γ_i,
        # (u_i/p)²·γ_r), γ_r' = max(γ_r/p², 1), from the FTRAN column alone
        beta_new = torch.maximum(s.beta, ratio_u * ratio_u * beta_r)
        beta_new = _put(beta_new, r, (beta_r / (p_safe * p_safe)).clamp_min(1.0))
        beta_new = beta_new.clamp(1e-12, 1e12)
    else:
        # Forrest–Goldfarb exact dual-steepest-edge weight update:
        #   τ = B⁻¹·(B⁻¹[r,:])ᵀ;  β_r' = β_r/p²;
        #   β_i' = β_i − 2(u_i/p)·τ_i + (u_i/p)²·β_r   (i ≠ r)
        beta_new = s.beta - 2.0 * ratio_u * piv.tau + ratio_u * ratio_u * beta_r
        beta_new = _put(beta_new, r, beta_r / (p_safe * p_safe)).clamp_min(1e-12)

    leave_stat = torch.where(leaving_below, st.NB_LOWER, st.NB_UPPER)
    leave_stat = torch.where(_at(lb_tot, kr) == _at(ub_tot, kr), st.NB_FIXED, leave_stat)
    vstat_new = torch.cat([vstat_flip, s.vstat[n:]])
    vstat_new = _put(_put(vstat_new, kr, leave_stat), q, torch.full_like(kr, st.BASIC))

    fresh = piv.fresh
    status_new = torch.where(
        primal_feasible & fresh & ~broken,
        st.OPTIMAL,
        torch.where(~primal_feasible & ~has_entering & fresh & ~broken,
                    st.INFEASIBLE, s.status),
    )
    wants_terminal = primal_feasible | (~primal_feasible & ~has_entering)
    # a too-small pivot is a numerical event: rebuild and retry
    force_refac = (wants_terminal & ~fresh) | broken | (
        ~primal_feasible & has_entering & ~ok_pivot)

    s_out = dataclasses.replace(
        s,
        basis=torch.where(do_pivot, _put(k.clone(), r, q), k),
        vstat=torch.where(do_pivot, vstat_new, s.vstat),
        xB=torch.where(do_pivot, xB_new, s.xB),
        pi=torch.where(do_pivot, pi_new, s.pi),
        d=torch.where(do_pivot, d_new, s.d),
        beta=torch.where(do_pivot, beta_new, s.beta),
        status=status_new,
        it=s.it + 1,
        since_refactor=torch.where(
            force_refac, cfg.refactor_period, s.since_refactor + do_pivot.long()),
        flips=s.flips + torch.where(do_pivot, n_flips, 0),
    )
    return s_out, K.flags(s_out), do_pivot


def pivot_update(K: DualKernel, s: DState, piv: Pivot):
    """:func:`dual_update_plain`'s ``(state, flags, do_pivot)``: on a CUDA
    device from one launch of the ``dual_update`` kernel into fresh tensors
    (counted in ``K.update_kernel_steps``), elsewhere the plain version."""
    if K.dev.type != "cuda":
        return dual_update_plain(K, s, piv)
    fields, flags, do_pivot = dual_kernels.dual_update(
        piv, s, K.lb, K.ub, K.lb_tot, K.ub_tot, refactor_period=K.cfg.refactor_period,
        max_iter=K.max_iter, eps_pivot=K.cfg.eps_pivot, devex=K.cfg.dual_pricing == "devex")
    K.update_kernel_steps += 1
    return dataclasses.replace(s, **fields), flags, do_pivot


# what DualKernel.step reads of its kernel besides the operator and the options
_STEP_INPUTS = ("lb", "ub", "lb_tot", "ub_tot", "boxed_range", "can_enter", "pos_ids")
# the fields of DState the step replaces, by dtype (one copy launch a group);
# B⁻¹ is updated in place and `repairs` passed through.  Copying them back
# keeps one set of state tensors that a refactorization can write into; two
# graphs alternating between two states would copy as much, the step's
# results being new tensors
_STEP_REPLACES = (("xB", "pi", "d", "beta"),
                  ("basis", "vstat", "status", "it", "since_refactor", "flips"))


def _cloned(s: DState) -> DState:
    return DState(**{f.name: getattr(s, f.name).clone() for f in dataclasses.fields(DState)})


class StepGraph:
    """:meth:`DualKernel.step` of one operator under one set of options,
    captured as a CUDA graph over static copies of the inputs it reads
    (``_STEP_INPUTS``, which every solve loads anew: :meth:`load`) and of
    the loop state (:attr:`state`, which every refactorization is stored
    into, the first capturing the graph: :meth:`enter`).  The captured body
    is the step, then the copy of the fields it replaces back into
    :attr:`state`; :attr:`flags` is the packed flags it returns,
    :attr:`update_launches` the ``dual_update`` launches it recorded.  The graph
    holds every tensor its kernels point at that the operator does not:
    these, its memory pool and the capture stream's pricing scratch
    (:attr:`workspace`), which a larger one may replace for later launches.
    """

    def __init__(self, K: DualKernel):
        self.inputs = {k: getattr(K, k).clone() for k in _STEP_INPUTS}
        self.state: DState | None = None
        self.update_launches = 0

    def load(self, K: DualKernel) -> DualKernel:
        """Copy ``K``'s inputs in; returns ``K`` reading the static ones
        (``K`` itself, which a solve may hand out, never reads them)."""
        Ks = copy.copy(K)
        for k, t in self.inputs.items():
            t.copy_(getattr(K, k))
            setattr(Ks, k, t)
        return Ks

    def enter(self, K: DualKernel, Ks: DualKernel, s: DState) -> DState:
        """``s`` stored in :attr:`state`, the graph captured first if it is
        not yet (counted in ``K.graph_captures``); returns :attr:`state`."""
        if self.state is None:
            self.state = _cloned(s)
            try:
                with span("dual.capture"):
                    self._capture(Ks)
            except BaseException:
                self.state = None  # the next solve captures anew
                raise
            K.graph_captures += 1
        return self.store(s)

    def body(self, Ks: DualKernel) -> torch.Tensor:
        """One step of :attr:`state` in place; returns the flags."""
        s, flags = Ks.step(self.state)
        for names in _STEP_REPLACES:
            torch._foreach_copy_([getattr(self.state, k) for k in names],
                                 [getattr(s, k) for k in names])
        return flags

    def _capture(self, Ks: DualKernel) -> None:
        dev = Ks.dev
        stream = _capture_stream(dev)
        with torch.cuda.device(dev):
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                # one eager step on this stream first, so that cuBLAS's
                # workspace and the kernels' scratch of this stream exist
                # before the capture (the state is stored anew after it)
                self.body(Ks)
            self.graph = torch.cuda.CUDAGraph()
            # another thread's work on the device (its allocations among
            # it) may go on while this one records
            steps = Ks.update_kernel_steps
            with torch.cuda.graph(self.graph, stream=stream, capture_error_mode="thread_local"):
                self.flags = self.body(Ks)
            # the update kernel's launches the graph recorded: each replay's
            self.update_launches = Ks.update_kernel_steps - steps
            self.workspace = current_workspace(dev, stream.cuda_stream)

    def replay(self) -> torch.Tensor:
        """One step of :attr:`state` in place; returns the flags."""
        self.graph.replay()
        return self.flags

    def store(self, s: DState) -> DState:
        """Copy the fields of ``s`` that are not already :attr:`state`'s in."""
        for f in dataclasses.fields(DState):
            src, dst = getattr(s, f.name), getattr(self.state, f.name)
            if src is not dst:
                dst.copy_(src)
        return self.state


@dataclasses.dataclass(frozen=True)
class StartInverse:
    """The B⁻¹ that a warm start's refactorization made, kept for the next
    warm start on the same operator: the start's ``basis`` and ``art_sign``,
    the ``refactor_mode`` and ``singular_tol`` it ran under, and ``Binv`` as
    the refactorization left it.  Nothing writes ``Binv`` once it is kept."""

    basis: torch.Tensor
    art_sign: torch.Tensor
    refactor_mode: str
    singular_tol: float
    Binv: torch.Tensor


@dataclasses.dataclass
class Kept:
    """What one operator keeps across solves: the :class:`StepGraph` of
    each set of options its graphed solves ran under (:func:`step_graph`),
    and the :class:`StartInverse` of the last sound warm start on it, or
    ``None`` (:class:`_WarmStart`)."""

    graphs: dict = dataclasses.field(default_factory=dict)
    start: StartInverse | None = None


# operator -> its Kept, dying with it.  The one rule: _KEPT and the records
# in it are read and written only under _KEPT_LOCK, held for nothing else
_KEPT: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_KEPT_LOCK = threading.Lock()
_CAPTURE_STREAMS: dict = {}  # device index -> the stream captures on it use
_LOCKS: dict = {}  # device -> the lock a graphed solve holds there


class _WarmStart:
    """One warm solve's use of its operator's kept start inverse, asked at
    the reads the loop makes anyway: at the first, whether the start state
    matches it (a hit installs it in place of the start's refactorization);
    after a miss's refactorization, whether the basis was sound (its B⁻¹
    then replaces the kept one)."""

    def __init__(self, K: DualKernel, s: DState, graphed: bool):
        self.K, self.graphed = K, graphed
        with _KEPT_LOCK:
            kept = getattr(_KEPT.get(K.A), "start", None)
        if kept is not None and (kept.refactor_mode, kept.singular_tol) != (
                K.cfg.refactor_mode, K.cfg.singular_tol):
            kept = None
        self.kept = kept
        self.question = None if kept is None else (
            (s.basis == kept.basis).all() & (K.art_sign == kept.art_sign).all()).reshape(1)
        self.hit = self.started = False
        self.made = None

    def ask(self, flags: torch.Tensor) -> torch.Tensor:
        """``flags`` with the open question, if any, appended."""
        if self.question is None:
            return flags
        flags, self.question = torch.cat([flags, self.question]), None
        return flags

    def told(self, yes: bool) -> None:
        """The answer to the question :meth:`ask` appended: before the start,
        whether it hits; after a miss's refactorization, whether its basis
        was sound (the B⁻¹ it made is then kept)."""
        if self.made is None:
            self.hit = yes
        elif yes:
            with _KEPT_LOCK:
                _KEPT.setdefault(self.K.A, Kept()).start = self.made

    def refactor(self, s: DState) -> DState:
        """The start's refactorization (a hit: the kept B⁻¹ installed), then
        :meth:`DualKernel.refactor`."""
        K = self.K
        if self.started:
            return K.refactor(s)
        self.started = True
        # an eager step updates B⁻¹ in place; a graph copies it into its state
        if self.hit:
            return K.start(s, self.kept.Binv if self.graphed else self.kept.Binv.clone())
        s = K.refactor(s)
        self.made = StartInverse(s.basis, K.art_sign.clone(), K.cfg.refactor_mode,
                                 K.cfg.singular_tol,
                                 s.Binv if self.graphed else s.Binv.clone())
        # the start state is RUNNING: NUMERICAL now means a singular basis
        self.question = (s.status != st.NUMERICAL).reshape(1)
        return s


def _capture_stream(dev: torch.device):
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[idx] = torch.cuda.Stream(idx)
    return _CAPTURE_STREAMS[idx]


def _graphable(A) -> bool:
    """Whether the loop replays a captured step on ``A``: on a CUDA device."""
    return A.device.type == "cuda"


def step_graph(K: DualKernel) -> StepGraph:
    """The :class:`StepGraph` of ``K``'s operator and options."""
    cfg = K.cfg
    key = (K.m, K.n, K.A.dtype, K.dev, cfg.dual_pricing, cfg.dual_ratio, cfg.eps_pivot,
           cfg.eps_dual, cfg.eps_feas, cfg.refactor_period, K.max_iter)
    with _KEPT_LOCK:
        graphs = _KEPT.setdefault(K.A, Kept()).graphs
        if key not in graphs:
            graphs[key] = StepGraph(K)
        return graphs[key]


def _tensor(v, dtype, dev):
    """``v`` (numpy or tensor) as a tensor of ``dtype`` on ``dev``; a copy
    whenever it came from numpy."""
    if torch.is_tensor(v):
        return v.to(device=dev, dtype=dtype)
    return torch.tensor(np.asarray(v), dtype=dtype, device=dev)


def as_device_operator(A, device: DeviceLike = None):
    """``A`` as an operator of ops/amatrix.py: operators pass through (they
    carry their device); a tensor becomes a :class:`DenseMatrix` on its own
    device unless ``device`` is given, a numpy array one on ``device``
    (``None``: ``RELP_TPU_TORCH_DEVICE``)."""
    if hasattr(A, "matvec"):
        return A
    if torch.is_tensor(A) and device is None:
        return DenseMatrix(A.to(F64))
    return DenseMatrix(_tensor(A, F64, resolve_device(device)))


def initial_state(basis0, vstat0, m: int, n: int, cfg: SolverConfig, dev) -> DState:
    """The state ``solve_core_dual`` starts from: placeholder inverse and
    derived vectors, a refactorization due before the first iteration."""
    def scalar(v):
        return torch.tensor(v, dtype=I64, device=dev)

    return DState(
        basis=_tensor(basis0, I64, dev).clone(),
        vstat=torch.cat([_tensor(vstat0, I64, dev),
                         torch.full((m,), st.NB_LOWER, dtype=I64, device=dev)]),
        xB=torch.zeros(m, dtype=F64, device=dev),
        Binv=torch.eye(m, dtype=F64, device=dev),
        pi=torch.zeros(m, dtype=F64, device=dev),
        d=torch.zeros(n, dtype=F64, device=dev),
        beta=torch.ones(m, dtype=F64, device=dev),
        status=scalar(st.RUNNING), it=scalar(0),
        since_refactor=scalar(cfg.refactor_period),  # refactor first
        repairs=scalar(0), flips=scalar(0),
    )


def _loop(K: DualKernel, s: DState, graph: StepGraph | None,
          warm: _WarmStart | None = None) -> DState:
    """The host loop from ``s``: one read of the packed flags per iteration,
    a refactorization whenever they ask for one (the start state does; with
    ``warm``, the start's goes through it), then an eager step, or with
    ``graph`` a replay of it."""
    if graph is not None:
        Ks = graph.load(K)
    refactor = K.refactor if warm is None else warm.refactor
    flags = K.flags(s)
    while True:
        with span("dual.read"):
            running, refactor_due, *told = K._read(flags if warm is None else warm.ask(flags))
        if told:
            warm.told(told[0])
        if not running:
            break
        if refactor_due:
            s = refactor(s)
            if graph is not None:
                s = graph.enter(K, Ks, s)
        if graph is None:
            s, flags = K.step(s)
        else:
            with span("dual.step"):
                flags = graph.replay()
            K.graph_steps += 1
            K.update_kernel_steps += graph.update_launches
    if graph is not None:
        # nothing returned is a static tensor; B⁻¹ the closing
        # refactorization makes anew
        s = dataclasses.replace(s, **{f.name: getattr(s, f.name).clone()
                                      for f in dataclasses.fields(DState) if f.name != "Binv"})
    return s


def solve_core_dual(
    A, b, c, lb, ub, basis0, vstat0, cfg: SolverConfig, max_iter: int,
    art_sign0=None, device: DeviceLike = None, final_state: list | None = None,
    keep_start: bool = False,
) -> SolveOutput:
    """Dual simplex from a dual-feasible warm basis (padded arrays as in
    ``solve_core``; numpy arrays or tensors, ``A`` an operator, a tensor or a
    numpy matrix).  The solve runs on ``A``'s device when ``A`` is an operator
    or a tensor, else on ``device``.  If the start is not dual feasible the
    method may stop at a dual-infeasible point: callers fall back to the
    primal core on a NUMERICAL or ITERATION_LIMIT outcome.

    ``art_sign0`` carries the artificial column signs of a prior primal
    solve (``SolveOutput.art_sign``): the primal engine's artificial columns
    are *signed* ±e_i, and a basis containing a sign −1 artificial (on a
    redundant row, say) must be refactorized with that sign or B is wrong on
    those rows.  ``final_state``, a list, receives ``(kernel, state)``: the
    :class:`DualKernel` with the problem's tensors and the final
    :class:`DState` (after the closing refactorization), what ``check_state``
    takes.  ``keep_start`` (warm re-solves, ``reoptimize_with_bounds``):
    start from the B⁻¹ kept for this start on ``A`` if there is one, else
    keep the one the start makes (:class:`StartInverse`, one per operator:
    an m² copy that lives as long as ``A``).

    On a CUDA device the iterations replay a captured step, and solves on
    one device run one at a time: a solve waits for one that another thread
    runs there to end.
    """
    with span("dual.solve"):
        A = as_device_operator(A, device)
        m, n = A.shape
        dev = A.device
        b, c, lb, ub = (_tensor(v, F64, dev) for v in (b, c, lb, ub))
        art_sign = (torch.ones(m, dtype=F64, device=dev) if art_sign0 is None
                    else _tensor(art_sign0, F64, dev))
        K = DualKernel(A, b, c, lb, ub, art_sign, cfg, max_iter)
        s = initial_state(basis0, vstat0, m, n, cfg, dev)
        graphed = _graphable(A)
        # a graphed solve holds its device's lock from loading the static
        # inputs to the closing refactorization's read of the static B⁻¹
        with _LOCKS.setdefault(dev, threading.Lock()) if graphed else contextlib.nullcontext():
            warm = _WarmStart(K, s, graphed) if keep_start else None
            s = _loop(K, s, step_graph(K) if graphed else None, warm)
            s = dataclasses.replace(
                s, status=torch.where(s.status == st.RUNNING, st.ITERATION_LIMIT, s.status))
            # clean final refactorization for extraction
            s = K.refactor(s)
        count(refactorizations=K.refactorizations, inverse_rebuilds=K.inverse_rebuilds,
              start_inverse_hits=K.start_inverse_hits, graph_steps=K.graph_steps,
              graph_captures=K.graph_captures, update_kernel_steps=K.update_kernel_steps,
              inverse_bytes=m * m * F64.itemsize)
        if final_state is not None:
            final_state.append((K, s))

        with span("dual.extract"):
            nb = _nonbasic_values(s.vstat, K.lb_tot, K.ub_tot)
            nb = torch.where(s.vstat == st.BASIC, 0.0, nb)
            x_pad = torch.zeros(n + 1, dtype=F64, device=dev)
            x_pad[:n] = nb[:n]
            structural = s.basis < n
            x_pad[torch.where(structural, s.basis, n)] = torch.where(structural, s.xB, 0.0)
            x = x_pad[:n]
            return SolveOutput(
                x=x, status=s.status, it=s.it, phase=torch.full_like(s.it, 2), basis=s.basis,
                vstat=s.vstat, art_inf=torch.where(~structural, s.xB.abs(), 0.0).sum(),
                pi=s.pi, obj=c @ x, art_sign=art_sign, host_reads=K.host_reads,
                trace=torch.zeros((0, 8), dtype=F32, device=dev),
                viol=torch.zeros((), dtype=F64, device=dev), flips=s.flips,
            )
