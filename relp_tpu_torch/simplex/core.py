"""The two-phase bounded-variable revised simplex core (primal).

Port of ``relp_tpu/simplex/core.py::solve_core`` for ``algorithm="primal"``
with both inverse backends.  The arithmetic of one iteration is the JAX loop
body's, in the same order: devex/Dantzig/Bland pricing over the whole column
pool or one block of it (f32 scan with f64 confirmation under
``mixed_pricing``), FTRAN against the basis inverse, the Harris two-pass
ratio test with bound flips, the update of the inverse with the incremental
π, and the devex weight update.  The phase, status and pivot choices stay
on the device as ``torch.where`` selects, so the step is straight-line.

Two inverse backends (``cfg.inverse``):

- ``"dense"``: the explicit B⁻¹, updated IN PLACE by one rank-1 step per
  pivot.
- ``"eta"``: the block product form.  Pivots compose into a pending block
  ``etaZ[m, T]`` / ``etaR[T]`` with the current inverse
  ``(I + etaZ·Pᵀ)·B⁻¹`` (P's columns ``e_{etaR[i]}``), folded into B⁻¹ by
  one (m,T)@(T,m) product once ``T = cfg.eta_block`` pivots are pending.

The loop has the shape of the JAX package's externally refactorized form
(``_make_primal_kernel(external=True)``): the step never refactorizes; the
HOST runs :meth:`PrimalKernel.refactor` when ``since_refactor`` reaches
``refactor_period``, :meth:`PrimalKernel.fold_etas` when the eta block is
full, and :meth:`PrimalKernel.repair` when the step asks for it.  The
numerical watchdog is evaluated at the end of each step, on the state the
next iteration starts from, so a refactorization it asks for runs before
the next pivot, as in the JAX package's in-loop form.

Host reads per iteration: one read of the packed loop flags (running,
refactor due, repair due, fold due) and, under ``mixed_pricing``, one read
of the f64 confirmation of the f32 candidate (of the block's candidate
under partial pricing; a block without a confirmed candidate falls back to
the full mixed pass and its own confirmation).  A refactorization adds one
or two (the polish residual check, the LU's minimum pivot).  The host
counts the iterations itself, so the partial-pricing block, the periodic
invariant check (``check_every_n``) and the row of the per-iteration trace
(``trace_iters``, written on the device) need no read.

Artificial variables occupy the virtual columns ``[n, n+m)``; they are
never materialized: artificial column ``i`` is ``art_sign[i]·e_i``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from relp_tpu_torch.ops.amatrix import as_amatrix
from relp_tpu_torch.ops.linalg import inverse_residual, lu_inverse, rank_one_basis_update
from relp_tpu_torch.simplex import status as st
from relp_tpu_torch.utils.config import SolverConfig

F64 = torch.float64
F32 = torch.float32
I64 = torch.int64
INF = float("inf")


@dataclasses.dataclass
class State:
    """Loop state; every field is a tensor on the solve's device."""

    basis: torch.Tensor           # i64[m] — column index in [0, n+m) per row
    vstat: torch.Tensor           # i64[n+m]
    xB: torch.Tensor              # f64[m] — values of the basic variables
    Binv: torch.Tensor            # f64[m, m] — updated in place
    pi: torch.Tensor              # f64[m] — simplex multipliers, incremental
    art_sign: torch.Tensor        # f64[m]
    phase: torch.Tensor           # i64 scalar: 1 or 2
    status: torch.Tensor          # i64 scalar
    it: torch.Tensor              # i64 — pivots and flips performed
    since_refactor: torch.Tensor  # i64
    degen_count: torch.Tensor     # i64 — consecutive degenerate steps
    bland: torch.Tensor           # bool — Bland's rule active
    repairs: torch.Tensor         # i64 — singular-basis repairs performed
    w: torch.Tensor               # f64[n] — devex reference weights
    broken: torch.Tensor          # bool — the watchdog's verdict on this state
    # pending eta block in composed form (inverse="eta"; None otherwise):
    # current B⁻¹ = (I + etaZ·Pᵀ)·Binv, P's columns e_{etaR[i]}
    etaZ: Optional[torch.Tensor] = None       # f64[m, T]
    etaR: Optional[torch.Tensor] = None       # i64[T]
    eta_count: Optional[torch.Tensor] = None  # i64 — live pending etas


class SolveOutput(NamedTuple):
    x: torch.Tensor         # f64[n] — solution in scaled space
    status: torch.Tensor    # i64
    it: torch.Tensor        # i64
    phase: torch.Tensor     # i64
    basis: torch.Tensor     # i64[m]
    vstat: torch.Tensor     # i64[n+m]
    art_inf: torch.Tensor   # f64 — residual artificial mass
    pi: torch.Tensor        # f64[m] — phase-2 simplex multipliers
    obj: torch.Tensor       # f64 — c @ x in the solver's (scaled, min) space
    art_sign: torch.Tensor  # f64[m]
    host_reads: int         # device-to-host reads made by the loop
    # f32[it, 8] — one row per iteration (cfg.trace_iters; zero rows when
    # off): [phase, cB·xB, art_mass, d_q, theta, events, q, r] with events =
    # pivot | 2·flip | 4·fresh inverse | 8·Bland, the JAX package's columns
    trace: torch.Tensor
    viol: torch.Tensor      # f64 — worst periodic-invariant violation (0 if off)


def _nonbasic_values(vstat, lb_tot, ub_tot):
    """Value of each column when nonbasic (0 for basic and free columns)."""
    at_lower = (vstat == st.NB_LOWER) | (vstat == st.NB_FIXED)
    at_upper = vstat == st.NB_UPPER
    return torch.where(at_lower, lb_tot, torch.where(at_upper, ub_tot, 0.0))


def _at(x, i):
    """``x[i]`` for a 0-dim index tensor, without a host read."""
    return x.index_select(0, i.reshape(1))[0]


def _put(x, i, v):
    """``x[i] = v`` in place for a 0-dim index tensor."""
    return x.index_copy_(0, i.reshape(1), v.reshape(1).to(x.dtype))


class PrimalKernel:
    """The primal engine over one fixed, padded problem: :meth:`watchdog`,
    :meth:`step`, :meth:`refactor`, :meth:`fold_etas`, :meth:`repair`.
    ``A`` carries its f32 shadow when the config prices in f32.

    Besides the problem it holds the loop's host-side counters: the number
    of steps taken (``steps``, equal to the state's ``it``), the host reads,
    the periodic check's worst violation and the trace buffers."""

    def __init__(self, A, b, c, lb, ub, cfg: SolverConfig, max_iter: int):
        self.A, self.b, self.c, self.lb, self.ub = A, b, c, lb, ub
        self.cfg = cfg
        self.max_iter = max_iter
        self.m, self.n = A.shape
        self.dev = A.device
        zeros_m = torch.zeros(self.m, dtype=F64, device=self.dev)
        self.lb_tot = torch.cat([lb, zeros_m])
        self.ub_tot_p2 = torch.cat([ub, zeros_m])  # artificials pinned to 0 in phase 2
        self.can_enter = lb < ub                    # fixed + padded columns never enter
        self.col_ids = torch.arange(self.n, device=self.dev)
        self.rows_m = torch.arange(self.m, device=self.dev)
        self.use_eta = cfg.inverse == "eta"
        # partial pricing needs the f32 scan and equal blocks (core.py:409-411)
        self.use_blocks = (cfg.price_blocks > 1 and cfg.mixed_pricing
                           and self.n % cfg.price_blocks == 0)
        self.steps = 0
        self.host_reads = 0
        self.viol = torch.zeros((), dtype=F64, device=self.dev)
        # trace rows land in buffers of trace_capacity rows, a new buffer
        # once one is full, so a solve of any length keeps every row
        self.trace_cap = cfg.trace_capacity if cfg.trace_iters else 0
        self._trace_full: list[torch.Tensor] = []
        self._trace_buf = torch.zeros((self.trace_cap, 8), dtype=F32, device=self.dev)

    def _read(self, t: torch.Tensor):
        """Bring a small tensor to the host (one synchronisation)."""
        self.host_reads += 1
        return t.tolist()

    def art_mass(self, s: State):
        return torch.where(s.basis >= self.n, s.xB.abs(), 0.0).sum()

    def eta0(self) -> dict:
        """An empty pending eta block (nothing for the dense inverse)."""
        if not self.use_eta:
            return {}
        T = self.cfg.eta_block
        return dict(
            etaZ=torch.zeros((self.m, T), dtype=F64, device=self.dev),
            etaR=torch.zeros(T, dtype=I64, device=self.dev),
            eta_count=torch.zeros((), dtype=I64, device=self.dev),
        )

    def basis_matrix(self, basis, art_sign):
        """The m×m basis B: structural columns from A, artificial column
        ``n + i`` as ``art_sign[i]·e_i``."""
        n, m = self.n, self.m
        is_art = basis >= n
        struct_cols = self.A.cols_matrix(basis.clamp(0, n - 1))
        k = (basis - n).clamp(0, m - 1)
        art_cols = (self.rows_m[:, None] == k[None, :]) * art_sign[k][None, :]
        return torch.where(is_art[None, :], art_cols, struct_cols)

    def trace(self) -> torch.Tensor:
        """The recorded trace rows, f32[steps, 8]."""
        if not self.trace_cap:
            return torch.zeros((0, 8), dtype=F32, device=self.dev)
        tail = self.steps - self.trace_cap * len(self._trace_full)
        return torch.cat(self._trace_full + [self._trace_buf[:tail]])

    # ---- basis repair: warm phase-1 restart from the artificial basis ----
    def repair(self, s: State) -> State:
        """The maintained basis went numerically singular (or a warm basis
        was infeasible): demote every basic structural column to a nonbasic
        status, put the artificials back, resume in phase 1 under Bland."""
        n, m = self.n, self.m
        lb_tot, ub_tot = self.lb_tot, self.ub_tot_p2
        demote = torch.where(
            lb_tot == ub_tot,
            st.NB_FIXED,
            torch.where(
                torch.isfinite(lb_tot),
                st.NB_LOWER,
                torch.where(torch.isfinite(ub_tot), st.NB_UPPER, st.NB_FREE),
            ),
        )
        vstat = torch.where(s.vstat == st.BASIC, demote, s.vstat)
        vstat[n:] = st.BASIC
        x0 = _nonbasic_values(vstat[:n], self.lb, self.ub)
        r0 = self.b - self.A.matvec(x0)
        sign = torch.where(r0 >= 0, 1.0, -1.0).to(F64)
        repairs = s.repairs + 1
        return dataclasses.replace(
            s,
            basis=n + torch.arange(m, device=self.dev),
            vstat=vstat,
            xB=r0.abs(),
            Binv=torch.diag(sign),
            pi=sign.clone(),
            art_sign=sign,
            phase=torch.ones_like(s.phase),
            since_refactor=torch.zeros_like(s.since_refactor),
            degen_count=torch.zeros_like(s.degen_count),
            bland=torch.ones_like(s.bland),
            repairs=repairs,
            status=torch.where(repairs > 3, st.NUMERICAL, s.status),
            w=torch.ones(n, dtype=F64, device=self.dev),
            **self.eta0(),
        )

    # ---- block product-form fold (inverse="eta") ----
    def fold_etas(self, s: State) -> State:
        """B⁻¹ ← B⁻¹ + etaZ·B⁻¹[etaR] (in place), and an empty block."""
        s.Binv.addmm_(s.etaZ, s.Binv.index_select(0, s.etaR))
        return dataclasses.replace(s, **self.eta0())

    # ---- refactorization ----
    def refactor(self, s: State) -> State:
        cfg, n = self.cfg, self.n
        B = self.basis_matrix(s.basis, s.art_sign)
        Binv = None
        if cfg.refactor_mode == "polish":
            # one Newton-Schulz step on the maintained inverse (pending etas
            # folded in) against the clean basis columns, X1 = X(2I − BX); a
            # failed residual check (singular basis, placeholder warm
            # inverse) rebuilds instead
            X = s.Binv
            if self.use_eta:
                X = X + s.etaZ @ X.index_select(0, s.etaR)
            X1 = X @ (2.0 * torch.eye(self.m, dtype=F64, device=self.dev) - B @ X)
            resid = inverse_residual(B, X1)
            healthy = torch.isfinite(resid) & (resid < 1e-9)
            if self._read(healthy):
                Binv = X1
        if Binv is None:
            Binv, min_piv = lu_inverse(B)
            # NaN-safe: a NaN pivot must route to repair (NaN >= tol is False)
            if not self._read(min_piv >= cfg.singular_tol):
                return self.repair(s)

        is_art = s.basis >= n
        nb = _nonbasic_values(s.vstat, self.lb_tot, self.ub_tot_p2)
        nb = torch.where(s.vstat == st.BASIC, 0.0, nb)
        r = self.b - self.A.matvec(nb[:n])  # nonbasic artificials sit at 0
        xB = Binv @ r
        phase1 = s.phase == 1
        c_eff = torch.where(phase1, 0.0, self.c)
        cB = torch.where(
            is_art,
            torch.where(phase1, 1.0, 0.0).to(F64),
            c_eff[s.basis.clamp(0, n - 1)],
        )
        pi = cB @ Binv
        # snap residual artificial levels (<= eps_feas) to exactly 0
        xB = torch.where(is_art & (xB.abs() <= cfg.eps_feas), 0.0, xB)
        # devex reference-framework reset once weights have grown large
        w = torch.where(s.w.max() > 1e6, torch.ones_like(s.w), s.w)
        return dataclasses.replace(
            s, Binv=Binv, xB=xB, pi=pi, w=w,
            since_refactor=torch.zeros_like(s.since_refactor), **self.eta0(),
        )

    # ---- numerical watchdog ----
    def watchdog(self, s: State):
        """The JAX body's opening check: a non-finite state, or |B⁻¹| (or the
        pending etas) blowing past 1e14 on a stale inverse, forces a
        refactorization (or gives up with NUMERICAL right after one).
        Returns the checked state and the packed loop condition (running,
        refactor due[, fold due]) evaluated as the JAX loop would:
        ``running`` on the state BEFORE the check."""
        cfg = self.cfg
        running = (s.status == st.RUNNING) & (s.it < self.max_iter)
        binv_mag = s.Binv.abs().max()
        if self.use_eta:
            binv_mag = torch.maximum(binv_mag, s.etaZ.abs().max())
        state_sum = s.xB.sum() + s.pi.sum()
        broken = (
            ~torch.isfinite(state_sum)
            | ~torch.isfinite(binv_mag)
            | ((binv_mag > 1e14) & (s.since_refactor > 0))
        )
        since = torch.where(broken, cfg.refactor_period, s.since_refactor)
        s = dataclasses.replace(
            s,
            status=torch.where(broken & (s.since_refactor == 0), st.NUMERICAL, s.status),
            since_refactor=since,
            broken=broken,
        )
        flags = [running, since >= cfg.refactor_period]
        if self.use_eta:
            flags.append(s.eta_count >= cfg.eta_block)
        return s, torch.stack(flags)

    # ---- one iteration (after watchdog, refactorization and fold) ----
    def _select(self, d, s: State, vs, lo: int = 0):
        """Best entering candidate among the columns ``[lo, lo+len(d))``
        (``vs`` their statuses); returns (q, has) as 0-dim tensors."""
        cfg, n = self.cfg, self.n
        hi = lo + d.shape[0]
        free = vs == st.NB_FREE
        imp_l = ((vs == st.NB_LOWER) | free) & (d < -cfg.eps_dual)
        imp_u = ((vs == st.NB_UPPER) | free) & (d > cfg.eps_dual)
        viol = torch.where(imp_l, -d, 0.0) + torch.where(imp_u, d, 0.0)
        viol = torch.where(self.can_enter[lo:hi] & (vs != st.BASIC), viol, 0.0)
        score = viol * viol / s.w[lo:hi] if cfg.pricing == "devex" else viol
        j_best = torch.argmax(score)
        # the ids ascend, so the masked argmin is the smallest improving id
        j_bland = torch.argmin(torch.where(viol > 0, self.col_ids[lo:hi], n))
        j = torch.where(s.bland, j_bland, j_best)
        has = _at(viol, j) > 0
        return (j + lo if lo else j), has

    def _confirm64(self, c_eff, pi, vs, q, has):
        """f64 confirmation of an f32-chosen candidate's reduced cost."""
        eps = self.cfg.eps_dual
        d_q64 = _at(c_eff, q) - self.A.col_dot(pi, q)
        vq = _at(vs, q)
        ok = has & (
            torch.where(vq == st.NB_UPPER, d_q64 > eps, d_q64 < -eps)
            | ((vq == st.NB_FREE) & (d_q64.abs() > eps))
        )
        return d_q64, ok

    def _price(self, s: State, c_eff, vs):
        """Entering column ``(q, has_entering, d_q)``: partial, mixed or f64
        pricing as the config says (JAX core.py:371-439)."""
        A, cfg, n = self.A, self.cfg, self.n
        pi = s.pi

        def price_f64():
            d = A.price(c_eff, pi)
            q, has = self._select(d, s, vs)
            return q, has, _at(d, q)

        def price_full_mixed():
            # scan in f32, confirm the chosen column's reduced cost in f64,
            # and fall back to a full f64 pass when the scan finds nothing
            # or its candidate fails confirmation (near optimality); OPTIMAL
            # is only ever declared off the f64 path
            d32 = A.price32(c_eff.float(), pi.float()).to(F64)
            q32, has32 = self._select(d32, s, vs)
            d_q64, confirmed = self._confirm64(c_eff, pi, vs, q32, has32)
            if self._read(confirmed):
                return q32, confirmed, d_q64
            return price_f64()

        if self.use_blocks:
            # block-cyclic partial pricing: scan one block of columns this
            # iteration; the full mixed pass when it offers no confirmed
            # candidate
            bsize = n // cfg.price_blocks
            bstart = (self.steps % cfg.price_blocks) * bsize
            win = slice(bstart, bstart + bsize)
            d32b = A.price32(c_eff[win].float(), pi.float(), bstart, bsize).to(F64)
            qb, has_b = self._select(d32b, s, vs[win], lo=bstart)
            d_qb, confirmed_b = self._confirm64(c_eff, pi, vs, qb, has_b)
            if self._read(confirmed_b):
                return qb, confirmed_b, d_qb
            return price_full_mixed()
        if cfg.mixed_pricing:
            return price_full_mixed()
        return price_f64()

    def _check_violation(self, s: State, phase1):
        """Worst BFS-invariant violation of ``s``: the row residual of the
        current point and the basic-bound violation (JAX core.py:653-681)."""
        n, m = self.n, self.m
        lb_tot, ub_tot = self.lb_tot, self.ub_tot_p2
        nbv = _nonbasic_values(s.vstat, lb_tot, ub_tot)
        nbv = torch.where(s.vstat == st.BASIC, 0.0, nbv)
        xx = torch.zeros(n + 1, dtype=F64, device=self.dev)
        xx[:n] = nbv[:n]
        structural = s.basis < n
        xx[torch.where(structural, s.basis, n)] = torch.where(structural, s.xB, 0.0)
        kk = (s.basis - n).clamp(0, m - 1)
        artc = torch.zeros(m, dtype=F64, device=self.dev).index_add_(
            0, kk, torch.where(~structural, s.art_sign[kk] * s.xB, 0.0))
        row_res = (self.A.matvec(xx[:n]) + artc - self.b).abs().max()
        lbv = lb_tot[s.basis]
        ubv = torch.where(~structural & phase1, INF, ub_tot[s.basis])
        bviol = torch.maximum(torch.maximum(lbv - s.xB, s.xB - ubv), torch.zeros_like(lbv)).max()
        return torch.maximum(row_res, bviol)

    def step(self, s: State):
        """One pivot, bound flip or no-op.  Returns ``(state, needs_repair)``.
        Under the dense inverse ``s.Binv`` is updated in place."""
        A, cfg, n, m = self.A, self.cfg, self.n, self.m
        lb, ub, c = self.lb, self.ub, self.c
        lb_tot, ub_tot = self.lb_tot, self.ub_tot_p2
        period = cfg.refactor_period
        use_eta = self.use_eta

        # phase transition: artificial mass numerically zero => real costs.
        # Only on a fresh state; the switch invalidates the phase-1 duals, so
        # it forces a refactorization and this iteration performs no pivot.
        art_mass = self.art_mass(s)
        transition = (s.phase == 1) & (s.since_refactor == 0) & (art_mass <= cfg.eps_feas)
        phase = torch.where(transition, 2, s.phase)
        since_refactor = torch.where(transition, period, s.since_refactor)
        phase1 = phase == 1
        c_eff = torch.where(phase1, 0.0, c)
        pi = s.pi
        vs = s.vstat[:n]

        q, has_entering, d_q = self._price(s, c_eff, vs)

        # ---- ratio test ----
        vq = _at(vs, q)
        t = torch.where(
            vq == st.NB_UPPER, -1.0,
            torch.where(vq == st.NB_FREE, -torch.sign(d_q), 1.0),
        ).to(F64)
        u = A.ftran(s.Binv, q)  # B⁻¹ a_q
        if use_eta:
            # current inverse = (I + Z·Pᵀ)·Binv → u += Z·u[etaR]
            u = u + s.etaZ @ u.index_select(0, s.etaR)
        ut = t * u

        k = s.basis
        is_art_k = k >= n
        lbk = lb_tot[k]
        ubk = torch.where(is_art_k & phase1, INF, ub_tot[k])  # artificials free upward in phase 1

        # Harris two-pass: pass 1 finds the largest step violating no basic
        # bound by more than delta; pass 2 picks the largest |pivot| whose
        # strict ratio fits within it
        delta = cfg.harris_delta
        pos = ut > cfg.eps_pivot
        neg = ut < -cfg.eps_pivot
        strict = torch.where(pos, (s.xB - lbk) / ut,
                             torch.where(neg, (s.xB - ubk) / ut, INF)).clamp_min(0.0)
        relaxed = torch.where(pos, (s.xB - lbk + delta) / ut,
                              torch.where(neg, (s.xB - ubk - delta) / ut, INF)).clamp_min(0.0)
        theta_max = relaxed.min()
        lbq, ubq = _at(lb, q), _at(ub, q)
        bound_range = ubq - lbq
        start_val = torch.where(vq == st.NB_UPPER, ubq,
                                torch.where(vq == st.NB_LOWER, lbq, 0.0))

        aut = ut.abs()
        elig = strict <= theta_max
        r_stab = torch.argmax(torch.where(elig, aut, -1.0))
        # Bland mode: smallest basis index among minimal-ratio rows, but never
        # on a relatively tiny pivot
        elig_b = strict <= strict.min() + cfg.eps_ratio
        max_piv_b = torch.where(elig_b, aut, 0.0).max()
        elig_b = elig_b & (aut >= 0.01 * max_piv_b)
        r_bland = torch.argmin(torch.where(elig_b, k, n + m))
        r = torch.where(s.bland, r_bland, r_stab)

        theta_piv = _at(strict, r)
        theta = torch.minimum(theta_piv, bound_range)
        can_step = torch.isfinite(theta)
        flip = bound_range < theta_piv
        do_update = has_entering & can_step & ~transition
        is_pivot = do_update & ~flip
        is_flip = do_update & flip
        theta_safe = torch.where(can_step, theta, 0.0)

        # ---- update (computed unconditionally, selected) ----
        xB_moved = s.xB - theta_safe * ut
        xB_piv = _put(xB_moved.clone(), r, start_val + t * theta_safe)
        p = _at(u, r)
        p_safe = torch.where(p.abs() > 0, p, 1.0)
        cur_row_r = s.Binv.index_select(0, r.reshape(1))[0]
        if use_eta:
            # row r of the CURRENT inverse (Binv + pending etas)
            cur_row_r = cur_row_r + s.etaZ.index_select(0, r.reshape(1))[0] @ \
                s.Binv.index_select(0, s.etaR)
        w_row = cur_row_r / p_safe

        kr = _at(k, r)
        leave_stat = torch.where(
            _at(lb_tot, kr) == _at(ub_tot, kr),
            st.NB_FIXED,
            torch.where(_at(ut, r) > 0, st.NB_LOWER, st.NB_UPPER),
        )
        flip_stat = torch.where(vq == st.NB_LOWER, st.NB_UPPER, st.NB_LOWER)
        vstat = s.vstat
        new_kr_stat = torch.where(is_pivot, leave_stat, _at(vstat, kr))
        new_q_stat = torch.where(is_pivot, st.BASIC, torch.where(is_flip, flip_stat, vq))
        vstat = _put(_put(vstat.clone(), kr, new_kr_stat), q, new_q_stat)

        xB_new = torch.where(is_pivot, xB_piv, torch.where(is_flip, xB_moved, s.xB))
        basis_new = _put(k.clone(), r, torch.where(is_pivot, q, kr))
        pi_new = torch.where(is_pivot, pi + d_q * w_row, pi)

        if cfg.pricing == "devex":
            # devex reference weights (Harris 1973) with the pivot row
            # α = (B⁻¹A)[r,:] in f32 (the weights are heuristic):
            #   w_j ← max(w_j, (α_j/α_q)² w_q),  w_leaving ← max(w_q/α_q², 1)
            alpha = A.rmatvec32(cur_row_r.float()).to(F64)
            inv_p = 1.0 / torch.where(p.abs() > 1e-12, p, 1.0)
            ratio2 = ((alpha * inv_p) ** 2).clamp_max(1e8)
            wq = _at(s.w, q).clamp_max(1e8)
            cand = (ratio2 * wq).clamp_max(1e8)
            w_upd = _put(torch.maximum(s.w, cand), q, torch.ones_like(wq))
            kr_in_n = kr.clamp_max(n - 1)
            w_upd = torch.where(
                self.col_ids == kr_in_n,
                torch.where(kr < n, (wq * inv_p * inv_p).clamp(1.0, 1e8), w_upd),
                w_upd,
            )
            w_new = torch.where(is_pivot, w_upd, s.w)
        else:
            w_new = s.w

        if use_eta:
            # push the new eta z = (e_r − u)/p in composed form:
            #   E_new·(I + Z·Pᵀ) = I + (Z + z⊗Z[r,:])·Pᵀ + z·e_rᵀ
            z = -u / p_safe
            z = _put(z, r, _at(z, r) + 1.0 / p_safe)
            Zc = s.etaZ + z[:, None] * s.etaZ.index_select(0, r.reshape(1))
            Zc = Zc.index_copy(1, s.eta_count.reshape(1), z[:, None])
            eta = dict(
                etaZ=torch.where(is_pivot, Zc, s.etaZ),
                etaR=torch.where(is_pivot, s.etaR.index_copy(
                    0, s.eta_count.reshape(1), r.reshape(1)), s.etaR),
                eta_count=s.eta_count + is_pivot.long(),
            )
        else:
            # B⁻¹ last: the selects above read the pre-pivot inverse
            rank_one_basis_update(s.Binv, u, r, apply=is_pivot)
            eta = {}

        degen = do_update & (theta_safe <= cfg.eps_zero)
        degen_count = torch.where(degen, s.degen_count + 1,
                                  torch.where(do_update, 0, s.degen_count))
        # Bland's rule engages after a run of degenerate pivots and
        # disengages as soon as a real step is taken again
        bland_new = torch.where(
            do_update,
            degen & (s.bland | (degen_count >= cfg.bland_trigger)),
            s.bland,
        )
        if cfg.pricing == "bland":
            bland_new = torch.ones_like(s.bland)

        # ---- status: terminal decisions only on a FRESH inverse ----
        fresh = since_refactor == 0
        wants_terminal = ~has_entering | (has_entering & ~can_step)
        art_ok = art_mass <= 10 * cfg.eps_feas
        xb_viol = torch.maximum(lb_tot[s.basis] - s.xB, s.xB - ub_tot[s.basis])
        xb_ok = torch.where(phase1 & (s.basis >= n), 0.0, xb_viol).max() <= 1e3 * cfg.eps_feas
        terminal_status = torch.where(
            phase1, st.INFEASIBLE, torch.where(art_ok, st.OPTIMAL, st.NUMERICAL))
        unb_status = torch.where(phase1, st.NUMERICAL, st.UNBOUNDED)
        status = s.status
        running = status == st.RUNNING
        status_new = torch.where(
            ~has_entering, terminal_status,
            torch.where(~can_step, unb_status, status))
        status_new = torch.where(fresh & ~transition, status_new, status)
        # a broken state must not masquerade as optimality/infeasibility
        status_new = torch.where(s.broken, status, status_new)
        status_new = torch.where(~running, status, status_new)
        # a bound-violating phase-2 terminal (infeasible warm basis) repairs
        needs_repair = (
            wants_terminal & fresh & ~transition & ~s.broken & ~phase1
            & ~xb_ok & running
        )
        status_new = torch.where(needs_repair, status, status_new)

        # ---- periodic in-loop invariant check (cfg.check_every_n) ----
        if cfg.check_every_n and self.steps % cfg.check_every_n == 0:
            self.viol = torch.maximum(self.viol, self._check_violation(s, phase1))

        # ---- per-iteration metric row (cfg.trace_iters), on the device ----
        if self.trace_cap:
            cBxB = torch.where(s.basis >= n, 0.0, c[s.basis.clamp(0, n - 1)]) @ s.xB
            events = (is_pivot.float() + 2.0 * is_flip.float()
                      + 4.0 * (since_refactor == 0).float() + 8.0 * s.bland.float())
            row = torch.stack([v.to(F32) for v in (
                phase, cBxB, art_mass, d_q, theta_safe, events, q, r)])
            slot = self.steps % self.trace_cap
            if slot == 0 and self.steps:
                self._trace_full.append(self._trace_buf)
                self._trace_buf = torch.zeros_like(self._trace_buf)
            self._trace_buf[slot] = row

        self.steps += 1
        s_out = dataclasses.replace(
            s,
            status=status_new,
            xB=xB_new,
            basis=basis_new,
            pi=pi_new,
            w=w_new,
            vstat=vstat,
            phase=phase,
            degen_count=degen_count,
            bland=bland_new,
            since_refactor=torch.where(
                wants_terminal & ~fresh & ~s.broken & ~transition,
                period,
                since_refactor + is_pivot.long(),
            ),
            it=s.it + 1,
            **eta,
        )
        return s_out, needs_repair


def solve_core(
    A, b, c, lb, ub, cfg: SolverConfig, max_iter: int, basis0=None,
    vstat0=None, slack_of_row=None, art_sign0=None, phase0=None,
) -> SolveOutput:
    """Solve  min c@x  s.t.  A@x == b, lb <= x <= ub  (f64 tensors, padded).

    ``A`` is an operator of ops/amatrix.py (or a dense tensor); every
    tensor lies on ``A.device``.  Padded columns must have lb == ub == 0
    and c == 0; padded rows must be zero in A with b == 0.

    Warm start: ``basis0`` (i64[m], entries >= n are artificials) and
    ``vstat0`` (statuses of the n columns), optionally ``art_sign0`` and
    ``phase0``; the inverse is refactorized from the given columns first,
    and a singular warm basis falls back to a phase-1 repair.
    """
    A = as_amatrix(A)
    m, n = A.shape
    dev = A.device
    if cfg.mixed_pricing or cfg.pricing == "devex":
        A = A.with_f32()
    K = PrimalKernel(A, b, c, lb, ub, cfg, max_iter)

    def scalar(v, dtype=I64):
        return torch.tensor(v, dtype=dtype, device=dev)

    common = dict(
        status=scalar(st.RUNNING), it=scalar(0), degen_count=scalar(0),
        bland=scalar(cfg.pricing == "bland", torch.bool), repairs=scalar(0),
        w=torch.ones(n, dtype=F64, device=dev), broken=scalar(False, torch.bool),
        **K.eta0(),
    )
    if basis0 is None:
        # ---- cold start: all-artificial basis ----
        vstat0_n = torch.where(
            lb == ub, st.NB_FIXED,
            torch.where(torch.isfinite(lb), st.NB_LOWER,
                        torch.where(torch.isfinite(ub), st.NB_UPPER, st.NB_FREE)),
        )
        vstat_full = torch.cat([vstat0_n, torch.full((m,), st.BASIC, dtype=I64, device=dev)])
        x0 = _nonbasic_values(vstat_full[:n], lb, ub)
        r0 = b - A.matvec(x0)
        art_sign = torch.where(r0 >= 0, 1.0, -1.0).to(F64)
        if slack_of_row is not None:
            # ---- slack crash: each row's slack column starts basic where
            # that gives a feasible value; phase 1 owns the other rows ----
            slack_of_row = torch.as_tensor(slack_of_row, device=dev).long()
            has_slack = slack_of_row >= 0
            scj = slack_of_row.clamp(0, n - 1)
            coeff = A.entries(K.rows_m, scj)
            ok_coeff = coeff.abs() > 1e-12
            r_excl = r0 + torch.where(has_slack, coeff * x0[scj], 0.0)
            s_val = r_excl / torch.where(ok_coeff, coeff, 1.0)
            feas = has_slack & ok_coeff & (s_val >= lb[scj]) & (s_val <= ub[scj])
            basis_init = torch.where(feas, scj, n + K.rows_m)
            vstat_full[basis_init] = st.BASIC
            xB0 = torch.where(feas, s_val, r0.abs())
            art_sign = torch.where(feas, 1.0, art_sign).to(F64)
            Binv0 = torch.diag(torch.where(feas, 1.0 / torch.where(ok_coeff, coeff, 1.0), art_sign))
            pi0 = torch.where(feas, 0.0, art_sign)
        else:
            basis_init = n + K.rows_m
            xB0 = r0.abs()
            Binv0 = torch.diag(art_sign)  # diag(±1) is its own inverse
            pi0 = art_sign.clone()        # phase-1 duals
        s = State(
            basis=basis_init, vstat=vstat_full, xB=xB0, Binv=Binv0, pi=pi0,
            art_sign=art_sign, phase=scalar(1), since_refactor=scalar(0),
            **common,
        )
    else:
        # ---- warm start from a caller-provided basis ----
        vstat_full = torch.cat([
            torch.as_tensor(vstat0, device=dev).long(),
            torch.full((m,), st.NB_LOWER, dtype=I64, device=dev),
        ])
        if art_sign0 is not None:
            art_sign = torch.as_tensor(art_sign0, device=dev).to(F64)
        else:
            x0w = _nonbasic_values(vstat_full[:n], lb, ub)
            x0w = torch.where(vstat_full[:n] == st.BASIC, 0.0, x0w)
            r0w = b - A.matvec(x0w)
            art_sign = torch.where(r0w >= 0, 1.0, -1.0).to(F64)
        s = State(
            basis=torch.as_tensor(basis0, device=dev).long().clone(),
            vstat=vstat_full,
            xB=torch.zeros(m, dtype=F64, device=dev),
            Binv=torch.eye(m, dtype=F64, device=dev),  # placeholder; refactor fires first
            pi=torch.zeros(m, dtype=F64, device=dev),
            art_sign=art_sign,
            phase=scalar(1 if phase0 is None else int(phase0)),
            since_refactor=scalar(cfg.refactor_period),  # force a refactorization
            **common,
        )

    # ---- the host loop ----
    # ``s`` is the watched state the next iteration starts from; ``final``
    # the same state before the watchdog, which is what the JAX loop hands
    # on when its condition fails
    def checked(state):
        state, flags = K.watchdog(state)
        running, refactor_due, fold_due = (K._read(flags) + [False])[:3]
        return state, running, refactor_due, fold_due

    final = s
    s, running, refactor_due, fold_due = checked(final)
    while running:
        if refactor_due:
            s = K.refactor(s)
        elif fold_due:
            s = K.fold_etas(s)
        final, needs_repair = K.step(s)
        s, flags = K.watchdog(final)
        repair_due, running, refactor_due, fold_due = (K._read(
            torch.cat([needs_repair.reshape(1), flags])) + [False])[:4]
        if repair_due:
            final = K.repair(final)
            s, running, refactor_due, fold_due = checked(final)

    s = dataclasses.replace(
        final,
        status=torch.where(final.status == st.RUNNING, st.ITERATION_LIMIT, final.status))
    # clean final refactorization for extraction
    s = K.refactor(s)

    # one step of iterative refinement on the basic solution:
    # xB += B⁻¹ (r − B xB) with B rebuilt from clean problem columns
    lb_tot, ub_tot = K.lb_tot, K.ub_tot_p2
    B_f = K.basis_matrix(s.basis, s.art_sign)
    nb = _nonbasic_values(s.vstat, lb_tot, ub_tot)
    nb = torch.where(s.vstat == st.BASIC, 0.0, nb)
    r_f = b - A.matvec(nb[:n])
    xB = s.xB + s.Binv @ (r_f - B_f @ s.xB)

    # ---- extract the solution vector ----
    x_pad = torch.zeros(n + 1, dtype=F64, device=dev)
    x_pad[:n] = nb[:n]
    structural = s.basis < n
    x_pad[torch.where(structural, s.basis, n)] = torch.where(structural, xB, 0.0)
    x = x_pad[:n]
    cB = torch.where(s.basis >= n, 0.0, c[s.basis.clamp(0, n - 1)])
    return SolveOutput(
        x=x, status=s.status, it=s.it, phase=s.phase, basis=s.basis,
        vstat=s.vstat, art_inf=K.art_mass(dataclasses.replace(s, xB=xB)),
        pi=cB @ s.Binv, obj=c @ x, art_sign=s.art_sign, host_reads=K.host_reads,
        trace=K.trace(), viol=K.viol,
    )
