"""Restarted adaptive PDHG (PDLP-style) for box-constrained LPs.

Port of ``relp_tpu/fom/pdhg.py``.  Solves  min cᵀx  s.t.  Ax = b,
lb ≤ x ≤ ub  (the scaled, padded computational form the simplex engine
consumes) by the Chambolle–Pock primal-dual iteration

    x⁺ = clip(x − (η/ω)(c − Aᵀy), lb, ub)
    y⁺ = y + (ηω)(b − A(2x⁺ − x))

with the stabilisations of PDLP (Applegate et al.): the adaptive step size
(accept a step only while η ≤ η̂ = ‖Δz‖²_ω / (2|ΔyᵀAΔx|), η tracking η̂ from
below), conditional restarts to the running average on sufficient KKT decay,
and the primal weight ω rebalanced at every restart (``variant="avg"``); or
the restarted reflected Halpern iteration  z⁺ = (1−β)(2T(z)−z) + β·z₀,
β = 1/(k+2), at a constant step size (``variant="halpern"``, Lu & Yang).
Termination is the relative KKT triple (primal residual, dual sign
violation against infinite bounds, normalised objective gap) below ``tol``.

Every step is two sparse products and O(n + m) vector work:
``A.price(c, y)`` is ``c − Aᵀy`` in one pricing kernel (``ell_price`` or
``dense_price`` with the subtraction fused), ``A.matvec(x)`` is ``ell_spmv``
on the ELL operator.  The vector updates are plain tensor code, as they are
plain ``jnp`` in the JAX package.

**A round reads nothing back from the device.**  The JAX round is one
``fori_loop`` with ``jnp.where`` for the accept/reject and restart
decisions; here a round is the same straight line of launches: the step
counter, the step size and every decision stay 0-dim tensors, the
step-dependent factors (β of the Halpern step, the two η schedule factors)
are computed for a whole round at once, and no value is turned into a
Python number.  Between two rounds the host reads one small vector (status,
iteration count, KKT, ω), where the ``cond`` of the JAX ``while_loop`` reads
the status.

The padded rows and columns of the computational form are inert: padded
columns have lb = ub = 0, padded rows are zero with b = 0 (their y stays 0).

**Lanes.**  Every function here also takes a fleet: vectors with a leading
lane axis (``[L, n]``, ``[L, m]``), per-lane scalars (η, ω, status, the
counters, the KKT) as ``[L]`` tensors, and a lane operator
(``LaneDenseMatrix``: one shared or a stacked dense A, priced through
``dense_price_lanes``), where the JAX package vmaps the single-LP code.  A
lane whose status is not RUNNING at the start of a round keeps its state,
as a lane whose vmapped ``cond`` is false keeps it in JAX; the host reads
the stacked per-lane scalars once per round.  :func:`solve_pdhg_batched`
is the JAX package's.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from relp_tpu_torch.ops.amatrix import as_amatrix
from relp_tpu_torch.simplex import status as st

INF = math.inf


class PdhgState(NamedTuple):
    x: torch.Tensor         # [n] current primal
    y: torch.Tensor         # [m] current dual
    ax: torch.Tensor        # [m] cached A·x
    x_sum: torch.Tensor     # [n] running sums since the last restart
    y_sum: torch.Tensor
    steps: torch.Tensor     # i32 accepted steps since the last restart
    x_anchor: torch.Tensor  # [n] point of the last restart (ω updates,
    y_anchor: torch.Tensor  #     Halpern anchor z₀)
    ax_anchor: torch.Tensor  # [m] cached A·x_anchor (Halpern combination)
    eta: torch.Tensor       # adaptive step size
    omega: torch.Tensor     # primal weight
    it: torch.Tensor        # i32 total inner iterations (incl. rejected)
    kkt: torch.Tensor       # last evaluated KKT (best candidate)
    kkt_mu: torch.Tensor    # KKT at the last restart
    status: torch.Tensor    # i32 RUNNING / OPTIMAL / ITERATION_LIMIT


def _c(t):
    """A per-lane scalar ``[L]`` as a column ``[L, 1]`` against ``[L, k]``
    vectors; a 0-dim scalar as it is."""
    return t.unsqueeze(-1) if torch.is_tensor(t) and t.dim() else t


def _dot(a, b):
    """``a·b`` of one vector (0-dim) or of every lane (``[L]``)."""
    return a @ b if a.dim() == 1 else (a * b).sum(-1)


def _lane_op(A):
    from relp_tpu_torch.ops.amatrix import LaneDenseMatrix

    return A if isinstance(A, LaneDenseMatrix) else as_amatrix(A)


def _power_norm(A, iters: int = 30, lanes: Optional[int] = None) -> torch.Tensor:
    """‖A‖₂ by power iteration on AᵀA, as a 0-dim tensor (``[L]`` for the
    ``lanes`` lanes of a lane operator)."""
    A = _lane_op(A)
    m, n = A.shape
    # deterministic quasi-random start: a constant vector can lie exactly in
    # null(A) (balanced rows), the iteration then collapses to its floor and
    # η comes out far too large
    i = torch.arange(n, dtype=A.dtype, device=A.device)
    v = torch.cos(1.7 * i + 0.3) + 0.5
    v = v / torch.linalg.vector_norm(v)
    if lanes is not None:
        v = v.expand(lanes, n).contiguous()
    for _ in range(iters):
        w = A.rmatvec(A.matvec(v))
        v = w / torch.linalg.vector_norm(w, dim=-1, keepdim=True).clamp_min(1e-300)
    return torch.linalg.vector_norm(A.rmatvec(A.matvec(v)), dim=-1).clamp_min(1e-12).sqrt()


def _kkt(A, b, c, lb, ub, x, y) -> torch.Tensor:
    """Relative KKT residual of (x, y), the PDLP termination triple, in the
    tensors' own precision."""
    r_prim = (A.matvec(x) - b).abs().amax(-1) / (1.0 + b.abs().amax(-1))
    z = A.price(c, y)
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    lb_fin, ub_fin = torch.isfinite(lb), torch.isfinite(ub)
    pos, neg = z > 0, z < 0
    # dual feasibility: z > 0 demands a finite lower bound, z < 0 a finite
    # upper bound; violations are the z-mass against infinite bounds
    viol = torch.where(pos & ~lb_fin, z, torch.where(neg & ~ub_fin, -z, zero))
    r_dual = viol.amax(-1) / (1.0 + c.abs().amax(-1))
    p_obj = _dot(c, x)
    # dual objective bᵀy + Σ lb_j·z_j⁺ + Σ ub_j·z_j⁻ over finite bounds
    d_obj = (
        _dot(b, y)
        + torch.where(pos & lb_fin, lb * z, zero).sum(-1)
        + torch.where(neg & ub_fin, ub * z, zero).sum(-1)
    )
    gap = (p_obj - d_obj).abs() / (1.0 + p_obj.abs() + d_obj.abs())
    return torch.maximum(torch.maximum(r_prim, r_dual), gap)


def kkt_residual(A, b, c, lb, ub, x, y) -> torch.Tensor:
    """Relative KKT of a point in the tensors' own precision: the driver's
    mixed-precision loop holds f32-stage iterates against the f64 operator
    through this (cast x and y up before calling)."""
    return _kkt(_lane_op(A), b, c, lb, ub, x, y)


def cast_state(state: PdhgState, A, dtype) -> PdhgState:
    """Re-express a PDHG state in ``dtype`` against operator ``A``.

    Float leaves are cast; the cached A·x products are recomputed in the
    target precision (a cached f32 product carries f32 error that would
    contaminate every later f64 step)."""
    A = _lane_op(A)
    x = state.x.to(dtype)
    xa = state.x_anchor.to(dtype)
    return state._replace(
        x=x,
        y=state.y.to(dtype),
        ax=A.matvec(x),
        x_sum=state.x_sum.to(dtype),
        y_sum=state.y_sum.to(dtype),
        x_anchor=xa,
        y_anchor=state.y_anchor.to(dtype),
        ax_anchor=A.matvec(xa),
        eta=state.eta.to(dtype),
        omega=state.omega.to(dtype),
        kkt=state.kkt.to(dtype),
        kkt_mu=state.kkt_mu.to(dtype),
    )


def initial_state(A, lb, ub, eta0, dtype=torch.float64) -> PdhgState:
    """The start of a solve: x the box's point nearest 0, y = 0.  With
    ``lb``/``ub`` of shape ``[L, n]`` (and a lane operator) the state of L
    lanes; ``eta0`` is then one value or ``[L]``."""
    A = _lane_op(A)
    m, n = A.shape
    dev = lb.device
    lead = tuple(lb.shape[:-1])

    def scalar(v, dt=dtype):
        if torch.is_tensor(v):
            v = v.detach().to(device=dev, dtype=dt)
            return v.expand(lead).clone() if lead else v.reshape(())
        return torch.full(lead, v, dtype=dt, device=dev)

    x0 = torch.clamp(torch.zeros(lead + (n,), dtype=dtype, device=dev), lb, ub)
    y0 = torch.zeros(lead + (m,), dtype=dtype, device=dev)
    ax0 = A.matvec(x0)
    return PdhgState(
        x=x0, y=y0, ax=ax0,
        x_sum=torch.zeros(lead + (n,), dtype=dtype, device=dev),
        y_sum=torch.zeros(lead + (m,), dtype=dtype, device=dev),
        steps=scalar(0, torch.int32),
        x_anchor=x0, y_anchor=y0, ax_anchor=ax0,
        eta=scalar(eta0),
        omega=scalar(1.0),
        it=scalar(0, torch.int32),
        kkt=scalar(INF),
        kkt_mu=scalar(INF),
        status=scalar(st.RUNNING, torch.int32),
    )


def _rebalanced_omega(s: PdhgState, do_restart, x_re, y_re):
    """Primal-weight rebalance from the movement since the anchor (θ = 0.5)."""
    dxn = torch.linalg.vector_norm(x_re - s.x_anchor, dim=-1)
    dyn = torch.linalg.vector_norm(y_re - s.y_anchor, dim=-1)
    good = do_restart & (dxn > 1e-30) & (dyn > 1e-30)
    one = torch.ones_like(dxn)
    omega = torch.where(
        good,
        torch.exp(0.5 * torch.log(dyn / torch.where(dxn > 0, dxn, one))
                  + 0.5 * torch.log(s.omega)),
        s.omega,
    )
    return omega.clamp(1e-6, 1e6)


def _round_halpern(A, b, c, lb, ub, s: PdhgState, round_len: int, tol: float) -> PdhgState:
    # constant step size (s.eta stays the driver's 0.9/‖A‖): the reflection
    # 2T−I is nonexpansive only under the global bound τσ‖A‖² ≤ 1
    dtype = b.dtype
    eta = s.eta
    neg_tau = -(eta / s.omega)
    sigma = eta * s.omega
    # β = 1/(acc+2) of every step of the round, and 1−β, at once
    acc0 = s.steps.to(dtype)
    beta = 1.0 / (acc0.unsqueeze(-1) + 2.0
                  + torch.arange(round_len, dtype=dtype, device=b.device))
    keep = 1.0 - beta
    neg_tau, sigma = _c(neg_tau), _c(sigma)

    def pdhg(x, y, ax):
        """One application T(z): (x1, A·x1, y1, 2·A·x1 − A·x)."""
        x1 = torch.clamp(torch.addcmul(x, neg_tau, A.price(c, y)), lb, ub)
        ax1 = A.matvec(x1)
        rax = torch.lerp(ax, ax1, 2.0)             # 2·ax1 − ax
        y1 = torch.addcmul(y, sigma, b - rax)
        return x1, ax1, y1, rax

    x, y, ax = s.x, s.y, s.ax
    for i in range(round_len):
        x1, ax1, y1, rax = pdhg(x, y, ax)
        # reflected Halpern step z⁺ = (1−β)(2T(z)−z) + β z₀; all three
        # pieces are linear in (x, ax), so the cached A·x follows the same
        # combination with no extra product
        k = _c(keep[..., i])
        x = torch.lerp(s.x_anchor, torch.lerp(x, x1, 2.0), k)
        y = torch.lerp(s.y_anchor, torch.lerp(y, y1, 2.0), k)
        ax = torch.lerp(s.ax_anchor, rax, k)
    acc = s.steps + round_len
    # every round ends on one extra application T(z): it is the restart
    # target, it is clipped (the raw Halpern iterate need not satisfy the
    # box), and installing it keeps state.x and state.kkt describing the
    # same point
    xT, axT, yT, _ = pdhg(x, y, ax)
    kkt = _kkt(A, b, c, lb, ub, xT, yT)

    # Halpern restart rule: sufficient decay of the ω-weighted fixed-point
    # residual ‖T(z)−z‖ against the anchor's; kkt_mu stores the anchor's
    dx, dy = xT - x, yT - y
    r_fp = torch.sqrt(s.omega * _dot(dx, dx) + _dot(dy, dy) / s.omega)
    do_restart = (r_fp < 0.2 * s.kkt_mu) | (acc >= 16 * round_len)
    omega = _rebalanced_omega(s, do_restart, xT, yT)
    done = kkt < tol
    optimal = torch.full_like(s.status, st.OPTIMAL)
    re = _c(do_restart)
    return PdhgState(
        x=xT, y=yT, ax=axT,
        x_sum=s.x_sum, y_sum=s.y_sum,
        steps=torch.where(do_restart, torch.zeros_like(acc), acc),
        x_anchor=torch.where(re, xT, s.x_anchor),
        y_anchor=torch.where(re, yT, s.y_anchor),
        ax_anchor=torch.where(re, axT, s.ax_anchor),
        eta=eta,
        omega=omega,
        it=s.it + round_len,
        kkt=kkt,
        kkt_mu=torch.where(do_restart, r_fp, s.kkt_mu),
        status=torch.where(done, optimal, s.status),
    )


def _round_avg(A, b, c, lb, ub, s: PdhgState, round_len: int, tol: float) -> PdhgState:
    dtype, dev = b.dtype, b.device
    inf = torch.tensor(INF, dtype=dtype, device=dev)
    neg_omega = -s.omega
    # the two schedule factors of every step of the round at once; k+2 keeps
    # the shrink factor strictly positive at k = 0
    kf = (s.it.to(dtype).unsqueeze(-1) + 2.0
          + torch.arange(round_len, dtype=dtype, device=dev))
    shrink = 1.0 - kf ** -0.3
    grow = 1.0 + kf ** -0.6

    x, y, ax, xs, ys, acc, eta = s.x, s.y, s.ax, s.x_sum, s.y_sum, s.steps, s.eta
    for i in range(round_len):
        neg_tau = eta / neg_omega
        sigma = eta * s.omega
        x1 = torch.clamp(torch.addcmul(x, _c(neg_tau), A.price(c, y)), lb, ub)
        ax1 = A.matvec(x1)
        y1 = torch.addcmul(y, _c(sigma), b - torch.lerp(ax, ax1, 2.0))
        dx = x1 - x
        dy = y1 - y
        # local curvature bound: accept while η ≤ η̂ = ‖Δz‖²_ω / (2|ΔyᵀAΔx|)
        chi = _dot(dy, ax1 - ax).abs()
        move = s.omega * _dot(dx, dx) + _dot(dy, dy) / s.omega
        eta_hat = torch.where(chi > 1e-300, move / (2.0 * chi), inf)
        # an infinite η̂ must not reach the product (0·∞ = NaN)
        shrunk = torch.where(torch.isfinite(eta_hat), shrink[..., i] * eta_hat, inf)
        eta_next = torch.minimum(shrunk, grow[..., i] * eta).clamp(1e-30, 1e30)
        ok = eta <= eta_hat
        okc = _c(ok)
        x = torch.where(okc, x1, x)
        y = torch.where(okc, y1, y)
        ax = torch.where(okc, ax1, ax)
        xs = torch.where(okc, xs + x1, xs)
        ys = torch.where(okc, ys + y1, ys)
        acc = acc + ok
        eta = eta_next
    x1, y1, ax1 = x, y, ax
    denom = _c(acc.clamp_min(1).to(dtype))
    x_avg = xs / denom
    y_avg = ys / denom

    kkt_cur = _kkt(A, b, c, lb, ub, x1, y1)
    kkt_avg = _kkt(A, b, c, lb, ub, x_avg, y_avg)
    use_avg = kkt_avg < kkt_cur
    kkt = torch.minimum(kkt_cur, kkt_avg)

    # conditional restart: sufficient decay against the last restart, or a
    # long stretch without one (stale averages stop helping)
    do_restart = (kkt < 0.5 * s.kkt_mu) | (acc >= 16 * round_len)
    x_re = torch.where(_c(use_avg), x_avg, x1)
    y_re = torch.where(_c(use_avg), y_avg, y1)
    omega = _rebalanced_omega(s, do_restart, x_re, y_re)

    done = kkt < tol
    # install the better candidate on restart and on termination, and report
    # the KKT of the point actually stored
    take = do_restart | done
    x_new = torch.where(_c(take), x_re, x1)
    y_new = torch.where(_c(take), y_re, y1)
    ax_out = torch.where(_c(take & use_avg), A.matvec(x_new), ax1)
    optimal = torch.full_like(s.status, st.OPTIMAL)
    re = _c(do_restart)
    return PdhgState(
        x=x_new, y=y_new, ax=ax_out,
        x_sum=torch.where(re, torch.zeros_like(xs), xs),
        y_sum=torch.where(re, torch.zeros_like(ys), ys),
        steps=torch.where(do_restart, torch.zeros_like(acc), acc),
        x_anchor=torch.where(re, x_new, s.x_anchor),
        y_anchor=torch.where(re, y_new, s.y_anchor),
        # on restart x_anchor = x_new, whose A·x is ax_out already
        ax_anchor=torch.where(re, ax_out, s.ax_anchor),
        eta=eta,
        omega=omega,
        it=s.it + round_len,
        kkt=torch.where(take, kkt, kkt_cur),
        kkt_mu=torch.where(do_restart, kkt, s.kkt_mu),
        status=torch.where(done, optimal, s.status),
    )


def _summary(state: PdhgState):
    """``(status, it, kkt, omega)`` of a state as Python numbers (lists of
    them, one a lane, for a fleet): one read."""
    status, it, kkt, omega = torch.stack(
        [v.to(torch.float64) for v in (state.status, state.it, state.kkt, state.omega)]
    ).tolist()
    if state.status.dim():
        return [int(v) for v in status], [int(v) for v in it], kkt, omega
    return int(status), int(it), kkt, omega


def _hold(new: PdhgState, old: PdhgState, live) -> PdhgState:
    """``new`` in the lanes ``live``, ``old`` in the others."""
    return PdhgState(*(torch.where(live if n.dim() == 1 else live[:, None], n, o)
                       for n, o in zip(new, old)))


def solve_pdhg_chunk(
    A, b, c, lb, ub, state: PdhgState,
    round_len: int = 256, max_rounds: int = 512, tol: float = 1e-8,
    variant: str = "avg", stats: Optional[dict] = None, assume_running: bool = False,
) -> PdhgState:
    """Run up to ``max_rounds`` restart rounds (``round_len`` PDHG steps
    each) from ``state``; returns when KKT < tol (status OPTIMAL) or the
    rounds are used up (status stays RUNNING and the caller continues with
    another call).  ``variant``: "avg" restarts to the running average
    (classic PDLP); "halpern" runs the reflected Halpern iteration and
    restarts to T(z).

    After every round the host reads ``(status, it, kkt, omega)`` in one
    transfer, as the ``cond`` of the JAX ``while_loop`` reads the status.  A
    state that is not RUNNING comes back untouched; a caller that has read
    the status since the last round says ``assume_running`` and saves that
    read.  ``stats`` (a dict) has its ``"rounds"`` and ``"host_reads"``
    raised by what this call did, and ``"last"`` set to the last tuple read
    (None if no round ran)."""
    if variant not in ("avg", "halpern"):
        raise ValueError(f"solve_pdhg_chunk: unknown variant {variant!r}")
    A = _lane_op(A)
    lanes = state.status.dim() > 0
    step_round = _round_halpern if variant == "halpern" else _round_avg
    rounds = reads = 0
    last = None
    with torch.no_grad():
        running = True
        if not assume_running:
            reads += 1
            running = bool((state.status == st.RUNNING).any())
        while running and rounds < max_rounds:
            new = step_round(A, b, c, lb, ub, state, round_len, tol)
            # a lane that stopped keeps its state, as under jax.vmap
            state = _hold(new, state, state.status == st.RUNNING) if lanes else new
            rounds += 1
            last = _summary(state)
            reads += 1
            running = (st.RUNNING in last[0]) if lanes else last[0] == st.RUNNING
    if stats is not None:
        stats["rounds"] = stats.get("rounds", 0) + rounds
        stats["host_reads"] = stats.get("host_reads", 0) + reads
        stats["last"] = last
    return state


def solve_pdhg_batched(
    A, b, c, lb, ub,
    round_len: int = 64, max_rounds: int = 256, tol: float = 1e-8,
    variant: str = "halpern", mesh=None, device=None,
) -> PdhgState:
    """Solve a STACK of same-shape box-constrained LPs with restarted PDHG
    (the first-order analogue of ``parallel.solve_batched``): ``A``
    ``[L, m, n]`` (or one ``[m, n]`` shared by every lane), ``b`` ``[L, m]``,
    ``c``, ``lb``, ``ub`` ``[L, n]``, numpy arrays or tensors, in f64.  Each
    lane takes η₀ = 0.9/‖A_s‖₂ and runs until its KKT < ``tol`` or the
    rounds are used up.  Returns the final lane-batched :class:`PdhgState`
    (statuses are per lane).  ``device=None`` takes a tensor ``A``'s device,
    else reads ``RELP_TPU_TORCH_DEVICE``.  A ``mesh`` (``parallel/mesh.py``)
    puts the scenarios over 'batch' as ``parallel.solve_batched`` does: one
    group of lanes per 'batch' row on its first device, the states back in
    lane order on the first row's device; each lane takes the steps it takes
    unmeshed."""
    import numpy as np

    from relp_tpu_torch.ops.amatrix import LaneDenseMatrix
    from relp_tpu_torch.utils.device import resolve_device

    if mesh is not None:
        from relp_tpu_torch.parallel.batched import gather_lanes, lane_groups

        groups = lane_groups(b.shape[0], mesh)
        if not groups:
            raise ValueError("this process holds no 'batch' row of the mesh")
        outs = [solve_pdhg_batched(A[lanes] if A.ndim == 3 else A,
                                   *(v[lanes] for v in (b, c, lb, ub)),
                                   round_len=round_len, max_rounds=max_rounds, tol=tol,
                                   variant=variant, device=mesh.devices[row][0])
                for row, lanes in groups]
        return gather_lanes(outs, mesh.devices[groups[0][0]][0])
    dev = A.device if device is None and torch.is_tensor(A) else resolve_device(device)
    A, b, c, lb, ub = (torch.as_tensor(np.asarray(v.cpu() if torch.is_tensor(v) else v,
                                                  np.float64), device=dev).contiguous()
                       for v in (A, b, c, lb, ub))
    op = LaneDenseMatrix(A)
    L = b.shape[0]
    with torch.no_grad():
        eta0 = 0.9 / _power_norm(op, lanes=L)
        s = initial_state(op, lb, ub, eta0)
        return solve_pdhg_chunk(op, b, c, lb, ub, s, round_len=round_len,
                                max_rounds=max_rounds, tol=tol, variant=variant)
