"""Primal-dual interior-point engine (Mehrotra predictor-corrector).

Port of ``relp_tpu/simplex/primal_dual.py``.  One iteration forms the
normal-equation matrix K = A·D·Aᵀ + δI as one (m×n)·(n×m) product, factors
it by one Cholesky (``torch.linalg``: cuBLAS and cuSOLVER on the card) and
takes a predictor and a corrector direction from that factor.

Problem shape (the scaled, padded computational form every engine takes):

    min cᵀx   s.t.  A x = b,   lb ≤ x ≤ ub

Bounds are handled natively by two slack/multiplier pairs (s_l = x−lb ⟂
z_l ≥ 0, s_u = ub−x ⟂ z_u ≥ 0) masked by bound finiteness.  Free variables
get a large temporary box (verified inactive at the end); fixed and padded
columns are pinned by a zero diagonal scaling d_j, so Δx_j ≡ 0.

Precision: state, residuals and every product with A are f64.  The factor
is a preconditioner, not the truth: every normal-equation solve is wrapped
in f64 iterative refinement against the exact operator
K·v = A(d·(Aᵀv)) + δv.  The factor's precision follows a ladder
(``ladder``): "f64" factors in f64 from the start; "mixed" starts on the f32
factor (Jacobi-equilibrated) and climbs to f64 when the f32 preconditioner
stops contracting.  "auto" is f64 on every device: the JAX package's f32
rung exists because the TPU emulates f64, and the H100's f64 rate is close
to its f32 one.

Regularization: primal ρ enters as d = 1/(z_l/s_l + z_u/s_u + ρ), dual δ on
K's diagonal; an unhealthy direction leaves the state as it was and raises
δ, and both shrink with μ.  Termination: relative primal and dual
infeasibility and duality gap below ``tol``.

Lanes: ``_factor``, ``_solve_normal``, ``_step_math``, ``ipm_chunk`` (with
``k_max=1``) and ``ls_start`` also take a fleet, the JAX package's
``jax.vmap`` of them over the scenario axis with the operator shared
(``driver._solve_fleet_ipm``): every vector with a leading lane axis, the
per-lane scalars (δ, ρ, the finite-bound count, the KKT reference) as
``[L]`` tensors, ``A64``/``Afac`` one ``[m, n]`` matrix.  The normal
matrices of all lanes are one batched product into ``[L, m, m]`` and one
batched ``cholesky_ex``, NaN in a lane whose ``info != 0``.

Differences from the JAX package: ``panel_matvec``/``panel_vecmat`` (limb
buffers of the TPU's f64 emulation) are plain products; ``ipm_chunk``'s
device loop is a host loop over a straight-line step whose health policy is
computed on the device; the host reads one stacked tensor of the chunk's
scalars per chunk; ``solve_ipm`` runs one iteration per chunk (the JAX
package's CPU cadence; its ``RELP_TPU_IPM_CHUNK`` and ``RELP_TPU_IPM_LADDER``
served the TPU's watchdog and remote compiler and are not carried).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from relp_tpu_torch.utils.device import DeviceLike, resolve_device

F64 = torch.float64


class IpmState(NamedTuple):
    x: torch.Tensor   # f64[n]
    y: torch.Tensor   # f64[m]
    zl: torch.Tensor  # f64[n]  multipliers of x ≥ lb (0 where no lower bound)
    zu: torch.Tensor  # f64[n]  multipliers of x ≤ ub


class IpmDiag(NamedTuple):
    mu: torch.Tensor        # average complementarity
    rp: torch.Tensor        # relative primal infeasibility (∞-norm)
    rd: torch.Tensor        # relative dual infeasibility (∞-norm)
    gap: torch.Tensor       # relative duality gap
    pobj: torch.Tensor      # primal objective (scaled space)
    dobj: torch.Tensor      # dual objective
    alpha_p: torch.Tensor   # last primal step
    alpha_d: torch.Tensor   # last dual step
    sigma: torch.Tensor     # centering parameter used
    ir_err: torch.Tensor    # worst normal-equation refinement residual (rel)


def _c(t):
    """A per-lane scalar ``[L]`` as a column ``[L, 1]`` against ``[L, k]``
    vectors; a 0-dim tensor or a number as it is."""
    return t.unsqueeze(-1) if torch.is_tensor(t) and t.dim() else t


def _Ax(A, x):
    """``A·x`` of one vector, or of every lane's (``x`` ``[L, n]``)."""
    return A @ x if x.dim() == 1 else x @ A.T


def _dot(a, b):
    return a @ b if a.dim() == 1 else (a * b).sum(-1)


def _max_step(s, ds, mask):
    """Largest α ∈ (0,1] with s + α·ds ≥ 0 on the masked entries."""
    blocking = mask & (ds < 0)
    ratios = torch.where(blocking, -s / torch.where(blocking, ds, -1.0), torch.inf)
    return torch.clamp(ratios.amin(-1), max=1.0)


def _factor(Afac, d, delta, fdt):
    """Form and factor K = (A√d)(A√d)ᵀ + δI with Jacobi equilibration.

    ``Afac`` is A at the factorization precision ``fdt``.  Returns
    ``(L, js)`` where ``js`` is the Jacobi scale: the factored matrix is
    S·K·S with S = diag(js), js = 1/√diag(K).  A matrix the Cholesky cannot
    factor gives a NaN factor, as the JAX package's does: the caller's health
    policy rejects the direction it produces."""
    w = torch.sqrt(d).to(Afac.dtype)
    B = Afac * w[..., None, :]
    K = (B @ B.mT).to(fdt)
    K.diagonal(dim1=-2, dim2=-1).add_(
        _c(torch.as_tensor(delta, dtype=F64, device=K.device).to(fdt)))
    dg = K.diagonal(dim1=-2, dim2=-1)
    js = torch.where(dg > 0, 1.0 / torch.sqrt(torch.where(dg > 0, dg, 1.0)), 1.0)
    Ks = K * js[..., :, None] * js[..., None, :]
    L, info = torch.linalg.cholesky_ex(Ks)
    L = torch.where(info[..., None, None] == 0, L, torch.nan)
    return L, js


def _solve_normal(L, js, A64, d, delta, rhs, n_ir):
    """Solve (A·D·Aᵀ + δI)·t = rhs: the equilibrated factor's solve plus
    ``n_ir`` steps of f64 iterative refinement against the exact operator.
    Returns ``(t, rel_resid)``."""
    fdt = L.dtype
    delta = _c(delta)

    def apply_K(v):
        return _Ax(A64, d * (v @ A64)) + delta * v

    def precond(r):
        z = torch.cholesky_solve((js * r).to(fdt)[..., None], L)[..., 0]
        return (js * z).to(F64)

    t = precond(rhs)
    r = rhs - apply_K(t)
    for _ in range(n_ir):
        t = t + precond(r)
        r = rhs - apply_K(t)
    scale = torch.clamp(rhs.abs().amax(-1), min=1e-30)
    return t, r.abs().amax(-1) / scale


def _step_math(A64, Afac, b, c, lbf, ubf, hl, hu, dmask,
               state: IpmState, delta, rho, nb, gamma, fdt, n_ir):
    """One Mehrotra predictor-corrector iteration (straight-line, no read).

    ``hl``/``hu`` are f64 0/1 masks of finite lower/upper bounds,
    ``lbf``/``ubf`` the bounds with ±inf replaced by 0, ``dmask`` the 0/1
    mask of movable (non-fixed, non-padded) columns, ``nb`` the number of
    finite-bound pairs, ``gamma`` the fraction-to-boundary, ``delta``/``rho``
    the dual/primal regularizations, ``fdt``/``n_ir`` the Cholesky dtype and
    the refinement step count."""
    x, y, zl, zu = state
    sl = torch.where(hl > 0, x - lbf, 1.0)
    su = torch.where(hu > 0, ubf - x, 1.0)

    r_p = b - _Ax(A64, x)
    r_d = (c - y @ A64 - zl + zu) * dmask
    mu = ((hl * sl * zl).sum(-1) + (hu * su * zu).sum(-1)) / nb

    dinv = hl * zl / sl + hu * zu / su + _c(rho)
    d = dmask / dinv

    L, js = _factor(Afac, d, delta, fdt)

    def direction(rcl, rcu, ir_acc):
        g = r_d - hl * rcl / sl + hu * rcu / su
        h = r_p + _Ax(A64, d * g)
        dy, ir = _solve_normal(L, js, A64, d, delta, h, n_ir)
        dx = d * (dy @ A64 - g)
        dzl = hl * (rcl - zl * dx) / sl
        dzu = hu * (rcu + zu * dx) / su
        return dx, dy, dzl, dzu, torch.maximum(ir_acc, ir)

    # -- predictor (affine scaling): pure Newton on the KKT residuals --
    zero = torch.zeros((), dtype=F64, device=x.device)
    dx_a, dy_a, dzl_a, dzu_a, ir1 = direction(-sl * zl, -su * zu, zero)
    hl_on, hu_on = hl > 0, hu > 0
    ap = torch.minimum(_max_step(sl, dx_a, hl_on), _max_step(su, -dx_a, hu_on))
    ad = torch.minimum(_max_step(zl, dzl_a, hl_on), _max_step(zu, dzu_a, hu_on))
    apc, adc = _c(ap), _c(ad)
    mu_aff = ((hl * (sl + apc * dx_a) * (zl + adc * dzl_a)).sum(-1)
              + (hu * (su - apc * dx_a) * (zu + adc * dzu_a)).sum(-1)) / nb
    sigma = torch.clamp((mu_aff / mu) ** 3, 1e-8, 1.0)

    # -- corrector: recentre to σμ and cancel the affine second-order term
    smu = _c(sigma * mu)
    rcl = smu - sl * zl - dx_a * dzl_a
    rcu = smu - su * zu + dx_a * dzu_a
    dx, dy, dzl, dzu, ir_err = direction(rcl, rcu, ir1)

    ap = gamma * torch.minimum(_max_step(sl, dx, hl_on), _max_step(su, -dx, hu_on))
    ad = gamma * torch.minimum(_max_step(zl, dzl, hl_on), _max_step(zu, dzu, hu_on))

    apc, adc = _c(ap), _c(ad)
    x1 = x + apc * dx
    y1 = y + adc * dy
    zl1 = zl + adc * dzl
    zu1 = zu + adc * dzu

    # -- diagnostics at the new point (what the host loop steers on) --
    sl1 = torch.where(hl > 0, x1 - lbf, 1.0)
    su1 = torch.where(hu > 0, ubf - x1, 1.0)
    aty1 = y1 @ A64
    r_p1 = b - _Ax(A64, x1)
    r_d1 = (c - aty1 - zl1 + zu1) * dmask
    mu1 = ((hl * sl1 * zl1).sum(-1) + (hu * su1 * zu1).sum(-1)) / nb
    pobj = _dot(c, x1)
    # fixed columns (dmask=0, padded ones included) enter the dual objective
    # with their exact multiplier c_j − a_jᵀy
    dobj = (_dot(b, y1) + (hl * lbf * zl1).sum(-1) - (hu * ubf * zu1).sum(-1)
            + ((1.0 - dmask) * (c - aty1) * x1).sum(-1))
    rp_rel = r_p1.abs().amax(-1) / (1.0 + b.abs().amax(-1))
    rd_rel = r_d1.abs().amax(-1) / (1.0 + c.abs().amax(-1))
    gap_rel = (pobj - dobj).abs() / (1.0 + pobj.abs() + dobj.abs())

    diag = IpmDiag(mu=mu1, rp=rp_rel, rd=rd_rel, gap=gap_rel, pobj=pobj, dobj=dobj,
                   alpha_p=ap, alpha_d=ad, sigma=sigma, ir_err=ir_err)
    return IpmState(x1, y1, zl1, zu1), diag


class IpmChunkOut(NamedTuple):
    state: IpmState
    delta: torch.Tensor      # f64 — regularization after the chunk
    rho: torch.Tensor
    committed: torch.Tensor  # i64 — healthy iterations applied
    bad: torch.Tensor        # i64 — consecutive unhealthy directions at exit
    best_x: torch.Tensor     # best-KKT committed point within the chunk
    best_y: torch.Tensor
    best_kkt: torch.Tensor
    diag: IpmDiag            # last committed iteration's diagnostics


def _kkt_of(diag: IpmDiag):
    return torch.maximum(torch.maximum(diag.rp, diag.rd), diag.gap)


def ipm_chunk(A64, Afac, b, c, lbf, ubf, hl, hu, dmask,
              state: IpmState, delta, rho, nb, gamma, tol, kkt_ref, fdt, n_ir, k_max):
    """Up to ``k_max`` Mehrotra iterations under the per-iteration health
    policy, each a straight-line step whose policy is computed on the
    device: an unhealthy direction (non-finite, or a normal-equation
    refinement residual ≥ 1e-2 or ≥ 3 % of the last committed KKT) leaves
    the state unchanged and raises δ ×100 (ρ = max(ρ, δ/100)); a healthy
    one commits and lets δ/ρ shrink with μ.  ``kkt_ref`` seeds the relative
    gate.  Between two steps the host reads one flag (KKT ≤ tol, or 3
    consecutive unhealthy retries, ends the chunk); a chunk of one step
    reads nothing.  The best committed point is tracked on the device.
    A fleet (vectors ``[L, k]``) takes one step per chunk (``k_max=1``)."""
    dev = b.device
    f64 = dict(dtype=F64, device=dev)
    lead = tuple(b.shape[:-1])
    if lead and k_max != 1:
        raise ValueError("ipm_chunk: a fleet takes k_max=1 (one step a lane per chunk)")
    delta = torch.as_tensor(delta, **f64)
    rho = torch.as_tensor(rho, **f64)
    kkt_ref = torch.as_tensor(kkt_ref, **f64)
    committed = torch.zeros(lead, dtype=torch.int64, device=dev)
    bad = torch.zeros(lead, dtype=torch.int64, device=dev)
    best_x, best_y = state.x, state.y
    best_kkt = torch.full(lead, torch.inf, **f64)
    diag = IpmDiag(*([torch.full(lead, torch.nan, **f64)] * len(IpmDiag._fields)))
    for attempt in range(k_max):
        new_state, new_diag = _step_math(A64, Afac, b, c, lbf, ubf, hl, hu, dmask,
                                         state, delta, rho, nb, gamma, fdt, n_ir)
        kkt = _kkt_of(new_diag)
        healthy = (torch.isfinite(new_diag.mu) & torch.isfinite(kkt)
                   & (new_diag.ir_err < 1e-2)
                   & (new_diag.ir_err < torch.clamp(0.03 * kkt_ref, min=1e-13)))
        state = IpmState(*(torch.where(_c(healthy), new, old)
                           for new, old in zip(new_state, state)))
        delta = torch.where(
            healthy,
            torch.minimum(torch.clamp(delta, min=1e-12),
                          torch.clamp(new_diag.mu * 1e-4, min=1e-12)),
            # the data is O(1)-equilibrated: δ beyond ~1e2 only buries the
            # Newton direction, never rescues the factorization
            torch.clamp(delta * 100.0, max=1e2),
        )
        rho = torch.where(
            healthy,
            torch.minimum(torch.clamp(rho, min=1e-12),
                          torch.clamp(new_diag.mu * 1e-6, min=1e-12)),
            torch.maximum(rho, delta * 1e-2),
        )
        bad = torch.where(healthy, 0, bad + 1)
        committed = committed + healthy.long()
        improved = healthy & (kkt < best_kkt)
        best_x = torch.where(_c(improved), state.x, best_x)
        best_y = torch.where(_c(improved), state.y, best_y)
        best_kkt = torch.where(improved, kkt, best_kkt)
        kkt_ref = torch.where(healthy, kkt, kkt_ref)
        diag = IpmDiag(*(torch.where(healthy, new, old) for new, old in zip(new_diag, diag)))
        if attempt + 1 < k_max:
            stop = (healthy & (kkt <= tol)) | (bad >= 3)
            if bool(stop):
                break
    return IpmChunkOut(state=state, delta=delta, rho=rho, committed=committed, bad=bad,
                       best_x=best_x, best_y=best_y, best_kkt=best_kkt, diag=diag)


def ls_start(A64, Afac, b, c, lbf, ubf, hl, hu, dmask, xfix, fdt, n_ir):
    """Mehrotra-style least-squares starting point.

    x̃ minimizes ‖x − x_fix‖ s.t. Ax = b (movable coordinates only); ỹ the
    least-squares dual of c.  Both come from one factorization of AAᵀ+δI.
    The iterate is then shifted into the interior of the box.
    """
    delta0 = 1e-6
    L, js = _factor(Afac, dmask.to(Afac.dtype), delta0, fdt)

    r0 = b - _Ax(A64, xfix)
    t, _ = _solve_normal(L, js, A64, dmask, delta0, r0, n_ir)
    xt = xfix + dmask * (t @ A64)
    yt, _ = _solve_normal(L, js, A64, dmask, delta0, _Ax(A64, dmask * c), n_ir)
    zt = c - yt @ A64

    # interior shift: margin 1 in Ruiz-scaled space for one-sided bounds;
    # boxed variables clip to the middle half of their box
    w = ubf - lbf
    margin = torch.clamp(0.25 * w, max=1.0)
    both = (hl > 0) & (hu > 0)
    x0 = torch.where(
        both,
        torch.minimum(torch.maximum(xt, lbf + margin), ubf - margin),
        torch.where(hl > 0, torch.maximum(xt, lbf + 1.0),
                    torch.where(hu > 0, torch.minimum(xt, ubf - 1.0), xt)),
    )
    x0 = torch.where(dmask > 0, x0, xfix)
    zl0 = hl * (torch.clamp(zt, min=0.0) + 1.0)
    zu0 = hu * (torch.clamp(-zt, min=0.0) + 1.0)
    return IpmState(x0, yt, zl0, zu0)


class IpmInfo(NamedTuple):
    iterations: int
    kkt: float          # max(rp, rd, gap) of the returned point
    converged: bool
    mu: float
    host_reads: int = 0  # device-to-host reads of the loop
    ladder: str = "f64"  # the rungs run: "f64", or "f32" / "f32→f64"


def ladder_rungs(ladder: str):
    """The factor precision ladder as ``[(dtype, n_ir), ...]``: "f64" (and
    "auto") one f64 rung with one refinement step, "mixed" an f32 rung with
    three and an f64 rung with two."""
    if ladder not in ("auto", "mixed", "f64"):
        raise ValueError(f"ipm ladder must be auto, mixed or f64, got {ladder!r}")
    if ladder == "mixed":
        return [(torch.float32, 3), (F64, 2)]
    return [(F64, 1)]


_DIAG_READ = ("committed", "bad", "delta", "rho", "best_kkt")


def solve_ipm(A_dense, b, c, lb, ub, *, tol: float = 1e-8, accept: float = 1e-6,
              max_iter: int = 200, free_box: float = 1e5, ladder: str = "auto",
              device: DeviceLike = None, log=None):
    """Host loop: run Mehrotra iterations until the relative KKT criteria
    reach ``tol`` (or stall above ``accept`` → ``None``).

    ``A_dense`` is the (m_pad, n_pad) scaled dense matrix (numpy, or a
    tensor, whose device is then the solve's); ``device=None`` otherwise
    reads ``RELP_TPU_TORCH_DEVICE``.  Returns ``(x, y, IpmInfo)`` in the same
    scaled space as numpy, or ``None`` when the method cannot certify (the
    caller falls back)."""
    dev = A_dense.device if torch.is_tensor(A_dense) else resolve_device(device)
    rungs = ladder_rungs(ladder)
    A64 = torch.as_tensor(A_dense, dtype=F64, device=dev)
    A32: Optional[torch.Tensor] = A64.to(torch.float32) if len(rungs) > 1 else None

    def rung_of(k):
        fdt, n_ir = rungs[k]
        return fdt, (A64 if fdt == F64 else A32), n_ir

    rung = 0
    fdt, Afac, n_ir = rung_of(rung)
    rungs_run = [fdt]

    lb = np.asarray(lb, np.float64).copy()
    ub = np.asarray(ub, np.float64).copy()
    fixed = lb == ub
    free = ~np.isfinite(lb) & ~np.isfinite(ub) & ~fixed
    # temporary box for free columns — verified inactive on acceptance
    lb_w = np.where(free, -free_box, lb)
    ub_w = np.where(free, free_box, ub)

    hl = (np.isfinite(lb_w) & ~fixed).astype(np.float64)
    hu = (np.isfinite(ub_w) & ~fixed).astype(np.float64)
    dmask = (~fixed).astype(np.float64)
    lbf = np.where(hl > 0, lb_w, 0.0)
    ubf = np.where(hu > 0, ub_w, 0.0)
    xfix = np.where(fixed, lb, 0.0)
    nb = float(hl.sum() + hu.sum())
    if nb == 0:
        return None

    args = tuple(torch.as_tensor(np.asarray(v, np.float64), device=dev)
                 for v in (b, c, lbf, ubf, hl, hu, dmask))
    xfix_d = torch.as_tensor(xfix, device=dev)
    reads = 0

    def start():
        nonlocal reads
        s = ls_start(A64, Afac, *args, xfix_d, fdt=fdt, n_ir=n_ir)
        reads += 1
        return s, bool(torch.isfinite(s.x.abs().max()))

    state, finite = start()
    while not finite:
        # a NaN start poisons every later iterate (the health policy keeps
        # the previous state, which is the NaN start): climb and restart
        if rung + 1 >= len(rungs):
            return None
        rung += 1
        fdt, Afac, n_ir = rung_of(rung)
        rungs_run.append(fdt)
        if log:
            log.info("ipm ls_start NaN — precision ladder → %s", str(fdt).split(".")[-1])
        state, finite = start()

    delta = 1e-8
    rho = 1e-10
    gamma = 0.9995
    best = None  # (kkt, x, y, mu)
    best_kkt = np.inf
    rung_best = np.inf  # stall reference local to the current rung
    stall = 0
    it = 0
    retries = 0

    def _escalate(reason: str) -> bool:
        nonlocal rung, fdt, Afac, n_ir, rung_best, stall
        if rung + 1 >= len(rungs):
            return False
        rung += 1
        fdt, Afac, n_ir = rung_of(rung)
        rungs_run.append(fdt)
        if log:
            log.info("ipm precision ladder → %s (%s)", str(fdt).split(".")[-1], reason)
        # the new rung gets a fresh stall reference: its early iterations
        # must not be judged against a floor-level best the old rung could
        # only measure, not hold
        rung_best = np.inf
        stall = 0
        return True

    restarted = False
    kkt_ref = np.inf  # last committed KKT — seeds the relative refinement gate

    def _cold_restart(reason: str) -> bool:
        """One restart from a fresh least-squares start at the top rung: a
        state poisoned beyond warm recovery still beats falling back to a
        full simplex solve, and the best-point tracking keeps whatever the
        failed path achieved."""
        nonlocal state, delta, rho, stall, retries, restarted, kkt_ref, rung_best
        if restarted or rung + 1 < len(rungs):
            return False
        restarted = True
        if log:
            log.info("ipm cold restart at top rung (%s)", reason)
        state, finite = start()
        if not finite:
            return False
        delta, rho = 1e-8, 1e-10
        stall = 0
        retries = 0
        rung_best = np.inf
        kkt_ref = np.inf
        return True

    while it < max_iter:
        out = ipm_chunk(A64, Afac, *args, state, delta, rho, nb, gamma, tol, kkt_ref,
                        fdt=fdt, n_ir=n_ir, k_max=1)
        diag = out.diag
        # the chunk's scalars, in one read
        vals = torch.stack([getattr(out, k).to(F64) for k in _DIAG_READ]
                           + list(diag)).cpu().tolist()
        reads += 1
        committed, bad, delta, rho, chunk_kkt = vals[:5]
        d = IpmDiag(*vals[5:])
        committed, bad = int(committed), int(bad)
        it += committed
        mu = d.mu
        kkt = max(d.rp, d.rd, d.gap)
        if log:
            log.info("ipm it=%d mu=%.3e rp=%.2e rd=%.2e gap=%.2e ap=%.2f ad=%.2f "
                     "sig=%.2e ir=%.1e best=%.2e", it, mu, d.rp, d.rd, d.gap,
                     d.alpha_p, d.alpha_d, d.sigma, d.ir_err, chunk_kkt)
        if chunk_kkt < best_kkt:
            best_kkt = chunk_kkt
            best = (chunk_kkt, out.best_x, out.best_y, mu)
        # stall bookkeeping is local to the rung
        if chunk_kkt < 0.9 * rung_best:
            stall = 0
        elif chunk_kkt >= rung_best:
            stall += committed
        if chunk_kkt < rung_best:
            rung_best = chunk_kkt
        if committed:
            state = out.state
            if np.isfinite(kkt):
                kkt_ref = kkt
        if bad >= 3 or committed == 0:
            # the rung's preconditioner stopped producing usable directions:
            # climb; at the top rung count hard retries
            retries += 1
            if _escalate(f"it={it} unhealthy (mu={mu:.2e} ir={d.ir_err:.2e})"):
                continue
            if retries > 6:
                if best_kkt > accept and _cold_restart(
                        f"it={it} retries exhausted, best={best_kkt:.2e}"):
                    continue
                break
            continue
        if np.isfinite(kkt) and kkt <= tol:
            break
        if stall >= 4 and _escalate(f"it={it} stalled at kkt={best_kkt:.2e}"):
            continue
        if stall >= 12:
            if best_kkt > accept and _cold_restart(f"it={it} stalled at kkt={best_kkt:.2e}"):
                continue
            break

    if best is None:
        return None
    kkt, x, y, mu = best
    if kkt > accept:
        return None
    x, y = x.cpu().numpy(), y.cpu().numpy()
    reads += 1
    if free.any() and np.max(np.abs(x[free])) >= 0.5 * free_box:
        return None  # the temporary free-variable box binds: not a certificate
    names = ["f32" if t == torch.float32 else "f64" for t in rungs_run]
    return x, y, IpmInfo(iterations=it, kkt=kkt, converged=kkt <= tol, mu=mu,
                         host_reads=reads, ladder="→".join(names))
