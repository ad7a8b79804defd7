"""The reference solve: Mehrotra's predictor-corrector interior point on
``min c·x  s.t.  A x = b,  lb ≤ x ≤ ub`` with ``lb < ub`` finite, written in
plain PyTorch and run in the precision it is given.

With ``x = lb + s``, ``s + w = u`` (``u = ub − lb``), ``s, w ≥ 0`` and the
duals ``y``, ``z ≥ 0`` (of ``s ≥ 0``) and ``v ≥ 0`` (of ``w ≥ 0``), each step
solves the normal equations ``A Θ Aᵀ Δy = r`` with ``Θ = (z/s + v/w)⁻¹`` by
one Cholesky factor, shared by the predictor and the corrector.  The solve
ends at a relative KKT of ``tol``, or when ten steps have not improved it,
and returns its best point.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.families.lp import LP
from portbench.reference.operator import Operator


@dataclass
class RefSolution:
    x: np.ndarray        # original columns
    y: np.ndarray        # row duals of the LP's own sense
    objective: float     # c·x in the LP's own sense
    kkt: float           # the solve's own relative KKT at x, y


def _max_step(v, dv):
    neg = dv < 0
    if not bool(neg.any()):
        return 1.0
    return float(torch.min(-v[neg] / dv[neg]).clamp(max=1.0))


def solve(lp: LP, dtype=torch.float64, device="cpu", tol: float = 1e-11,
          max_iter: int = 200, op: Operator = None) -> RefSolution:
    """The LP's optimum, computed in ``dtype`` on ``device``; ``op`` reuses an
    operator of the same A (in ``dtype``)."""
    if not np.all(lp.ub > lp.lb):
        raise ValueError("the reference takes no fixed columns")
    dev = torch.device(device)
    f = dict(dtype=dtype, device=dev)
    op = op or Operator(lp, dtype, dev)
    sense = -1.0 if lp.maximize else 1.0
    c = torch.as_tensor(sense * lp.c, **f)
    lb = torch.as_tensor(lp.lb, **f)
    u = torch.as_tensor(lp.ub - lp.lb, **f)
    b = torch.as_tensor(lp.b, **f) - op.mv(lb)

    s, w = 0.5 * u, 0.5 * u
    y = torch.zeros(lp.m, **f)
    nb, nc = 1.0 + float(b.abs().max()), 1.0 + float(c.abs().max())
    z = torch.clamp(c, min=0) + 0.1 * nc
    v = torch.clamp(-c, min=0) + 0.1 * nc
    eps = torch.finfo(dtype).eps
    eye = torch.eye(lp.m, **f)

    best, stall = None, 0
    for _ in range(max_iter):
        r_p = b - op.mv(s)
        r_d = c - op.rmv(y) - z + v
        pobj, dobj = float(c @ s), float(b @ y - u @ v)
        kkt = max(float(r_p.abs().max()) / nb, float(r_d.abs().max()) / nc,
                  abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj)))
        if not np.isfinite(kkt):
            break
        if best is None or kkt < best[0]:
            best, stall = (kkt, s, y), 0
        else:
            stall += 1
        if kkt <= tol or stall >= 10:
            break
        mu = float((s @ z + w @ v)) / (2 * lp.n)
        r_u = u - s - w
        theta = 1.0 / (z / s + v / w)
        M = op.normal(theta)
        reg = 10 * eps * float(M.diagonal().max())
        L, info = torch.linalg.cholesky_ex(M + reg * eye)
        while int(info) != 0 and reg < 1e30:
            reg *= 100.0
            L, info = torch.linalg.cholesky_ex(M + reg * eye)
        if int(info) != 0:
            break

        def direction(r_xz, r_wv):
            r_hat = r_d - r_xz / s + (r_wv - v * r_u) / w
            dy = torch.cholesky_solve((r_p + op.mv(theta * r_hat))[:, None], L)[:, 0]
            dx = theta * (op.rmv(dy) - r_hat)
            dw = r_u - dx
            return dx, dy, (r_xz - z * dx) / s, dw, (r_wv - v * dw) / w

        dx, dy, dz, dw, dv = direction(-s * z, -w * v)
        a_p = min(_max_step(s, dx), _max_step(w, dw))
        a_d = min(_max_step(z, dz), _max_step(v, dv))
        mu_aff = float((s + a_p * dx) @ (z + a_d * dz)
                       + (w + a_p * dw) @ (v + a_d * dv)) / (2 * lp.n)
        sigma = (mu_aff / mu) ** 3
        dx, dy, dz, dw, dv = direction(sigma * mu - s * z - dx * dz,
                                       sigma * mu - w * v - dw * dv)
        a_p = 0.99 * min(_max_step(s, dx), _max_step(w, dw))
        a_d = 0.99 * min(_max_step(z, dz), _max_step(v, dv))
        s, w = s + a_p * dx, w + a_p * dw
        y, z, v = y + a_d * dy, z + a_d * dz, v + a_d * dv

    if best is None:
        raise FloatingPointError("the reference solve found no finite point")
    kkt, s, y = best
    x = (lb + s).double().cpu().numpy()
    return RefSolution(x=x, y=sense * y.double().cpu().numpy(),
                       objective=float(lp.c @ x), kkt=kkt)
