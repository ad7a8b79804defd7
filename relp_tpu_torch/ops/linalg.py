"""Dense linear algebra for basis-inverse maintenance.

The engine keeps an explicit dense f64 basis inverse, updated by one rank-1
product-form step per pivot and rebuilt from the basis columns periodically
(see ``relp_tpu/ops/linalg.py``).  The rebuild is an f64 LU with partial
pivoting (cuSOLVER on the card, LAPACK on the CPU); the JAX package's f32 LU
seed with Newton-Schulz refinement and Gauss-Jordan fallback exists only
because the TPU's LU is f32-only, and is not ported.
"""

from __future__ import annotations

import torch


def lu_inverse(B: torch.Tensor):
    """Invert ``B`` (m×m, or a stack ``[L, m, m]`` of the lanes of a fleet,
    f64) through an LU with partial pivoting.

    Returns ``(B_inv, min_abs_pivot)`` with ``min_abs_pivot = min|diag(U)|``,
    a 0-dim tensor (``[L]`` for a stack): partial pivoting picks the same
    pivots as the JAX package's ``gauss_jordan_inverse``, so near zero means
    B is (numerically) singular and the caller repairs the basis.  Nothing is
    read back to the host here; a singular B gives a non-finite inverse
    that the caller must not use.
    """
    LU, piv, _ = torch.linalg.lu_factor_ex(B)
    min_piv = LU.diagonal(dim1=-2, dim2=-1).abs().amin(-1)
    eye = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
    return torch.linalg.lu_solve(LU, piv, eye.expand_as(B)), min_piv


def inverse_residual(B: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``max|I − B·X|`` of a candidate inverse (0-dim tensor; ``[L]`` for
    stacks)."""
    eye = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
    return (eye - B @ X).abs().amax((-2, -1))


def rank_one_basis_update(Binv: torch.Tensor, u: torch.Tensor, r: torch.Tensor,
                          apply: torch.Tensor) -> torch.Tensor:
    """Product-form update of the explicit inverse after a pivot, IN PLACE.

    ``u = Binv @ a_q`` is the FTRAN column of the entering variable and
    ``r`` the leaving row (0-dim tensor): ``Binv ← E·Binv`` with
    ``E = I − (u − e_r) e_rᵀ / u_r``.  ``apply`` (0-dim bool tensor) makes
    the update conditional without a host read: when it is False ``Binv``
    is left exactly as it was.

    The JAX package builds a new array each pivot because its arrays are
    immutable; at m = 4096 that is a 128 MiB copy per pivot, so the port
    updates in place (one ``addr_`` pass and one row write).
    """
    r = r.reshape(1).long()
    row_r = Binv.index_select(0, r)[0]
    w = row_r / u.index_select(0, r)[0]
    # zeros (not a scale by 0) so a non-finite u or w cannot leak in
    Binv.addr_(torch.where(apply, u, 0.0), torch.where(apply, w, 0.0), alpha=-1)
    return Binv.index_copy_(0, r, torch.where(apply, w, row_r).reshape(1, -1))


def rank_one_basis_update_lanes(Binv: torch.Tensor, u: torch.Tensor, r: torch.Tensor,
                                apply: torch.Tensor) -> torch.Tensor:
    """:func:`rank_one_basis_update` of every lane of a fleet at once, IN
    PLACE: ``Binv`` ``[L, m, m]``, ``u`` ``[L, m]``, the leaving rows ``r``
    and the mask ``apply`` ``[L]``.  A lane whose ``apply`` is False is left
    exactly as it was (a finished lane, or one that flipped a bound)."""
    L, m, _ = Binv.shape
    rows = r.long().view(L, 1, 1).expand(L, 1, m)
    row_r = Binv.gather(1, rows).squeeze(1)
    w = row_r / u.gather(1, r.long().view(L, 1))
    on = apply[:, None]
    Binv.baddbmm_(torch.where(on, u, 0.0).unsqueeze(2), torch.where(on, w, 0.0).unsqueeze(1),
                  alpha=-1)
    return Binv.scatter_(1, rows, torch.where(on, w, row_r).unsqueeze(1))
