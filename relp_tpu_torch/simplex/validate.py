"""Basic-feasible-solution invariant checker on tensors.

Port of ``relp_tpu/simplex/validate.py``: the residual norms of a basis
state (B·B⁻¹ against I, the basic variables against their bounds, the
reduced costs on the basis, A·x against b), callable from tests or from
monitoring code.  The four residuals stay on the state's device; ``ok``
reads them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from relp_tpu_torch.ops.amatrix import as_amatrix
from relp_tpu_torch.simplex import status as st
from relp_tpu_torch.simplex.dual import _basis_matrix


class StateCheck(NamedTuple):
    inverse_residual: torch.Tensor    # max |B @ Binv - I|
    bound_violation: torch.Tensor     # max violation of basic variable bounds
    basis_reduced_cost: torch.Tensor  # max |reduced cost| over basic columns
    row_residual: torch.Tensor        # max |A x - b|

    def ok(self, tol: float = 1e-6) -> bool:
        return bool(
            (self.inverse_residual < tol)
            & (self.bound_violation < tol)
            & (self.basis_reduced_cost < tol)
            & (self.row_residual < tol)
        )


def check_state(A, b, c, lb, ub, basis, vstat, xB, Binv, art_sign) -> StateCheck:
    """The four invariant residuals of one basis state; every argument is a
    tensor on ``A``'s device (``A`` an operator or a dense tensor)."""
    A = as_amatrix(A)
    m, n = A.shape
    dev, f = A.device, A.dtype
    basis = basis.long()
    vs = vstat[:n]
    B, is_art = _basis_matrix(A, basis, art_sign)
    k = (basis - n).clamp(0, m - 1)

    inverse_residual = (B @ Binv - torch.eye(m, dtype=f, device=dev)).abs().max()

    lb_tot = torch.cat([lb, torch.zeros(m, dtype=f, device=dev)])
    ub_tot = torch.cat([ub, torch.full((m,), float("inf"), dtype=f, device=dev)])
    bound_violation = torch.maximum(lb_tot[basis] - xB, xB - ub_tot[basis]).clamp_min(0.0).max()

    cB = torch.where(is_art, 0.0, c[basis.clamp(0, n - 1)])
    d = A.price(c, cB @ Binv)
    basic_mask = vs == st.BASIC
    basis_reduced_cost = torch.where(basic_mask, d.abs(), 0.0).max()

    at_lower = (vs == st.NB_LOWER) | (vs == st.NB_FIXED)
    x = torch.where(at_lower, lb, torch.where(vs == st.NB_UPPER, ub, 0.0))
    x_pad = torch.zeros(n + 1, dtype=f, device=dev)
    x_pad[:n] = torch.where(basic_mask, 0.0, x)
    structural = basis < n
    x_pad[torch.where(structural, basis, n)] = torch.where(structural, xB, 0.0)
    # basic artificials (phase 1 / redundant rows) contribute ±xB on their row
    art_contrib = torch.zeros(m, dtype=f, device=dev).index_add_(
        0, k, torch.where(is_art, art_sign[k] * xB, 0.0))
    row_residual = (A.matvec(x_pad[:n]) + art_contrib - b).abs().max()

    return StateCheck(inverse_residual, bound_violation, basis_reduced_cost, row_residual)
