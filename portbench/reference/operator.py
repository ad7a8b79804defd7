"""A of an LP on a torch device: products with A and Aᵀ, and the normal
matrix A·diag(θ)·Aᵀ of an interior-point step."""

from __future__ import annotations

import torch

from portbench.families.lp import LP


class Operator:
    """A held dense, ``[m, n]``, in the given precision."""

    def __init__(self, lp: LP, dtype=torch.float64, device="cpu"):
        self.m, self.n = lp.m, lp.n
        self.dtype, self.device = dtype, torch.device(device)
        self.dense = torch.as_tensor(lp.dense, dtype=dtype, device=self.device)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """A·x."""
        return self.dense @ x

    def rmv(self, y: torch.Tensor) -> torch.Tensor:
        """Aᵀ·y."""
        return self.dense.T @ y

    def normal(self, theta: torch.Tensor) -> torch.Tensor:
        """A·diag(θ)·Aᵀ as a dense ``[m, m]`` tensor."""
        return (self.dense * theta) @ self.dense.T
