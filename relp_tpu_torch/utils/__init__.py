"""Configuration, device selection, metrics."""

from relp_tpu_torch.utils.config import SolverConfig

__all__ = ["SolverConfig"]
