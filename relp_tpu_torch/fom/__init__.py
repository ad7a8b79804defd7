"""First-order engines: restarted PDHG (``pdhg.py``), one LP or a fleet."""

from relp_tpu_torch.fom.pdhg import solve_pdhg_batched

__all__ = ["solve_pdhg_batched"]
