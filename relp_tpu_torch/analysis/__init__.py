"""Post-optimal analysis tools (sensitivity ranging)."""

from relp_tpu_torch.analysis.ranging import RangingResult, ranging  # noqa: F401
