"""Column-oracle layer: the column pool and its providers (base.py), the row
filter (filters.py), lazy column generation over the pool
(column_generation.py) and the per-variable feasibility logic of branch and
bound (variable.py)."""

from relp_tpu_torch.providers.base import ColumnPool, MatrixProvider
from relp_tpu_torch.providers.column_generation import (
    ColumnGenerationResult,
    solve_with_column_generation,
)
from relp_tpu_torch.providers.filters import remove_rows

__all__ = [
    "ColumnGenerationResult",
    "ColumnPool",
    "MatrixProvider",
    "remove_rows",
    "solve_with_column_generation",
]
