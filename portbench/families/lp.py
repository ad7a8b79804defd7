"""The LP that a family makes and that both sides receive.

``min/max c·x  s.t.  A x = b,  lb ≤ x ≤ ub``, every bound finite, rows and
columns named.  A is held either dense (``dense``, ``[m, n]``) or sparse
(``sparse``, a SciPy CSR or CSC matrix), never both.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass
class LP:
    name: str
    maximize: bool
    m: int
    n: int
    b: np.ndarray
    c: np.ndarray
    lb: np.ndarray
    ub: np.ndarray
    row_names: List[str]
    col_names: List[str]
    dense: Optional[np.ndarray] = None
    sparse: Any = None  # scipy.sparse CSR or CSC
    # what the family knows besides the LP (the dense family's feasible x0)
    extra: Dict[str, np.ndarray] = field(default_factory=dict)

    def __post_init__(self):
        if (self.dense is None) == (self.sparse is None):
            raise ValueError(f"LP {self.name} must hold A either dense or sparse")
        if self.sparse is not None and self.sparse.format not in ("csr", "csc"):
            raise ValueError(f"LP {self.name}: sparse A must be CSR or CSC, "
                             f"not {self.sparse.format}")

    @property
    def A(self):
        """A as it is held: the dense array or the sparse matrix."""
        return self.dense if self.sparse is None else self.sparse
