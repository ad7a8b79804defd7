"""The LP that a family makes and that both sides receive.

``min/max c·x  s.t.  A x = b,  lb ≤ x ≤ ub``, every bound finite, A held
dense (``[m, n]``), rows and columns named.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

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
    dense: np.ndarray
    # what the family knows besides the LP (the dense family's feasible x0)
    extra: Dict[str, np.ndarray] = field(default_factory=dict)
