"""The check that nothing of JAX, or of the JAX package, is loaded: the
top-level name of every module (the part before the first dot), compared
whole, so ``relp_tpu_torch`` passes and ``relp_tpu`` does not."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "relp_tpu"})


def forbidden(names: Iterable[str]) -> List[str]:
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def loaded() -> List[str]:
    """The forbidden modules in ``sys.modules`` now."""
    return forbidden(list(sys.modules))
