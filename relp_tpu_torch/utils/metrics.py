"""Per-solve metrics and a wall-clock timer.

Every solve produces a :class:`SolveMetrics` record, logged at INFO level
on the ``relp_tpu_torch`` logger.
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import asdict, dataclass

logger = logging.getLogger("relp_tpu_torch")


@dataclass
class SolveMetrics:
    """One device solve's worth of counters."""

    status: str = ""
    iterations: int = 0
    wall_s: float = 0.0
    m: int = 0
    n: int = 0
    m_padded: int = 0
    n_padded: int = 0
    art_residual: float = 0.0
    phase: int = 0
    nnz: int = 0              # nonzeros of the lowered A
    matrix_format: str = ""   # device layout actually used
    device: str = ""          # torch device the solve ran on
    # device-to-host reads the iteration loop made (small flag/scalar
    # copies, each a synchronisation with the device)
    host_reads: int = 0

    @property
    def iters_per_s(self) -> float:
        return self.iterations / self.wall_s if self.wall_s > 0 else 0.0

    def emit(self) -> None:
        if logger.isEnabledFor(logging.INFO):
            payload = asdict(self)
            payload["iters_per_s"] = round(self.iters_per_s, 2)
            logger.info("solve %s", json.dumps(payload))


class Timer:
    """Wall-clock context manager: ``with Timer() as t: ...; t.elapsed``."""

    def __enter__(self):
        self._t0 = time.perf_counter()
        self.elapsed = 0.0
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False
