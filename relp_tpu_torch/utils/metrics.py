"""Per-solve metrics, a wall-clock timer and a device profiler hook.

Every solve produces a :class:`SolveMetrics` record, logged at INFO level
on the ``relp_tpu_torch`` logger; :func:`device_trace` profiles the enclosed
work with ``torch.profiler`` into a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from dataclasses import asdict, dataclass
from typing import Optional

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
    # per-iteration stream aggregates (config.trace_iters; 0 when off)
    pivots: int = 0
    bound_flips: int = 0
    refresh_iters: int = 0
    bland_iters: int = 0
    degenerate_steps: int = 0
    # worst periodic in-loop invariant violation (config.check_every_n)
    check_violation: float = 0.0

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


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Profile the enclosed work with ``torch.profiler`` (host activity, and
    the card's kernels when CUDA is available) and write a Chrome trace to
    ``log_dir/trace.json`` (open it in Perfetto or chrome://tracing); a
    no-op when ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
