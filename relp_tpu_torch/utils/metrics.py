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
    # the engine that produced the answer: "primal", "pdlp" (the first-order
    # point), "pdlp+crossover" (the vertex recovered from it), "pdlp→primal"
    # (the first-order engine gave up and the primal solved), "dual" (the
    # device dual simplex), "dual-lu" (the host sparse-LU dual),
    # "dual→primal" (the dual could not certify and the primal solved), and
    # "ipm", "ipm+crossover", "ipm→primal" as for "pdlp"; above the XL gate
    # (refactor_external_m) also "pdlp→dual-lu", "pdlp→dual" and, on a CUDA
    # device, "dual→dual-lu" (the host LU dual's second attempt answered)
    engine: str = ""
    # update engine of the host LU under "dual-lu": "forrest-tomlin" (the
    # native library) or "product-form"
    lu_engine: str = ""
    # device-to-host reads the iteration loop made (small flag/scalar
    # copies, each a synchronisation with the device)
    host_reads: int = 0
    # per-iteration stream aggregates (config.trace_iters; 0 when off);
    # bound_flips also counts the flips of a dual engine's ratio test
    pivots: int = 0
    bound_flips: int = 0
    refresh_iters: int = 0
    bland_iters: int = 0
    degenerate_steps: int = 0
    # worst periodic in-loop invariant violation (config.check_every_n)
    check_violation: float = 0.0
    # the first-order engine (algorithm="pdlp"; 0 when it did not run):
    # PDHG iterations in all and in the f32 stage, restart rounds, the host
    # reads made between them (at most one each; the rest of host_reads are
    # the driver's), refinement zooms, the final f64 relative KKT, and the
    # crossover's push pivots; under algorithm="ipm" fo_iterations and
    # fo_kkt are the interior point's Mehrotra iterations and KKT, and
    # ipm_ladder the factor precisions it ran ("f64", "f32", "f32→f64")
    fo_iterations: int = 0
    fo_f32_iterations: int = 0
    fo_rounds: int = 0
    fo_round_reads: int = 0
    fo_refines: int = 0
    fo_kkt: float = 0.0
    # the first-order engine's operator ("dense", "ell", "hybrid" or "bricks",
    # the last under pdlp_matrix="bricks"; matrix_format names the simplex
    # operator, as in the JAX package) and the host seconds of its set-up
    # (scaling, the operator's build and transfer, the norm's power iteration)
    fo_matrix: str = ""
    fo_setup_s: float = 0.0
    push_pivots: int = 0
    ipm_ladder: str = ""

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
