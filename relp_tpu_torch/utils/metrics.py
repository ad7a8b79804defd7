"""Per-solve metrics, spans, a wall-clock timer and a device profiler hook.

Every solve (the driver's ``solve_computational_form`` and
``reoptimize_with_bounds``) produces a :class:`SolveMetrics` record, logged
at INFO level on the ``relp_tpu_torch`` logger and kept in :func:`recent`;
:func:`device_trace` profiles the enclosed work with ``torch.profiler`` into
a Chrome trace.

:func:`span` marks a phase of a solve.  It is on only while a torch profiler
records: it then puts the phase on the profiler's clock as a host operation
and adds its count and host seconds to the open solve's ``spans``.  Off, it
costs one flag check.  Spans never synchronise the device, so their seconds
are the host's (dispatch and any wait inside), not the device's.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import logging
import os
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Dict, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

logger = logging.getLogger("relp_tpu_torch")

_RECENT: collections.deque = collections.deque(maxlen=1024)
_IDS = itertools.count(1)


class _Open(threading.local):
    def __init__(self):
        self.records: list = []  # the records of the entry points open on this thread


_OPEN = _Open()


@dataclass
class SolveMetrics:
    """One solve's worth of counters."""

    call: str = ""            # the entry point: "solve" (the driver) or "reoptimize"
    solve_id: int = 0         # the process's sequence number of the record
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
    # device, "dual→dual-lu" (the host LU dual's second attempt answered);
    # a re-solve (call "reoptimize") reads "dual", "dual→primal" (the warm
    # primal answered) or "dual→primal-cold" (the cold primal did)
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
    # the device dual's refactorizations (DualKernel.refactor, the closing
    # one included) and those of them that rebuilt B⁻¹ by LU (the polish was
    # rejected or not used)
    refactorizations: int = 0
    inverse_rebuilds: int = 0
    # the device dual's iterations replayed from a CUDA graph of its step,
    # and the captures of such a graph the solve paid for (0 on the CPU)
    graph_steps: int = 0
    graph_captures: int = 0
    # span name -> (entries, host seconds); empty while no profiler records
    spans: Dict[str, Tuple[int, float]] = field(default_factory=dict)

    @property
    def iters_per_s(self) -> float:
        return self.iterations / self.wall_s if self.wall_s > 0 else 0.0

    def emit(self) -> None:
        """Keep the record in :func:`recent` and log it at INFO level."""
        _RECENT.append(self)
        if logger.isEnabledFor(logging.INFO):
            payload = asdict(self)
            payload["iters_per_s"] = round(self.iters_per_s, 2)
            logger.info("solve %s", json.dumps(payload))


def recent() -> collections.deque:
    """The process's last 1,024 emitted records, oldest first."""
    return _RECENT


@contextlib.contextmanager
def recording(call: str):
    """Open the record of an entry point's solve (``call``) on this thread:
    spans and :func:`count` add to it until the block ends.  The caller fills
    its other fields and emits it."""
    rec = SolveMetrics(call=call, solve_id=next(_IDS))
    stack = _OPEN.records
    stack.append(rec)
    try:
        yield rec
    finally:
        stack.pop()
        for k, (n, ns) in list(rec.spans.items()):  # in place: copies share the dict
            rec.spans[k] = (n, ns * 1e-9)


def count(**counters: int) -> None:
    """Add to counters of the open record (none open: nothing)."""
    stack = _OPEN.records
    if stack:
        rec = stack[-1]
        for k, v in counters.items():
            setattr(rec, k, getattr(rec, k) + v)


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "_mark", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
        self._mark = fast(self.name) if fast is not None else _profiler.record_function(self.name)
        self._mark.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self._t0
        self._mark.__exit__(*exc)
        stack = _OPEN.records
        if stack:
            acc = stack[-1].spans.get(self.name)
            stack[-1].spans[self.name] = (1, dt) if acc is None else (acc[0] + 1, acc[1] + dt)
        return False


def span(name: str):
    """A context marking the phase ``name``: on while a torch profiler
    records (a ``cpu_op`` event of ``_RecordFunctionFast``, or of
    ``record_function`` where torch lacks it, and the open record's
    ``spans[name]``), else one shared no-op context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


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
