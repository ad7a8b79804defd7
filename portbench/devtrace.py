"""What the device did in a traced slice, read from ``torch.profiler``.

A ``Traced`` block profiles the card's kernels, copies and sets (and, with
``host=True``, the host's operations) over a slice of requests; each timed
call in it runs inside ``Traced.call()``, which notes the call's start and
end on the profiler's clock (the system clock, ``time.time_ns``).  Per call,
``summaries`` hold the union of the device's busy intervals within the call,
its kernel launches and the device time of each kernel name; over the
slice, ``device_ops`` are the device operations that took most time and
``idle_gaps`` (host tracing only) the idle seconds by what the host was
doing when the device went idle.  Host tracing records every operator and
slows a host-bound loop several times over, so the metrics come from a
slice traced without it.

The profiler's raw events are read as they come (``kineto_results``),
without building its tree of function events, which takes minutes for the
hundreds of thousands of host operations of a few solves.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

CALL = "portbench.call"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class DeviceSummary:
    window_s: float
    busy_s: float
    launches: int                               # kernels (copies and sets left out)
    kernels: Dict[str, Tuple[int, float]]      # name -> (launches, device seconds)

    def launches_of(self, part: str) -> List[Tuple[str, int, float]]:
        """``(name, launches, seconds)`` of every kernel whose name holds ``part``."""
        return [(k, n, s) for k, (n, s) in self.kernels.items() if part in k]


@dataclass
class _Event:
    name: str
    start: float   # ns
    end: float     # ns
    thread: int
    kind: str      # "device", "host" or "other"

    @classmethod
    def of(cls, e) -> "_Event":
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns(), e.duration_ns()
        else:
            start, dur = e.start_us() * 1e3, e.duration_us() * 1e3
        act = e.activity_type() if hasattr(e, "activity_type") else ""
        on_card = str(e.device_type()).endswith("CUDA")
        name = e.name()
        if "annotation" in act or (on_card and name == CALL):
            kind = "other"  # a mark's copy on the device timeline
        elif on_card:
            kind = "device" if act in DEVICE_ACTIVITIES or not act else "other"
        else:
            kind = "host"
        return cls(name, float(start), float(start + dur), int(e.start_thread_id()), kind)


class Traced:
    """``with Traced(host) as t: ... with t.call(): <timed call> ...``; then
    ``t.summaries`` (one per call), ``t.device_ops`` and ``t.idle_gaps``."""

    def __init__(self, host: bool = False):
        self.host = host
        self.windows: List[Tuple[int, int]] = []

    @contextlib.contextmanager
    def call(self):
        from torch.profiler import record_function

        with record_function(CALL):
            t0 = time.time_ns()
            try:
                yield
            finally:
                self.windows.append((t0, time.time_ns()))

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] if self.host else []
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts or [ProfilerActivity.CPU])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            events = [_Event.of(e) for e in self._prof.profiler.kineto_results.events()]
            self.summaries, self.device_ops, self.idle_gaps = summarise(events, self.windows)
        return False


def summarise(events: List[_Event], windows, top: int = 10):
    """``(per-call summaries, device_ops, idle_gaps)`` of a slice's events,
    ``windows`` the calls' ``(start, end)`` in ns."""
    calls = sorted(windows)
    spans = sorted((e.start, e.end, e.name) for e in events if e.kind == "device")
    starts = [s for s, _, _ in spans]
    summaries, gaps, totals = [], [], {}
    for c0, c1 in calls:
        kernels: Dict[str, List[float]] = {}
        busy, cur_s, cur_t = 0.0, None, c0
        for s, t, name in spans[bisect.bisect_left(starts, c0):bisect.bisect_left(starts, c1)]:
            t = min(t, c1)
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += (t - s) * 1e-9
            if cur_s is None or s > cur_t:
                if cur_s is not None:
                    busy += cur_t - cur_s
                if s > cur_t:
                    gaps.append((cur_t, s))
                cur_s, cur_t = s, t
            else:
                cur_t = max(cur_t, t)
        if cur_s is not None:
            busy += cur_t - cur_s
        if c1 > cur_t:
            gaps.append((cur_t, c1))
        for name, (_, sec) in kernels.items():
            totals[name] = totals.get(name, 0.0) + sec
        summaries.append(DeviceSummary(
            window_s=(c1 - c0) * 1e-9, busy_s=busy * 1e-9,
            launches=sum(int(n) for name, (n, _) in kernels.items()
                         if not name.startswith(("Memcpy", "Memset"))),
            kernels={k: (int(n), s) for k, (n, s) in kernels.items()}))
    device_ops = sorted(totals.items(), key=lambda p: -p[1])[:top]
    host = [e for e in events if e.kind == "host"]
    return summaries, device_ops, _gaps_by_host(gaps, host, top)


def _gaps_by_host(gaps, host: List[_Event], top):
    """Idle seconds by the innermost host operation of the main thread that
    was open when each gap began (``host, between operations`` where only
    the call's own mark was)."""
    if not host or not gaps:
        return []
    threads: Dict[int, int] = {}
    for e in host:
        threads[e.thread] = threads.get(e.thread, 0) + 1
    main = max(threads, key=threads.get)
    ops = sorted(((e.start, e.end, e.name) for e in host if e.thread == main),
                 key=lambda p: (p[0], -p[1]))
    totals: Dict[str, float] = {}
    stack: list = []
    i = 0
    for g0, g1 in sorted(gaps):
        while i < len(ops) and ops[i][0] <= g0:
            while stack and stack[-1][1] < ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] < g0:
            stack.pop()
        name = stack[-1][2] if stack and stack[-1][2] != CALL else "host, between operations"
        totals[name] = totals.get(name, 0.0) + (g1 - g0) * 1e-9
    return sorted(totals.items(), key=lambda p: -p[1])[:top]
