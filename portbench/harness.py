"""The harness: finds a cell's files by name, sets the program up, measures
a closed loop of requests for ``seconds``, optionally profiles a slice of
further requests, judges every answer against the reference (solving each
distinct LP once) and reads the cell's metrics.

Everything that belongs to one configuration, cell, request kind, LP family
or metric is a file of its own:

- ``BENCHMARK.json`` (the repo root): the cells, configurations and metrics;
- ``configs/<config>.json``: the LP family and its sizes;
- ``cells/<cell>.json``: the configuration, the request kind, the solver
  options, the traffic, the traced slice and the limits of ``correct``;
- ``families/<family>.py``, ``kinds/<kind>.py``: found by the names above;
- ``metrics/<metric>.py``: one reader per metric, ``read(ctx)``, which
  returns a number or None when it finds nothing to read.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import re
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from portbench.devtrace import DeviceSummary, Traced
from portbench.roofline import peak_bytes_per_s

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
MODULE = re.compile(r"[A-Za-z_][A-Za-z0-9_]{0,63}")
MEASURES = ("res", "gap", "obj")


class UnknownCell(ValueError):
    pass


@dataclass
class Context:
    """What a metric reader reads."""

    setup_s: float
    records: List[dict]                    # the measured window's requests
    traced: List[dict] = field(default_factory=list)  # the profiled slice's
    device_kind: str = ""

    @property
    def peak_bytes_per_s(self) -> float:
        return peak_bytes_per_s(self.device_kind)

    def summaries(self) -> List[DeviceSummary]:
        return [r["device"] for r in self.traced if r.get("device") is not None]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(root: Path, workload: str):
    """``(benchmark, workload entry, cell, configuration)`` of a cell name."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None or not NAME.fullmatch(workload):
        raise UnknownCell(f"unknown workload {workload!r}; BENCHMARK.json has "
                          f"{[w['name'] for w in bench['workloads']]}")
    conf_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cell = load_json(root / "portbench" / "cells" / f"{workload}.json")
    config = load_json(root / conf_entry["file"])
    if cell["config"] != entry["config"] or cell["traffic"]["name"] != entry["traffic"]:
        raise ValueError(f"cells/{workload}.json does not match BENCHMARK.json's entry")
    return bench, entry, cell, config


def metrics_of(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics
    without the trace, its per-layer metrics with it."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if workload in m.get("workloads", [workload])]


def _module(package: str, name: str):
    if not MODULE.fullmatch(name):
        raise ValueError(f"bad {package} name {name!r}")
    return importlib.import_module(f"portbench.{package}.{name}")


def reader(root: Path, name: str):
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit() -> str:
    """``name, power.limit`` of the card as nvidia-smi prints it ("" without)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def note(msg: str) -> None:
    """A progress line on standard error."""
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def lp_identity(lp) -> tuple:
    """What makes two LPs one LP to the reference: the same A object, the
    same bytes of b, c, lb and ub, and the same sense."""
    return (id(lp.A), lp.maximize) + tuple((v.dtype.str, v.shape, v.tobytes())
                                           for v in (lp.b, lp.c, lp.lb, lp.ub))


def judge(kind, records: List[dict], limits: Dict[str, float], device: str):
    """Every answer against the reference: ``(attempted, failed, worst)``,
    ``worst`` the largest reading of each measure over the answers.  The
    reference solves each distinct LP once (``lp_identity``); each answer is
    read from its own x, y and objective."""
    import torch

    from portbench.reference import certificate, ipm
    from portbench.reference.operator import Operator

    attempted = failed = 0
    worst = {k: 0.0 for k in MEASURES}
    ops: dict = {}   # id(A): (A, its operator); A is held, so its id stays its own
    refs: dict = {}  # lp_identity: the reference's solution
    for rec in records:
        for ans in rec["answers"]:
            attempted += 1
            if not ans.ok or ans.x is None or ans.y is None:
                failed += 1
                continue
            lp = kind.lp_of(ans.key)
            held = ops.get(id(lp.A))
            if held is None:
                held = ops[id(lp.A)] = (lp.A, Operator(lp, torch.float64, device))
            op = held[1]
            key = lp_identity(lp)
            ref = refs.get(key)
            if ref is None:
                ref = refs[key] = ipm.solve(lp, torch.float64, device, op=op)
                if ref.kkt > limits["reference_kkt"]:
                    raise RuntimeError(f"the reference solve of {lp.name} ended at KKT "
                                       f"{ref.kkt:.3e} above {limits['reference_kkt']}")
            got = certificate.measures(lp, op, ans.objective, ans.x, ans.y, ref.objective)
            for k in MEASURES:
                worst[k] = max(worst[k], got[k])
            if any(not got[k] <= limits[k] for k in MEASURES):
                failed += 1
    note(f"the reference solved {len(refs)} distinct LPs")
    return attempted, failed, worst


def run_cell(root: Path, bench: dict, workload: str, cell: dict, config: dict, seed: int,
             seconds: float, trace: bool, device: str, t_start: float):
    """One run of a cell: ``(result, compared)``; ``compared`` maps each
    number of the correctness check to ``(reading, limit)``."""
    import torch

    from portbench import guard

    on_card = device.startswith("cuda")
    family = _module("families", config["family"])
    kind = _module("kinds", cell["kind"]).Kind(cell, config, family, seed, device)
    try:
        kind.setup()
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        note(f"set-up {setup_s:.3f} s {' '.join(kind.notes)}")
        found = guard.loaded()
        if found:
            raise ImportError(f"loaded during set-up: {found}")

        records = []
        k = 1
        t_w, cpu_w = time.perf_counter(), time.process_time()
        cycle = int(cell["traffic"].get("cycle", 1))
        while True:
            records.append(kind.request(k))
            k += 1
            if time.perf_counter() - t_w >= seconds and len(records) % cycle == 0:
                break
        window_s = time.perf_counter() - t_w
        note(f"window {window_s:.3f} s (process CPU {time.process_time() - cpu_w:.3f} s), "
             f"{len(records)} requests; walls "
             f"{[round(r['wall'], 4) for r in records]} iterations "
             f"{[r['iterations'] for r in records]}")

        traced, breakdown = [], None
        if trace:
            t_t = time.perf_counter()
            with Traced(host=False) as slice_:
                kind.timed = slice_.call
                for _ in range(int(cell["trace_requests"])):
                    traced.append(kind.request(k))
                    k += 1
            # one more call with the host's operations, for the idle gaps alone
            with Traced(host=True) as detail:
                kind.timed = detail.call
                traced.append(kind.request(k))
            kind.timed = contextlib.nullcontext
            if len(slice_.summaries) != len(traced) - 1:
                raise RuntimeError(f"{len(slice_.summaries)} call windows in the trace of "
                                   f"{len(traced) - 1} calls")
            for rec, summary in zip(traced, slice_.summaries):
                rec["device"] = summary
            breakdown = {"device_ops": [list(p) for p in slice_.device_ops],
                         "idle_gaps": [list(p) for p in detail.idle_gaps]}
            note(f"traced {len(traced)} requests in {time.perf_counter() - t_t:.3f} s")

        peak = torch.cuda.max_memory_allocated() if on_card else 0
        name = torch.cuda.get_device_name() if on_card else "cpu"
        kind.release()
        if on_card:
            torch.cuda.empty_cache()
        ctx = Context(setup_s=setup_s, records=records, traced=traced, device_kind=name)
        limits = cell["limits"]
        t_j = time.perf_counter()
        attempted, failed, worst = judge(kind, records + traced, limits, device)
        note(f"judged {attempted} answers in {time.perf_counter() - t_j:.3f} s, {failed} failed")
    finally:
        kind.close()

    metrics = {}
    for m in metrics_of(bench, workload, trace):
        value = reader(root, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": name, "count": 1,
           "memory_peak_bytes": int(peak)}
    result = {"correct": attempted > 0 and failed == 0, "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        sums = ctx.summaries()
        dev["busy_s"] = sum(s.busy_s for s in sums)
        dev["window_s"] = sum(s.window_s for s in sums)
        result["breakdown"] = breakdown
    result["power_limit"] = power_limit() if on_card else ""
    compared = {k: (worst[k], limits[k]) for k in MEASURES}
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return result, compared


def run(workload: str, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, root: Optional[Path] = None):
    root = Path(root or ROOT)
    bench, _, cell, config = find_cell(root, workload)
    return run_cell(root, bench, workload, cell, config, seed, seconds, trace, device,
                    t_start)
