"""The cells at sizes that a CPU test can hold, read from their own files."""

import json
import time
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
SIZES = {"dense-768x1536": dict(rows=32, cols=64)}


def small_cell(workload: str):
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = json.loads((ROOT / "portbench" / "cells" / f"{workload}.json").read_text())
    config = json.loads((ROOT / "portbench" / "configs" / f"{cell['config']}.json").read_text())
    config = {**config, **SIZES[config["name"]]}
    cell = {**cell, "trace_requests": 1}
    if cell["kind"] == "resolve":
        cell["traffic"] = {**cell["traffic"], "bounds": 4, "cycle": 3}
    return bench, cell, config


def run_small(workload: str, seed: int = 2**31 + 11, seconds: float = 0.3, trace=False):
    bench, cell, config = small_cell(workload)
    return harness.run_cell(ROOT, bench, workload, cell, config, seed, seconds, trace, "cpu",
                            time.perf_counter())
