#!/usr/bin/env python3
"""Run one cell of the benchmark of relp_tpu_torch and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads and warms the cell (counted as ``setup_s``), measures a closed loop
of requests for ``--seconds`` (the request under way when the time is up
finishes and counts), with ``--trace 1`` profiles a slice of further
requests, judges every answer against the plain reference, and prints the
compared numbers beside their limits on standard error and one JSON object
as the last line of standard output.  Exits non-zero, printing no result,
for an unknown cell, without enough CUDA cards, or when a module of JAX or
of the JAX package (``relp_tpu``) is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))
# one process with few threads: the loops are host-bound, and idle pool threads
# that spin after a parallel region take cores from the thread that dispatches
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "1")
# every compile cache at a fixed place inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(HERE / "_cache" / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import guard, harness

    try:
        _, entry, _, _ = harness.find_cell(ROOT, args.workload)
    except harness.UnknownCell as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"portbench: {args.workload} needs {entry['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 4
    result, compared = harness.run(args.workload, args.seed % (1 << 64), args.seconds,
                                   bool(args.trace), "cuda", T_START, root=ROOT)
    found = guard.loaded()
    if found:
        print(f"portbench: modules of JAX or of the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    if result.get("power_limit"):
        print(f"portbench: card and power limit: {result['power_limit']}", file=sys.stderr)
    for name, (value, limit) in compared.items():
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
