"""The control of ``correct``: the reference put in the program's place and
computed in float32, the precision below the float64 the configurations
state (TF32 off).  Its answers go through the same judge as a run's, at the
cell's own LPs; a sound benchmark must find them not correct.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 --requests <n>

prints, per seed, the judge's readings beside the cell's limits (on the
card when there is one, else on the CPU).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from portbench import harness
from portbench.kinds.base import Answer


def control_run(root: Path, workload: str, seed: int, requests: int, device: str,
                cell: dict = None, config: dict = None):
    """``(attempted, failed, worst)`` of the float32 reference's answers to
    the LPs of requests 1..``requests`` of a run with ``seed``."""
    import torch

    from portbench.reference import ipm

    if cell is None:
        cell = harness.load_json(root / "portbench" / "cells" / f"{workload}.json")
        config = harness.load_json(root / "portbench" / "configs" / f"{cell['config']}.json")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    family = harness._module("families", config["family"])
    kind = harness._module("kinds", cell["kind"]).Kind(cell, config, family, seed, device)
    kind.prepare()
    records = []
    for k in range(1, requests + 1):
        answers = []
        for key in kind.keys(k):
            lp = kind.lp_of(key)
            try:
                sol = ipm.solve(lp, torch.float32, device)
            except FloatingPointError:
                answers.append(Answer(key=key, ok=False))
                continue
            answers.append(Answer(key=key, ok=True, objective=sol.objective, x=sol.x, y=sol.y))
        records.append({"answers": answers})
    return harness.judge(kind, records, cell["limits"], device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, required=True)
    args = ap.parse_args(argv)
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    cell = harness.load_json(harness.ROOT / "portbench" / "cells" / f"{args.workload}.json")
    for seed in (int(s) for s in args.seeds.split(",")):
        attempted, failed, worst = control_run(harness.ROOT, args.workload, seed,
                                               args.requests, device)
        print(json.dumps({"workload": args.workload, "seed": seed, "device": device,
                          "attempted": attempted, "failed": failed,
                          "readings": worst, "limits": cell["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
