"""Scenario-fleet solving with the PyTorch port (the counterpart of
examples/scenario_fleet.py): many demand-shocked copies of one LP solved at
once, one lane per scenario.

The base LP is models/dense.py's dense resource-allocation LP (bench.py's
DENSE family), since the JAX example's AFIRO comes from a corpus that is not
in the repository.  Each scenario's demands are A·x_s for the base's x0
moved by 5 % per column (numpy seed 0), as bench.py's fleet moves them, so
every scenario stays feasible.

Run:  python examples/torch_scenario_fleet.py                    (on the GPU)
      RELP_TPU_TORCH_DEVICE=cpu python examples/torch_scenario_fleet.py
      ... --algorithm ipm --scenarios 64 --size 256x512
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from relp_tpu_torch.models.dense import SEED, dense_lp  # noqa: E402
from relp_tpu_torch.simplex.driver import solve_general_forms_batched  # noqa: E402
from relp_tpu_torch.utils.config import SolverConfig  # noqa: E402


def main(n_scenarios=16, m=64, n=128, algorithm="primal", device=None):
    base = np.random.default_rng(SEED)  # dense_lp's draws: A, then x0
    A = base.uniform(0.05, 1.0, (m, n))
    x0 = base.uniform(0.2, 1.0, n)
    rng = np.random.default_rng(0)
    generals = []
    for _ in range(n_scenarios):
        gf = dense_lp(m, n)
        gf.b = A @ (x0 * (1.0 + 0.05 * rng.standard_normal(n)))  # demand shocks
        generals.append(gf)

    stats = []
    t0 = time.perf_counter()
    results = solve_general_forms_batched(generals, SolverConfig(algorithm=algorithm),
                                          device=device, stats=stats)
    dt = time.perf_counter() - t0

    objs = [r.solution.objective_value for r in results if r.solution is not None]
    engines = ", ".join(str(g.get("engine")) for g in stats)
    print(f"solved {len(objs)}/{n_scenarios} scenarios in {dt:.3f}s ({engines} fleet)")
    print(f"objective range: [{min(objs):.3f}, {max(objs):.3f}]")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenarios", type=int, default=16)
    ap.add_argument("--size", default="64x128", help="rows x columns of the base LP")
    ap.add_argument("--algorithm", default="primal", choices=("primal", "dual", "pdlp", "ipm"))
    args = ap.parse_args()
    rows, cols = (int(v) for v in args.size.lower().split("x"))
    main(args.scenarios, rows, cols, args.algorithm)
