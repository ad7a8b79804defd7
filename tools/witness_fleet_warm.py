#!/usr/bin/env python3
"""The primal fleet's warm start on the lanes where it stalls: the JAX
package and relp_tpu_torch side by side, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/witness_fleet_warm.py [--m 256] [--n 512]
                        [--lanes 64] [--probe-iters 4000] [--only N]

Builds ``chip_smoke.py``'s primal fleet with demands and costs moved 3 %
(bench.py's DENSE generator, seed 20260819) and solves it with the port's
``solve_general_forms_batched`` (presolve off, every lane warm from one base
solve of lane 0, ``pdlp_fleet_warm``) under an iteration limit of
``--probe-iters``: the lanes left without an optimum are the stalling ones.
Beside them it counts the lanes for which the base LP's optimal vertex
(HiGHS) is primal infeasible: with its nonbasic columns at their bounds,
its basic columns solve ``A_B x_B = b_s − A_N x_N`` outside ``[0, 2]``.
Then it solves the fleet ``[lane 0] + those lanes`` (``--only`` keeps the
first N of them) with each package's ``solve_general_forms_batched`` at the
default limit, ``max(1000, 40·(m + n))``, and prints per lane the status,
the iterations and the objective of both, and HiGHS's objective.  Lanes of
a fleet are independent (vmapped in the JAX package, masked in the port),
so each lane takes the steps it takes in the whole fleet.  The JAX
package's fleet runs in calls of ``device_chunk_iters`` scaled to the
fleet's width, each warm from the last (relp_tpu/parallel/batched.py:96-130),
and reports the iterations of its last call only.

The tool imports both packages and runs on the CPU only (the port with
``device="cpu"``); a stalling lane takes minutes in either package.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sp
from scipy.optimize import linprog

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def infeasible_lanes(A, B, lb, ub, base_x, tol=1e-9):
    """The lanes whose demand ``B[s]`` puts the base vertex's basic columns
    out of their bounds by more than 1e-7."""
    basic = np.flatnonzero((base_x > lb[0] + tol) & (base_x < ub[0] - tol))
    if len(basic) != A.shape[0]:
        return None  # a degenerate base vertex: no square basis to test
    nonbasic = np.setdiff1d(np.arange(A.shape[1]), basic)
    x_N = np.where(base_x[nonbasic] > 0.5 * (lb[0, nonbasic] + ub[0, nonbasic]),
                   ub[0, nonbasic], lb[0, nonbasic])
    x_B = np.linalg.solve(A[:, basic], (B - x_N @ A[:, nonbasic].T).T).T
    viol = np.maximum(lb[:, basic] - x_B, x_B - ub[:, basic]).max(axis=1)
    return [s for s in range(B.shape[0]) if viol[s] > 1e-7]


def generals(el, gf, A, B, C, lanes):
    A_csc = sp.csc_matrix(A)
    m, n = A.shape
    return [gf.GeneralForm(objective=el.Objective.MINIMIZE, A=A_csc,
                           constraint_types=[el.RangedConstraintRelation.equal()] * m, b=B[s],
                           variables=[gf.Variable(f"x{j}", cost=C[s, j], lower=0.0, upper=2.0)
                                      for j in range(n)], name=f"dense{s}")
            for s in lanes]


def run_port(A, B, C, lanes, max_iter=0):
    from relp_tpu_torch.model import elements as el
    from relp_tpu_torch.model import general_form as gf
    from relp_tpu_torch.simplex.driver import solve_general_forms_batched
    from relp_tpu_torch.utils.config import SolverConfig

    stats = []
    t0 = time.perf_counter()
    res = solve_general_forms_batched(generals(el, gf, A, B, C, lanes),
                                      SolverConfig(presolve=False, max_iter=max_iter),
                                      device="cpu", stats=stats)
    return res, time.perf_counter() - t0, stats[0]


def run_jax(A, B, C, lanes):
    from relp_tpu.model import elements as el
    from relp_tpu.model import general_form as gf
    from relp_tpu.simplex.driver import solve_general_forms_batched
    from relp_tpu.utils.config import SolverConfig

    t0 = time.perf_counter()
    res = solve_general_forms_batched(generals(el, gf, A, B, C, lanes),
                                      SolverConfig(presolve=False, bucket_shapes=False))
    return res, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, default=256)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--probe-iters", type=int, default=4000,
                    help="iteration limit of the run that finds the stalling lanes")
    ap.add_argument("--only", type=int, default=0, help="keep the first N stalling lanes")
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import torch

    from chip_smoke import _fleet_arrays

    torch.set_num_threads(1)
    A, B, C, lb, ub = _fleet_arrays(args.m, args.n, args.lanes)
    base = linprog(C[0], A_eq=A, b_eq=B[0], bounds=list(zip(lb[0], ub[0])), method="highs")
    bad = infeasible_lanes(A, B, lb, ub, base.x)
    print(f"lanes for which the base vertex is primal infeasible: "
          f"{'not tested (degenerate base)' if bad is None else f'{len(bad)} of {args.lanes}'}",
          flush=True)
    probe, probe_s, info = run_port(A, B, C, range(args.lanes), args.probe_iters)
    its = [r.simplex.iterations for r in probe]
    stalled = [s for s, r in enumerate(probe) if r.solution is None]
    done = [i for s, i in enumerate(its) if s not in stalled]
    print(f"port, all {args.lanes} lanes, limit {args.probe_iters}: {probe_s:.1f} s, base solve "
          f"{info.get('base_iterations')} iterations, {min(done)}-{max(done)} iterations in the "
          f"lanes that finish; stalled: {stalled}", flush=True)
    lanes = [0] + stalled[: args.only or None]
    port, port_s, info = run_port(A, B, C, lanes)
    print(f"port: fleet of lanes {lanes} in {port_s:.1f} s", flush=True)
    ref, jax_s = run_jax(A, B, C, lanes)
    print(f"jax: fleet of lanes {lanes} in {jax_s:.1f} s", flush=True)
    for s, p, j in zip(lanes, port, ref):
        highs = linprog(C[s], A_eq=A, b_eq=B[s], bounds=list(zip(lb[s], ub[s])), method="highs")
        print(json.dumps({
            "lane": s, "highs": float(highs.fun),
            "port": {"kind": p.kind.value, "iterations": p.simplex.iterations,
                     "objective": None if p.solution is None else p.solution.objective_value},
            "jax": {"kind": j.kind.value, "iterations": j.simplex.iterations,
                    "objective": None if j.solution is None else j.solution.objective_value},
        }), flush=True)


if __name__ == "__main__":
    main()
