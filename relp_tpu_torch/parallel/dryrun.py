"""Every multi-device path on a list of devices, with a scaling table.

The counterpart of ``__graft_entry__.dryrun_multichip`` for this package::

    python -m relp_tpu_torch.parallel.dryrun 8 --device cpu

:func:`dryrun_multichip` builds a ('batch', 'cols') mesh as square as the
device count allows and runs, each to its end: the column-sharded single
solve to OPTIMAL; a fleet over 'batch'; the product path (the driver with
``mesh_cols``), certified against HiGHS; the first-order engine under the
same mesh; then the sharded and the batched solve at 1, 2, 4, ... devices on
the same problems, whose objectives must agree.  A device list may repeat a
device, so one card (or the CPU) runs every path: the walls then measure the
sharding's overhead, not a speed-up.
"""

from __future__ import annotations

import argparse
import time
from typing import Sequence

import numpy as np

from relp_tpu_torch.utils.device import device_list, visible_devices


def _problem(m, n, seed=0):
    """``__graft_entry__._problem``: a seeded sparse equality LP, feasible at
    a random point of [0, 1]ⁿ."""
    rng = np.random.default_rng(seed)
    A = np.where(rng.random((m, n)) < 0.12, rng.standard_normal((m, n)), 0.0)
    A[np.arange(m), rng.integers(0, n, m)] = 1.0  # no empty rows
    x_feas = rng.random(n)
    b = A @ x_feas
    c = rng.standard_normal(n)
    return A, b, c, np.zeros(n), np.full(n, np.inf)


def _square(k: int) -> int:
    """The 'batch' size of a mesh over ``k`` devices as square as possible."""
    return next(c for c in range(int(k ** 0.5), 0, -1) if k % c == 0)


def product_lp(m=24, n=64, seed=9):
    """The dryrun's product-path LP (``__graft_entry__.py:93-109``) as a
    GeneralForm: ``_problem(24, 64, seed=9)`` with ``0 <= x <= 10``; and its
    arrays ``(A, b, c)``."""
    import scipy.sparse as sp

    from relp_tpu_torch.model.elements import (
        ConstraintRelation, Objective, RangedConstraintRelation,
    )
    from relp_tpu_torch.model.general_form import GeneralForm, Variable

    A, b, c, _, _ = _problem(m, n, seed=seed)
    gf = GeneralForm(
        objective=Objective.MINIMIZE, A=sp.csc_matrix(A),
        constraint_types=[RangedConstraintRelation(ConstraintRelation.EQUAL)
                          for _ in range(m)],
        b=b,
        variables=[Variable(name=f"x{j}", cost=float(c[j]), lower=0.0, upper=10.0)
                   for j in range(n)],
    )
    return gf, (A, b, c)


def dryrun_multichip(devices: Sequence) -> list:
    """Run every multi-device path over ``devices``; raises on a wrong
    answer.  Returns the scaling table's rows ``(devices, sharded wall s,
    batched wall s, batched optimal of 8)`` after printing it."""
    import torch
    from scipy.optimize import linprog

    from relp_tpu_torch.fom.pdhg import solve_pdhg_batched
    from relp_tpu_torch.model.elements import LinearProgramType
    from relp_tpu_torch.parallel.batched import solve_batched
    from relp_tpu_torch.parallel.mesh import make_solver_mesh
    from relp_tpu_torch.parallel.sharded import solve_sharded
    from relp_tpu_torch.simplex import status as st
    from relp_tpu_torch.simplex.driver import solve_general_form
    from relp_tpu_torch.utils.config import SolverConfig

    devices = device_list(devices)
    cfg = SolverConfig()
    batch_size = _square(len(devices))
    cols_size = len(devices) // batch_size
    mesh = make_solver_mesh(batch=batch_size, cols=cols_size, devices=devices)

    # the column-sharded single solve, to OPTIMAL
    m, n = 16, 32 * cols_size
    A, b, c, lb, _ = _problem(m, n, seed=1)
    ub = np.full(n, 10.0)  # box: the random objective is otherwise unbounded
    out = solve_sharded(mesh, A, b, c, lb, ub, cfg=cfg, max_iter=400)
    if int(out.status) != st.OPTIMAL:
        raise AssertionError(f"sharded status={int(out.status)}")

    # a fleet over 'batch' (a few steps), and the first-order fleet likewise
    probs = [_problem(m, n, seed=2 + i) for i in range(2 * batch_size)]
    stacked = [np.stack(arrays) for arrays in zip(*probs)]
    stacked[4] = np.full_like(stacked[3], 10.0)
    solve_batched(*stacked, cfg=cfg, max_iter=5, mesh=mesh)
    solve_pdhg_batched(*stacked, round_len=16, max_rounds=2, mesh=mesh)

    # the product path: the driver with mesh_cols, certified against HiGHS
    gf, (A3, b3, c3) = product_lp()
    res = solve_general_form(gf, SolverConfig(mesh_cols=cols_size, presolve=False),
                             device=devices[0], devices=devices)
    if res.kind is not LinearProgramType.FINITE_OPTIMUM:
        raise AssertionError(f"meshed product path: {res.kind}")
    ref = linprog(c3, A_eq=A3, b_eq=b3, bounds=[(0, 10.0)] * len(c3), method="highs")
    got = res.solution.objective_value
    if ref.status == 0 and abs(got - ref.fun) > 1e-6 * (1 + abs(ref.fun)):
        raise AssertionError(f"meshed product path objective {got} != HiGHS {ref.fun}")

    # the first-order engine under the same mesh (the primal completes a
    # budget too small for it)
    res_fo = solve_general_form(
        product_lp()[0],
        SolverConfig(mesh_cols=cols_size, presolve=False, max_iter=600,
                     algorithm="pdlp", pdlp_crossover=False),
        device=devices[0], devices=devices)
    if res_fo.kind is not LinearProgramType.FINITE_OPTIMUM:
        raise AssertionError(f"meshed first-order path: {res_fo.kind}")

    # the scaling record: the sharded and the batched solve at 1, 2, 4, ...
    # devices on the same problems; equal objectives pin the placement
    counts = [k for k in (1, 2, 4, 8, 16) if k <= len(devices)]
    if len(devices) not in counts:
        counts.append(len(devices))
    table, ref_objs = [], None
    for k in counts:
        bk = _square(k)
        mesh_k = make_solver_mesh(batch=bk, cols=k // bk, devices=devices[:k])
        n_s = 32 * (k // bk)
        As, bs, cs, lbs, _ = _problem(16, n_s, seed=41)
        t0 = time.perf_counter()
        o1 = solve_sharded(mesh_k, As, bs, cs, lbs, np.full(n_s, 10.0), cfg=cfg, max_iter=400)
        w_shard = time.perf_counter() - t0
        if int(o1.status) != st.OPTIMAL:
            raise AssertionError(f"sharded solve over {k} devices: status {int(o1.status)}")

        probs8 = [_problem(24, 64, seed=50 + i) for i in range(8)]
        A8, b8, c8, lb8, _ = (np.stack(arrays) for arrays in zip(*probs8))
        t0 = time.perf_counter()
        o2 = solve_batched(A8, b8, c8, lb8, np.full_like(lb8, 10.0), cfg=cfg, max_iter=2000,
                           mesh=mesh_k)
        if o2.obj.device.type == "cuda":
            torch.cuda.synchronize(o2.obj.device)
        w_batch = time.perf_counter() - t0
        objs = np.where(o2.status.cpu().numpy() == st.OPTIMAL, o2.obj.cpu().numpy(), np.nan)
        if ref_objs is None:
            ref_objs = objs
        else:
            both = np.isfinite(ref_objs) & np.isfinite(objs)
            if not (np.allclose(ref_objs[both], objs[both], rtol=1e-9, atol=1e-9)
                    and both.sum() >= 7):
                raise AssertionError(f"batched objectives moved with the mesh: {ref_objs} {objs}")
        table.append((k, w_shard, w_batch, int(np.isfinite(objs).sum())))
    print("devices  sharded_wall_s  batched8_wall_s  batched_optimal")
    for k, ws, wb, nopt in table:
        print(f"{k:7d}  {ws:14.3f}  {wb:15.3f}  {nopt:15d}/8")
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m relp_tpu_torch.parallel.dryrun",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int, help="devices of the mesh (the visible ones, repeated)")
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: RELP_TPU_TORCH_DEVICE, else cuda)")
    args = ap.parse_args(argv)
    visible = visible_devices(args.device)
    dryrun_multichip([visible[i % len(visible)] for i in range(args.n_devices)])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
