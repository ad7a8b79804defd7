#!/usr/bin/env python3
"""Smoke run of relp_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printing its own lines:

1. device  — requires a CUDA device; prints ``nvidia-smi``'s name and power
             limit of the card.
2. build   — builds every CUDA kernel from ``relp_tpu_torch/csrc`` (one nvcc
             per source, in parallel) and prints ptxas's register and spill
             report.
3. probe   — ``python -m relp_tpu_torch.probe``'s three probes (f32 and f64
             ``2·x``, the pricing grid through ``dense_price``).
4. kernels — every kernel against its plain PyTorch version on the card, in
             f32 and f64: ``ell_price`` (with and without ``c``, and on a
             partial-pricing window) at the max-flow operator's shapes and
             on a K = 8 pool; ``ell_spmv`` at three shapes (the max-flow
             operator's row pool, Kr = 31 over 4,096 rows; its column pool
             read as the rows of Aᵀ, Kr = 2 over 32,768 rows; and Kr = 31
             over 131,072 rows, where bandwidth shows); ``dense_price`` (with
             and without ``c``) at the dense LP's operator, on a window of
             it, at a wide 2,048 × 16,384 and at the first-order path's
             256 × 2,048 max-flow operator; ``probe_scale`` at [8, 128];
             ``brick_spmv`` (A·x) and ``brick_price`` (c − Aᵀy) on the bricks
             path's operator (the scaled N = 4,096 max flow in RCM order, 4,096
             × 32,768, its bricks compacted to their nonzeros) in its grouped
             layout and in the flat one, the bound counted from the nonzeros;
             ``ell_price_select`` and ``dense_price_select`` (the pricing
             pass with the entering column chosen in the kernel) on the two
             operators with the state of a solve cut at 600 iterations, and
             on made-up ties; the lane kernels ``dense_price_lanes`` (with
             and without ``c``) for 64 and for 17 lanes (a ragged last group;
             also with a partly dead group and a whole dead one) against the
             dense LP's shared operator, 16 lanes against the N = 1,024 max
             flow's dense operator (the first-order fleet's) and a stacked
             A[4, 256, 512], and ``dense_price_select_lanes`` on the state of
             a lane-batched solve cut mid-way (and with dead lanes; and on
             the partial-pricing windows [256, 512) and [129, 329)), each
             lane also held bit for bit against the single-vector kernel on
             its data, each row naming the lanes a block served; ``dual_update``
             (the dual step's update, port-only) under ``dse`` and ``devex`` on
             the operands of the 200th update of a cold dual solve of the dense
             LP 768 × 1536 and of the 4,096-node max flow on ELL, every output
             equal in bits to ``dual_update_plain``'s.  Each pricing kernel,
             ``ell_spmv``, both brick kernels and ``dual_update`` are run twice and must give the same bits.  Device time per launch (CUDA events over
             batches of 50 launches) beside the plain version's, the bound
             (the bytes the call must move at 3.35 TB/s, or its operations
             at the card's peak) and one PyTorch call as a yardstick
             (``addmv``/``mv`` of the dense window, ``addmm``/``mm`` or
             ``baddbmm``/``bmm`` of the lanes, ``mv`` of a sparse CSR matrix),
             and the time per call as the host issues it.
5. slice   — a seeded 4,096-node max-flow LP (32,768 arcs) written to MPS
             and solved through ``relp_tpu_torch.api.solve(path)`` on the
             ELL operator; the objective must equal ``scipy``'s max-flow
             value and the three ELL wrappers must have been launched by
             the solve, ``ell_price_select`` at least once per iteration.
6. dense   — the dense resource-allocation LP at 768 × 1536 written to MPS
             and solved through ``api.solve(path)``; the operator must be
             dense, the objective must equal HiGHS's (scipy ``linprog``,
             solved meanwhile by a second process on the host) within 1e-9
             relative, and ``dense_price`` and
             ``dense_price_select`` must each have been launched at least
             once per iteration.
7. options — each primal option on the card (the eta inverse, partial
             pricing, perturbation, the trace, the invariant check) on the
             dense LP at 256 × 512, against the default config's objective;
             partial pricing also on the ELL max flow at N = 1,024.
8. pdlp    — the first-order engine through ``api.solve(path,
             SolverConfig(algorithm="pdlp", ...))``: the 4,096-node max flow
             without crossover on the ELL operator (``engine == "pdlp"``,
             the objective within 1e-5 relative of ``scipy``'s, ``ell_price``
             and ``ell_spmv`` each launched at least once per iteration, all
             in f64, and of every host read of the solve one per round and
             one before the first); the max flow at N = 1,024 under the
             default config (``engine == "pdlp+crossover"``, the objective
             equal to ``scipy``'s) and under ``pdlp_precision="mixed"``
             without crossover (f32 rounds, one more read per 8 rounds for
             their f64 KKT); the max flow at N = 256 without crossover,
             which runs on the dense operator (``dense_price`` at least once
             per iteration).
9. bricks  — the first-order engine on the brick operator
             (``pdlp_matrix="bricks"``: the grouped 8 × 128 bricks of the scaled
             matrix in RCM order, compacted to their nonzeros on the card)
             through ``api.solve``: the max flows at
             N = 4,096 and N = 1,024 without crossover, each run in turns with
             the default operator (default, bricks, bricks, default: what
             ``"auto"`` was decided on), the objective within 1e-5 relative of
             ``scipy``'s and ``brick_spmv`` and ``brick_price`` each launched
             at least once per iteration; N = 1,024 with the crossover (the
             objective equal to ``scipy``'s) and under
             ``pdlp_precision="mixed"`` (the f32 brick operator on the path).
10. dual   — the dual simplex and what stands on it.  The 4,096-node max flow
             through ``api.solve(path, SolverConfig(algorithm="dual"))`` on the
             ELL operator (``engine == "dual"``, the objective equal to
             ``scipy``'s, ``ell_price`` at least once per iteration and
             ``ell_spmv`` at least once per refactorization, ``check_state``
             on the final state under 1e-6, here and on the dense LP;
             ``dual_update`` once per capture and once per replay, as
             ``update_kernel_steps`` counts it, here and on the dense LP); the
             same LP at N = 1,024 under
             ``dual_pricing="devex"``, ``dual_ratio="bisect"`` and
             ``xl_engine="lu"`` (``engine == "dual-lu"``, with the host LU's
             update engine); the dense LP 768 × 1536 under the dual against
             HiGHS, with ``dense_price``'s launches; ``reoptimize_with_bounds``
             on the dense LP at 256 × 512 after a seeded tenth of the upper
             bounds was tightened, against a cold primal solve; branch and
             bound with Gomory cuts on seeded multi-constraint 0/1 knapsacks
             (32 × 256 under a budget of 200 nodes, 8 × 48 to the optimum,
             through ``solve_mip`` and through the command line's ``--mip``)
             against ``scipy.optimize.milp``, solved meanwhile by the second
             process.
11. analysis — sensitivity ranging of the dense LP at 256 × 512 (a seeded
             sample of 8 cost and 8 rhs intervals, each finite end held against
             re-solves from the optimal basis just inside, where the objective
             must move along the reported slope, and just outside, where it
             must leave that line only on the side the optimal value's shape
             allows; costs by a warm primal, right-hand sides by
             ``reoptimize_with_bounds``'s dual simplex); the primal vertex of the N = 1,024 max flow
             certified optimal over ℚ (``certify_optimal_basis``, then
             ``polish_to_certified``: exact pivots and seconds), its exact
             objective equal to scipy's max flow; ``python -m relp_tpu_torch
             --verify --ranging --json`` and ``--verify`` on a small MPS file,
             exit 0.
12. colgen — column generation on the dense operator: the cutting stock of
             examples/column_range.py to its optimum (knapsack pricing) against
             HiGHS on the full enumeration of its patterns, and the masked
             64 × 10,000 pool of tests/test_lazy_pool_10k.py (priced over its
             active columns, then grown 32 columns a round by reduced cost to
             the optimum over every column) against HiGHS; rounds, iterations
             and ``dense_price*`` launches, ``dense_price_select`` at least
             once per iteration.  HiGHS runs in the second process.
13. ipm    — the interior point (``algorithm="ipm"``) under
             ``ipm_ladder="f64"`` and ``"mixed"``: the dense LP 768 × 1536
             without crossover against HiGHS (1e-6 relative), with the share
             of the wall in the normal-equation product and Cholesky (an
             instrumented second solve), and at 256 × 512 with crossover
             (1e-9; at 768 × 1536 the crossover's host push takes minutes,
             which ``tools/profile_torch_slice.py --problem ipm --crossover``
             measures); the max flow at N = 1,024 with crossover and at
             N = 4,096 without (a 1 GiB dense operator), against scipy's max
             flow.
14. fleet  — ``solve_general_forms_batched`` on the card, one engine each:
             the interior-point fleet on bench.py's fleet configuration
             (DENSE-768x1536, 64 scenarios, demand and cost moved 3 %, seed
             20260819, presolve off), every lane's primal residual and KKT
             gap from its own x and duals under 1e-6 and lanes 0 and 63
             against HiGHS (solved meanwhile by two more processes); the
             lane-batched primal on 64 scenarios of the dense LP at 256 × 512
             (costs moved 3 %, demands kept: see phase_fleet; presolve off as
             in every fleet here), warm from one base solve, every lane
             against HiGHS, with
             ``dense_price_select_lanes`` and ``dense_price_lanes`` at least
             once per batched iteration; the same 64 lanes again under each
             primal option through ``parallel.solve_batched`` from the
             default run's warm start (``inverse="eta"``,
             ``price_blocks=2`` with its windowed lane-select launches
             counted, ``trace_iters``, ``check_every_n=50``) and under all
             four through ``solve_general_forms_batched`` (its base solve
             under them too), every lane against HiGHS, the lane of the
             median and the lane of the most iterations against their
             single ``solve_core`` from the same warm basis (iterations,
             basis, the trace's phase, events, q and r), under
             ``check_every_n`` each lane's check value against a violation
             planted at step 0 and at step 50 (only while it is live), host
             reads per batched iteration no more than the default run's,
             each run's wall, launches and peak memory beside the default
             run's; the first-order fleet on 16
             perturbed max flows at N = 1,024 (shared A, presolve off), each
             against ``scipy``'s max flow, with ``dense_price_lanes`` at least
             once per PDHG step.  Wall, LPs/s, iterations, host reads per
             step, launches per iteration and peak memory of each.  Then
             ``examples/torch_scenario_fleet.py`` (16 scenarios, the IPM fleet).
15. mesh   — the multi-device paths (``relp_tpu_torch/parallel/``) on two
             shards of the one card (``devices=["cuda:0"] * 2``): first the
             sharded operator's ``price_select`` and ``price32_select`` on the
             slice's ELL pool (two blocks of 16,384 columns) and the dense LP
             at 256 × 512 (two of 256), at the mid-solve state of the kernels
             phase, over the whole pool and a window across the shard
             boundary, against the plain selection of the whole pool (q and
             has equal, d_q within the kernels' tolerance) and the single
             operator's bits; then the slice's max flow through
             ``api.solve(path, SolverConfig(mesh_cols=2))`` on ELL (scipy's objective, the slice's iterations and host reads,
             ``ell_price_select`` launched twice as often as by the slice's
             single solve: once per shard), the dense LP at 256 × 512 with
             ``mesh_cols=2`` (HiGHS's objective within 1e-9 relative, the
             options phase's iterations and host reads,
             ``dense_price_select`` at least twice per iteration), the N = 4,096
             max flow under ``algorithm="pdlp"``, ``pdlp_matrix="bricks"`` and
             ``mesh_cols=2`` (no brick kernel launched: a mesh that shards takes
             ELL; the pdlp phase's iterations and objective), ``solve_batched``
             and ``solve_pdhg_batched`` with a mesh of two 'batch' rows against
             their unmeshed runs lane by lane (and each row's 2-lane
             ``dense_price_select_lanes`` launch at 64 × 128, at step 16 of the
             meshed solve, against the plain selection of its lanes), and a
             one-rank NCCL process group (``multihost._join``, the path of
             ``initialize_distributed`` for more than one process) that gathers
             a 2-scenario fleet's objectives and is destroyed.  The walls stand
             beside the single solve's: two shards on one card measure the
             sharding's overhead, not a speed-up.
16. xl     — the XL gate (``SolverConfig.refactor_external_m``): a default-config
             (``algorithm="primal"``) solve above it goes to the host sparse-LU
             dual.  The 4,096-node max flow through ``api.solve(path)`` under
             ``refactor_external_m=2048`` and a block-diagonal LP of 1,600 boxed
             8 × 32 blocks (tests/test_parallel.py's recipe from seeds 1000 + k;
             12,800 rows, 51,200 columns) under the default config: each with
             ``engine == "dual-lu"``, no kernel launched and the peak of device
             memory less than 64 MiB above the start (no device operator, no
             B⁻¹: the primal's alone is 128 MiB at N = 4,096); the max flow's
             objective equal to scipy's and its iterations to those of
             ``algorithm="dual", xl_engine="lu"``, the blocks' objective to the
             sum of HiGHS's block optima within 1e-9 relative (both references
             computed meanwhile by another process on the host's CPU).
17. cli    — ``relp_tpu_torch.cli.main(["-q", file])`` on a small MPS file, and
             with ``--algorithm pdlp --pdlp-matrix bricks`` (both brick kernels
             launched).

Launch counts: every kernel's count is set to 0 just before each path that
runs it (probe, slice, dense, pdlp, bricks, the primal and first-order fleets,
the mesh phase's paths) and read just after (``xl`` requires that its paths
launch none).  A launch replayed from a CUDA graph of the dual's step counts
apart from those made from the host: the wrapper calls recorded into each
graph, times its replays in the path (``REPLAYED``, and the report's
``replayed_launches``); the dual's checks add the two.  Launches made to
compare a kernel with its plain version do not count.  (``dual`` is the
N = 4,096 dual solve; its other runs keep their counts apart.)  The report's
``launches`` is the count of the path whose shape and mode the kernel's
timed row has: ``pdlp`` at N = 4,096 for ``ell_price`` and ``ell_spmv`` (f64
``c − Aᵀy`` and A·x), ``dense`` for ``dense_price`` (the f32 sum row), the
first-order fleet for ``dense_price_lanes`` (16 lanes of ``C − Y·A`` at
N = 1,024, f32), ``dual dense`` for ``dual_update`` (the dense LP under the
dual, ``dse``), the primal fleet for ``dense_price_select_lanes`` (the
f32 scan) and the bricks path at N = 4,096 for ``brick_spmv`` and
``brick_price`` (f64 A·x and c − Aᵀy, grouped); the other first-order runs
keep their counts apart.  Every path's counts are
printed in its phase and checked at the end.  Any failure raises, so the
run exits nonzero without the final line.  The line before the last is the
kernel report, one JSON object; the last line is ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_NODES = 4096          # max-flow graph size of the slice
SEED = 7
DENSE_SHAPE = (768, 1536)   # the dense LP's documented default size
OPTIONS_SHAPE = (256, 512)  # smallest dense size at which mixed pricing stays on
OPTIONS_NODES = 1024
PDLP_DENSE_NODES = 256  # max flow small enough for the dense operator
KNAPSACK_WIDE = (32, 256)   # rows × binary columns; no incumbent within its node budget
KNAPSACK_WIDE_NODES = 200
KNAPSACK_SMALL = (8, 48)    # solved to the optimum by the default budget
MILP_SECONDS = 60           # HiGHS's time limit on a knapsack
TIMED_RUNS = 50
HOLD_CYCLES = 100_000_000  # ~50 ms of a sleep kernel at the H100's clock
F32_TOL = 2e-5          # f32 sums run in another order (and fused) than the plain version
F64_TOL = 1e-12
OBJ_REL = 1e-9
MID_SOLVE_ITERS = 600   # where the select comparisons take their state
DUAL_UPDATE_AT = 200    # the update of a cold dual solve whose operands dual_update is held on
MESH_LANE_STEP = 16     # where the [mesh] phase's lane comparison takes its state
ANALYSIS_SAMPLE = 8     # cost and rhs intervals of the dense LP held against re-solves
CUT_WIDTH = 100.0       # examples/column_range.py's cutting stock
CUT_SIZES = (45.0, 36.0, 31.0, 14.0)
CUT_DEMAND = (97.0, 610.0, 395.0, 211.0)
POOL_SHAPE = (64, 10_000)   # tests/test_lazy_pool_10k.py's masked pool
POOL_BATCH = 32         # inactive columns activated per column-generation round
IPM_NODES = 4096        # the interior point's largest max flow (dense operator, 1 GiB)
XL_GATE = 2048          # [xl]: refactor_external_m below the slice's m_pad (4,096)
XL_BLOCKS = 1600        # [xl]: block-diagonal LP of 1,600 boxed 8 × 32 blocks, m_pad 12,800
XL_BLOCK_SHAPE = (8, 32)
XL_BLOCK_SEED = 1000    # block k from seed 1000 + k
XL_PEAK_MIB = 64        # [xl]: the host LU route builds no device operator and no B⁻¹
FLEET_SEED = 20260819   # bench.py's fleet suite: its perturbations' seed
FLEET_LANES = 64        # bench.py's DENSE fleet: 64 scenarios
FLEET_PRIMAL_SHAPE = (256, 512)
FLEET_FLOW_LANES = 16
FLEET_FLOW_NODES = 1024
RAGGED_LANES = 17       # a lane count that leaves the last group of lanes ragged
LANE_WINDOWS = ((256, 256), (129, 200))  # partial-pricing windows of the lane select
FLEET_OPTIONS = (  # the primal options, each through the primal fleet (check: every 50 steps)
    ("inverse=eta", dict(inverse="eta")), ("price_blocks=2", dict(price_blocks=2)),
    ("trace_iters", dict(trace_iters=True)), ("check_every_n=50", dict(check_every_n=50)))
TRACE_EXACT = [0, 5, 6, 7]  # trace columns phase, events, q, r
# NVIDIA's H100 SXM data sheet: device memory rate, the float32 rate outside
# the tensor cores, and the float64 rate on them (the larger of the two
# float64 rates, 34 TFLOP/s outside them): a bound is the least time the card
# could take
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 67e12}

# the classic MPS example (en.wikipedia.org, "MPS (format)"); optimum -8
WIKI_MPS = """NAME          TESTPROB
ROWS
 N  COST
 L  LIM1
 G  LIM2
 E  MYEQN
COLUMNS
    X1        COST                 1   LIM1                 1
    X1        LIM2                 1
    X2        COST                 2   LIM1                 1
    X2        MYEQN               -1
    X3        COST                -1   LIM2                 1
    X3        MYEQN                1
RHS
    RHS1      LIM1                 4   LIM2                 1
    RHS1      MYEQN                7
BOUNDS
 UP BND1      X1                   4
 LO BND1      X2                  -1
ENDATA
"""

KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "ell_price": ("relp_tpu_torch/csrc/sparse_kernels.cu", "relp_tpu/ops/pallas_kernels.py:126"),
    "ell_price_select": ("relp_tpu_torch/csrc/sparse_kernels.cu",
                         "relp_tpu/ops/pallas_kernels.py:126"),
    "ell_spmv": ("relp_tpu_torch/csrc/sparse_kernels.cu", "relp_tpu/ops/pallas_kernels.py:64"),
    "dense_price": ("relp_tpu_torch/csrc/dense_kernels.cu", "tools/probe_pallas.py:50"),
    "dense_price_select": ("relp_tpu_torch/csrc/dense_kernels.cu", "tools/probe_pallas.py:50"),
    "dense_price_lanes": ("relp_tpu_torch/csrc/dense_kernels.cu", "tools/probe_pallas.py:50"),
    "dense_price_select_lanes": ("relp_tpu_torch/csrc/dense_kernels.cu",
                                 "tools/probe_pallas.py:50"),
    "brick_spmv": ("relp_tpu_torch/csrc/brick_kernels.cu", "relp_tpu/ops/pallas_kernels.py:64"),
    "brick_price": ("relp_tpu_torch/csrc/brick_kernels.cu",
                    "relp_tpu/ops/pallas_kernels.py:126"),
    # the JAX package's dual loop body is one XLA program, which fuses the chain
    "dual_update": ("relp_tpu_torch/csrc/dual_kernels.cu", "port-only"),
    "probe_scale_f32": ("relp_tpu_torch/csrc/probe_kernels.cu", "tools/probe_pallas.py:24"),
    "probe_scale_f64": ("relp_tpu_torch/csrc/probe_kernels.cu", "tools/probe_pallas.py:37"),
}


def _wrappers():
    """Every kernel wrapper by name (each carries its ``launches`` count)."""
    from relp_tpu_torch.ops.brick_kernels import brick_price, brick_spmv
    from relp_tpu_torch.ops.dense_kernels import (
        dense_price, dense_price_lanes, dense_price_select, dense_price_select_lanes,
    )
    from relp_tpu_torch.ops.dual_kernels import dual_update
    from relp_tpu_torch.ops.probe_kernels import probe_scale_f32, probe_scale_f64
    from relp_tpu_torch.ops.sparse_kernels import ell_price, ell_price_select, ell_spmv

    return {"ell_price": ell_price, "ell_price_select": ell_price_select,
            "ell_spmv": ell_spmv, "dense_price": dense_price,
            "dense_price_select": dense_price_select, "dense_price_lanes": dense_price_lanes,
            "dense_price_select_lanes": dense_price_select_lanes,
            "brick_spmv": brick_spmv, "brick_price": brick_price,
            "dual_update": dual_update,
            "probe_scale_f32": probe_scale_f32, "probe_scale_f64": probe_scale_f64}


PATHS = {}  # path -> {kernel: launches}: what every driven path launched from the host
REPLAYED = {}  # path -> {kernel: launches}: what it launched by replaying the dual's step graphs
SOLVES = {}  # phase -> what a later phase compares with (the single solves' metrics)
GRAPHS = []  # per step graph the dual captured: its wrapper calls recorded, its replays


def count_graph_launches():
    """Record, for each step graph the dual captures, the wrapper calls made
    while its stream recorded (counted by the wrappers on the host, launched
    only by its replays) and its replays."""
    import torch

    from relp_tpu_torch.simplex import dual

    wrappers = _wrappers()
    body, replay = dual.StepGraph.body, dual.StepGraph.replay

    def recorded_body(self, Ks):
        if not torch.cuda.is_current_stream_capturing():
            return body(self, Ks)
        before = {k: w.launches for k, w in wrappers.items()}
        flags = body(self, Ks)
        self.launch_record = {"recorded": {k: w.launches - before[k]
                                           for k, w in wrappers.items()}, "replays": 0}
        GRAPHS.append(self.launch_record)
        return flags

    def counted_replay(self):
        self.launch_record["replays"] += 1
        return replay(self)

    dual.StepGraph.body, dual.StepGraph.replay = recorded_body, counted_replay


@contextlib.contextmanager
def counted(names, launches, path):
    """Set the named kernels' counts to 0, run the path, record the counts:
    launched from the host (in ``launches`` for the report and under
    ``PATHS[path]``) and replayed from the dual's step graphs (in
    ``launches`` as "<kernel> replayed" and under ``REPLAYED[path]``)."""
    wrappers = _wrappers()
    for name in names:
        wrappers[name].launches = 0
    first, replays = len(GRAPHS), [g["replays"] for g in GRAPHS]
    yield
    new = GRAPHS[first:]
    replays += [0] * len(new)
    PATHS[path] = {name: wrappers[name].launches - sum(g["recorded"][name] for g in new)
                   for name in names}
    REPLAYED[path] = {name: sum(g["recorded"][name] * (g["replays"] - r)
                                for g, r in zip(GRAPHS, replays)) for name in names}
    launches.update(PATHS[path])
    launches.update({f"{name} replayed": v for name, v in REPLAYED[path].items()})


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this "
                         "smoke run needs an NVIDIA GPU")
    if not (ROOT / "relp_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: no relp_tpu_torch package under {ROOT}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device_count {torch.cuda.device_count()} name {torch.cuda.get_device_name(0)}")
    print(smi)
    return smi


def phase_build():
    from relp_tpu_torch.ops.cuda_build import load_kernels

    t0 = time.perf_counter()
    lib = load_kernels()
    print(f"[build] {lib.path.relative_to(ROOT)} nvcc {lib.build_s:.2f} s "
          f"(load total {time.perf_counter() - t0:.2f} s)")
    for line in lib.log.splitlines():
        if "registers" in line or "spill stores" in line:
            print(f"[build] {line.strip()}")


def phase_probe(launches):
    from relp_tpu_torch import probe

    buf = io.StringIO()
    with counted(("probe_scale_f32", "probe_scale_f64"), launches, "probe"), \
            contextlib.redirect_stdout(buf):
        rc = probe.main()
    for line in buf.getvalue().splitlines():
        print(f"[probe] {line}")
    if rc != 0:
        raise AssertionError(f"[probe] python -m relp_tpu_torch.probe exited {rc}")


def _device_ms(fn, runs=TIMED_RUNS, batches=5):
    """Device time of one call of ``fn``, in ms: the median over ``batches``
    of the mean over ``runs`` back-to-back calls.  A sleep kernel holds the
    stream while the host enqueues a batch, so the CUDA events bracket the
    calls' device work alone and not the Python that launches them."""
    import torch

    for _ in range(5):
        fn()
    means = []
    for _ in range(batches):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(HOLD_CYCLES)
        e0.record()
        for _ in range(runs):
            fn()
        e1.record()
        if e0.query():
            raise RuntimeError("the host enqueued a batch slower than the sleep held "
                               "the stream; raise HOLD_CYCLES")
        e1.synchronize()
        means.append(e0.elapsed_time(e1) / runs)
    return statistics.median(means)


def _host_ms(fn, runs=TIMED_RUNS):
    """Wall time of one call of ``fn`` as the host issues it, in ms (the
    rate at which a loop can launch it), synchronised at the end."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / runs


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _agree(phase, label, got, want, tol, scale=1.0):
    """Raise unless a kernel's result ``got`` agrees with its plain version's
    ``want``: a selection ``(q, has, d_q)`` exactly in ``q`` and ``has``, the
    values within ``tol·(1 + |want|)``, ``tol`` widened by ``scale`` (see
    :func:`_compare`).  Returns ``(the choice as text, max abs err, tol)``."""
    import torch

    choice = ""
    if isinstance(got, tuple):
        (q, has, got), (q0, has0, want) = got, want
        if not (torch.equal(q, q0) and torch.equal(has, has0)):
            raise AssertionError(f"[{phase}] {label}: chose (q, has) = ({q.tolist()}, "
                                 f"{has.tolist()}), the plain version ({q0.tolist()}, "
                                 f"{has0.tolist()})")
        choice = (f"q {int(q)} has {bool(has)} == plain; d_q " if q.dim() == 0 else
                  f"(q, has) of all {q.numel()} lanes == plain; d_q ")
    err = (got - want).abs()
    tol = tol * max(1.0, scale)
    bound = tol + tol * want.abs()
    if not bool(torch.isfinite(got).all()) or bool((err > bound).any()):
        raise AssertionError(f"[{phase}] {label}: max abs err {float(err.max()):.3e} "
                             f"exceeds {tol:g} (rel/abs)")
    return choice, float(err.max()), tol


def _compare(label, kernel_fn, plain_fn, tol, smi, *, nbytes, flops, tag,
             library_fn=None, library=None, same_bits=False, scale=1.0, plain_runs=TIMED_RUNS):
    """Launch, synchronise, compare with the plain version, then time both
    (and ``library_fn``, one PyTorch call named ``library``).  A selection
    ``(q, has, d_q)`` must agree exactly in ``q`` and ``has``.  ``nbytes``
    and ``flops`` are what the call must move and compute: they give the
    bound.  ``scale`` widens the tolerance to the size of the terms summed
    where they cancel, ``plain_runs`` shortens the timed batches of a plain
    version of many launches.  Returns the kernel's row of the report."""
    import torch

    got = kernel_fn()
    torch.cuda.synchronize()
    want = plain_fn()
    torch.cuda.synchronize()
    if same_bits:
        again = kernel_fn()
        torch.cuda.synchronize()
        pairs = zip(got, again) if isinstance(got, tuple) else [(got, again)]
        if not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"[kernels] {label}: two runs gave different bits")
    choice, max_err, tol = _agree("kernels", label, got, want, tol, scale)
    by_bytes, by_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FLOPS[tag] * 1e3
    row = {"max_abs_err": max_err, "ms": _device_ms(kernel_fn),
           "plain_ms": _device_ms(plain_fn, plain_runs, batches=3),
           "bound_ms": max(by_bytes, by_ops),
           "bound_by": "bytes" if by_bytes >= by_ops else "operations",
           "library_ms": None if library_fn is None else _device_ms(library_fn, batches=3)}
    host_ms, plain_host_ms = _host_ms(kernel_fn), _host_ms(plain_fn, plain_runs)
    lib = "" if library_fn is None else f" {library} {row['library_ms'] * 1e3:.2f} us"
    print(f"[kernels] {label}: {choice}max_abs_err {row['max_abs_err']:.3e} "
          f"(bound {tol:g}·(1 + |plain|)){' same bits twice' if same_bits else ''}; "
          f"device kernel {row['ms'] * 1e3:.2f} us plain {row['plain_ms'] * 1e3:.2f} us{lib} "
          f"least {row['bound_ms'] * 1e3:.2f} us ({nbytes / 1e6:.2f} MB, by {row['bound_by']}: "
          f"{row['bound_ms'] / row['ms']:.0%} of it reached); "
          f"per call from the host kernel {host_ms * 1e3:.1f} us plain "
          f"{plain_host_ms * 1e3:.1f} us [{smi}]")
    return row


def slice_problem(n_nodes=None):
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import maximum_flow

    from relp_tpu_torch.models.networks import max_flow_lp, random_arcs

    n_nodes = N_NODES if n_nodes is None else n_nodes
    arcs = random_arcs(n_nodes, 8, SEED)
    u, v, cap = (np.array(col) for col in zip(*arcs))
    graph = sp.csr_matrix((cap.astype(np.int32), (u, v)), shape=(n_nodes, n_nodes))
    flow = maximum_flow(graph, 0, n_nodes - 1).flow_value
    return max_flow_lp(n_nodes, arcs, 0, n_nodes - 1), float(flow)


def _operator(general, dev, expect):
    """The device operator the driver builds for ``general`` (presolved,
    lowered and padded as the driver does)."""
    from relp_tpu_torch.model.computational_form import build_computational_form
    from relp_tpu_torch.presolve.engine import presolve
    from relp_tpu_torch.simplex.driver import device_problem
    from relp_tpu_torch.utils.config import DEFAULT_CONFIG

    presolve(general)
    op = device_problem(build_computational_form(general, scale=True), DEFAULT_CONFIG, dev).A
    if op.format != expect:
        raise AssertionError(f"[kernels] operator is {op.format}, expected {expect}")
    return op


def _csr_of_pool(data_t, idx_t, n_minor):
    """The K-major ELL pool as a sparse CSR matrix [n, n_minor] (one row per
    pool element, padding slots kept): the operand of the ``torch.mv``
    yardstick.  The port never builds one."""
    import torch

    K, n = data_t.shape
    crow = torch.arange(n + 1, dtype=torch.int32, device=data_t.device) * K
    return torch.sparse_csr_tensor(crow, idx_t.T.contiguous().reshape(-1),
                                   data_t.T.contiguous().reshape(-1), size=(n, n_minor),
                                   check_invariants=False)


def _kernels_ell(smi, dev, rng, op):
    import torch

    from relp_tpu_torch.ops.sparse_kernels import (
        ell_price, ell_price_plain, ell_spmv, ell_spmv_plain,
    )

    m_pad, n_pad = op.shape
    # a K = 8 column pool at the slice's width, rows spread over m
    K8_rows = torch.as_tensor(rng.integers(0, m_pad, (8, n_pad)).astype("int32"), device=dev)
    K8_data = torch.as_tensor(rng.standard_normal((8, n_pad)), device=dev)
    pools = {
        f"slice K={op.data_t.shape[0]} n={n_pad} m={m_pad}": (op.data_t, op.rows_t),
        f"K=8 n={n_pad} m={m_pad}": (K8_data, K8_rows),
    }
    y = torch.as_tensor(rng.standard_normal(m_pad), device=dev)
    c = torch.as_tensor(rng.standard_normal(n_pad), device=dev)
    x = torch.as_tensor(rng.standard_normal(n_pad), device=dev)
    mv = "torch.mv(sparse CSR)"
    wide_m, wide_n = 131072, 1048576
    spmv_pools = {  # name -> (rdata_t [Kr, m], rcols_t, the vector gathered from)
        "slice": (op.rdata_t, op.rcols_t, x),
        "short rows": (op.data_t, op.rows_t, y),
        "bandwidth": (
            torch.as_tensor(rng.standard_normal((31, wide_m)), device=dev),
            torch.as_tensor(rng.integers(0, wide_n, (31, wide_m)).astype("int32"), device=dev),
            torch.as_tensor(rng.standard_normal(wide_n), device=dev)),
    }
    report = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        tag = "f32" if dtype == torch.float32 else "f64"
        yd, cd, xd = y.to(dtype), c.to(dtype), x.to(dtype)
        for pool, (data_t, rows_t) in pools.items():
            dd = data_t.to(dtype).contiguous()
            csr = _csr_of_pool(dd, rows_t, m_pad)
            common = dict(flops=2 * dd.numel(), tag=tag, library_fn=lambda: torch.mv(csr, yd),
                          library=mv, same_bits=True)
            report[("ell_price", tag, "c", pool)] = _compare(
                f"ell_price {tag} c-d {pool}",
                lambda: ell_price(dd, rows_t, yd, cd),
                lambda: ell_price_plain(dd, rows_t, yd, cd), tol, smi,
                nbytes=_nbytes(dd, rows_t, yd, cd, cd), **common)
            report[("ell_price", tag, "sum", pool)] = _compare(
                f"ell_price {tag} sum {pool}",
                lambda: ell_price(dd, rows_t, yd),
                lambda: ell_price_plain(dd, rows_t, yd), tol, smi,
                nbytes=_nbytes(dd, rows_t, yd, cd), **common)
        # partial pricing's window: one block of four, c of the block
        dd = op.data_t.to(dtype).contiguous()
        w = n_pad // 4
        cw = cd[w:2 * w]
        csr_w = _csr_of_pool(dd[:, w:2 * w].contiguous(), op.rows_t[:, w:2 * w].contiguous(), m_pad)
        _compare(f"ell_price {tag} c-d window [{w}, {2 * w}) of the slice pool",
                 lambda: ell_price(dd, op.rows_t, yd, cw, w, w),
                 lambda: ell_price_plain(dd, op.rows_t, yd, cw, w, w), tol, smi,
                 nbytes=_nbytes(dd, op.rows_t) // 4 + _nbytes(yd, cw, cw), flops=dd.numel() // 2,
                 tag=tag, library_fn=lambda: torch.mv(csr_w, yd), library=mv, same_bits=True)
        # A·x: the slice's row pool, its column pool read as the rows of Aᵀ
        # (short rows: one segment), and a pool where bandwidth shows.  The
        # segments' partial sums meet in another order than the plain
        # version's k = 0 .. Kr-1, so the two agree within the tolerance, not
        # bit for bit; two runs of the kernel must give the same bits.
        for name, (rdata_t, rcols_t, xs) in spmv_pools.items():
            rd = rdata_t.to(dtype).contiguous()
            xv = xs.to(dtype)
            csr_r = _csr_of_pool(rd, rcols_t, xv.shape[0])
            Kr, rows = rd.shape
            report[("ell_spmv", tag, name)] = _compare(
                f"ell_spmv {tag} {name} Kr={Kr} m={rows} n={xv.shape[0]}",
                lambda: ell_spmv(rd, rcols_t, xv),
                lambda: ell_spmv_plain(rd, rcols_t, xv), tol, smi,
                nbytes=_nbytes(rd, rcols_t, xv) + rows * xv.element_size(),
                flops=2 * rd.numel(), tag=tag, library_fn=lambda: torch.mv(csr_r, xv),
                library=mv, same_bits=True)
            del csr_r
    slice_pool = next(iter(pools))
    # the first-order path's launches (f64 under the default config): c − Aᵀy and A·x
    return {
        "ell_price": report[("ell_price", "f64", "c", slice_pool)],
        "ell_spmv": report[("ell_spmv", "f64", "slice")],
    }


def _kernels_dense(smi, dev, rng, op, fo_op):
    """``dense_price`` at the dense LP's operator, on a partial-pricing
    window of it, at a wide shape, and at the operator the first-order path
    gives it (``fo_op``, the N = 256 max flow: ``c − Aᵀy`` in f32 and f64).
    Nonnegative inputs, as the LP's are, keep the f32 sums' error relative to
    their size."""
    import torch

    from relp_tpu_torch.ops.dense_kernels import dense_price, dense_price_plain

    m_pad, n_pad = op.shape
    wide = torch.as_tensor(rng.uniform(0.05, 1.0, (2048, 16384)), device=dev)
    cases = {  # label -> (A, j0, w)
        f"dense LP operator m={m_pad} n={n_pad}": (op.A, 0, n_pad),
        f"window [{n_pad // 4}, {n_pad // 2}) of the dense LP operator":
            (op.A, n_pad // 4, n_pad // 4),
        "wide m=2048 n=16384": (wide, 0, 16384),
        f"max-flow N={PDLP_DENSE_NODES} operator m={fo_op.shape[0]} n={fo_op.shape[1]}":
            (fo_op.A, 0, fo_op.shape[1]),
    }
    report = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        tag = "f32" if dtype == torch.float32 else "f64"
        for label, (A, j0, w) in cases.items():
            Ad = A.to(dtype).contiguous()
            m = Ad.shape[0]
            v = torch.as_tensor(rng.uniform(0.0, 1.0, m), dtype=dtype, device=dev)
            c = torch.as_tensor(rng.uniform(0.0, 1.0, w), dtype=dtype, device=dev)
            At = Ad[:, j0:j0 + w].t()
            window_bytes = m * w * Ad.element_size()
            common = dict(flops=2 * m * w, tag=tag, same_bits=True)
            report[(tag, "c", label)] = _compare(
                f"dense_price {tag} c-d {label}",
                lambda: dense_price(Ad, v, c, j0, w),
                lambda: dense_price_plain(Ad, v, c, j0, w), tol, smi,
                nbytes=window_bytes + _nbytes(v, c, c),
                library_fn=lambda: torch.addmv(c, At, v, alpha=-1),
                library="torch.addmv(c, A.t(), v, alpha=-1)", **common)
            report[(tag, "sum", label)] = _compare(
                f"dense_price {tag} sum {label}",
                lambda: dense_price(Ad, v, None, j0, w),
                lambda: dense_price_plain(Ad, v, None, j0, w), tol, smi,
                nbytes=window_bytes + _nbytes(v, c),
                library_fn=lambda: torch.mv(At, v), library="torch.mv(A.t(), v)", **common)
    # the dense path's launch of this wrapper: the f32 devex row (the sum)
    return {"dense_price": report[("f32", "sum", next(iter(cases)))]}


def _mid_solve_state(general, dev, iters):
    """``(selection, π, c_eff)`` as the engine's pricing meets them at
    iteration ``iters`` of a default-config solve of ``general``."""
    from relp_tpu_torch.model.computational_form import build_computational_form
    from relp_tpu_torch.ops.select_epilogue import Selection
    from relp_tpu_torch.presolve.engine import presolve
    from relp_tpu_torch.simplex.core import PrimalKernel
    from relp_tpu_torch.simplex.driver import solve_computational_form
    from relp_tpu_torch.utils.config import SolverConfig

    presolve(general)
    cf = build_computational_form(general, scale=True)
    seen = []
    price = PrimalKernel._price

    def watched(self, s, c_eff, vs, live=None):
        if self.steps == iters - 1:
            sel = Selection(s.vstat.clone(), self.can_enter, s.w.clone(), s.bland.clone(),
                            self.cfg.eps_dual, self.cfg.pricing == "devex")
            seen.append((sel, s.pi.clone(), c_eff.clone()))
        return price(self, s, c_eff, vs, live)

    PrimalKernel._price = watched
    try:
        solve_computational_form(cf, SolverConfig(max_iter=iters), device=dev)
    finally:
        PrimalKernel._price = price
    if len(seen) != 1:
        raise AssertionError(f"[kernels] the solve priced {len(seen)} times at iteration {iters}")
    return seen[0]


def _kernels_select(smi, dev, ell_op, ell_general, dense_op, dense_general):
    """Both ``_select`` routes against their plain versions: on the two
    operators with a real mid-solve state (the f32 scan, a partial-pricing
    window of it and the f64 pass), and on made-up ties."""
    import torch

    from relp_tpu_torch.ops.dense_kernels import dense_price_select, dense_price_select_plain
    from relp_tpu_torch.ops.select_epilogue import Selection
    from relp_tpu_torch.ops.sparse_kernels import (
        ell_price_plain, ell_price_select, ell_price_select_plain,
    )

    report = {}
    for name, op, general in (("ell", ell_op, ell_general), ("dense", dense_op, dense_general)):
        sel, pi, c_eff = _mid_solve_state(general, dev, MID_SOLVE_ITERS)
        op = op.with_f32()
        m_pad, n_pad = op.shape
        nonbasic = int(((sel.vstat[:n_pad] != 2) & sel.can_enter).sum())
        print(f"[kernels] {name} operator at iteration {MID_SOLVE_ITERS}: {nonbasic} of {n_pad} "
              f"columns may enter, Bland {bool(sel.bland)}, max devex weight "
              f"{float(sel.w.max()):.3g}, |c_eff| max {float(c_eff.abs().max()):.3g}")
        side = 17 * n_pad  # vstat (8), can_enter (1) and w (8) per column
        for tag, tol, j0, w in (("f32", F32_TOL, 0, n_pad), ("f32", F32_TOL, n_pad // 4, n_pad // 4),
                                ("f64", F64_TOL, 0, n_pad)):
            v = pi.float() if tag == "f32" else pi
            c = (c_eff.float() if tag == "f32" else c_eff)[j0:j0 + w].contiguous()
            if name == "ell":
                pool = (op.data32_t if tag == "f32" else op.data_t), op.rows_t
                kernel, plain = ell_price_select, ell_price_select_plain
                nbytes = _nbytes(*pool) * w // n_pad + _nbytes(v, c) + side * w // n_pad
                flops = 2 * pool[0].numel() * w // n_pad
                scale = float(ell_price_plain(pool[0].abs(), pool[1], v.abs(), None, j0, w).max())
            else:
                pool = (op.A32 if tag == "f32" else op.A,)
                kernel, plain = dense_price_select, dense_price_select_plain
                nbytes = m_pad * w * pool[0].element_size() + _nbytes(v, c) + side * w // n_pad
                flops = 2 * m_pad * w
                scale = float((v.abs() @ pool[0][:, j0:j0 + w].abs()).max())
            label = f"{name}_price_select {tag} [{j0}, {j0 + w}) of {m_pad}x{n_pad}, mid-solve state"
            report[(name, tag, j0)] = _compare(
                label, lambda: kernel(*pool, v, c, *sel, j0, w),
                lambda: plain(*pool, v, c, *sel, j0, w), tol, smi,
                nbytes=nbytes, flops=flops, tag=tag, same_bits=True, scale=scale, plain_runs=10)

    # made-up ties: every score equal over many blocks, then Bland's rule,
    # then nothing that may enter
    m, n = 64, 40000
    zeros = torch.zeros(m, dtype=torch.float32, device=dev)
    c = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
    pools = {"ell": (torch.zeros((2, n), dtype=torch.float32, device=dev),
                     torch.zeros((2, n), dtype=torch.int32, device=dev)),
             "dense": (torch.zeros((m, n), dtype=torch.float32, device=dev),)}
    vstat = torch.zeros(n + m, dtype=torch.int64, device=dev)
    vstat[:5000] = 2
    for bland, basic, want in ((False, False, (5000, True)), (True, False, (5000, True)),
                               (False, True, (0, False))):
        sel = Selection(torch.full_like(vstat, 2) if basic else vstat,
                        torch.ones(n, dtype=torch.bool, device=dev),
                        torch.ones(n, dtype=torch.float64, device=dev),
                        torch.tensor(bland, device=dev), 1e-9, True)
        for name, kernel in (("ell", ell_price_select), ("dense", dense_price_select)):
            q, has, d_q = kernel(*pools[name], zeros, c, *sel)
            torch.cuda.synchronize()
            if (int(q), bool(has), float(d_q)) != (*want, -1.0):
                raise AssertionError(f"[kernels] {name}_price_select on ties (Bland {bland}, all "
                                     f"basic {basic}): ({int(q)}, {bool(has)}, {float(d_q)})")
    print(f"[kernels] ties over {n} equal scores: both select kernels take the lowest column "
          "(devex and Bland), and the window's first column when nothing may enter")
    # the main path's launches of these wrappers: the f32 scan of the pool
    return {"ell_price_select": report[("ell", "f32", 0)],
            "dense_price_select": report[("dense", "f32", 0)]}


def _kernels_probe(smi, dev):
    import torch

    from relp_tpu_torch.ops.probe_kernels import (
        probe_scale_f32, probe_scale_f64, probe_scale_plain,
    )

    report = {}
    for name, fn, dtype in (("probe_scale_f32", probe_scale_f32, torch.float32),
                            ("probe_scale_f64", probe_scale_f64, torch.float64)):
        x = torch.linspace(-1.0, 1.0, 8 * 128, dtype=dtype, device=dev).reshape(8, 128)
        report[name] = _compare(f"{name} [8, 128]", lambda: fn(x),
                                lambda: probe_scale_plain(x), 0.0, smi,
                                nbytes=2 * _nbytes(x), flops=x.numel(),
                                tag="f32" if dtype == torch.float32 else "f64",
                                library_fn=lambda: torch.mul(x, 2.0), library="torch.mul(x, 2)")
    return report


class _Captured(Exception):
    pass


def _update_operands(general, pricing, dev, at=DUAL_UPDATE_AT):
    """``(K, state, pivot)`` of the ``at``-th update of a cold dual solve of
    ``general`` under ``pricing``, stepped eagerly: what the step hands
    ``dual.pivot_update``, copied."""
    from relp_tpu_torch.model.computational_form import build_computational_form
    from relp_tpu_torch.ops.dual_kernels import Pivot
    from relp_tpu_torch.simplex import driver, dual
    from relp_tpu_torch.utils.config import SolverConfig

    real, graphable, kept = dual.pivot_update, dual._graphable, []

    def spy(K, s, piv):
        kept.append(None)
        if len(kept) == at:
            kept[-1] = (K, dual._cloned(s), Pivot(*(None if t is None else t.clone()
                                                    for t in piv)))
            raise _Captured
        return real(K, s, piv)

    dual.pivot_update, dual._graphable = spy, lambda A: False
    try:
        driver.solve_computational_form(
            build_computational_form(general, scale=False),
            SolverConfig(algorithm="dual", scale=False, presolve=False, dual_pricing=pricing),
            device=dev)
    except _Captured:
        return kept[-1]
    finally:
        dual.pivot_update, dual._graphable = real, graphable
    raise AssertionError(f"[kernels] the dual solve ended before update {at}")


def _kernels_dual(smi, dev):
    """``dual_update`` (through ``dual.pivot_update``) against
    ``dual_update_plain`` on the operands of a mid-solve update of the dense
    LP and of the max flow, under both weight rules: every output in bits,
    twice; then both timed.  The bound is each input read once and each
    output written once: 8 bytes an element of u, B⁻¹·(A·dx), ρ, xB, π, β
    and the basis in (τ too under ``dse``) and of xB, π, β and the basis out
    (m each); of α and d in and d out (n each), 1 of the flips' mask; 8 of
    the statuses in and out (n + m each)."""
    import torch

    from relp_tpu_torch.models.dense import dense_lp
    from relp_tpu_torch.simplex import dual

    names = ("basis", "vstat", "xB", "pi", "d", "beta", "status", "it", "since_refactor",
             "flips")

    def bits(t):
        return t.view(torch.int64) if t.dtype == torch.float64 else t

    def same(a, b):
        (s1, f1, p1), (s2, f2, p2) = a, b
        pairs = [(getattr(s1, k), getattr(s2, k)) for k in names] + [(f1, f2), (p1, p2)]
        return [k for k, (x, y) in zip(names + ("flags", "do_pivot"), pairs)
                if not torch.equal(bits(x), bits(y))]

    report = {}
    for label, general in ((f"dense LP {DENSE_SHAPE[0]}x{DENSE_SHAPE[1]}",
                            dense_lp(*DENSE_SHAPE)),
                           (f"max flow N={N_NODES}", slice_problem()[0])):
        for pricing in ("dse", "devex"):
            K, s, piv = _update_operands(general, pricing, dev)
            if K.A.format != ("dense" if label.startswith("dense") else "ell"):
                raise AssertionError(f"[kernels] dual_update {label}: operator {K.A.format}")
            kernel_fn = lambda: dual.pivot_update(K, s, piv)  # noqa: E731
            plain_fn = lambda: dual.dual_update_plain(K, s, piv)  # noqa: E731
            got = kernel_fn()
            again = kernel_fn()
            want = plain_fn()
            torch.cuda.synchronize()
            differ = same(got, want) + [f"{k} (twice)" for k in same(got, again)]
            if differ:
                raise AssertionError(f"[kernels] dual_update {label} {pricing}: {differ} "
                                     "differ from dual_update_plain's bits")
            m, n = s.basis.shape[0], K.n
            nbytes = (8 * (7 + (pricing == "dse")) + 8 * 4) * m + (8 * 3 + 1) * n \
                + 16 * (n + m)
            # the plain chain is ~120 launches: two calls a batch stay well
            # inside the sleep's hold while the reference processes share the host
            row = {"max_abs_err": 0.0, "ms": _device_ms(kernel_fn),
                   "plain_ms": _device_ms(plain_fn, 2, batches=5),
                   "bound_ms": nbytes / PEAK_BYTES_S * 1e3, "bound_by": "bytes",
                   "library_ms": None}
            host_ms, plain_host_ms = _host_ms(kernel_fn), _host_ms(plain_fn, 10)
            print(f"[kernels] dual_update {label} {pricing} (m {m} n {n}; update "
                  f"{DUAL_UPDATE_AT}: pivot {bool(got[2])}, {int(piv.n_flips)} flips): every "
                  f"output == dual_update_plain in bits, same bits twice; device kernel "
                  f"{row['ms'] * 1e3:.2f} us plain {row['plain_ms'] * 1e3:.2f} us least "
                  f"{row['bound_ms'] * 1e3:.2f} us ({nbytes / 1e6:.3f} MB, by bytes: "
                  f"{row['bound_ms'] / row['ms']:.0%} of it reached); per call from the host "
                  f"kernel {host_ms * 1e3:.1f} us plain {plain_host_ms * 1e3:.1f} us [{smi}]")
            report[(label, pricing)] = row
            del K, s, piv
        torch.cuda.empty_cache()
    return {"dual_update": report[(f"dense LP {DENSE_SHAPE[0]}x{DENSE_SHAPE[1]}", "dse")]}


def _padded_dense(general):
    """The padded dense A of ``general``'s computational form without
    presolve (as the fleets run), on the host."""
    import numpy as np

    from relp_tpu_torch.model.computational_form import build_computational_form
    from relp_tpu_torch.simplex.driver import _round_up

    cf = build_computational_form(general, scale=True)
    A = np.zeros((_round_up(cf.m, 8), _round_up(cf.n, 128)))
    A[: cf.m, : cf.n] = cf.A.toarray()
    return A


def _lane_states(iters, arrays, **kw):
    """``(selection, V, C, live)`` of every lane group as the lane-batched
    primal's f32 scan meets them at step ``iters`` of a cold solve of the LPs
    ``arrays`` (``kw``: ``solve_batched``'s ``device`` or ``mesh``)."""
    from relp_tpu_torch.ops.select_epilogue import Selection
    from relp_tpu_torch.parallel import solve_batched
    from relp_tpu_torch.simplex.core import LanePrimalKernel
    from relp_tpu_torch.utils.config import SolverConfig

    seen = []
    price = LanePrimalKernel._price

    def watched(self, s, c_eff, vs, live):
        if self.steps == iters - 1:
            sel = Selection(s.vstat.clone(), self.can_enter, s.w.clone(), s.bland.clone(),
                            self.cfg.eps_dual, self.cfg.pricing == "devex")
            seen.append((sel, s.pi.float().contiguous(), c_eff.float().contiguous(),
                         live.clone()))
        return price(self, s, c_eff, vs, live)

    LanePrimalKernel._price = watched
    try:
        solve_batched(*arrays, SolverConfig(), iters, **kw)
    finally:
        LanePrimalKernel._price = price
    return seen


def _mid_lane_state(dev, iters):
    """``(selection, V, C, live)`` as the lane-batched primal's f32 scan meets
    them at step ``iters`` of a cold solve of the primal fleet's LPs, and
    their shared A in f32."""
    import torch

    arrays = _fleet_arrays(*FLEET_PRIMAL_SHAPE, FLEET_LANES, demand=False)
    seen = _lane_states(iters, arrays, device=dev)
    if len(seen) != 1:
        raise AssertionError(f"[kernels] the lane solve priced {len(seen)} times at step {iters}")
    return seen[0], torch.as_tensor(arrays[0], dtype=torch.float32, device=dev)


def _lanes_equal_single(got, A, V, C, stacked, live=None):
    """Whether every (live) lane of a ``dense_price_lanes`` result equals the
    single-vector ``dense_price`` on that lane's data, bit for bit."""
    import torch

    from relp_tpu_torch.ops.dense_kernels import dense_price

    return all(
        torch.equal(got[s], dense_price(A[s] if stacked else A, V[s].contiguous(),
                                        None if C is None else C[s].contiguous()))
        for s in range(V.shape[0]) if live is None or bool(live[s]))


def _kernels_lanes(smi, dev, rng, dense_op):
    """The lane kernels against their plain versions: ``dense_price_lanes``
    for 64 lanes against the dense LP's shared operator, 17 against it (a
    ragged last group; also with a partly dead group and a whole dead one)
    and 16 against the N = 1,024 max flow's dense operator (f32 and f64,
    with and without ``C``), for a stacked A[4, 256, 512];
    ``dense_price_select_lanes`` on a lane-batched solve's state.  Each lane
    is also held bit for bit against the single-vector kernel on its data,
    and each row prints the lanes a block served (``lane_plan``'s group; 1:
    lane by lane)."""
    import torch

    from relp_tpu_torch.ops.dense_kernels import (
        dense_price_lanes, dense_price_lanes_plain, dense_price_select,
        dense_price_select_lanes, dense_price_select_lanes_plain, lane_plan,
    )

    general, _ = slice_problem(FLEET_FLOW_NODES)
    flow_A = torch.as_tensor(_padded_dense(general), device=dev)
    cases = {  # label -> (A, lanes)
        f"dense LP operator shared by {FLEET_LANES} lanes m={dense_op.shape[0]} "
        f"n={dense_op.shape[1]}":
            (dense_op.A, FLEET_LANES),
        f"dense LP operator shared by {RAGGED_LANES} lanes m={dense_op.shape[0]} "
        f"n={dense_op.shape[1]}":
            (dense_op.A, RAGGED_LANES),
        f"max-flow N={FLEET_FLOW_NODES} dense operator shared by {FLEET_FLOW_LANES} lanes "
        f"m={flow_A.shape[0]} n={flow_A.shape[1]}": (flow_A, FLEET_FLOW_LANES),
        "stacked A[4, 256, 512]": (torch.as_tensor(rng.uniform(0.05, 1.0, (4, 256, 512)),
                                                   device=dev), 4),
    }
    report = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        tag = "f32" if dtype == torch.float32 else "f64"
        for label, (A, L) in cases.items():
            Ad = A.to(dtype).contiguous()
            m, w = Ad.shape[-2:]
            V = torch.as_tensor(rng.uniform(0.0, 1.0, (L, m)), dtype=dtype, device=dev)
            C = torch.as_tensor(rng.uniform(0.0, 1.0, (L, w)), dtype=dtype, device=dev)
            stacked = Ad.dim() == 3
            group = lane_plan(L, m, w, Ad.element_size(), not stacked).group
            if stacked:
                lib_c = (lambda: torch.baddbmm(C.unsqueeze(1), V.unsqueeze(1), Ad, alpha=-1),
                         "torch.baddbmm(C, V, A, alpha=-1)")
                lib_s = (lambda: torch.bmm(V.unsqueeze(1), Ad), "torch.bmm(V, A)")
            else:
                lib_c = (lambda: torch.addmm(C, V, Ad, alpha=-1), "torch.addmm(C, V, A, alpha=-1)")
                lib_s = (lambda: torch.mm(V, Ad), "torch.mm(V, A)")
            common = dict(flops=2 * L * m * w, tag=tag, same_bits=True)
            for mode, Cm, lib in (("c", C, lib_c), ("sum", None, lib_s)):
                row = _compare(
                    f"dense_price_lanes {tag} {'C-VA' if Cm is not None else 'VA'} {label} L={L} "
                    f"group {group}",
                    lambda: dense_price_lanes(Ad, V, Cm),
                    lambda: dense_price_lanes_plain(Ad, V, Cm), tol, smi,
                    nbytes=_nbytes(Ad, V, Cm, Cm if Cm is not None else C),
                    library_fn=lib[0], library=lib[1], **common)
                if not _lanes_equal_single(dense_price_lanes(Ad, V, Cm), Ad, V, Cm, stacked):
                    raise AssertionError(f"[kernels] dense_price_lanes {tag} {label}: a lane "
                                         "differs from the single-vector dense_price")
                print(f"[kernels]   each of the {L} lanes equals the single-vector dense_price "
                      "bit for bit")
                report[(tag, mode, label)] = row
            if L != RAGGED_LANES:
                continue
            # dead lanes: two of the first group, and the whole ragged last group
            live = torch.ones(L, dtype=torch.bool, device=dev)
            live[1:3] = False
            live[(L - 1) // group * group:] = False
            n_live = int(live.sum())
            kept = torch.full((L, w), 7.0, dtype=dtype, device=dev)
            out = kept.clone()
            report[(tag, "dead", label)] = _compare(
                f"dense_price_lanes {tag} C-VA {label} L={L} group {group}, lanes 1-2 and the "
                f"last group dead ({n_live} live)",
                lambda: dense_price_lanes(Ad, V, C, live=live, out=out),
                lambda: dense_price_lanes_plain(Ad, V, C, live=live, out=kept), tol, smi,
                nbytes=_nbytes(Ad) + n_live * (m + 2 * w) * Ad.element_size(),
                flops=2 * n_live * m * w, tag=tag, library_fn=lib_c[0], library=lib_c[1])
            got = dense_price_lanes(Ad, V, C, live=live, out=out)
            if not (torch.equal(got[~live], kept[~live])
                    and _lanes_equal_single(got, Ad, V, C, stacked, live)):
                raise AssertionError(f"[kernels] dense_price_lanes {tag} {label}: a dead lane "
                                     "was written, or a live one differs from dense_price")
            print(f"[kernels]   the {L - n_live} dead lanes kept their rows; each live lane "
                  "equals the single-vector dense_price bit for bit")

    (sel, V32, C32, live), A32 = _mid_lane_state(dev, MID_SOLVE_ITERS // 6)
    L = V32.shape[0]
    m, n = A32.shape
    print(f"[kernels] lane-batched primal at step {MID_SOLVE_ITERS // 6}: {int(live.sum())} of {L} "
          f"lanes live, Bland in {int(sel.bland.sum())}, max devex weight {float(sel.w.max()):.3g}")
    side = 17 * n * L  # vstat (8), can_enter (1) and w (8) per column and lane
    for tag, tol, A, v, c in (("f32", F32_TOL, A32, V32, C32),
                              ("f64", F64_TOL, A32.double(), V32.double(), C32.double())):
        group = lane_plan(L, m, n, A.element_size()).group
        scale = float((v.abs() @ A.abs()).max())
        row = _compare(
            f"dense_price_select_lanes {tag} {L} lanes of {m}x{n}, mid-solve state, group {group}",
            lambda: dense_price_select_lanes(A, v, c, *sel),
            lambda: dense_price_select_lanes_plain(A, v, c, *sel), tol, smi,
            nbytes=_nbytes(A, v, c) + side, flops=2 * L * m * n, tag=tag, same_bits=True,
            scale=scale, plain_runs=10)
        q, has, d_q = dense_price_select_lanes(A, v, c, *sel)
        if not all(
            (int(q[s]), bool(has[s])) == tuple(map(lambda t: t.item(), one[:2]))
            and torch.equal(d_q[s], one[2])
            for s in range(L)
            for one in [dense_price_select(A, v[s].contiguous(), c[s].contiguous(),
                                           sel.vstat[s].contiguous(), sel.can_enter[s].contiguous(),
                                           sel.w[s].contiguous(), sel.bland[s], sel.eps_dual,
                                           sel.devex)]):
            raise AssertionError(f"[kernels] dense_price_select_lanes {tag}: a lane differs "
                                 "from the single-vector dense_price_select")
        # dead lanes: two of the first group and the whole second one keep their outputs
        alive = torch.ones(L, dtype=torch.bool, device=dev)
        alive[1:3] = False
        alive[group:2 * group] = False
        kept = (torch.full((L,), -1, dtype=torch.int64, device=dev),
                torch.zeros(L, dtype=torch.bool, device=dev),
                torch.full((L,), 9.0, dtype=A.dtype, device=dev))
        outs = dense_price_select_lanes(A, v, c, *sel, live=alive,
                                        outs=tuple(t.clone() for t in kept))
        if not all(torch.equal(o[~alive], k[~alive]) and torch.equal(o[alive], f[alive])
                   for o, k, f in zip(outs, kept, (q, has, d_q))):
            raise AssertionError(f"[kernels] dense_price_select_lanes {tag}: a dead lane was "
                                 "written, or a live one differs from the full launch")
        print("[kernels]   each lane's (q, has, d_q) equals the single-vector "
              "dense_price_select's bit for bit; dead lanes (part of a group, a whole group) "
              "kept their outputs")
        report[(tag, "select")] = row
        # the partial-pricing window (price_blocks: a block of columns per
        # step), aligned and not, with the window's costs
        for j0, w in LANE_WINDOWS:
            cw = c[:, j0:j0 + w].contiguous()
            _compare(
                f"dense_price_select_lanes {tag} {L} lanes of {m}x{n}, window [{j0}, {j0 + w}), "
                f"mid-solve state, group {lane_plan(L, m, w, A.element_size()).group}",
                lambda: dense_price_select_lanes(A, v, cw, *sel, j0, w),
                lambda: dense_price_select_lanes_plain(A, v, cw, *sel, j0, w), tol, smi,
                nbytes=m * w * A.element_size() + _nbytes(v, cw) + side * w // n,
                flops=2 * L * m * w, tag=tag, same_bits=True,
                scale=float((v.abs() @ A[:, j0:j0 + w].abs()).max()), plain_runs=10)
            q, has, d_q = dense_price_select_lanes(A, v, cw, *sel, j0, w)
            if not all(
                (int(q[s]), bool(has[s])) == tuple(map(lambda t: t.item(), one[:2]))
                and torch.equal(d_q[s], one[2])
                for s in range(L)
                for one in [dense_price_select(A, v[s].contiguous(), cw[s].contiguous(),
                                               sel.vstat[s].contiguous(),
                                               sel.can_enter[s].contiguous(),
                                               sel.w[s].contiguous(), sel.bland[s],
                                               sel.eps_dual, sel.devex, j0, w)]):
                raise AssertionError(f"[kernels] dense_price_select_lanes {tag} window "
                                     f"[{j0}, {j0 + w}): a lane differs from the single-vector "
                                     "dense_price_select on the window")
            print(f"[kernels]   each lane's (q, has, d_q) on the window equals the single-vector "
                  "dense_price_select's on it bit for bit")
    flow_label = next(k for k in cases if k.startswith("max-flow"))
    # the fleets' launches: the first-order fleet's f32 C − Y·A at N = 1,024,
    # the primal fleet's f32 scan
    return {"dense_price_lanes": report[("f32", "c", flow_label)],
            "dense_price_select_lanes": report[("f32", "select")]}


def first_order_operator(n_nodes, dev, pdlp_matrix="auto"):
    """The first-order engine's operator of the max flow at ``n_nodes``
    nodes, built as ``_run_pdlp`` builds it (presolve, lowering, padding,
    scaling): ``(operator, csc of the operator's space, rpad, cpad)``.  Under
    ``pdlp_matrix="bricks"`` the scaled matrix sits in RCM order in a
    128-aligned space (``driver._brick_operator``)."""
    import scipy.sparse as sp

    from relp_tpu_torch.model.computational_form import build_computational_form
    from relp_tpu_torch.presolve.engine import presolve
    from relp_tpu_torch.simplex import driver
    from relp_tpu_torch.utils.config import SolverConfig

    general, _ = slice_problem(n_nodes)
    presolve(general)
    cf = build_computational_form(general, scale=True)
    p = driver._Padded.of(cf, SolverConfig(algorithm="pdlp", pdlp_matrix=pdlp_matrix), dev)
    d_r, d_c, csc_s = driver._pdlp_scaling(p)
    op, _, rpad, cpad, _, _ = driver._pdlp_operator(p, d_r, d_c, csc_s)
    csc_s = csc_s.tocsc()
    if rpad is not None:
        csc_s = csc_s[rpad[:cf.m]][:, cpad[:cf.n]]
    coo = csc_s.tocoo()
    return op, sp.csc_matrix((coo.data, (coo.row, coo.col)), shape=op.shape), rpad, cpad


def _csr_tensor(csr, dev, dtype):
    """A scipy CSR matrix as a torch sparse CSR tensor (the yardstick's operand)."""
    import torch

    csr = csr.tocsr()
    return torch.sparse_csr_tensor(
        torch.as_tensor(csr.indptr.astype("int32"), device=dev),
        torch.as_tensor(csr.indices.astype("int32"), device=dev),
        torch.as_tensor(csr.data, dtype=dtype, device=dev), size=csr.shape)


def _kernels_bricks(smi, dev, rng):
    """``brick_spmv`` (A·x) and ``brick_price`` (c − Aᵀy) on the operator of
    the bricks path, the RCM-ordered N = 4,096 max flow, in the grouped layout
    the driver builds and in the flat one, f64 and f32.  The bound reads the
    compacted bricks once (each nonzero's value and position word, the tile
    offsets and ``tile_of``), the vector, c and the output once: what these
    inputs need, not the dense 8 × 128 bricks the TPU kernels read (printed
    beside it); the yardstick is ``torch.mv`` on a sparse CSR of the same
    matrix (or of its transpose)."""
    import torch

    from relp_tpu_torch.ops.brick_kernels import (
        brick_price, brick_price_plain, brick_spmv, brick_spmv_plain,
    )
    from relp_tpu_torch.ops.bricks import bricks_from_csc

    grouped, csc, _, _ = first_order_operator(N_NODES, dev, "bricks")
    mp, np_ = grouped.shape
    flat = bricks_from_csc(csc, mp, np_, device=dev)
    layouts = {"grouped": grouped, "flat": flat}
    for label, op in layouts.items():
        if label == "grouped":
            slots = [sum((e - s) * b for s, e, b in g) for g in (op.rgroups, op.cgroups)]
        else:
            slots = [op.rtiles.tiles * op.rslots, op.ctiles.tiles * op.cslots]
        held = _nbytes(*(t for side in (op.rtiles, op.ctiles)
                         for t in (side.ptr, side.vals, side.pos, side.tile_of)))
        print(f"[kernels] brick operator {label}: {held / 1e6:.3f} MB on the card for both "
              f"orientations ({op.rtiles.vals.numel()} nonzeros); the dense bricks of its "
              f"{slots[0]}/{slots[1]} slots would be {sum(slots) * 8 * 128 * 8 / 1e6:.1f} MB "
              f"in f64 (not built)")
    x = torch.as_tensor(rng.standard_normal(np_), device=dev)
    y = torch.as_tensor(rng.standard_normal(mp), device=dev)
    c = torch.as_tensor(rng.standard_normal(np_), device=dev)
    mv = "torch.mv(sparse CSR)"
    report = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        tag = "f32" if dtype == torch.float32 else "f64"
        xd, yd, cd = x.to(dtype), y.to(dtype), c.to(dtype)
        csr, csr_t = _csr_tensor(csc, dev, dtype), _csr_tensor(csc.T, dev, dtype)
        for label, op in layouts.items():
            rt, ct = op.astype(dtype).rtiles, op.astype(dtype).ctiles
            shape = (f"{label}, {rt.vals.numel()} nonzeros in {rt.tiles}/{ct.tiles} tiles of "
                     f"{rt.lanes}/{ct.lanes} lanes, {mp}x{np_}")
            report[("spmv", tag, label)] = _compare(
                f"brick_spmv {tag} A·x {shape}",
                lambda: brick_spmv(rt, xd), lambda: brick_spmv_plain(rt, xd), tol, smi,
                nbytes=_nbytes(rt.ptr, rt.vals, rt.pos, rt.tile_of, xd) + mp * xd.element_size(),
                flops=2 * rt.vals.numel(), tag=tag, library_fn=lambda: torch.mv(csr, xd),
                library=mv, same_bits=True)
            report[("price", tag, label)] = _compare(
                f"brick_price {tag} c-Aᵀy {shape}",
                lambda: brick_price(ct, yd, cd), lambda: brick_price_plain(ct, yd, cd), tol, smi,
                nbytes=_nbytes(ct.ptr, ct.vals, ct.pos, ct.tile_of, yd, cd, cd),
                flops=2 * ct.vals.numel(), tag=tag, library_fn=lambda: torch.mv(csr_t, yd),
                library=mv, same_bits=True)
        del csr, csr_t
    del grouped, flat, layouts
    torch.cuda.empty_cache()
    # the bricks path's launches (f64 under the default precision), grouped
    return {"brick_spmv": report[("spmv", "f64", "grouped")],
            "brick_price": report[("price", "f64", "grouped")]}


def phase_kernels(smi):
    """Every kernel against its plain version on the card."""
    import numpy as np
    import torch

    from relp_tpu_torch.models.dense import dense_lp

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    ell_op = _operator(slice_problem()[0], dev, "ell")
    dense_op = _operator(dense_lp(*DENSE_SHAPE), dev, "dense")
    timings = _kernels_ell(smi, dev, rng, ell_op)
    timings.update(_kernels_dense(smi, dev, rng, dense_op,
                                  _operator(slice_problem(PDLP_DENSE_NODES)[0], dev, "dense")))
    timings.update(_kernels_select(smi, dev, ell_op, slice_problem()[0], dense_op,
                                   dense_lp(*DENSE_SHAPE)))
    timings.update(_kernels_probe(smi, dev))
    timings.update(_kernels_lanes(smi, dev, rng, dense_op))
    del ell_op, dense_op
    torch.cuda.empty_cache()
    timings.update(_kernels_bricks(smi, dev, rng))
    torch.cuda.empty_cache()
    timings.update(_kernels_dual(smi, dev))
    return timings


def _solve_file(general, name, config=None, devices=None):
    """Write ``general`` to MPS and solve it through ``api.solve(path)``
    (``devices``: what ``mesh_cols`` shards over); returns the result and the
    api wall (synchronised)."""
    import torch

    from relp_tpu_torch import api
    from relp_tpu_torch.io.mps_write import export_mps
    from relp_tpu_torch.utils.config import DEFAULT_CONFIG

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"{name}.mps")
        export_mps(general, path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = api.solve(path, DEFAULT_CONFIG if config is None else config, devices=devices)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0


def _report_solve(tag, res, wall, smi):
    import torch

    met = res.simplex.metrics
    print(f"[{tag}] iterations {met.iterations} solve_wall {met.wall_s:.3f} s "
          f"iters/s {met.iters_per_s:.1f} api_wall {wall:.3f} s host_reads "
          f"{met.host_reads} ({met.host_reads / max(met.iterations, 1):.3f}/iter) "
          f"peak_mem {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB [{smi}]")


def _check_optimal(tag, res, fmt):
    from relp_tpu_torch.model.elements import LinearProgramType

    if res.kind is not LinearProgramType.FINITE_OPTIMUM:
        raise AssertionError(f"[{tag}] status {res.kind}")
    met = res.simplex.metrics
    if met.matrix_format != fmt:
        raise AssertionError(f"[{tag}] matrix_format {met.matrix_format!r}, expected {fmt!r}")
    if met.device != "cuda":
        raise AssertionError(f"[{tag}] solved on {met.device!r}")
    return res.solution.objective_value


def phase_slice(smi, launches):
    import torch

    general, flow = slice_problem()
    torch.cuda.reset_peak_memory_stats()
    with counted(("ell_price", "ell_price_select", "ell_spmv"), launches, "slice"):
        res, wall = _solve_file(general, f"maxflow_{N_NODES}")
    obj = _check_optimal("slice", res, "ell")
    met = res.simplex.metrics
    SOLVES["slice"] = (met, wall)
    if abs(obj - flow) > 1e-6:
        raise AssertionError(f"[slice] objective {obj!r} != max-flow value {flow!r}")
    if min(launches["ell_price"], launches["ell_spmv"]) < 1 or \
            launches["ell_price_select"] < met.iterations:
        raise AssertionError(f"[slice] launches {launches} for {met.iterations} iterations")
    print(f"[slice] max-flow N={N_NODES} seed={SEED}: m={met.m} n={met.n} nnz={met.nnz} "
          f"(padded {met.m_padded}x{met.n_padded}) objective {obj:.12g} == scipy {flow:.12g}")
    _report_solve("slice", res, wall, smi)
    its = max(met.iterations, 1)
    print(f"[slice] launches ell_price_select {launches['ell_price_select']} "
          f"({launches['ell_price_select'] / its:.3f}/iter) ell_price {launches['ell_price']} "
          f"({launches['ell_price'] / its:.3f}/iter) ell_spmv {launches['ell_spmv']}")


def _highs_objective(m, n):
    from scipy.optimize import linprog

    from relp_tpu_torch.models.dense import dense_lp_data

    A, b, c = dense_lp_data(m, n)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, 2), method="highs")
    if ref.status != 0:
        raise AssertionError(f"HiGHS did not solve the dense LP: {ref.message}")
    return float(ref.fun)


def phase_dense(smi, launches, highs):
    import torch

    from relp_tpu_torch.models.dense import dense_lp

    m, n = DENSE_SHAPE
    highs = highs.result()
    torch.cuda.reset_peak_memory_stats()
    with counted(("dense_price", "dense_price_select"), launches, "dense"):
        res, wall = _solve_file(dense_lp(m, n), f"dense_{m}x{n}")
    obj = _check_optimal("dense", res, "dense")
    met = res.simplex.metrics
    if abs(obj - highs) > OBJ_REL * abs(highs):
        raise AssertionError(f"[dense] objective {obj!r} != HiGHS {highs!r}")
    if min(launches["dense_price"], launches["dense_price_select"]) < met.iterations:
        raise AssertionError(f"[dense] launches {launches} for {met.iterations} iterations")
    print(f"[dense] dense LP {m}x{n}: m={met.m} n={met.n} (padded "
          f"{met.m_padded}x{met.n_padded}) objective {obj:.15g} HiGHS {highs:.15g} "
          f"rel {abs(obj - highs) / abs(highs):.2e}")
    _report_solve("dense", res, wall, smi)
    its = max(met.iterations, 1)
    print(f"[dense] launches dense_price_select {launches['dense_price_select']} "
          f"({launches['dense_price_select'] / its:.3f}/iter) dense_price "
          f"{launches['dense_price']} ({launches['dense_price'] / its:.3f}/iter)")


def phase_options(smi):
    """Each ported option solved on the card against the default config."""
    from relp_tpu_torch.models.dense import dense_lp
    from relp_tpu_torch.ops.sparse_kernels import ell_price
    from relp_tpu_torch.utils.config import SolverConfig

    m, n = OPTIONS_SHAPE
    base, wall = _solve_file(dense_lp(m, n), f"dense_{m}x{n}")
    ref = _check_optimal("options", base, "dense")
    SOLVES["options"] = (base.simplex.metrics, wall)
    print(f"[options] dense {m}x{n} default: objective {ref:.15g} iterations "
          f"{base.simplex.iterations} api_wall {wall:.3f} s [{smi}]")
    for opts in (dict(inverse="eta"), dict(price_blocks=4), dict(perturb=1e-6),
                 dict(trace_iters=True), dict(check_every_n=50)):
        res, wall = _solve_file(dense_lp(m, n), f"dense_{m}x{n}", SolverConfig(**opts))
        obj = _check_optimal("options", res, "dense")
        if abs(obj - ref) > OBJ_REL * abs(ref):
            raise AssertionError(f"[options] {opts}: objective {obj!r} != default {ref!r}")
        sx = res.simplex
        extra = ""
        if opts.get("trace_iters"):
            if sx.trace is None or sx.trace.shape != (sx.iterations, 8):
                raise AssertionError(f"[options] trace of shape "
                                     f"{None if sx.trace is None else sx.trace.shape}")
            extra = f" trace {sx.trace.shape} pivots {sx.metrics.pivots}"
        if opts.get("check_every_n"):
            if not 0.0 <= sx.check_violation < 1e-6:
                raise AssertionError(f"[options] check violation {sx.check_violation!r}")
            extra = f" check_violation {sx.check_violation:.3e}"
        print(f"[options] dense {m}x{n} {opts}: objective {obj:.15g} iterations "
              f"{sx.iterations} api_wall {wall:.3f} s{extra}")
    general, flow = slice_problem(OPTIONS_NODES)
    price0 = ell_price.launches
    res, wall = _solve_file(general, f"maxflow_{OPTIONS_NODES}", SolverConfig(price_blocks=4))
    obj = _check_optimal("options", res, "ell")
    if abs(obj - flow) > 1e-6:
        raise AssertionError(f"[options] max-flow price_blocks=4: {obj!r} != scipy {flow!r}")
    print(f"[options] max-flow N={OPTIONS_NODES} {{'price_blocks': 4}}: objective {obj:.12g} "
          f"== scipy {flow:.12g} iterations {res.simplex.iterations} ell_price launches "
          f"{ell_price.launches - price0} api_wall {wall:.3f} s")


def _report_pdlp(tag, res, wall, smi, counts, phase="pdlp"):
    """The first-order run's line; returns its metrics."""
    import torch

    met = res.simplex.metrics
    its = max(met.fo_iterations, 1)
    print(f"[{phase}] {tag}: engine {met.engine} iterations {met.iterations} (first-order "
          f"{met.fo_iterations}: f32 stage {met.fo_f32_iterations}, f64 "
          f"{met.fo_iterations - met.fo_f32_iterations}; rounds {met.fo_rounds}, refinement "
          f"zooms {met.fo_refines}) final f64 KKT {met.fo_kkt:.3e} push pivots "
          f"{met.push_pivots} solve_wall {met.wall_s:.3f} s ({met.wall_s / its * 1e6:.1f} us "
          f"per first-order iteration; set-up {met.fo_setup_s:.3f} s, operator "
          f"{met.fo_matrix}) api_wall {wall:.3f} s host_reads {met.host_reads} "
          f"({met.host_reads / max(met.fo_rounds, 1):.3f} per round, driver's included) peak_mem "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB launches "
          + " ".join(f"{k} {v} ({v / its:.3f}/iter)" for k, v in counts.items())
          + f" [{smi}]")
    return met


def phase_pdlp(smi, launches):
    """The first-order engine through ``api.solve`` on the card."""
    import torch

    from relp_tpu_torch.utils.config import SolverConfig

    # 1. the slice's LP at full width, first-order point only
    general, flow = slice_problem()
    torch.cuda.reset_peak_memory_stats()
    names = ("ell_price", "ell_spmv")
    with counted(names, launches, "pdlp"):
        res, wall = _solve_file(general, f"maxflow_{N_NODES}",
                                SolverConfig(algorithm="pdlp", pdlp_crossover=False))
    obj = _check_optimal("pdlp", res, "ell")
    met = _report_pdlp(f"max-flow N={N_NODES} without crossover", res, wall, smi,
                       PATHS["pdlp"])
    SOLVES["pdlp"] = (met, obj)
    if met.engine != "pdlp":
        raise AssertionError(f"[pdlp] engine {met.engine!r}, expected 'pdlp'")
    if abs(obj - flow) > 1e-5 * abs(flow):
        raise AssertionError(f"[pdlp] objective {obj!r}, scipy's max flow {flow!r}")
    if min(PATHS["pdlp"].values()) < met.fo_iterations:
        raise AssertionError(f"[pdlp] launches {PATHS['pdlp']} for {met.fo_iterations} "
                             "first-order iterations")
    if met.fo_f32_iterations != 0:
        raise AssertionError(f"[pdlp] {met.fo_f32_iterations} f32 iterations under the "
                             "default precision, which is f64")
    # every read of the solve, those of ``_run_pdlp`` included: one per round, and the
    # operator norm's before the first round
    if not 0 < met.fo_round_reads <= met.fo_rounds or met.host_reads > met.fo_rounds + 1:
        raise AssertionError(f"[pdlp] {met.host_reads} host reads ({met.fo_round_reads} "
                             f"between the rounds) for {met.fo_rounds} rounds")
    print(f"[pdlp] objective {obj:.12g} scipy {flow:.12g} rel "
          f"{abs(obj - flow) / abs(flow):.2e}; the solve read the device "
          f"{met.host_reads} times for {met.fo_rounds} rounds: {met.fo_round_reads} after "
          f"a round ({met.fo_round_reads / met.fo_rounds:.3f} per round, none inside a "
          "round) and the operator norm before the first")

    # 2. the default config: first-order point, then the crossover to the vertex
    general, flow = slice_problem(OPTIONS_NODES)
    torch.cuda.reset_peak_memory_stats()
    with counted(names, {}, "pdlp crossover"):
        res, wall = _solve_file(general, f"maxflow_{OPTIONS_NODES}",
                                SolverConfig(algorithm="pdlp"))
    obj = _check_optimal("pdlp", res, "ell")
    met = _report_pdlp(f"max-flow N={OPTIONS_NODES} default config", res, wall, smi,
                       PATHS["pdlp crossover"])
    if met.engine != "pdlp+crossover" or abs(obj - flow) > 1e-6:
        raise AssertionError(f"[pdlp] engine {met.engine!r} objective {obj!r}, expected "
                             f"'pdlp+crossover' and scipy's {flow!r}")
    print(f"[pdlp] objective {obj:.12g} == scipy {flow:.12g} after {met.push_pivots} "
          "push pivots")

    # 3. the explicit mixed precision: f32 rounds held against the f64 KKT
    # every 8 rounds (one more read per call), refinement zooms, f64 endgame
    torch.cuda.reset_peak_memory_stats()
    with counted(names, {}, "pdlp mixed"):
        res, wall = _solve_file(general, f"maxflow_{OPTIONS_NODES}", SolverConfig(
            algorithm="pdlp", pdlp_crossover=False, pdlp_precision="mixed"))
    obj = _check_optimal("pdlp", res, "ell")
    met = _report_pdlp(f"max-flow N={OPTIONS_NODES} without crossover, mixed precision",
                       res, wall, smi, PATHS["pdlp mixed"])
    if met.engine != "pdlp" or abs(obj - flow) > 1e-5 * abs(flow) or met.fo_f32_iterations < 1:
        raise AssertionError(f"[pdlp] engine {met.engine!r} objective {obj!r} (scipy's "
                             f"{flow!r}) f32 iterations {met.fo_f32_iterations}")
    print(f"[pdlp] objective {obj:.12g} scipy {flow:.12g} rel {abs(obj - flow) / abs(flow):.2e}")

    # 4. the dense operator (auto picks it below 1,024 rows): dense_price in
    # c − Aᵀy mode, A·x a plain product.  The dense resource-allocation LP of
    # the options phase is no first-order workload (PDHG stalls above its
    # tolerance there and the driver falls back), so this is the max flow at
    # N = 256, 254 × 2,048.
    general, flow = slice_problem(PDLP_DENSE_NODES)
    torch.cuda.reset_peak_memory_stats()
    with counted(("dense_price",), {}, "pdlp dense"):
        res, wall = _solve_file(general, f"maxflow_{PDLP_DENSE_NODES}",
                                SolverConfig(algorithm="pdlp", pdlp_crossover=False))
    obj = _check_optimal("pdlp", res, "dense")
    met = _report_pdlp(f"max-flow N={PDLP_DENSE_NODES} without crossover, dense operator",
                       res, wall, smi, PATHS["pdlp dense"])
    if met.engine != "pdlp" or abs(obj - flow) > 1e-5 * abs(flow):
        raise AssertionError(f"[pdlp] engine {met.engine!r} objective {obj!r}, scipy's "
                             f"max flow {flow!r}")
    if PATHS["pdlp dense"]["dense_price"] < met.fo_iterations:
        raise AssertionError(f"[pdlp] launches {PATHS['pdlp dense']} for "
                             f"{met.fo_iterations} first-order iterations")
    print(f"[pdlp] objective {obj:.12g} scipy {flow:.12g} rel {abs(obj - flow) / abs(flow):.2e}")


def phase_bricks(smi, launches):
    """The first-order engine on the brick operator (``pdlp_matrix="bricks"``)
    through ``api.solve``, and the default operator's runs of the same LPs
    in turns beside it (what ``"auto"`` was decided on)."""
    import torch

    from relp_tpu_torch.utils.config import SolverConfig

    names = ("brick_spmv", "brick_price")
    for n_nodes in (N_NODES, OPTIONS_NODES):
        general, flow = slice_problem(n_nodes)
        walls = {"auto": [], "bricks": []}
        # in turns: default, bricks, bricks, default
        for i, matrix in enumerate(("auto", "bricks", "bricks", "auto")):
            cfg = SolverConfig(algorithm="pdlp", pdlp_crossover=False, pdlp_matrix=matrix)
            path = f"bricks N={n_nodes} {matrix} #{i}"
            main_path = n_nodes == N_NODES and i == 1
            torch.cuda.reset_peak_memory_stats()
            with counted(names, launches if main_path else {}, path) if matrix == "bricks" \
                    else contextlib.nullcontext():
                res, wall = _solve_file(general, f"maxflow_{n_nodes}", cfg)
            obj = _check_optimal("bricks", res, "ell")
            met = _report_pdlp(f"max-flow N={n_nodes} without crossover, pdlp_matrix={matrix!r}",
                               res, wall, smi, PATHS.get(path, {}), "bricks")
            # "auto" never takes the bricks
            if met.engine != "pdlp" or (met.fo_matrix == "bricks") != (matrix == "bricks") or \
                    abs(obj - flow) > 1e-5 * abs(flow):
                raise AssertionError(f"[bricks] engine {met.engine!r} operator "
                                     f"{met.fo_matrix!r} objective {obj!r}, scipy's {flow!r}")
            if matrix == "bricks" and min(PATHS[path].values()) < met.fo_iterations:
                raise AssertionError(f"[bricks] launches {PATHS[path]} for "
                                     f"{met.fo_iterations} first-order iterations")
            walls[matrix].append((met.wall_s, met.fo_setup_s, met.fo_iterations, wall,
                                  torch.cuda.max_memory_allocated() / 2**20))
        print(f"[bricks] N={n_nodes} in turns (solve wall s, of it set-up s, iterations, "
              "us per iteration after the set-up, api wall s, peak MiB): " + "; ".join(
                  f"{k} " + ", ".join(f"({w:.3f}, {su:.3f}, {it}, {(w - su) / it * 1e6:.1f}, "
                                      f"{a:.3f}, {mem:.0f})" for w, su, it, a, mem in v)
                  for k, v in walls.items()) + f" [{smi}]")

    # the crossover from the brick operator's point: scipy's vertex exactly
    general, flow = slice_problem(OPTIONS_NODES)
    torch.cuda.reset_peak_memory_stats()
    with counted(names, {}, "bricks crossover"):
        res, wall = _solve_file(general, f"maxflow_{OPTIONS_NODES}",
                                SolverConfig(algorithm="pdlp", pdlp_matrix="bricks"))
    obj = _check_optimal("bricks", res, "ell")
    met = _report_pdlp(f"max-flow N={OPTIONS_NODES} with crossover, pdlp_matrix='bricks'",
                       res, wall, smi, PATHS["bricks crossover"], "bricks")
    if met.engine != "pdlp+crossover" or met.fo_matrix != "bricks" or abs(obj - flow) > 1e-6:
        raise AssertionError(f"[bricks] engine {met.engine!r} objective {obj!r}, expected "
                             f"'pdlp+crossover' and scipy's {flow!r}")
    print(f"[bricks] objective {obj:.12g} == scipy {flow:.12g} after {met.push_pivots} "
          "push pivots")

    # mixed precision: the f32 brick operator (astype) runs the f32 rounds
    torch.cuda.reset_peak_memory_stats()
    with counted(names, {}, "bricks mixed"):
        res, wall = _solve_file(general, f"maxflow_{OPTIONS_NODES}", SolverConfig(
            algorithm="pdlp", pdlp_matrix="bricks", pdlp_crossover=False,
            pdlp_precision="mixed"))
    obj = _check_optimal("bricks", res, "ell")
    met = _report_pdlp(f"max-flow N={OPTIONS_NODES} without crossover, mixed precision, "
                       "pdlp_matrix='bricks'", res, wall, smi, PATHS["bricks mixed"], "bricks")
    if met.engine != "pdlp" or abs(obj - flow) > 1e-5 * abs(flow) or \
            met.fo_f32_iterations < 1 or min(PATHS["bricks mixed"].values()) < met.fo_iterations:
        raise AssertionError(f"[bricks] engine {met.engine!r} objective {obj!r} (scipy's "
                             f"{flow!r}) f32 iterations {met.fo_f32_iterations} launches "
                             f"{PATHS['bricks mixed']}")
    print(f"[bricks] objective {obj:.12g} scipy {flow:.12g} rel {abs(obj - flow) / abs(flow):.2e}")
    torch.cuda.empty_cache()


def knapsack_data(rows, cols):
    """A seeded multi-constraint 0/1 knapsack: integer weights and profits
    1-99, capacities at half the row sums."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    W = rng.integers(1, 100, (rows, cols)).astype(float)
    profit = rng.integers(1, 100, cols).astype(float)
    return W, profit, np.floor(W.sum(1) / 2)


def knapsack_mip(rows, cols):
    import scipy.sparse as sp

    from relp_tpu_torch.model.elements import Objective, RangedConstraintRelation, VariableType
    from relp_tpu_torch.model.general_form import GeneralForm, Variable

    W, profit, cap = knapsack_data(rows, cols)
    return GeneralForm(
        objective=Objective.MAXIMIZE, A=sp.csc_matrix(W),
        constraint_types=[RangedConstraintRelation.less() for _ in range(rows)], b=cap,
        variables=[Variable(name=f"x{j}", cost=float(profit[j]), lower=0.0, upper=1.0,
                            variable_type=VariableType.INTEGER) for j in range(cols)],
        name=f"knapsack_{rows}x{cols}")


def _milp_reference(shapes):
    """HiGHS on each knapsack: ``(best objective or None, proven upper bound,
    optimal?)`` per shape, each under ``MILP_SECONDS``."""
    import numpy as np
    from scipy.optimize import Bounds, LinearConstraint, milp

    out = {}
    for rows, cols in shapes:
        W, profit, cap = knapsack_data(rows, cols)
        ref = milp(-profit, constraints=LinearConstraint(W, -np.inf, cap),
                   integrality=np.ones(cols), bounds=Bounds(0, 1),
                   options={"time_limit": MILP_SECONDS})
        out[(rows, cols)] = (None if ref.x is None else float(-ref.fun),
                             float(-ref.mip_dual_bound), ref.status == 0)
    return out


def _check_mip(tag, kind, objective, best_bound, nodes, lp_iterations, wall, ref, smi):
    """Hold one branch-and-bound outcome (a maximisation) to HiGHS's:
    objectives equal where both are proven, else our incumbent at most
    HiGHS's bound and our bound at least HiGHS's incumbent."""
    highs_obj, highs_bound, highs_optimal = ref
    if kind not in ("finite_optimum", "iteration_limit"):
        raise AssertionError(f"[dual] {tag}: {kind}")
    line = (f"[dual] mip {tag}: {kind} nodes {nodes} LP iterations {lp_iterations} wall "
            f"{wall:.3f} s; HiGHS objective {highs_obj} bound {highs_bound:.6g} "
            f"{'optimal' if highs_optimal else 'at its time limit'}")
    if objective is None:
        print(f"{line}; no incumbent within the node budget, nothing claimed [{smi}]")
        return
    tol = 1e-6 * max(1.0, abs(highs_bound))
    if objective > highs_bound + tol or (highs_obj is not None and best_bound < highs_obj - tol):
        raise AssertionError(f"{line}: incumbent {objective!r} bound {best_bound!r}")
    proven = abs(best_bound - objective) <= tol
    if proven and highs_optimal and abs(objective - highs_obj) > tol:
        raise AssertionError(f"{line}: objective {objective!r} != HiGHS {highs_obj!r}")
    print(f"{line}; incumbent {objective:.12g} bound {best_bound:.12g} "
          f"({'equal to HiGHS' if proven and highs_optimal else 'bracketing HiGHS'}) [{smi}]")


def _dual_solve(tag, general, name, fmt, config, want, smi, engine="dual", abs_tol=None):
    """One ``algorithm="dual"`` solve through ``api.solve``; prints its line."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    res, wall = _solve_file(general, name, config)
    obj = _check_optimal("dual", res, fmt)
    met = res.simplex.metrics
    tol = abs_tol if abs_tol is not None else OBJ_REL * abs(want)
    if met.engine != engine or abs(obj - want) > tol:
        raise AssertionError(f"[dual] {tag}: engine {met.engine!r} objective {obj!r}, expected "
                             f"{engine!r} and {want!r}")
    its = max(met.iterations, 1)
    lu = f" host LU engine {met.lu_engine}" if met.lu_engine else ""
    print(f"[dual] {tag}: engine {met.engine}{lu} objective {obj:.12g} == {want:.12g} "
          f"iterations {met.iterations} flips {met.bound_flips} solve_wall {met.wall_s:.3f} s "
          f"iters/s {met.iters_per_s:.1f} api_wall {wall:.3f} s host_reads {met.host_reads} "
          f"({met.host_reads / its:.3f}/iter) peak_mem "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB [{smi}]")
    return met


def phase_dual(smi, launches, highs, milp_ref):
    """The dual simplex, reoptimization and branch and bound on the card."""
    import numpy as np
    import torch

    from relp_tpu_torch import cli
    from relp_tpu_torch.io.mps_write import export_mps
    from relp_tpu_torch.model.computational_form import build_computational_form
    from relp_tpu_torch.models.branch_bound import solve_mip
    from relp_tpu_torch.models.dense import dense_lp
    from relp_tpu_torch.presolve.engine import presolve
    from relp_tpu_torch.simplex import driver, dual
    from relp_tpu_torch.simplex import status as st
    from relp_tpu_torch.simplex.core import solve_core
    from relp_tpu_torch.simplex.reoptimize import reoptimize_with_bounds
    from relp_tpu_torch.simplex.validate import check_state
    from relp_tpu_torch.utils.config import DEFAULT_CONFIG, SolverConfig

    def checked_dual_solve(path, names, *args, **kwargs):
        """``_dual_solve`` under ``counted``, with ``check_state`` on the final
        state of its ``solve_core_dual`` call (all four residuals under 1e-6)
        and its step graphs' replays against its ``graph_steps``."""
        kept = []
        solve_core_dual = dual.solve_core_dual
        dual.solve_core_dual = lambda *a, **k: solve_core_dual(*a, final_state=kept, **k)
        first, replays = len(GRAPHS), sum(g["replays"] for g in GRAPHS)
        try:
            with counted(names, {}, path):
                met = _dual_solve(*args, **kwargs)
        finally:
            dual.solve_core_dual = solve_core_dual
        (K, s), = kept
        chk = check_state(K.A, K.b, K.c, K.lb, K.ub, s.basis, s.vstat, s.xB, s.Binv, K.art_sign)
        if not chk.ok(1e-6):
            raise AssertionError(f"[dual] check_state of the final state: {chk}")
        graphs = GRAPHS[first:]
        replays = sum(g["replays"] for g in GRAPHS) - replays
        if replays != met.graph_steps or len(graphs) != met.graph_captures or \
                any(g["recorded"][names[0]] < 1 for g in graphs):
            raise AssertionError(f"[dual] {replays} replays of {len(graphs)} step graphs "
                                 f"recording {[g['recorded'][names[0]] for g in graphs]} "
                                 f"{names[0]}; graph_steps {met.graph_steps} graph_captures "
                                 f"{met.graph_captures}")
        # the update kernel: once in each graph, which its replays launch, and
        # once in the eager step before each capture, which the metric leaves out
        if any(g["recorded"]["dual_update"] != 1 for g in graphs) or \
                REPLAYED[path]["dual_update"] != met.update_kernel_steps or \
                met.update_kernel_steps != met.graph_steps or \
                PATHS[path]["dual_update"] != met.graph_captures:
            raise AssertionError(f"[dual] dual_update launched {PATHS[path]['dual_update']} "
                                 f"times from the host and {REPLAYED[path]['dual_update']} "
                                 f"replayed ({[g['recorded']['dual_update'] for g in graphs]} "
                                 f"a graph); update_kernel_steps {met.update_kernel_steps} "
                                 f"graph_steps {met.graph_steps} graph_captures "
                                 f"{met.graph_captures}")
        its = max(met.iterations, 1)
        print("[dual] launches from the host "
              + " ".join(f"{k} {v} ({v / its:.3f}/iter)" for k, v in PATHS[path].items())
              + ", replayed " + " ".join(f"{k} {v} ({v / its:.3f}/iter)"
                                         for k, v in REPLAYED[path].items())
              + f" in {replays} steps from {len(graphs)} CUDA graphs"
              + "; check_state of the final state: "
              + " ".join(f"{k} {float(v):.2e}" for k, v in chk._asdict().items()))
        return met

    def launched(path, name):
        return PATHS[path][name] + REPLAYED[path][name]

    # 1. the slice's LP at full width, dual from scratch
    general, flow = slice_problem()
    met = checked_dual_solve("dual", ("ell_price", "ell_spmv", "dual_update"),
                             f"max-flow N={N_NODES}", general,
                             f"maxflow_{N_NODES}", "ell", SolverConfig(algorithm="dual"), flow,
                             smi, abs_tol=1e-6)
    refactorizations = met.iterations // DEFAULT_CONFIG.refactor_period
    if launched("dual", "ell_price") < met.iterations + refactorizations or \
            PATHS["dual"]["ell_spmv"] < max(refactorizations, 1):
        raise AssertionError(f"[dual] launches {PATHS['dual']} for {met.iterations} iterations")
    torch.cuda.empty_cache()

    # 2. the options of the dual at N = 1,024
    general, flow = slice_problem(OPTIONS_NODES)
    for opts in (dict(dual_pricing="devex"), dict(dual_ratio="bisect"), dict(xl_engine="lu")):
        lu = "xl_engine" in opts
        with counted(("ell_price", "ell_spmv"), {}, f"dual {opts}"):
            met = _dual_solve(f"max-flow N={OPTIONS_NODES} {opts}",
                              slice_problem(OPTIONS_NODES)[0], f"maxflow_{OPTIONS_NODES}",
                              "csc" if lu else "ell", SolverConfig(algorithm="dual", **opts),
                              flow, smi, engine="dual-lu" if lu else "dual", abs_tol=1e-6)
        if lu:  # a host engine: it launches nothing, and says which LU updates ran
            if met.lu_engine not in ("forrest-tomlin", "product-form"):
                raise AssertionError(f"[dual] host LU engine {met.lu_engine!r}")
            del PATHS[f"dual {opts}"]

    # 3. the dense LP at its documented size, on the dense operator
    m, n = DENSE_SHAPE
    met = checked_dual_solve("dual dense", ("dense_price", "dual_update"), f"dense LP {m}x{n}",
                             dense_lp(m, n), f"dense_{m}x{n}", "dense",
                             SolverConfig(algorithm="dual"), highs.result(), smi)
    if launched("dual dense", "dense_price") < met.iterations:
        raise AssertionError(f"[dual] launches {PATHS['dual dense']} for {met.iterations} "
                             "iterations")
    # the report's dual_update launches: the dense LP's (its timed row's shape)
    launches["dual_update"] = PATHS["dual dense"]["dual_update"]
    launches["dual_update replayed"] = REPLAYED["dual dense"]["dual_update"]

    # 4. reoptimization: the dense LP at 256 × 512, a seeded tenth of the upper
    # bounds tightened, from the prior output against a cold primal solve
    general = dense_lp(*OPTIONS_SHAPE)
    presolve(general)
    p = driver._Padded.of(build_computational_form(general, scale=True), DEFAULT_CONFIG,
                          torch.device("cuda"))
    A = p.device_A()
    b_t, c_t, lb_t, ub_t = (torch.as_tensor(v, device=p.dev) for v in (p.b, p.c, p.lb, p.ub))
    prior = solve_core(A, b_t, c_t, lb_t, ub_t, DEFAULT_CONFIG, p.max_iter)
    x = prior.x.cpu().numpy()
    tight = np.random.default_rng(SEED).choice(p.cf.n, p.cf.n // 10, replace=False)
    ub2 = p.ub.copy()
    ub2[tight] = np.minimum(ub2[tight], 0.5 * (x[tight] + p.lb[tight]) + 0.25 * ub2[tight])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = reoptimize_with_bounds(A, b_t, c_t, p.lb, ub2, prior, DEFAULT_CONFIG, p.max_iter)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cold = solve_core(A, b_t, c_t, lb_t, torch.as_tensor(ub2, device=p.dev), DEFAULT_CONFIG,
                      p.max_iter)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if not int(prior.status) == int(warm.status) == int(cold.status) == st.OPTIMAL:
        raise AssertionError(f"[dual] reoptimize: statuses {int(prior.status)} "
                             f"{int(warm.status)} {int(cold.status)}")
    if abs(float(warm.obj) - float(cold.obj)) > OBJ_REL * abs(float(cold.obj)) or \
            int(warm.it) >= int(cold.it):
        raise AssertionError(f"[dual] reoptimize: objective {float(warm.obj)!r} in "
                             f"{int(warm.it)} iterations, cold {float(cold.obj)!r} in "
                             f"{int(cold.it)}")
    moved = int((x[tight] > ub2[tight] + 1e-9).sum())
    print(f"[dual] reoptimize dense {OPTIONS_SHAPE[0]}x{OPTIONS_SHAPE[1]}: {len(tight)} upper "
          f"bounds tightened ({moved} below the prior optimum's value); from the prior basis "
          f"{int(warm.it)} iterations ({int(warm.flips)} flips) {t1 - t0:.3f} s, cold primal "
          f"{int(cold.it)} iterations {t2 - t1:.3f} s; objective {float(warm.obj):.12g} rel "
          f"{abs(float(warm.obj) - float(cold.obj)) / abs(float(cold.obj)):.2e} [{smi}]")

    # 5. branch and bound with Gomory cuts, on the dense operator
    milp_ref = milp_ref.result()
    for shape, budget in ((KNAPSACK_WIDE, KNAPSACK_WIDE_NODES), (KNAPSACK_SMALL, 2000)):
        with counted(("dense_price",), {}, f"mip {shape}"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solve_mip(knapsack_mip(*shape), max_nodes=budget)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _check_mip(f"knapsack {shape[0]}x{shape[1]}, solve_mip (4 cut rounds, {budget} nodes)",
                   res.kind.value, res.objective, res.best_bound, res.nodes, res.lp_iterations,
                   wall, milp_ref[shape], smi)
        print(f"[dual] mip launches dense_price {PATHS[f'mip {shape}']['dense_price']} "
              f"from the host, {REPLAYED[f'mip {shape}']['dense_price']} replayed")
    if not res.is_optimal:
        raise AssertionError(f"[dual] mip {KNAPSACK_SMALL}: {res.kind}, not the optimum")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "knapsack.mps")
        export_mps(knapsack_mip(*KNAPSACK_SMALL), path)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--mip", "--json", "-q", path])
        wall = time.perf_counter() - t0
    out = json.loads(buf.getvalue())
    if rc != 0 or out["objective"] != res.objective:
        raise AssertionError(f"[dual] --mip: rc={rc} {out}, solve_mip gave {res.objective!r}")
    _check_mip(f"knapsack {KNAPSACK_SMALL[0]}x{KNAPSACK_SMALL[1]}, python -m relp_tpu_torch "
               "--mip", out["status"], out["objective"], out["best_bound"], out["nodes"],
               out["lp_iterations"], wall, milp_ref[KNAPSACK_SMALL], smi)


def _cutting_stock(width, sizes):
    """Every cutting pattern (a column of piece counts) that fits ``width``."""
    import itertools

    import numpy as np

    out = []
    for combo in itertools.product(*[range(int(width // size) + 1) for size in sizes]):
        a = np.array(combo, dtype=float)
        if a.sum() > 0 and a @ sizes <= width:
            out.append(a)
    return np.stack(out, axis=1)


def masked_pool_data(m=POOL_SHAPE[0], n_pool=POOL_SHAPE[1], active_every=7, seed=3):
    """A covering-style LP over a large virtual pool of which every
    ``active_every``-th column is active (tests/test_lazy_pool_10k.py's
    ``build_pool``, drawn in the same order)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    A = np.where(rng.random((m, n_pool)) < 0.05, rng.random((m, n_pool)), 0.0)
    A[np.arange(m), rng.integers(0, n_pool, m)] = 1.0
    active = np.zeros(n_pool, dtype=bool)
    active[::active_every] = True
    b = A[:, active] @ rng.random(int(active.sum()))  # feasible w.r.t. the active set
    c = rng.random(n_pool) + 0.1
    return A, b, c, active


def _colgen_reference():
    """HiGHS on the full cutting-stock enumeration and on the masked pool
    (its active columns, and all of them): the optimal objectives."""
    import numpy as np
    from scipy.optimize import linprog

    patterns = _cutting_stock(CUT_WIDTH, np.array(CUT_SIZES))
    full = linprog(np.ones(patterns.shape[1]), A_ub=-patterns, b_ub=-np.array(CUT_DEMAND),
                   bounds=(0, None), method="highs")
    A, b, c, active = masked_pool_data()
    act = linprog(c[active], A_eq=A[:, active], b_eq=b, bounds=(0, None), method="highs")
    every = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs")
    for name, ref in (("cutting stock", full), ("pool active", act), ("pool all", every)):
        if ref.status != 0:
            raise AssertionError(f"HiGHS did not solve the {name} LP: {ref.message}")
    return {"cutting stock": float(full.fun), "pool active": float(act.fun),
            "pool all": float(every.fun), "patterns": patterns.shape[1]}


def phase_analysis(smi):
    """Ranging, the exact certificate and the CLI's --verify/--ranging on the card."""
    import copy
    from fractions import Fraction
    from types import SimpleNamespace

    import numpy as np
    import torch

    from relp_tpu_torch import api
    from relp_tpu_torch.model.elements import LinearProgramType
    from relp_tpu_torch.models.dense import dense_lp
    from relp_tpu_torch.numerics.exact import certify_optimal_basis, polish_to_certified
    from relp_tpu_torch.simplex import driver
    from relp_tpu_torch.simplex import status as st
    from relp_tpu_torch.simplex.driver import solve_computational_form
    from relp_tpu_torch.simplex.reoptimize import reoptimize_with_bounds
    from relp_tpu_torch.utils.config import DEFAULT_CONFIG

    # 1. ranging (api.ranging_of) of the dense LP at 256 × 512 solved through
    # api.solve, a seeded sample of its intervals held against warm re-solves
    # just inside and just outside each finite end: inside, the objective moves linearly with the slope the
    # ranging reports (a range reported too wide fails here); outside, the
    # objective leaves the line on the side the optimal value's shape allows
    # (a minimum is concave in a cost: at or below the line; convex in a
    # right-hand side: at or above it), as the JAX package's tight-edge test
    m, n = OPTIONS_SHAPE
    solved, solve_s = _solve_file(dense_lp(m, n), f"dense_{m}x{n}")
    _check_optimal("analysis", solved, "dense")
    t0 = time.perf_counter()
    rng_ = api.ranging_of(solved)
    range_s = time.perf_counter() - t0
    cf, res = solved.cf, solved.simplex
    warm = (res.basis, res.vstat[: res.metrics.n_padded])

    # a cost change keeps the basis primal feasible: a warm primal re-solve
    # (a few pivots); an rhs change keeps it dual feasible: the dual simplex
    # from it (reoptimize_with_bounds), as a user re-solving would
    padded = driver._Padded.of(cf, DEFAULT_CONFIG, torch.device("cuda"))
    prior = SimpleNamespace(**{k: torch.as_tensor(getattr(res, k), device=padded.dev)
                               for k in ("basis", "vstat", "art_sign")})

    def resolve(dc=None, db=None):
        """(objective in the problem's units, iterations) after the change."""
        if dc:
            cf2 = copy.deepcopy(cf)
            for j, delta in dc.items():
                cf2.c[j] += cf2.col_scale[j] * delta   # a minimization: sigma = 1
                cf2._orig_cost[j] += delta
            out = solve_computational_form(cf2, DEFAULT_CONFIG, warm_start_builder=lambda *_: warm)
            if out.kind is not LinearProgramType.FINITE_OPTIMUM:
                raise AssertionError(f"[analysis] re-solve {dc}: {out.kind}")
            return out.objective, out.iterations
        b2 = padded.b.copy()
        for i, delta in db.items():
            b2[i] += cf.row_scale[i] * delta
        out = reoptimize_with_bounds(padded.device_A(), b2, padded.c, padded.lb, padded.ub,
                                     prior, DEFAULT_CONFIG, padded.max_iter)
        if int(out.status) != st.OPTIMAL:
            raise AssertionError(f"[analysis] re-solve {db}: status {int(out.status)}")
        return cf.objective_of(out.x[: cf.n].cpu().numpy()), int(out.it)

    sample = np.random.default_rng(SEED)
    checked = {"cost": 0, "rhs": 0}
    left = {"cost": 0, "rhs": 0}   # outside ends where the objective left the line
    its = []
    t0 = time.perf_counter()
    for part, rows in (("cost", rng_.cost), ("rhs", rng_.rhs)):
        finite = [k for k, r in enumerate(rows)
                  if (np.isfinite(r.lo) or np.isfinite(r.hi)) and getattr(r, "computed", True)]
        for k in sample.choice(finite, min(ANALYSIS_SAMPLE, len(finite)), replace=False):
            r = rows[k]
            cur, slope = (r.cost, r.value) if part == "cost" else (r.rhs, r.dual)
            for end in (r.lo, r.hi):
                if not np.isfinite(end):
                    continue
                width = abs(end - cur)
                side = 1.0 if end >= cur else -1.0
                for where, delta in (("inside", (end - cur) - side * 1e-4 * width),
                                     ("outside", (end - cur) + side * 1e-2 * max(width, 1.0))):
                    j = cf.col_names.index(r.name) if part == "cost" else k
                    obj, it = resolve(dc={j: delta}) if part == "cost" else resolve(db={j: delta})
                    its.append(it)
                    line = res.objective + delta * slope
                    tol = 1e-7 * max(1.0, abs(line))
                    if where == "inside" and abs(obj - line) > tol:
                        raise AssertionError(f"[analysis] {part} {r.name} end {end!r}: inside, "
                                             f"objective {obj!r} off the line {line!r}")
                    if where == "outside":
                        off = (obj - line) * (1.0 if part == "cost" else -1.0)
                        if off > tol:
                            raise AssertionError(
                                f"[analysis] {part} {r.name} end {end!r}: outside, objective "
                                f"{obj!r} on the wrong side of the line {line!r}")
                        left[part] += off < -tol
                checked[part] += 1
    check_s = time.perf_counter() - t0
    print(f"[analysis] ranging dense {m}x{n}: api.solve {solve_s:.3f} s ({res.iterations} "
          f"iterations), api.ranging_of {range_s:.3f} s for {len(rng_.cost)} costs and "
          f"{len(rng_.rhs)} rhs; finite ends held against warm re-solves: cost {checked['cost']} "
          f"(beyond the end off the line {left['cost']}), rhs {checked['rhs']} "
          f"({left['rhs']}), {len(its)} re-solves, {sum(its)} iterations, {check_s:.3f} s "
          f"[{smi}]")
    if min(checked.values()) < ANALYSIS_SAMPLE:
        raise AssertionError(f"[analysis] only {checked} finite ends checked")

    # 2. the vertex of the N = 1,024 max flow certified over Q
    general, flow = slice_problem(OPTIONS_NODES)
    res, wall = _solve_file(general, f"maxflow_{OPTIONS_NODES}")
    _check_optimal("analysis", res, "ell")
    t0 = time.perf_counter()
    cert = certify_optimal_basis(res.cf, res.simplex)
    cert_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    polished, pivots = polish_to_certified(res.cf, res.simplex)
    polish_s = time.perf_counter() - t0
    if not polished.ok() or polished.objective != Fraction(int(flow)) or flow != int(flow):
        raise AssertionError(f"[analysis] certificate of the max flow: ok={polished.ok()} "
                             f"objective {polished.objective} scipy {flow!r}")
    print(f"[analysis] max-flow N={OPTIONS_NODES}: basis of the primal solve ({res.simplex.iterations} "
          f"iterations, {wall:.3f} s) certified {'OPTIMAL' if cert.ok() else 'NOT YET'} over Q "
          f"in {cert_s:.3f} s; polish_to_certified {pivots} exact pivots {polish_s:.3f} s -> "
          f"OPTIMAL, objective {polished.objective} == scipy {flow:.12g} [{smi}]")

    # 3. the command line: --verify --ranging --json, then --verify alone
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "testprob.mps")
        Path(path).write_text(WIKI_MPS)
        env = dict(os.environ, RELP_TPU_TORCH_DEVICE="cuda", PYTHONPATH=str(ROOT))
        for flags in (["--verify", "--ranging", "--json"], ["--verify", "-q"]):
            t0 = time.perf_counter()
            run = subprocess.run([sys.executable, "-m", "relp_tpu_torch", *flags, path],
                                 capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
            wall = time.perf_counter() - t0
            if run.returncode != 0:
                raise AssertionError(f"[analysis] {flags}: exit {run.returncode}\n{run.stderr}")
            if "--json" in flags:
                out = json.loads(run.stdout)
                if out["objective"] != -8.0 or not out["ranging"]["rhs"]:
                    raise AssertionError(f"[analysis] {flags}: {out}")
                said = f"objective {out['objective']} ranging of {len(out['ranging']['cost'])} " \
                       f"costs and {len(out['ranging']['rhs'])} rows"
            else:
                said = " / ".join(line for line in run.stderr.splitlines()
                                  if line.startswith("exact"))
                if "exact check: OK" not in said or "certificate: OPTIMAL" not in said:
                    raise AssertionError(f"[analysis] {flags}: {run.stderr}")
            print(f"[analysis] python -m relp_tpu_torch {' '.join(flags)} testprob.mps: exit 0, "
                  f"{said} ({wall:.1f} s with start-up)")
    torch.cuda.empty_cache()


def phase_colgen(smi, colgen_ref):
    """Column generation on the card: the cutting stock of
    examples/column_range.py to its proven optimum, and the masked
    10,000-column pool, each against HiGHS."""
    import numpy as np
    import torch

    from relp_tpu_torch.providers import ColumnPool, solve_with_column_generation
    from relp_tpu_torch.utils.config import SolverConfig

    ref = colgen_ref.result()
    cfg = SolverConfig(scale=False)
    names = ("dense_price", "dense_price_select")
    sizes, demand = np.array(CUT_SIZES), np.array(CUT_DEMAND)

    def knapsack(pi, pool):
        patterns = _cutting_stock(CUT_WIDTH, sizes)
        values = pi @ patterns
        best = int(np.argmax(values))
        if values[best] <= 1.0 + 1e-7:
            return None  # priced out, as the example's pricing decides
        return patterns[:, [best]], [1.0], [0.0], [np.inf], None

    def run(tag, pool, generator, want, path):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with counted(names, {}, path):
            res = solve_with_column_generation(pool, generator, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if res.kind.value != "finite_optimum" or abs(res.objective - want) > OBJ_REL * abs(want):
            raise AssertionError(f"[colgen] {tag}: {res.kind} objective {res.objective!r}, "
                                 f"HiGHS {want!r}")
        counts = PATHS[path]
        if counts["dense_price_select"] < res.total_iterations or \
                counts["dense_price"] < res.rounds:
            raise AssertionError(f"[colgen] {tag}: launches {counts} for "
                                 f"{res.total_iterations} iterations in {res.rounds} rounds")
        its = max(res.total_iterations, 1)
        print(f"[colgen] {tag}: objective {res.objective:.12g} == HiGHS {want:.12g} rounds "
              f"{res.rounds} iterations {res.total_iterations} pool {res.pool.nr_columns} columns "
              f"wall {wall:.3f} s launches "
              + " ".join(f"{k} {v} ({v / its:.3f}/iter)" for k, v in counts.items())
              + f" [{smi}]")
        return res

    # 1. the cutting stock, single-size patterns first, knapsack pricing
    m = len(demand)
    init = np.diag((CUT_WIDTH // sizes).astype(float))
    pool = ColumnPool(A=np.concatenate([init, -np.eye(m)], axis=1), b=demand.astype(float),
                      c=np.concatenate([np.ones(m), np.zeros(m)]), lb=np.zeros(2 * m),
                      ub=np.full(2 * m, np.inf),
                      names=[f"p{j}" for j in range(m)] + [f"s{i}" for i in range(m)])
    res = run(f"cutting stock width {CUT_WIDTH:g} (of {ref['patterns']} patterns)", pool,
              knapsack, ref["cutting stock"], "colgen")
    if res.rounds < 2:
        raise AssertionError("[colgen] the cutting stock generated no column")

    # 2. the masked pool: priced over the active columns, then grown by the
    # most negative reduced costs of the inactive ones until none is left
    A, b, c, active = masked_pool_data()
    pool = ColumnPool(A=A, b=b, c=c, lb=np.zeros(A.shape[1]), ub=np.full(A.shape[1], np.inf),
                      names=[f"v{j}" for j in range(A.shape[1])], active=active)
    res = run(f"masked pool {A.shape[0]}x{A.shape[1]} (every 7th active)", pool,
              lambda pi, pool: None, ref["pool active"], "colgen pool")
    if np.any(res.x[~active] != 0.0):
        raise AssertionError("[colgen] an inactive column entered")
    inactive = np.flatnonzero(~active)

    def activate(pi, pool):
        d = c[inactive] - pi @ A[:, inactive]
        take = inactive[np.argsort(d)[:POOL_BATCH]]
        take = take[(c[take] - pi @ A[:, take]) < -1e-9]
        if not len(take):
            return None
        return A[:, take], c[take], np.zeros(len(take)), np.full(len(take), np.inf), \
            [f"v{j}+" for j in take]

    run(f"masked pool, {POOL_BATCH} inactive columns a round by reduced cost", pool, activate,
        ref["pool all"], "colgen grow")
    torch.cuda.empty_cache()


def phase_ipm(smi, highs, highs_small):
    """The interior point on the card: the dense LP with and without
    crossover under both ladders, and the max flows."""
    import torch

    from relp_tpu_torch.models.dense import dense_lp
    from relp_tpu_torch.simplex import primal_dual
    from relp_tpu_torch.simplex.driver import solve_computational_form
    from relp_tpu_torch.utils.config import SolverConfig

    factor = primal_dual._factor
    spent = [0.0, 0]

    def timed_factor(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = factor(*args, **kwargs)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        spent[1] += 1
        return out

    def solve(tag, general, name, want, rel, fmt, share=False, **kw):
        """One algorithm="ipm" solve through ``api.solve``; with ``share`` a
        second, instrumented solve of its computational form times the
        normal-equation product and Cholesky (``_factor``)."""
        torch.cuda.reset_peak_memory_stats()
        config = SolverConfig(algorithm="ipm", **kw)
        res, wall = _solve_file(general, name, config)
        obj = _check_optimal("ipm", res, fmt)
        met = res.simplex.metrics
        crossover = kw.get("pdlp_crossover", True)
        engine = "ipm+crossover" if crossover else "ipm"
        if met.engine != engine or abs(obj - want) > rel * abs(want):
            raise AssertionError(f"[ipm] {tag}: engine {met.engine!r} objective {obj!r}, "
                                 f"expected {engine!r} and {want!r}")
        extra = ""
        if share:
            spent[:] = [0.0, 0]
            primal_dual._factor = timed_factor
            try:
                res2 = solve_computational_form(res.cf, config)
            finally:
                primal_dual._factor = factor
            extra = (f"; instrumented run {res2.metrics.wall_s:.3f} s of which _factor "
                     f"(A·D·Aᵀ + Cholesky) {spent[0]:.3f} s in {spent[1]} calls, share "
                     f"{spent[0] / res2.metrics.wall_s:.3f}")
        print(f"[ipm] {tag}: engine {met.engine} ladder {met.ipm_ladder} interior-point "
              f"iterations {met.fo_iterations} (all {met.iterations}) KKT {met.fo_kkt:.2e} "
              f"objective {obj:.15g} ref {want:.15g} rel {abs(obj - want) / abs(want):.2e} "
              f"solve_wall {met.wall_s:.3f} s ({met.wall_s / max(met.fo_iterations, 1) * 1e3:.2f}"
              f" ms per interior-point iteration, crossover included) api_wall {wall:.3f} s "
              f"host_reads {met.host_reads} peak_mem "
              f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB{extra} [{smi}]")
        return met

    # 1. the dense LP at its documented size, both ladders, without crossover;
    # with it at 256 × 512: the crossover's host push refactorizes the dense
    # basis ~180 times at 768 × 1536 (~1.3 s each, ~4 min; PERF.md,
    # tools/profile_torch_slice.py --problem ipm --crossover)
    m, n = DENSE_SHAPE
    want = highs.result()
    for ladder in ("f64", "mixed"):
        solve(f"dense LP {m}x{n} {ladder} without crossover", dense_lp(m, n), f"dense_{m}x{n}",
              want, 1e-6, "dense", share=True, pdlp_crossover=False, ipm_ladder=ladder)
    m, n = OPTIONS_SHAPE
    want = highs_small.result()
    for ladder in ("f64", "mixed"):
        solve(f"dense LP {m}x{n} {ladder} with crossover", dense_lp(m, n), f"dense_{m}x{n}",
              want, OBJ_REL, "dense", ipm_ladder=ladder)

    # 2. the max flow at N = 1,024 with crossover, against scipy's max flow
    general, flow = slice_problem(OPTIONS_NODES)
    for ladder in ("f64", "mixed"):
        solve(f"max-flow N={OPTIONS_NODES} {ladder} with crossover", general,
              f"maxflow_{OPTIONS_NODES}", flow, OBJ_REL, "ell", ipm_ladder=ladder)

    # 3. the max flow at N = 4,096 without crossover: a 4,096 × 32,768 f64
    # operator (1 GiB) in every normal-equation product
    general, flow = slice_problem(IPM_NODES)
    for ladder in ("f64", "mixed"):
        solve(f"max-flow N={IPM_NODES} {ladder} without crossover", general,
              f"maxflow_{IPM_NODES}", flow, 1e-6, "dense", share=ladder == "f64",
              pdlp_crossover=False, ipm_ladder=ladder)
    torch.cuda.empty_cache()


def _fleet_data(m, n, lanes, demand=True):
    """bench.py's DENSE fleet (bench.py:214-262): the base LP of
    models/dense.py's generator (seed 0xDE55E) and, per scenario, x0 (unless
    ``demand`` is False) and c0 moved by 3 % from the seed 20260819:
    ``(A, X, C)``, demands ``A @ X[s]``.  A copy of the generator: the package
    does not import bench.py."""
    import numpy as np

    rng = np.random.default_rng(FLEET_SEED)
    zb = rng.standard_normal((lanes, 30_000)) if demand else np.zeros((lanes, 30_000))
    zc = rng.standard_normal((lanes, 30_000))
    g = np.random.default_rng(0xDE55E)
    A = g.uniform(0.05, 1.0, (m, n))
    x0 = g.uniform(0.2, 1.0, n)
    c0 = g.uniform(0.1, 1.0, n)
    return A, x0 * (1.0 + 0.03 * zb[:, :n]), c0 * (1.0 + 0.03 * zc[:, :n])


def _fleet_arrays(m, n, lanes, demand=True):
    """The fleet's LPs as stacked arrays (one shared A, 0 ≤ x ≤ 2)."""
    import numpy as np

    A, X, C = _fleet_data(m, n, lanes, demand)
    return A, X @ A.T, C, np.zeros((lanes, n)), np.full((lanes, n), 2.0)


def _fleet_generals(m, n, lanes, demand=True):
    import scipy.sparse as sp

    from relp_tpu_torch.model.elements import Objective, RangedConstraintRelation
    from relp_tpu_torch.model.general_form import GeneralForm, Variable

    A, X, C = _fleet_data(m, n, lanes, demand)
    A_csc = sp.csc_matrix(A)
    return [GeneralForm(objective=Objective.MINIMIZE, A=A_csc,
                        constraint_types=[RangedConstraintRelation.equal()] * m, b=A @ X[s],
                        variables=[Variable(f"x{j}", cost=C[s, j], lower=0.0, upper=2.0)
                                   for j in range(n)], name=f"dense{s}")
            for s in range(lanes)]


def _fleet_highs(m, n, lanes, which, demand=True):
    """HiGHS's objectives of the fleet's LPs ``which`` (in a second process)."""
    from scipy.optimize import linprog

    A, b, c, lb, ub = _fleet_arrays(m, n, lanes, demand)
    out = {}
    for s in which:
        res = linprog(c[s], A_eq=A, b_eq=b[s], bounds=list(zip(lb[s], ub[s])), method="highs")
        if res.status != 0:
            raise AssertionError(f"HiGHS: fleet lane {s} status {res.status}")
        out[s] = float(res.fun)
    return out


def _flow_fleet():
    """The first-order fleet's LPs: the N = 1,024 max flow with each capacity
    scaled by 1 + 0.03·z (seed 20260819) and rounded to thousandths, and
    ``scipy``'s max flow of each (integers in thousandths)."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import maximum_flow

    from relp_tpu_torch.models.networks import max_flow_lp, random_arcs

    nodes = FLEET_FLOW_NODES
    arcs = random_arcs(nodes, 8, SEED)
    z = np.random.default_rng(FLEET_SEED).standard_normal((FLEET_FLOW_LANES, len(arcs)))
    generals, flows = [], []
    for s in range(FLEET_FLOW_LANES):
        lane = [(u, v, round(w * (1 + 0.03 * z[s, k]), 3)) for k, (u, v, w) in enumerate(arcs)]
        cap = sp.csr_matrix((np.array([round(w * 1000) for *_, w in lane], np.int64),
                             ([u for u, *_ in lane], [v for _, v, _ in lane])),
                            shape=(nodes, nodes))
        flows.append(maximum_flow(cap, 0, nodes - 1).flow_value / 1000.0)
        generals.append(max_flow_lp(nodes, lane, 0, nodes - 1))
    return generals, flows


def _lane_kkt(general, res):
    """Relative primal residual and duality gap of one lane's answer from its
    own x and duals (original units; a box 0 ≤ x ≤ 2, equality rows)."""
    import numpy as np

    A = general.A.toarray()
    x, y = res.simplex.x_structural, res.simplex.duals
    c = np.array([v.cost for v in general.variables])
    lb = np.array([v.lower for v in general.variables])
    ub = np.array([v.upper for v in general.variables])
    rp = max(np.abs(A @ x - general.b).max(), np.maximum(lb - x, x - ub).max(), 0.0) / (
        1.0 + np.abs(general.b).max())
    z = c - A.T @ y
    pobj = c @ x
    dobj = general.b @ y + np.where(z > 0, lb * z, ub * z).sum()
    return rp, abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj))


def _all_certified(engine, info):
    """Every lane answered by the fleet ``engine`` on the card: a lane it
    leaves uncertified goes to HiGHS on the host, whose answer would pass
    the comparisons with a reference all the same."""
    if info["engine"] != engine or info["certified"] != info["lanes"]:
        raise AssertionError(f"[fleet] {engine}: engine {info['engine']} certified "
                             f"{info['certified']} of {info['lanes']} lanes")


@contextlib.contextmanager
def _lane_calls():
    """Record each ``parallel.batched.solve_batched`` call the fleet driver
    makes (its arguments, its output and its wall) and pass it on."""
    import torch

    from relp_tpu_torch.parallel import batched

    calls = []
    solve = batched.solve_batched

    def recorded(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solve(*args, **kwargs)
        torch.cuda.synchronize()
        calls.append((args, kwargs, out, time.perf_counter() - t0))
        return out

    batched.solve_batched = recorded
    try:
        yield calls
    finally:
        batched.solve_batched = solve


def _lanes_equal_singles(tag, args, kwargs, out, config):
    """Raise unless the lane of the median and the lane of the most
    iterations among those that take more than ``eta_block`` steps (so that
    an eta block folds and both pricing windows come round) each took its
    single ``solve_core``'s steps from the same warm basis under the same
    config: iterations, basis and, under ``trace_iters``, the trace's phase,
    events, q and r."""
    import torch

    from relp_tpu_torch.simplex.core import solve_core

    its = out.it.tolist()
    long = sorted((it, s) for s, it in enumerate(its) if it > config.eta_block)
    if len(long) < 2:
        raise AssertionError(f"[fleet] {tag}: fewer than two lanes take more than "
                             f"{config.eta_block} steps ({its})")
    lanes = (long[len(long) // 2][1], long[-1][1])
    dev = out.x.device
    A, b, c, lb, ub = (torch.as_tensor(v, dtype=torch.float64, device=dev) for v in args)
    warm = kwargs["warm"]
    for s in lanes:
        with torch.no_grad():
            one = solve_core(A, b[s], c[s], lb[s], ub[s], config, kwargs["max_iter"],
                             basis0=torch.as_tensor(warm["basis0"][s], device=dev),
                             vstat0=torch.as_tensor(warm["vstat0"][s], device=dev),
                             art_sign0=torch.as_tensor(warm["art_sign0"][s], device=dev),
                             phase0=int(warm["phase0"][s]))
        it = int(one.it)
        rows = out.trace[s, :one.trace.shape[0]]
        if not (it == int(out.it[s]) and torch.equal(one.basis, out.basis[s])
                and torch.equal(rows[:, TRACE_EXACT], one.trace[:, TRACE_EXACT])
                and not out.trace[s, it:].any()):
            raise AssertionError(f"[fleet] {tag}: lane {s} took {int(out.it[s])} iterations, its "
                                 f"single solve {it}, or their bases or traces differ")
    print(f"[fleet] {tag}: lanes {list(lanes)} (the median and the most iterations above "
          f"eta_block {config.eta_block}) equal their single solve_core from the same warm "
          f"basis (iterations {[int(out.it[s]) for s in lanes]}, basis"
          f"{', trace rows' if config.trace_iters else ''})")


def phase_fleet(smi, launches, fleet_refs):
    """``solve_general_forms_batched`` on the card through each fleet engine."""
    import torch

    from relp_tpu_torch.simplex.driver import solve_general_forms_batched
    from relp_tpu_torch.utils.config import SolverConfig

    def run(tag, generals, config, names=(), report=True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stats = []
        with counted(names, launches if report else {}, f"fleet {tag}"):
            t0 = time.perf_counter()
            results = solve_general_forms_batched(generals, config, stats=stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if len(stats) != 1:
            raise AssertionError(f"[fleet] {tag}: {len(stats)} groups, expected one fleet")
        info = stats[0]
        its = max(info["iterations"], 1)
        per_it = " ".join(f"{k} {v / its:.3f}" for k, v in PATHS[f"fleet {tag}"].items())
        print(f"[fleet] {tag}: {info['lanes']} LPs of {info['shape'][0]}x{info['shape'][1]} "
              f"(shared A {info['shared_A']}) engine {info['engine']} wall {wall:.3f} s "
              f"({info['lanes'] / wall:.2f} LPs/s; engine group {info['wall_s']:.3f} s) "
              f"iterations {info['iterations']} host_reads {info['host_reads']} "
              f"({info['host_reads'] / its:.3f} per step) launches per iteration "
              f"[{per_it or 'none of the hand kernels'}] peak_mem "
              f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB "
              f"{ {k: v for k, v in info.items() if k not in ('shape', 'lanes', 'shared_A')} } "
              f"[{smi}]")
        bad = [s for s, r in enumerate(results) if r.solution is None]
        if bad:
            raise AssertionError(f"[fleet] {tag}: lanes {bad} have no optimum")
        return results, info

    # 1. the interior-point fleet on bench.py's fleet configuration
    m, n = DENSE_SHAPE
    generals = _fleet_generals(m, n, FLEET_LANES)
    results, info = run(f"ipm DENSE-{m}x{n}", generals,
                        SolverConfig(algorithm="ipm", presolve=False))
    _all_certified("ipm", info)
    worst = max((_lane_kkt(g, r) for g, r in zip(generals, results)), key=max)
    if max(worst) > 1e-6:
        raise AssertionError(f"[fleet] ipm: a lane's primal residual / KKT gap {worst}")
    ref = fleet_refs["ipm"].result()
    rels = {s: abs(results[s].solution.objective_value - want) / abs(want)
            for s, want in ref.items()}
    if max(rels.values()) > 1e-6:
        raise AssertionError(f"[fleet] ipm: lanes against HiGHS {rels}")
    print(f"[fleet] ipm: every lane's primal residual and KKT gap from its own x and duals "
          f"under 1e-6 (worst {worst[0]:.2e}, {worst[1]:.2e}); lanes {sorted(ref)} against "
          f"HiGHS rel {max(rels.values()):.2e}")
    del generals, results

    # 2. the lane-batched primal, every lane warm from one base solve.  Costs
    # move, demands do not: a demand shock can leave the base basis primal
    # infeasible for a lane, and the warm start then pivots degenerately on
    # it to the iteration limit, in the JAX package's code as in the single
    # solve here (ROADMAP.md queue 3)
    m, n = FLEET_PRIMAL_SHAPE
    lane_kernels = ("dense_price_lanes", "dense_price_select_lanes")
    generals = _fleet_generals(m, n, FLEET_LANES, demand=False)
    with _lane_calls() as calls:
        results, info = run(f"primal {m}x{n} (costs moved)", generals,
                            SolverConfig(presolve=False), lane_kernels)
    counts = PATHS[f"fleet primal {m}x{n} (costs moved)"]
    if min(counts.values()) < info["iterations"]:
        raise AssertionError(f"[fleet] primal: {counts} launches in {info['iterations']} "
                             "batched iterations")
    ref = fleet_refs["primal"].result()
    rel = max(abs(results[s].solution.objective_value - want) / abs(want)
              for s, want in ref.items())
    if rel > OBJ_REL:
        raise AssertionError(f"[fleet] primal: rel {rel:.2e} from HiGHS")
    print(f"[fleet] primal: all {len(ref)} lanes equal HiGHS (rel {rel:.2e}); lane iterations "
          f"{min(r.simplex.iterations for r in results)}-"
          f"{max(r.simplex.iterations for r in results)} after the base solve's "
          f"{info.get('base_iterations')}")
    _fleet_options(smi, generals, calls[0], ref, run, lane_kernels)

    # 3. the first-order fleet on perturbed max flows
    generals, flows = _flow_fleet()
    results, info = run(f"pdlp max-flow N={FLEET_FLOW_NODES}", generals,
                        SolverConfig(algorithm="pdlp", presolve=False), ("dense_price_lanes",))
    got = PATHS[f"fleet pdlp max-flow N={FLEET_FLOW_NODES}"]["dense_price_lanes"]
    if got < info["iterations"]:
        raise AssertionError(f"[fleet] pdlp: dense_price_lanes {got} launches in "
                             f"{info['iterations']} PDHG steps")
    _all_certified("pdlp", info)
    rel = max(abs(r.solution.objective_value - f) / f for r, f in zip(results, flows))
    if rel > 1e-6 or not info["shared_A"]:
        raise AssertionError(f"[fleet] pdlp: rel {rel:.2e} from scipy's max flow")
    print(f"[fleet] pdlp: all {len(flows)} lanes certified by the fleet on the card and equal "
          f"to scipy's max flow (rel {rel:.2e})")

    # 4. examples/torch_scenario_fleet.py on the card, as a user runs it
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_scenario_fleet", ROOT / "examples" / "torch_scenario_fleet.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results = example.main(algorithm="ipm")
    if not all(r.solution is not None for r in results):
        raise AssertionError(f"[fleet] examples/torch_scenario_fleet.py: {buf.getvalue()!r}")
    for line in buf.getvalue().splitlines():
        print(f"[fleet] examples/torch_scenario_fleet.py --algorithm ipm: {line}")
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _planted_checks(A, ub, plants):
    """The lane kernel's invariant check on states whose violation is known.
    At step ``t`` each lane's state goes to ``_check_violation`` with the
    structural basic value farthest below its upper bound moved up by
    ``plants[t][lane]`` (the solve goes on from the true state), which puts
    δ·max|A[:, j]| into the row residual and nothing into the bound
    violation.  Yields the list of ``(t, value)`` pairs, ``value`` ``[L]``
    (0 where no basic value had room for its plant)."""
    import torch

    from relp_tpu_torch.simplex import core

    if A.dim() != 2:
        raise AssertionError("the planted checks take an A shared by every lane")
    check = core.LanePrimalKernel._check_violation
    colmax = A.abs().amax(0)
    n = A.shape[1]
    planted = []

    def planting(self, s, phase1):
        delta = plants.get(self.steps)
        if delta is not None:
            j = s.basis.clamp(max=n - 1)
            room = torch.where(s.basis < n, ub.gather(1, j) - s.xB, -torch.inf)
            room, i = room.max(1)
            delta = torch.where(room > 2 * delta, delta, 0.0)
            xB = s.xB.clone()
            xB.scatter_add_(1, i[:, None], delta[:, None])
            planted.append((self.steps, delta * colmax[j.gather(1, i[:, None])[:, 0]]))
            s = dataclasses.replace(s, xB=xB)
        return check(self, s, phase1)

    core.LanePrimalKernel._check_violation = planting
    try:
        yield planted
    finally:
        core.LanePrimalKernel._check_violation = check


def _read_plants(tag, out, planted):
    """Raise unless each lane's ``viol`` reads the largest plant of
    :func:`_planted_checks` made while it was live (at a step below its
    ``it``), within 1e-9 (the unplanted runs' bound on the noise), and no
    plant made after its last step; every lane is planted at step 0 and, at
    the second firing step, at least one live and one finished lane."""
    import torch

    its = out.it
    want = torch.zeros_like(out.viol)
    for t, value in planted:
        want = torch.maximum(want, torch.where(its > t, value, 0.0))
    (t0, first), (t1, second) = planted
    err = float((out.viol - want).abs().max())
    live, done = int(((its > t1) & (second > 0)).sum()), int(((its <= t1) & (second > 0)).sum())
    if (t0 != 0 or not bool((first > 0).all()) or float(want.min()) < 1e-6 or err > 1e-9
            or not live or not done):
        raise AssertionError(f"[fleet] {tag}: planted checks read {out.viol.tolist()}, the plants "
                             f"{want.tolist()} (worst {err:.3g}; step {t1}: {live} live lanes, "
                             f"{done} finished)")
    print(f"[fleet] {tag}: every lane's check reads the violation planted in it at step 0 "
          f"((s + 1)·1e-6·max|A[:, j]|) and at step {t1} on the {live} lanes still live, not on "
          f"the {done} finished ones (worst |viol − plant| {err:.3g})")


def _fleet_options(smi, generals, default_call, ref, run, lane_kernels):
    """The primal fleet under each primal option through
    ``parallel.solve_batched``, warm from the default run's base basis, then
    all four together through ``solve_general_forms_batched`` (which runs
    its base solve under them): every lane against HiGHS, two lanes
    against their single solves (:func:`_lanes_equal_singles`), the check's
    values against violations planted in it (:func:`_planted_checks`), the
    lane kernels' launches and the host reads per batched iteration beside
    the default run's."""
    import torch

    from relp_tpu_torch.model.computational_form import build_computational_form
    from relp_tpu_torch.ops.dense_kernels import dense_price_select_lanes
    from relp_tpu_torch.parallel import solve_batched
    from relp_tpu_torch.utils.config import SolverConfig

    args, kwargs, out0, wall0 = default_call
    its0 = int(out0.it.max())
    reads0 = out0.host_reads / its0
    default_counts = PATHS[next(k for k in PATHS if k.startswith("fleet primal"))]
    cfs = [build_computational_form(g, scale=True) for g in generals]

    def report(tag, out, wall, peak, counts, config, call_args, call_kwargs, planted=None):
        its = int(out.it.max())
        x = out.x.cpu().numpy()
        rel = max(abs(cfs[s].objective_of(x[s][:cfs[s].n]) - want) / abs(want)
                  for s, want in ref.items())
        if rel > OBJ_REL or sorted(ref) != list(range(FLEET_LANES)):
            raise AssertionError(f"[fleet] {tag}: rel {rel:.2e} from HiGHS")
        viol = out.viol.cpu().numpy()
        if planted is not None:
            _read_plants(tag, out, planted)
        elif config.check_every_n and not ((viol >= 0.0) & (viol < 1e-9)).all():
            raise AssertionError(f"[fleet] {tag}: a lane's invariant check found {viol.max()}")
        if out.trace.shape != (FLEET_LANES, its if config.trace_iters else 0, 8):
            raise AssertionError(f"[fleet] {tag}: trace of shape {tuple(out.trace.shape)}")
        reads = out.host_reads / its
        if reads > reads0:
            raise AssertionError(f"[fleet] {tag}: {reads:.3f} host reads per batched iteration, "
                                 f"the default run {reads0:.3f}")
        per_it = " ".join(f"{k} {v / its:.3f}" for k, v in counts.items())
        per_it0 = " ".join(f"{k} {v / its0:.3f}" for k, v in default_counts.items())
        print(f"[fleet] {tag}: {FLEET_LANES} lanes warm from the base basis, all equal HiGHS "
              f"(rel {rel:.2e}); lane loop wall {wall:.3f} s (default {wall0:.3f} s), batched "
              f"iterations {its} ({its0}), host reads per batched iteration {reads:.3f} "
              f"({reads0:.3f}), launches per batched iteration [{per_it}] ([{per_it0}]), "
              f"peak_mem {peak / 2**20:.0f} MiB, max viol {float(out.viol.max()):.3g}, trace "
              f"{tuple(out.trace.shape)} [{smi}]")
        _lanes_equal_singles(tag, call_args, call_kwargs, out, config)

    dev = out0.x.device
    A, ub = (torch.as_tensor(args[k], dtype=torch.float64, device=dev) for k in (0, 4))
    lane_ids = torch.arange(1, FLEET_LANES + 1, dtype=torch.float64, device=dev)
    for tag, opts in FLEET_OPTIONS:
        config = SolverConfig(presolve=False, **opts)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dense_price_select_lanes.window_launches = 0
        every = config.check_every_n
        plant = (_planted_checks(A, ub, {0: lane_ids * 1e-6, every: lane_ids * 1e-5}) if every
                 else contextlib.nullcontext())
        with counted(lane_kernels, {}, f"fleet primal {tag}"), plant as planted:
            t0 = time.perf_counter()
            out = solve_batched(*args, cfg=config, max_iter=kwargs["max_iter"],
                                warm=kwargs["warm"], device=out0.x.device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = PATHS[f"fleet primal {tag}"]
        its = int(out.it.max())
        if config.price_blocks > 1:
            windowed = dense_price_select_lanes.window_launches
            if windowed < 1 or counts["dense_price_select_lanes"] < its:
                raise AssertionError(f"[fleet] {tag}: {windowed} windowed and "
                                     f"{counts['dense_price_select_lanes']} select launches in "
                                     f"{its} batched iterations")
            print(f"[fleet] {tag}: {windowed} windowed dense_price_select_lanes launches "
                  f"({windowed / its:.3f} per batched iteration)")
        report(tag, out, wall, torch.cuda.max_memory_allocated(), counts, config, args, kwargs,
               planted)

    # all four together through the fleet driver, whose base solve runs under them
    tag = "all four options"
    config = SolverConfig(presolve=False, **{k: v for _, o in FLEET_OPTIONS for k, v in o.items()})
    with _lane_calls() as calls:
        results, info = run(f"primal {tag}", generals, config, lane_kernels, report=False)
    (call_args, call_kwargs, out, wall), = calls
    rel = max(abs(results[s].solution.objective_value - want) / abs(want)
              for s, want in ref.items())
    if rel > OBJ_REL:
        raise AssertionError(f"[fleet] {tag}: driver's results rel {rel:.2e} from HiGHS")
    report(tag, out, wall, torch.cuda.max_memory_allocated(), PATHS[f"fleet primal {tag}"],
           config, call_args, call_kwargs)


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _mesh_select(dev, two):
    """The sharded operator's selections, at the shapes its shards launch
    them with, against the plain selection over the whole pool at the
    mid-solve state of ``_kernels_select``: the slice's ELL pool and the
    dense LP at 256 × 512 (the phase's), f32 over the whole pool and over a
    window across the shard boundary, f64 over the whole pool.  Each must
    also give the single operator's bits."""
    import torch

    from relp_tpu_torch.models.dense import dense_lp
    from relp_tpu_torch.ops.dense_kernels import dense_price_select_plain
    from relp_tpu_torch.ops.sparse_kernels import ell_price_plain, ell_price_select_plain
    from relp_tpu_torch.parallel.sharded import shard_operator

    for name, general in (("ell", lambda: slice_problem()[0]),
                          ("dense", lambda: dense_lp(*OPTIONS_SHAPE))):
        op = _operator(general(), dev, name).with_f32()
        sel, pi, c_eff = _mid_solve_state(general(), dev, MID_SOLVE_ITERS)
        sh = shard_operator(op, two)
        m_pad, n_pad = op.shape
        for tag, tol, j0, w in (("f32", F32_TOL, 0, n_pad),
                                ("f32", F32_TOL, n_pad // 4, n_pad // 2),
                                ("f64", F64_TOL, 0, n_pad)):
            v = pi.float() if tag == "f32" else pi
            c = (c_eff.float() if tag == "f32" else c_eff)[j0:j0 + w].contiguous()
            if name == "ell":
                pool = (op.data32_t if tag == "f32" else op.data_t), op.rows_t
                plain = ell_price_select_plain
                scale = float(ell_price_plain(pool[0].abs(), pool[1], v.abs(), None, j0, w).max())
            else:
                pool = (op.A32 if tag == "f32" else op.A,)
                plain = dense_price_select_plain
                scale = float((v.abs() @ pool[0][:, j0:j0 + w].abs()).max())
            got, single = ((o.price32_select(c, v, sel, j0, w) if tag == "f32" else
                            o.price_select(c, v, sel)) for o in (sh, op))
            torch.cuda.synchronize()
            label = (f"{name}_price_select {tag} [{j0}, {j0 + w}) of {m_pad}x{n_pad} over shards "
                     f"{sh.bounds}, mid-solve state")
            choice, err, tol = _agree("mesh", label, got, plain(*pool, v, c, *sel, j0, w),
                                      tol, scale)
            if not all(torch.equal(a, b) for a, b in zip(got, single)):
                raise AssertionError(f"[mesh] {label}: {tuple(t.tolist() for t in got)}, the "
                                     f"single operator {tuple(t.tolist() for t in single)}")
            print(f"[mesh] {label}: {choice}max_abs_err {err:.3e} (bound {tol:g}·(1 + |plain|)); "
                  "the single operator's (q, has, d_q) bit for bit")


def _mesh_lanes(dev, mesh, arrays, iters):
    """``dense_price_select_lanes`` as each 'batch' row of ``mesh`` launches
    it (its lanes of the shared A), at step ``iters`` of the meshed solve of
    ``arrays``, against the plain selection of every lane, f32 and f64."""
    import torch

    from relp_tpu_torch.ops.dense_kernels import (
        dense_price_select_lanes, dense_price_select_lanes_plain,
    )

    states = _lane_states(iters, arrays, mesh=mesh)
    if len(states) != mesh.shape["batch"]:
        raise AssertionError(f"[mesh] {len(states)} lane groups priced at step {iters}")
    A32 = torch.as_tensor(arrays[0], dtype=torch.float32, device=dev)
    m, n = A32.shape
    for row, (sel, V32, C32, live) in enumerate(states):
        for tag, tol, A, v, c in (("f32", F32_TOL, A32, V32, C32),
                                  ("f64", F64_TOL, A32.double(), V32.double(), C32.double())):
            got = dense_price_select_lanes(A, v, c, *sel)
            torch.cuda.synchronize()
            label = (f"dense_price_select_lanes {tag} 'batch' row {row}: {v.shape[0]} lanes of "
                     f"{m}x{n} at step {iters} ({int(live.sum())} live)")
            choice, err, tol = _agree("mesh", label, got,
                                      dense_price_select_lanes_plain(A, v, c, *sel), tol,
                                      float((v.abs() @ A.abs()).max()))
            print(f"[mesh] {label}: {choice}max_abs_err {err:.3e} (bound {tol:g}·(1 + |plain|))")


def phase_mesh(smi, highs_small):
    """The multi-device paths on two shards of the one card."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from relp_tpu_torch.fom import solve_pdhg_batched
    from relp_tpu_torch.models.dense import dense_lp
    from relp_tpu_torch.parallel import global_solver_mesh, make_solver_mesh, solve_batched
    from relp_tpu_torch.parallel.multihost import _join, process_allgather
    from relp_tpu_torch.simplex import status as st
    from relp_tpu_torch.utils.config import SolverConfig

    two = ["cuda:0", "cuda:0"]
    ell_names = ("ell_price", "ell_price_select", "ell_spmv")

    # 0. the shards' selection launches against the plain versions
    _mesh_select(torch.device("cuda"), [torch.device(d) for d in two])

    # 1. the slice's max flow over two column shards
    general, flow = slice_problem()
    torch.cuda.reset_peak_memory_stats()
    with counted(ell_names, {}, "mesh maxflow"):
        res, wall = _solve_file(general, f"maxflow_{N_NODES}", SolverConfig(mesh_cols=2),
                                devices=two)
    obj = _check_optimal("mesh", res, "ell")
    met, (one, one_wall) = res.simplex.metrics, SOLVES["slice"]
    got, single = PATHS["mesh maxflow"], PATHS["slice"]
    if abs(obj - flow) > 1e-6:
        raise AssertionError(f"[mesh] objective {obj!r} != max-flow value {flow!r}")
    if met.iterations != one.iterations or met.host_reads != one.host_reads:
        raise AssertionError(f"[mesh] {met.iterations} iterations, {met.host_reads} host reads;"
                             f" the single solve {one.iterations}, {one.host_reads}")
    if got["ell_price_select"] != 2 * single["ell_price_select"] or \
            got["ell_spmv"] != single["ell_spmv"]:
        raise AssertionError(f"[mesh] launches {got}, the single solve's {single}")
    its = max(met.iterations, 1)
    print(f"[mesh] max-flow N={N_NODES} over 2 shards of cuda:0: objective {obj:.12g} == scipy "
          f"{flow:.12g}; iterations {met.iterations} (single {one.iterations}) host_reads "
          f"{met.host_reads} ({met.host_reads / its:.3f}/iter, single {one.host_reads}) "
          f"ell_price_select {got['ell_price_select']} ({got['ell_price_select'] / its:.3f}/iter,"
          f" {got['ell_price_select'] / 2 / its:.3f} per shard; single "
          f"{single['ell_price_select']}) ell_price {got['ell_price']} ell_spmv "
          f"{got['ell_spmv']}")
    print(f"[mesh] max-flow solve_wall {met.wall_s:.3f} s api_wall {wall:.3f} s beside the "
          f"single solve's {one.wall_s:.3f} / {one_wall:.3f} s (the overhead of two shards on "
          f"one card, no speed-up) peak_mem {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB "
          f"[{smi}]")

    # 2. the dense LP over two column shards
    m, n = OPTIONS_SHAPE
    highs = highs_small.result()
    with counted(("dense_price", "dense_price_select"), {}, "mesh dense"):
        res, wall = _solve_file(dense_lp(m, n), f"dense_{m}x{n}", SolverConfig(mesh_cols=2),
                                devices=two)
    obj = _check_optimal("mesh", res, "dense")
    met, got, (one, one_wall) = res.simplex.metrics, PATHS["mesh dense"], SOLVES["options"]
    if abs(obj - highs) > OBJ_REL * abs(highs):
        raise AssertionError(f"[mesh] dense objective {obj!r} != HiGHS {highs!r}")
    if met.iterations != one.iterations or met.host_reads != one.host_reads:
        raise AssertionError(f"[mesh] dense {met.iterations} iterations, {met.host_reads} host "
                             f"reads; the single solve {one.iterations}, {one.host_reads}")
    if got["dense_price_select"] < 2 * met.iterations:
        raise AssertionError(f"[mesh] dense launches {got} for {met.iterations} iterations")
    its = max(met.iterations, 1)
    print(f"[mesh] dense LP {m}x{n} over 2 shards: objective {obj:.15g} HiGHS {highs:.15g} rel "
          f"{abs(obj - highs) / abs(highs):.2e} iterations {met.iterations} (single "
          f"{one.iterations}) host_reads {met.host_reads} (single {one.host_reads}) "
          f"dense_price_select {got['dense_price_select']} "
          f"({got['dense_price_select'] / its:.3f}/iter) dense_price {got['dense_price']} "
          f"solve_wall {met.wall_s:.3f} s api_wall {wall:.3f} s (single {one.wall_s:.3f} / "
          f"{one_wall:.3f} s) [{smi}]")

    # 3. PDLP on bricks under a mesh that shards: ELL, sharded
    general, flow = slice_problem()
    bricks = {name: _wrappers()[name] for name in ("brick_spmv", "brick_price")}
    for wrapper in bricks.values():  # counted apart: this path must launch neither
        wrapper.launches = 0
    with counted(("ell_price", "ell_spmv"), {}, "mesh pdlp"):
        res, wall = _solve_file(general, f"maxflow_{N_NODES}", SolverConfig(
            algorithm="pdlp", pdlp_crossover=False, pdlp_matrix="bricks", mesh_cols=2),
            devices=two)
    obj = _check_optimal("mesh", res, "ell")
    met = res.simplex.metrics
    got = dict(PATHS["mesh pdlp"], **{name: w.launches for name, w in bricks.items()})
    one, one_obj = SOLVES["pdlp"]
    if met.fo_matrix != "ell" or got["brick_spmv"] or got["brick_price"]:
        raise AssertionError(f"[mesh] pdlp operator {met.fo_matrix!r}, launches {got}")
    if met.fo_iterations != one.fo_iterations or abs(obj - one_obj) > OBJ_REL * abs(one_obj):
        raise AssertionError(f"[mesh] pdlp {met.fo_iterations} iterations objective {obj!r}; "
                             f"unmeshed {one.fo_iterations}, {one_obj!r}")
    print(f"[mesh] pdlp max-flow N={N_NODES} pdlp_matrix=bricks mesh_cols=2: operator "
          f"{met.fo_matrix}, launches {got}, iterations {met.fo_iterations} (unmeshed "
          f"{one.fo_iterations}) objective {obj:.12g} (unmeshed {one_obj:.12g}, scipy "
          f"{flow:.12g}) solve_wall {met.wall_s:.3f} s (unmeshed {one.wall_s:.3f} s) [{smi}]")

    # 4. scenarios over 'batch': two rows on the one card against the unmeshed runs
    mesh = make_solver_mesh(batch=2, cols=1, devices=two)
    arrays = _fleet_arrays(64, 128, 4, demand=False)
    cfg = SolverConfig()
    with counted(("dense_price_select_lanes",), {}, "mesh batched"):
        meshed = solve_batched(*arrays, cfg=cfg, max_iter=5000, mesh=mesh)
    flat = solve_batched(*arrays, cfg=cfg, max_iter=5000, device="cuda")
    if meshed.status.tolist() != flat.status.tolist() \
            or not torch.allclose(meshed.obj, flat.obj, rtol=OBJ_REL, atol=0) \
            or set(flat.status.tolist()) != {st.OPTIMAL}:
        raise AssertionError(f"[mesh] solve_batched meshed {meshed.status.tolist()} "
                             f"{meshed.it.tolist()} {meshed.obj.tolist()}; unmeshed "
                             f"{flat.status.tolist()} {flat.it.tolist()} {flat.obj.tolist()}")
    fo = dict(round_len=64, max_rounds=8, tol=1e-8)
    meshed_fo = solve_pdhg_batched(*arrays, mesh=mesh, **fo)
    flat_fo = solve_pdhg_batched(*arrays, device="cuda", **fo)
    if meshed_fo.status.tolist() != flat_fo.status.tolist() or \
            not torch.allclose(meshed_fo.x, flat_fo.x, rtol=0, atol=1e-9):
        raise AssertionError(f"[mesh] solve_pdhg_batched meshed {meshed_fo.it.tolist()}, "
                             f"unmeshed {flat_fo.it.tolist()}")
    # the lane kernels keep each lane's bits whatever the group; the shared
    # A's products (X·Aᵀ, the batched FTRAN) are cuBLAS calls over 2 or 4
    # lanes, whose rounding the library may choose by the lane count
    _mesh_lanes(torch.device("cuda"), mesh, arrays, MESH_LANE_STEP)
    print(f"[mesh] solve_batched 4 lanes of the dense LP 64x128 over 2 'batch' rows: "
          f"iterations {meshed.it.tolist()} (unmeshed {flat.it.tolist()}), objectives within "
          f"{OBJ_REL:g}, max |dobj| {float((meshed.obj - flat.obj).abs().max()):.2e} (launches "
          f"{PATHS['mesh batched']}); solve_pdhg_batched 8 rounds of 64: steps "
          f"{meshed_fo.it.tolist()} (unmeshed {flat_fo.it.tolist()}), max |dx| "
          f"{float((meshed_fo.x - flat_fo.x).abs().max()):.2e}")

    # 5. a one-rank NCCL group gathers a 2-scenario fleet's objectives
    _join(f"127.0.0.1:{_free_port()}", 1, 0, device="cuda")
    try:
        backend = dist.get_backend()
        gmesh = global_solver_mesh(device="cuda")
        A = np.zeros((2, 8, 128))
        A[:, 0, :3] = 1.0
        b = np.zeros((2, 8))
        b[:, 0] = (3.0, 6.0)
        c = np.zeros((2, 128))
        c[:, :2] = (-1.0, -2.0)
        ub = np.zeros((2, 128))
        ub[:, :2], ub[:, 2] = 4.0, np.inf
        out = solve_batched(A, b, c, np.zeros((2, 128)), ub, cfg=cfg, max_iter=64, mesh=gmesh)
        objs = process_allgather(out.obj).tolist()
    finally:
        dist.destroy_process_group()
    if backend != "nccl" or not np.allclose(objs, [-6.0, -10.0], rtol=0, atol=1e-9):
        raise AssertionError(f"[mesh] {backend} group gathered {objs}, expected [-6.0, -10.0]")
    print(f"[mesh] one-rank {backend} group over mesh {gmesh.shape}: gathered objectives "
          f"{objs} == closed form (-6, -10); destroyed")


def xl_block(k):
    """Block k of the [xl] LP: tests/test_parallel.py's boxed LP (30 % fill,
    one unit entry per row, ``b = A·U(0, 1)``, ``0 ≤ x ≤ 10``) from seed
    ``XL_BLOCK_SEED + k``."""
    import numpy as np

    m, n = XL_BLOCK_SHAPE
    rng = np.random.default_rng(XL_BLOCK_SEED + k)
    A = np.where(rng.random((m, n)) < 0.3, rng.standard_normal((m, n)), 0.0)
    A[np.arange(m), rng.integers(0, n, m)] = 1.0
    b = A @ rng.random(n)
    c = rng.standard_normal(n)
    return A, b, c


def xl_blocks_lp(blocks=XL_BLOCKS):
    """The block-diagonal stack of ``blocks`` independent boxed LPs
    (``xl_block``) as one GeneralForm: a sparse LP above the default XL gate
    whose optimum is the sum of the blocks' optima."""
    import numpy as np
    import scipy.sparse as sp

    from relp_tpu_torch.model.elements import Objective, RangedConstraintRelation
    from relp_tpu_torch.model.general_form import GeneralForm, Variable

    parts = [xl_block(k) for k in range(blocks)]
    A = sp.block_diag([sp.csc_matrix(a) for a, _, _ in parts], format="csc")
    b = np.concatenate([b_k for _, b_k, _ in parts])
    c = np.concatenate([c_k for _, _, c_k in parts])
    return GeneralForm(
        objective=Objective.MINIMIZE, A=A,
        constraint_types=[RangedConstraintRelation.equal()] * A.shape[0], b=b,
        variables=[Variable(f"x{j}", cost=float(c[j]), lower=0.0, upper=10.0)
                   for j in range(A.shape[1])],
        name=f"xl_blocks_{blocks}")


def _xl_references(n_nodes, blocks):
    """[xl]'s references, in a second process: the iterations and objective of
    the slice's max flow under ``algorithm="dual", xl_engine="lu"`` (the host
    LU dual, asked for on the host's CPU), and the sum of the blocks' optima
    by HiGHS."""
    import numpy as np
    import torch
    from scipy.optimize import linprog

    from relp_tpu_torch.simplex.driver import solve_general_form
    from relp_tpu_torch.utils.config import SolverConfig

    torch.set_num_threads(1)  # the host LU's work is scipy's and the native library's
    res = solve_general_form(slice_problem(n_nodes)[0],
                             SolverConfig(algorithm="dual", xl_engine="lu"), device="cpu")
    met = res.simplex.metrics
    total = 0.0
    for k in range(blocks):
        A, b, c = xl_block(k)
        ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, 10), method="highs")
        if ref.status != 0:
            raise AssertionError(f"HiGHS did not solve block {k}: {ref.message}")
        total += float(ref.fun)
    return dict(engine=met.engine, iterations=met.iterations,
                objective=res.solution.objective_value, wall=met.wall_s,
                blocks=float(np.float64(total)))


def _xl_solve(tag, general, name, config, smi):
    """One solve through ``api.solve(path)`` that the XL gate sends to the
    host LU dual: ``engine == "dual-lu"``, no kernel launched, and the peak of
    device memory no more than ``XL_PEAK_MIB`` above what was allocated."""
    import torch

    wrappers = _wrappers()
    before = {name_: w.launches for name_, w in wrappers.items()}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res, wall = _solve_file(general, name, config)
    rise = torch.cuda.max_memory_allocated() - base
    _check_optimal("xl", res, "csc")
    met = res.simplex.metrics
    launched = {k: w.launches - before[k] for k, w in wrappers.items()
                if w.launches != before[k]}
    if met.engine != "dual-lu" or launched or rise >= XL_PEAK_MIB << 20:
        raise AssertionError(f"[xl] {tag}: engine {met.engine!r}, kernels launched {launched}, "
                             f"peak device memory {rise / 2**20:.1f} MiB above the start")
    print(f"[xl] {tag}: m={met.m} n={met.n} nnz={met.nnz} (padded {met.m_padded}x"
          f"{met.n_padded}) engine {met.engine} host LU engine {met.lu_engine} matrix_format "
          f"{met.matrix_format} iterations {met.iterations} flips {met.bound_flips} solve_wall "
          f"{met.wall_s:.3f} s iters/s {met.iters_per_s:.1f} api_wall {wall:.3f} s; no kernel "
          f"launched, peak device memory {rise / 2**20:.2f} MiB above the start [{smi}]")
    return res


def phase_xl(smi, xl_refs):
    """The XL gate: a default-config (``algorithm="primal"``) solve above
    ``refactor_external_m`` answers on the host sparse-LU dual."""
    from relp_tpu_torch.utils.config import SolverConfig

    # 1. the slice's max flow under a gate lowered below its m_pad
    general, flow = slice_problem()
    res = _xl_solve(f"max-flow N={N_NODES}, refactor_external_m={XL_GATE}", general,
                    f"maxflow_{N_NODES}", SolverConfig(refactor_external_m=XL_GATE), smi)
    met = res.simplex.metrics
    ref = xl_refs.result()
    obj = res.solution.objective_value
    if met.m_padded <= XL_GATE or abs(obj - flow) > 1e-6 or ref["engine"] != "dual-lu" or \
            met.iterations != ref["iterations"]:
        raise AssertionError(f"[xl] max flow: m_pad {met.m_padded}, objective {obj!r} (scipy "
                             f"{flow!r}), iterations {met.iterations}; algorithm='dual', "
                             f"xl_engine='lu': {ref}")
    print(f"[xl] max-flow N={N_NODES}: objective {obj:.12g} == scipy {flow:.12g}; iterations "
          f"{met.iterations} == algorithm='dual', xl_engine='lu' (solved meanwhile on the "
          f"host's CPU in {ref['wall']:.3f} s)")

    # 2. above the default gate under the default config
    general = xl_blocks_lp()
    m, n = XL_BLOCK_SHAPE
    res = _xl_solve(f"{XL_BLOCKS} blocks of {m}x{n}, default config", general,
                    f"xl_blocks_{XL_BLOCKS}", None, smi)
    met = res.simplex.metrics
    obj, want = res.solution.objective_value, ref["blocks"]
    if met.m_padded <= SolverConfig().refactor_external_m or \
            abs(obj - want) > OBJ_REL * abs(want):
        raise AssertionError(f"[xl] blocks: m_pad {met.m_padded}, objective {obj!r}, HiGHS's "
                             f"sum {want!r}")
    print(f"[xl] blocks: objective {obj:.12g} == sum of HiGHS's block optima {want:.12g} "
          f"(rel {abs(obj - want) / abs(want):.2e})")


def phase_cli():
    from relp_tpu_torch import cli

    for flags, names in (((), ()),
                         (("--algorithm", "pdlp", "--pdlp-matrix", "bricks"),
                          ("brick_spmv", "brick_price"))):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "testprob.mps")
            Path(path).write_text(WIKI_MPS)
            buf = io.StringIO()
            with counted(names, {}, f"cli {' '.join(flags)}") if names else \
                    contextlib.nullcontext(), contextlib.redirect_stdout(buf):
                rc = cli.main([*flags, "-q", path])
        out = buf.getvalue().strip()
        if rc != 0 or out != "objective -8":
            raise AssertionError(f"[cli] {flags}: rc={rc} output {out!r}, expected "
                                 "'objective -8'")
        counts = PATHS.get(f"cli {' '.join(flags)}", {})
        print(f"[cli] python -m relp_tpu_torch {' '.join((*flags, '-q'))} testprob.mps -> {out}"
              + (f" (launches {counts})" if counts else ""))


def main() -> int:
    os.environ["RELP_TPU_TORCH_DEVICE"] = "cuda"
    sys.path.insert(0, str(ROOT))
    smi = phase_device()
    import torch

    count_graph_launches()
    launches = {}
    timings = {}
    # HiGHS takes its time over the dense LP on the host: a second process
    # solves it while the device phases run, and leaves once it has answered
    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    highs = pool.submit(_highs_objective, *DENSE_SHAPE)
    milp_ref = pool.submit(_milp_reference, (KNAPSACK_SMALL, KNAPSACK_WIDE))
    colgen_ref = pool.submit(_colgen_reference)
    highs_small = pool.submit(_highs_objective, *OPTIONS_SHAPE)
    pool.shutdown(wait=False)
    # the fleet's references: two of its 768 × 1536 lanes (~35 s each) and all
    # 64 lanes of the primal fleet, in two more processes
    fleet_pool = ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn"))
    fleet_refs = {
        "ipm": fleet_pool.submit(_fleet_highs, *DENSE_SHAPE, FLEET_LANES, (0, FLEET_LANES - 1)),
        "primal": fleet_pool.submit(_fleet_highs, *FLEET_PRIMAL_SHAPE, FLEET_LANES,
                                    range(FLEET_LANES), False),
    }
    fleet_pool.shutdown(wait=False)
    xl_pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    xl_refs = xl_pool.submit(_xl_references, N_NODES, XL_BLOCKS)
    xl_pool.shutdown(wait=False)
    for phase in (phase_build, lambda: phase_probe(launches),
                  lambda: timings.update(phase_kernels(smi)),
                  lambda: phase_slice(smi, launches),
                  lambda: phase_dense(smi, launches, highs),
                  lambda: phase_options(smi), lambda: phase_pdlp(smi, launches),
                  lambda: phase_bricks(smi, launches),
                  lambda: phase_dual(smi, launches, highs, milp_ref),
                  lambda: phase_analysis(smi), lambda: phase_colgen(smi, colgen_ref),
                  lambda: phase_ipm(smi, highs, highs_small),
                  lambda: phase_fleet(smi, launches, fleet_refs),
                  lambda: phase_mesh(smi, highs_small), lambda: phase_xl(smi, xl_refs),
                  phase_cli):
        t0 = time.perf_counter()
        phase()
        print(f"[time] {time.perf_counter() - t0:.1f} s", flush=True)
    if "jax" in sys.modules or "relp_tpu" in sys.modules:
        raise AssertionError("the smoke run imported JAX or the JAX package")
    if min(launches[name] for name in KERNELS) < 1 or \
            min(count + REPLAYED.get(path, {}).get(name, 0) for path, counts in PATHS.items()
                for name, count in counts.items()) < 1:
        raise AssertionError(f"a kernel was not launched on its path: {PATHS}")

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "replayed_launches": launches.get(f"{name} replayed", 0),
         **{k: timings[name][k] for k in keys}}
        for name, (source, replaces) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
