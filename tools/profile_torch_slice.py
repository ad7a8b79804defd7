#!/usr/bin/env python3
"""Where the time of relp_tpu_torch's iterations goes, on one NVIDIA GPU.

    python3 tools/profile_torch_slice.py [--problem maxflow|dense|pdlp|dual|ipm|xl|
                                                    fleet-primal|fleet-pdlp|fleet-ipm]
                                         [--nodes 4096] [--iters 600] [--out FILE]
                                         [--crossover] [--pdlp-matrix auto|bricks]
                                         [--mesh-cols K] [--lane-options NAME,...]
                                         [--xl-nodes N,...] [--xl-engines NAME,...] [--xl-dense]
                                         [--xl-lu-max-iter K]

Builds one of the two LPs that ``chip_smoke.py`` solves (the seeded max-flow
LP of ``--nodes`` nodes on the ELL operator, or the dense LP at 768 × 1536 on
the dense operator), lowers it on the
host (presolve, computational form), then runs the device solve for
``--iters`` iterations three times: a warm-up, a timed run, and a run under
``torch.profiler`` (CPU and CUDA activities).  Prints the wall time per
iteration, the device's busy share of the profiled wall (kernel time summed
over the run), kernel launches per iteration, and the heaviest operators by
device and by host time; ``--out`` receives the full profiler tables.  With
``--mesh-cols K`` the solve's column pool is split over K shards of the one
card (``devices=["cuda:0"] * K``, ``parallel/sharded.py``): what sharding
costs an iteration.

``--problem pdlp`` profiles the first-order engine's rounds instead: the
max-flow LP is scaled and sent to the device as the driver's ``_run_pdlp``
does it (on the operator ``--pdlp-matrix`` names: ``auto``, the ELL operator
there, or ``bricks``, the grouped brick operator in RCM order, its bricks
compacted to their nonzeros; the header gives the operator's set-up seconds
and peak device memory), and
``solve_pdhg_chunk`` runs ``--iters`` PDHG steps (whole rounds of 256) from
the initial state, for each restart scheme in f32 and in f64.  Per iteration
it prints launches, kernel time, wall, the device's busy share, and the
share of the operator's two kernels (``ell_price`` + ``ell_spmv``, or
``brick_price`` + ``brick_spmv``) in the kernel time.

``--problem ipm`` takes the interior point (``algorithm="ipm"``) through
``solve_computational_form`` on the dense LP at 768 × 1536 and on the
max-flow LP of ``--nodes`` nodes, under ``ipm_ladder="f64"`` and ``"mixed"``:
the wall of its parts on the host clock (the Ruiz scaling, ``solve_ipm``,
``_factor`` — the normal-equation product and its Cholesky — and, with
``--crossover``, the crossover and its host push, under the f64 ladder
only), then a profiled run without crossover: kernel time, launches and
host reads per interior-point iteration, the heaviest kernels, and the device
time under ``aten::mm`` (the GEMM, and the vector-matrix products ``v @ A``),
the Cholesky, its solves and ``aten::mv`` (the products ``A @ x``).

``--problem xl`` times the three engines the XL gate chooses between, one
after the other in one process, on the max flows of ``--xl-nodes`` nodes
(default 4,096, 8,192 and 16,384) and, with ``--xl-dense``, on the dense LP
at 768 × 1536: the device primal (``algorithm="primal"`` with
``refactor_external_m`` above every ``m_pad``, so no gate fires), the device
dual (``algorithm="dual", xl_engine="dense"``) and the host sparse-LU dual
(``algorithm="dual", xl_engine="lu"``), each through the driver's engine call
from a cold start (``_Padded.solve_core``, ``_run_dual``: no fall back to
another engine), its operator or factors built inside the timed wall.  Per
run: iterations, wall and iterations per second, the peak of device memory
above what was allocated before it, the LU's update engine, and the
objective against scipy's max flow.  ``--xl-engines`` picks the engines
(``primal,dual,lu``); ``--xl-lu-max-iter`` caps the host LU dual's iterations
(its iterations per second are then the reading).

``--problem fleet-{primal,pdlp,ipm}`` takes one of ``chip_smoke.py``'s
fleets through ``solve_general_forms_batched``: the lane-batched primal on
64 scenarios of the dense LP at 256 × 512 (warm from one base solve), the
first-order fleet on 16 perturbed max flows at N = 1,024 (``--nodes`` from
1,024 down), the interior-point fleet on bench.py's DENSE-768x1536 with 64
scenarios.  A warm-up, a run timed by parts on the host clock (synchronised:
the base solve and the lane loop; the scaling, the warm point, the PDHG
calls and the cleanup; the scaling, ``_factor`` and ``ipm_chunk``), then a
profiled run — of the lane loop alone for the primal fleet (the base solve
is a single solve, profiled by ``--problem dense``), of the whole call
otherwise: wall, batched iterations, kernel time, launches and host reads
per batched iteration, the busy share of the profiled wall, the heaviest
kernels and the lane kernels' share.  ``--iters`` caps the first-order
fleet's PDHG iterations (whole calls of 8 rounds of 256; the lanes left
go to HiGHS, which the parts show).  ``--lane-options`` profiles the primal
fleet once per named config, in one process: ``default``, ``eta``
(``inverse="eta"``), ``blocks`` (``price_blocks=2``), ``trace``
(``trace_iters``), ``check`` (``check_every_n=50``) and ``all`` (the four
together), each through the driver, whose base solve runs under it.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _device_attr(avg) -> str:
    """Name of the device-time field of a profiler average (it was renamed
    from ``cuda`` to ``device`` across PyTorch versions)."""
    return ("self_device_time_total" if hasattr(avg, "self_device_time_total")
            else "self_cuda_time_total")


def profile_pdlp(args, smi) -> list[str]:
    """The PDHG rounds of the max-flow LP, each scheme in f32 and f64."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from relp_tpu_torch.fom.pdhg import _power_norm, initial_state, solve_pdhg_chunk
    from relp_tpu_torch.model.computational_form import build_computational_form
    from relp_tpu_torch.presolve.engine import presolve
    from relp_tpu_torch.simplex import driver
    from relp_tpu_torch.utils.config import SolverConfig

    general, _ = chip_smoke.slice_problem(args.nodes)
    presolve(general)
    cf = build_computational_form(general, scale=True)
    config = SolverConfig(algorithm="pdlp", pdlp_matrix=args.pdlp_matrix)
    dev = torch.device("cuda")
    p = driver._Padded.of(cf, config, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    A64, vecs, _, _, _, fmt = driver._pdlp_operator(p, *driver._pdlp_scaling(p))
    torch.cuda.synchronize()
    setup_s, setup_mib = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**20
    vec64 = [torch.as_tensor(v, device=dev) for v in vecs]
    eta0 = 0.9 / float(_power_norm(A64))
    rounds = max(1, args.iters // config.pdlp_round)
    its = rounds * config.pdlp_round
    m_op, n_op = A64.shape
    lines = [f"[profile] PDHG rounds, max-flow N={args.nodes}: m={cf.m} n={cf.n} (operator "
             f"{m_op}x{n_op}) format {fmt}, scaled and built in {setup_s:.3f} s, peak "
             f"{setup_mib:.1f} MiB on the card; {rounds} rounds of {config.pdlp_round} steps "
             f"[{smi}]"]
    for dtype in (torch.float32, torch.float64):
        A = A64.astype(dtype)
        b, c, lb, ub = (v.to(dtype) for v in vec64)
        for variant in ("halpern", "avg"):
            def run():
                stats = {}
                state = initial_state(A, lb, ub, eta0, dtype=dtype)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                # tol = 0: no round ends the call early
                solve_pdhg_chunk(A, b, c, lb, ub, state, round_len=config.pdlp_round,
                                 max_rounds=rounds, tol=0.0, variant=variant, stats=stats,
                                 assume_running=True)
                torch.cuda.synchronize()
                return time.perf_counter() - t0, stats

            run()
            wall, stats = run()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                prof_wall, _ = run()
            avgs = prof.key_averages()
            attr = _device_attr(avgs[0])
            kernels = [a for a in avgs if a.device_type == DeviceType.CUDA]
            busy_us = sum(getattr(a, attr) for a in kernels)
            launches = sum(a.count for a in kernels)
            # per operator kernel: (launches, device us) summed over its instantiations
            names = (("brick_price_kernel", "brick_spmv_kernel") if fmt == "bricks" else
                     ("ell_price_kernel", "ell_spmv_kernel"))
            ell = {k: (sum(a.count for a in kernels if k in a.key),
                       sum(getattr(a, attr) for a in kernels if k in a.key))
                   for k in names}
            ell_us = sum(us for _, us in ell.values())
            tag = f"{variant} {'f32' if dtype == torch.float32 else 'f64'}"
            lines.append(
                f"[profile] pdlp {tag}: wall {wall / its * 1e6:.1f} us/iter unprofiled "
                f"({prof_wall / its * 1e6:.1f} profiled); "
                f"kernel launches {launches / its:.2f}/iter; "
                f"kernel time {busy_us / its:.2f} us/iter; device busy share "
                f"{busy_us / 1e6 / prof_wall:.4f}; the operator's two kernels {ell_us / its:.2f} us/iter "
                f"= {ell_us / max(busy_us, 1e-9):.3f} of kernel time ("
                + ", ".join(f"{k} {n / its:.3f} launches/iter {us / max(n, 1):.2f} us each"
                            for k, (n, us) in ell.items())
                + f"); host reads {stats['host_reads']} in {stats['rounds']} rounds")
            for a in sorted(kernels, key=lambda a: getattr(a, attr), reverse=True)[:8]:
                lines.append(f"[profile]   kernel {getattr(a, attr) / its:8.2f} us/iter "
                             f"{a.count / its:6.2f} launches/iter  {a.key[:90]}")
            if args.out:
                lines.append(avgs.table(sort_by="self_cpu_time_total", row_limit=25))
    return lines


DUAL_OPTIONS = (dict(dual_ratio="bisect"), dict(dual_ratio="sort"),
                dict(dual_ratio="sort", dual_pricing="devex"))


def _dual_problem(nodes: int, dev):
    """The max-flow LP padded, with the driver's dual start."""
    import chip_smoke
    from relp_tpu_torch.model.computational_form import build_computational_form
    from relp_tpu_torch.presolve.engine import presolve
    from relp_tpu_torch.simplex import driver
    from relp_tpu_torch.utils.config import SolverConfig

    general, _ = chip_smoke.slice_problem(nodes)
    presolve(general)
    cf = build_computational_form(general, scale=True)
    p = driver._Padded.of(cf, SolverConfig(algorithm="dual", matrix_format="ell"), dev)
    lb_d, ub_d, warm, _, _ = driver._dual_start(p)
    return p, lb_d, ub_d, warm


def count_dual_ops(args) -> list[str]:
    """Tensor operations per dual iteration, counted on the CPU."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from relp_tpu_torch.simplex.dual import solve_core_dual
    from relp_tpu_torch.utils.config import SolverConfig

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    p, lb_d, ub_d, warm = _dual_problem(args.nodes, torch.device("cpu"))
    lines = []
    for opts in DUAL_OPTIONS:
        Count.n = 0
        with Count():
            out = solve_core_dual(p.device_A(), p.b, p.c, lb_d, ub_d,
                                  cfg=SolverConfig(algorithm="dual", **opts),
                                  max_iter=args.iters, **warm)
        lines.append(f"[ops] dual {opts} on the CPU, max-flow N={args.nodes} (padded {p.m_pad}x"
                     f"{p.n_pad}): {int(out.it)} iterations, status {int(out.status)}, "
                     f"{Count.n / max(int(out.it), 1):.1f} tensor operations per iteration, "
                     f"host reads {out.host_reads}")
    return lines


def profile_dual(args, smi) -> list[str]:
    """The dual simplex's loop on the max-flow LP, under each ratio test."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from relp_tpu_torch.ops.sparse_kernels import ell_price, ell_spmv
    from relp_tpu_torch.simplex.dual import solve_core_dual
    from relp_tpu_torch.utils.config import SolverConfig

    p, lb_d, ub_d, warm = _dual_problem(args.nodes, torch.device("cuda"))
    cf = p.cf
    A = p.device_A()
    fmt = A.format
    lines = [f"[profile] dual simplex, max-flow N={args.nodes}: m={cf.m} n={cf.n} (padded "
             f"{p.m_pad}x{p.n_pad}) format {fmt}, first {args.iters} iterations [{smi}]"]
    for opts in DUAL_OPTIONS:
        cfg = SolverConfig(algorithm="dual", **opts)

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = solve_core_dual(A, p.b, p.c, lb_d, ub_d, cfg=cfg, max_iter=args.iters, **warm)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, out

        run()
        ell_price.launches = ell_spmv.launches = 0
        wall, out = run()
        counts = (ell_price.launches, ell_spmv.launches)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prof_wall, _ = run()
        avgs = prof.key_averages()
        attr = _device_attr(avgs[0])
        kernels = [a for a in avgs if a.device_type == DeviceType.CUDA]
        busy_us = sum(getattr(a, attr) for a in kernels)
        launches = sum(a.count for a in kernels)
        its = max(int(out.it), 1)
        lines.append(
            f"[profile] dual {opts}: iterations {its} status {int(out.status)} flips "
            f"{int(out.flips)}; wall {wall / its * 1e6:.1f} us/iter unprofiled "
            f"({prof_wall / its * 1e6:.1f} profiled); kernel launches {launches / its:.1f}/iter; "
            f"kernel time {busy_us / its:.1f} us/iter; device busy share "
            f"{busy_us / 1e6 / prof_wall:.4f}; host reads {out.host_reads} "
            f"({out.host_reads / its:.3f}/iter); ell_price {counts[0]} "
            f"({counts[0] / its:.3f}/iter) ell_spmv {counts[1]} ({counts[1] / its:.3f}/iter)")
        for a in sorted(kernels, key=lambda a: getattr(a, attr), reverse=True)[:8]:
            lines.append(f"[profile]   kernel {getattr(a, attr) / its:8.2f} us/iter "
                         f"{a.count / its:6.2f} launches/iter  {a.key[:90]}")
        if args.out:
            lines.append(avgs.table(sort_by="self_cpu_time_total", row_limit=25))
    return lines


def _device_total(avg) -> float:
    """Device time of a profiler average, its children's kernels included."""
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(avg, name):
            return getattr(avg, name)
    return 0.0


IPM_PARTS = (("driver", "_ruiz"), ("primal_dual", "solve_ipm"), ("primal_dual", "_factor"),
             ("driver", "_crossover"), ("lu_host", "primal_push"))
IPM_OPS = ("aten::mm", "aten::linalg_cholesky_ex", "aten::cholesky_solve", "aten::mv")


def profile_ipm(args, smi) -> list[str]:
    """The interior point on the dense LP and the max flow, both ladders."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from relp_tpu_torch.model.computational_form import build_computational_form
    from relp_tpu_torch.models.dense import dense_lp
    from relp_tpu_torch.presolve.engine import presolve
    from relp_tpu_torch.simplex import driver, lu_host, primal_dual
    from relp_tpu_torch.simplex.driver import solve_computational_form
    from relp_tpu_torch.utils.config import SolverConfig

    modules = {"driver": driver, "primal_dual": primal_dual, "lu_host": lu_host}
    spent: dict[str, list] = {}

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                entry = spent.setdefault(name, [0.0, 0])
                entry[0] += time.perf_counter() - t0
                entry[1] += 1
        return wrapper

    m, n = chip_smoke.DENSE_SHAPE
    problems = ((dense_lp(m, n), f"dense LP {m}x{n}"),
                (chip_smoke.slice_problem(args.nodes)[0], f"max-flow N={args.nodes}"))
    lines = []
    for general, name in problems:
        presolve(general)
        cf = build_computational_form(general, scale=True)
        for ladder in ("f64",) if args.crossover else ("f64", "mixed"):
            cfg = SolverConfig(algorithm="ipm", ipm_ladder=ladder, pdlp_crossover=False)

            def run(config):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = solve_computational_form(cf, config, device="cuda")
                torch.cuda.synchronize()
                return time.perf_counter() - t0, res

            run(cfg)  # warm-up: library handles, allocator
            wall, res = run(cfg)
            met = res.metrics
            its = max(met.fo_iterations, 1)
            originals = {(mod, fn): getattr(modules[mod], fn) for mod, fn in IPM_PARTS}
            spent.clear()
            for (mod, fn), orig in originals.items():
                setattr(modules[mod], fn, timed(fn, orig))
            try:
                parts_wall, parts = run(dataclasses.replace(cfg, pdlp_crossover=args.crossover))
            finally:
                for (mod, fn), orig in originals.items():
                    setattr(modules[mod], fn, orig)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                prof_wall, _ = run(cfg)
            avgs = prof.key_averages()
            attr = _device_attr(avgs[0])
            kernels = [a for a in avgs if a.device_type == DeviceType.CUDA]
            busy_us = sum(getattr(a, attr) for a in kernels)
            launches = sum(a.count for a in kernels)
            ops = {op: sum(_device_total(a) for a in avgs if a.key == op) for op in IPM_OPS}
            lines.append(
                f"[profile] ipm {name} {ladder} (m={met.m} n={met.n}, padded {met.m_padded}x"
                f"{met.n_padded}): {met.fo_iterations} iterations, ladder run {met.ipm_ladder}, "
                f"KKT {met.fo_kkt:.2e}, objective {res.objective:.15g}; solve wall {wall:.3f} s "
                f"unprofiled = {wall / its * 1e3:.2f} ms/iter; host reads {met.host_reads} "
                f"[{smi}]")
            lines.append(
                f"[profile]   parts (host clock, synchronised; run of {parts_wall:.3f} s"
                f"{', crossover ' + parts.metrics.engine if args.crossover else ''}): "
                + "; ".join(f"{k} {v[0]:.3f} s in {v[1]} calls" for k, v in spent.items()))
            lines.append(
                f"[profile]   profiled {prof_wall:.3f} s: kernel time {busy_us / 1e3:.2f} ms = "
                f"{busy_us / its / 1e3:.3f} ms/iter, busy share {busy_us / 1e6 / prof_wall:.4f}, "
                f"launches {launches / its:.1f}/iter; device ms by op: "
                + ", ".join(f"{k} {v / 1e3:.2f}" for k, v in ops.items())
                + f"; aten::mm (the GEMM, and the vector-matrix products with A) + Cholesky "
                f"{(ops['aten::mm'] + ops['aten::linalg_cholesky_ex']) / max(busy_us, 1e-9):.3f}"
                " of kernel time")
            for a in sorted(kernels, key=lambda a: getattr(a, attr), reverse=True)[:6]:
                lines.append(f"[profile]   kernel {getattr(a, attr) / its / 1e3:8.3f} ms/iter "
                             f"{a.count / its:6.2f} launches/iter  {a.key[:90]}")
            if args.out:
                lines.append(avgs.table(sort_by="self_cpu_time_total", row_limit=25))
    return lines


FLEET_PARTS = {
    "fleet-primal": (("driver", "solve_computational_form"), ("batched", "solve_core_lanes")),
    "fleet-pdlp": (("driver", "_fleet_ruiz"), ("driver", "_fleet_highs"),
                   ("pdhg", "solve_pdhg_chunk"), ("driver", "_fleet_cleanup")),
    "fleet-ipm": (("driver", "_fleet_ruiz"), ("primal_dual", "ls_start"),
                  ("primal_dual", "_factor"), ("primal_dual", "ipm_chunk"),
                  ("driver", "_fleet_cleanup")),
}


LANE_OPTIONS = {"default": {}, "eta": dict(inverse="eta"), "blocks": dict(price_blocks=2),
                "trace": dict(trace_iters=True), "check": dict(check_every_n=50),
                "all": dict(inverse="eta", price_blocks=2, trace_iters=True, check_every_n=50)}


def profile_fleet(args, smi) -> list[str]:
    """One of chip_smoke.py's fleets through solve_general_forms_batched
    (the primal fleet once per ``--lane-options`` config)."""
    names = args.lane_options.split(",") if args.lane_options else ["default"]
    if args.problem != "fleet-primal" and names != ["default"]:
        raise SystemExit("--lane-options takes --problem fleet-primal")
    lines = []
    for name in names:
        lines += _profile_fleet(args, smi, name, LANE_OPTIONS[name])
    return lines


def _profile_fleet(args, smi, option_name, options) -> list[str]:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from relp_tpu_torch.fom import pdhg
    from relp_tpu_torch.ops import dense_kernels
    from relp_tpu_torch.parallel import batched
    from relp_tpu_torch.simplex import driver, primal_dual
    from relp_tpu_torch.utils.config import SolverConfig

    modules = {"driver": driver, "batched": batched, "pdhg": pdhg, "primal_dual": primal_dual}
    lanes, select = dense_kernels.dense_price_lanes, dense_kernels.dense_price_select_lanes
    lanes.launches = select.launches = select.window_launches = 0
    kind = args.problem.split("-", 1)[1]
    if kind == "primal":
        m, n = cs.FLEET_PRIMAL_SHAPE
        make = lambda: cs._fleet_generals(m, n, cs.FLEET_LANES, demand=False)  # noqa: E731
        name = f"{m}x{n} (costs moved), {option_name} config"
        config = SolverConfig(presolve=False, **options)
    elif kind == "pdlp":
        cs.FLEET_FLOW_NODES = min(args.nodes, cs.FLEET_FLOW_NODES)
        make, name = (lambda: cs._flow_fleet()[0]), f"max-flow N={cs.FLEET_FLOW_NODES}"
        config = SolverConfig(algorithm="pdlp", presolve=False, max_iter=args.iters)
    else:
        m, n = cs.DENSE_SHAPE
        make, name = (lambda: cs._fleet_generals(m, n, cs.FLEET_LANES)), f"DENSE-{m}x{n}"
        config = SolverConfig(algorithm="ipm", presolve=False)
    spent: dict[str, list] = {}

    def timed(label, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                entry = spent.setdefault(label, [0.0, 0])
                entry[0] += time.perf_counter() - t0
                entry[1] += 1
        return wrapper

    def run():
        generals = make()
        stats = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        driver.solve_general_forms_batched(generals, config, device="cuda", stats=stats)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, stats[0]

    run()  # warm-up: kernel build, library handles, allocator
    torch.cuda.reset_peak_memory_stats()
    wall, info = run()
    peak = torch.cuda.max_memory_allocated()
    its = max(info["iterations"], 1)
    originals = {(mod, fn): getattr(modules[mod], fn) for mod, fn in FLEET_PARTS[args.problem]}
    for (mod, fn), orig in originals.items():
        setattr(modules[mod], fn, timed(fn, orig))
    try:
        parts_wall, _ = run()
    finally:
        for (mod, fn), orig in originals.items():
            setattr(modules[mod], fn, orig)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    if kind == "primal":
        # the lane loop alone, under the profiler
        lanes_fn = batched.solve_core_lanes

        def profiled(*a, **k):
            with prof:
                t0 = time.perf_counter()
                out = lanes_fn(*a, **k)
                torch.cuda.synchronize()
            spent["profiled lane loop"] = [time.perf_counter() - t0, 1]
            return out

        batched.solve_core_lanes = profiled
        try:
            run()
        finally:
            batched.solve_core_lanes = lanes_fn
        prof_wall = spent["profiled lane loop"][0]
    else:
        with prof:
            prof_wall, _ = run()
    avgs = prof.key_averages()
    attr = _device_attr(avgs[0])
    kernels = [a for a in avgs if a.device_type == DeviceType.CUDA]
    busy_us = sum(getattr(a, attr) for a in kernels)
    launches = sum(a.count for a in kernels)
    lane_us = sum(getattr(a, attr) for a in kernels
                  if "dense_price_kernel" in a.key or "dense_price_group_kernel" in a.key)
    lines = [
        f"[profile] fleet {kind} {name}: {info['lanes']} lanes of {info['shape'][0]}x"
        f"{info['shape'][1]}, engine {info['engine']}, {info['iterations']} batched "
        f"iterations, host reads {info['host_reads']} ({info['host_reads'] / its:.3f}/iter); "
        f"wall {wall:.3f} s unprofiled ({info['lanes'] / wall:.2f} LPs/s; engine group "
        f"{info['wall_s']:.3f} s = {info['wall_s'] / its * 1e3:.3f} ms/iter); peak memory "
        f"{peak / 2**20:.0f} MiB; {info} [{smi}]",
        f"[profile]   parts (host clock, synchronised; run of {parts_wall:.3f} s): "
        + "; ".join(f"{k} {v[0]:.3f} s in {v[1]} calls" for k, v in spent.items()),
        f"[profile]   profiled {prof_wall:.3f} s: kernel time {busy_us / 1e3:.2f} ms = "
        f"{busy_us / its:.1f} us/iter, busy share {busy_us / 1e6 / prof_wall:.4f}, launches "
        f"{launches / its:.1f}/iter; dense_price_kernel and dense_price_group_kernel (the lane "
        "kernels) "
        f"{lane_us / its:.1f} us/iter, {lane_us / max(busy_us, 1e-9):.3f} of kernel time; "
        f"dense_price_lanes {lanes.launches}, dense_price_select_lanes {select.launches} "
        f"({select.window_launches} on a partial-pricing window) launches over the four runs",
    ]
    for a in sorted(kernels, key=lambda a: getattr(a, attr), reverse=True)[:8]:
        lines.append(f"[profile]   kernel {getattr(a, attr) / its:9.2f} us/iter "
                     f"{a.count / its:7.2f} launches/iter  {a.key[:90]}")
    if args.out:
        lines.append(avgs.table(sort_by=attr, row_limit=40))
        lines.append(avgs.table(sort_by="self_cpu_time_total", row_limit=40))
    return lines


XL_ENGINES = {  # engine -> the config that sends a cold solve to it, ungated
    "primal": dict(refactor_external_m=1 << 30),
    "dual": dict(algorithm="dual", xl_engine="dense", refactor_external_m=1 << 30),
    "lu": dict(algorithm="dual", xl_engine="lu"),
}


def profile_xl(args, smi) -> list[str]:
    import numpy as np
    import torch

    import chip_smoke
    from relp_tpu_torch.model.computational_form import build_computational_form
    from relp_tpu_torch.models.dense import dense_lp
    from relp_tpu_torch.presolve.engine import presolve
    from relp_tpu_torch.simplex import driver
    from relp_tpu_torch.simplex import status as st
    from relp_tpu_torch.utils.config import SolverConfig

    problems = [(f"max-flow N={n}", lambda n=n: chip_smoke.slice_problem(n))
                for n in (int(v) for v in args.xl_nodes.split(","))]
    if args.xl_dense:
        m, n = chip_smoke.DENSE_SHAPE
        problems.append((f"dense LP {m}x{n}", lambda: (dense_lp(m, n), None)))
    dev = torch.device("cuda")
    # warm-up, untimed: the kernels' build, the libraries' handles, the allocator
    for engine in XL_ENGINES:
        driver.solve_general_form(chip_smoke.slice_problem(256)[0],
                                  SolverConfig(**XL_ENGINES[engine]), device=dev)
    lines = []
    for name, make in problems:
        general, want = make()
        presolve(general)
        cf = build_computational_form(general, scale=True)
        for engine in args.xl_engines.split(","):
            cap = args.xl_lu_max_iter if engine == "lu" else 0
            config = SolverConfig(max_iter=cap, **XL_ENGINES[engine])
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            p = driver._Padded.of(cf, config, dev)
            fo = {}
            if engine == "primal":
                vstat = driver._cold_vstat(p.lb, p.ub).astype(np.int64)
                warm = dict(basis0=p.n_pad + np.arange(p.m_pad), vstat0=vstat,
                            art_sign0=p.host_art_sign(vstat), phase0=1)
                out = p.solve_core(p.lb, p.ub, warm, p.max_iter)
                certified = int(out.status) == st.OPTIMAL
            else:
                out = driver._run_dual(p, fo)
                certified = out is not None
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            obj = cf.objective_of(driver._host(out.x)[: cf.n]) if certified else float("nan")
            ref = f" (scipy {want:.12g})" if want is not None else ""
            capped = f", capped at {cap}" if cap else ""
            lines.append(
                f"[profile] xl {name} engine {engine}: m_pad {p.m_pad} n_pad {p.n_pad} "
                f"iterations {p.iterations}{capped} certified {certified} wall {wall:.3f} s "
                f"({p.iterations / wall:.1f} it/s) peak device memory {peak / 2**20:.1f} MiB "
                f"objective {obj:.12g}{ref} lu_engine {fo.get('lu_engine', '-')} [{smi}]")
            print(lines[-1], flush=True)
            del p, out
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--problem", choices=("maxflow", "dense", "pdlp", "dual", "ipm", "xl",
                                          *FLEET_PARTS), default="maxflow")
    ap.add_argument("--nodes", type=int, default=4096, help="size of the max-flow graph")
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--out", help="file for the full profiler tables")
    ap.add_argument("--pdlp-matrix", choices=("auto", "bricks"), default="auto",
                    help="with --problem pdlp: the first-order operator (SolverConfig.pdlp_matrix)")
    ap.add_argument("--crossover", action="store_true",
                    help="with --problem ipm: time the crossover too (f64 ladder only)")
    ap.add_argument("--mesh-cols", type=int, default=1,
                    help="with --problem maxflow|dense: shards of the column pool, all on cuda:0")
    ap.add_argument("--lane-options", default="",
                    help="with --problem fleet-primal: configs to profile in turn, comma-separated "
                         f"({', '.join(LANE_OPTIONS)})")
    ap.add_argument("--xl-nodes", default="4096,8192,16384",
                    help="with --problem xl: the max flows' node counts, comma-separated")
    ap.add_argument("--xl-engines", default="primal,dual,lu",
                    help="with --problem xl: the engines to time in turn (primal, dual, lu)")
    ap.add_argument("--xl-dense", action="store_true",
                    help="with --problem xl: the dense LP at 768 x 1536 too")
    ap.add_argument("--xl-lu-max-iter", type=int, default=0,
                    help="with --problem xl: cap the host LU dual's iterations (0: none)")
    ap.add_argument("--count-ops", action="store_true",
                    help="with --problem dual: count tensor operations on the CPU instead")
    args = ap.parse_args(argv)
    if args.count_ops:
        sys.path.insert(0, str(ROOT))
        print("\n".join(count_dual_ops(args)))
        return 0

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_slice: needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from relp_tpu_torch.model.computational_form import build_computational_form
    from relp_tpu_torch.presolve.engine import presolve
    from relp_tpu_torch.simplex.driver import solve_computational_form
    from relp_tpu_torch.utils.config import SolverConfig

    smi = chip_smoke.phase_device()
    if args.problem in ("pdlp", "dual", "ipm", "xl", *FLEET_PARTS):
        profilers = {"pdlp": profile_pdlp, "dual": profile_dual, "ipm": profile_ipm,
                     "xl": profile_xl}
        lines = profilers.get(args.problem, profile_fleet)(args, smi)
        if args.problem != "xl":  # profile_xl prints each line as it is read
            print("\n".join(line for line in lines if line.startswith("[profile]")))
        if args.out:
            out = Path(args.out)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text("\n".join(lines) + "\n")
            print(f"[profile] tables written to {out}")
        return 0
    if args.problem == "maxflow":
        general, _ = chip_smoke.slice_problem(args.nodes)
        name = f"max-flow N={args.nodes}"
    else:
        from relp_tpu_torch.models.dense import dense_lp

        m, n = chip_smoke.DENSE_SHAPE
        general, name = dense_lp(m, n), f"dense LP {m}x{n}"
    presolve(general)
    cf = build_computational_form(general, scale=True)
    config = SolverConfig(max_iter=args.iters, mesh_cols=args.mesh_cols)
    shards = ["cuda:0"] * max(args.mesh_cols, 1)

    def run():
        res = solve_computational_form(cf, config, device="cuda", devices=shards)
        torch.cuda.synchronize()
        return res

    run()  # warm-up: kernel build, library handles, allocator
    t0 = time.perf_counter()
    res = run()
    wall = time.perf_counter() - t0
    met = res.metrics
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        prof_wall = time.perf_counter() - t0

    avgs = prof.key_averages()
    attr = _device_attr(avgs[0]) if len(avgs) else "self_device_time_total"
    kernels = [a for a in avgs if a.device_type == DeviceType.CUDA]
    busy_us = sum(getattr(a, attr) for a in kernels)
    launches = sum(a.count for a in kernels)
    it = max(met.iterations, 1)
    lines = [
        f"[profile] {name} mesh_cols={args.mesh_cols}: m={met.m} n={met.n} "
        f"(padded {met.m_padded}x{met.n_padded}) format {met.matrix_format} "
        f"iterations {met.iterations} status {met.status} [{smi}]",
        f"[profile] unprofiled: wall {wall:.3f} s = {wall / it * 1e3:.3f} ms/iter; "
        f"host_reads {met.host_reads} ({met.host_reads / it:.3f}/iter)",
        f"[profile] profiled: wall {prof_wall:.3f} s; kernel time {busy_us / 1e6:.3f} s "
        f"= {busy_us / it:.1f} us/iter; device busy share "
        f"{busy_us / 1e6 / prof_wall:.4f}; kernel launches {launches} "
        f"({launches / it:.1f}/iter)",
    ]
    top = sorted(kernels, key=lambda a: getattr(a, attr), reverse=True)[:12]
    for a in top:
        lines.append(f"[profile] kernel {getattr(a, attr) / it:9.2f} us/iter "
                     f"{a.count / it:6.2f} launches/iter  {a.key[:90]}")
    print("\n".join(lines))
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text("\n".join(lines) + "\n\n"
                       + avgs.table(sort_by=attr, row_limit=60) + "\n\n"
                       + avgs.table(sort_by="self_cpu_time_total", row_limit=60) + "\n")
        print(f"[profile] tables written to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
