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
             partial-pricing window) and ``ell_spmv`` at the max-flow
             operator's shapes and on a K = 8 pool; ``dense_price`` (with
             and without ``c``) at the dense LP's operator, on a window of
             it and at a wide 2,048 × 16,384; ``probe_scale`` at [8, 128].
             Device time per launch (CUDA events over batches of 50
             launches) and the time per call as the host issues it.
5. slice   — a seeded 4,096-node max-flow LP (32,768 arcs) written to MPS
             and solved through ``relp_tpu_torch.api.solve(path)`` on the
             ELL operator; the objective must equal ``scipy``'s max-flow
             value and both ELL kernels must have been launched by the solve.
6. dense   — the dense resource-allocation LP at 768 × 1536 written to MPS
             and solved through ``api.solve(path)``; the operator must be
             dense, the objective must equal HiGHS's (scipy ``linprog``)
             within 1e-9 relative, and ``dense_price`` must have been
             launched at least once per iteration.
7. options — each primal option on the card (the eta inverse, partial
             pricing, perturbation, the trace, the invariant check) on the
             dense LP at 256 × 512, against the default config's objective;
             partial pricing also on the ELL max flow at N = 1,024.
8. cli     — ``relp_tpu_torch.cli.main(["-q", file])`` on a small MPS file.

Launch counts: every kernel's count is set to 0 just before the path that
runs it (probe, slice, dense) and read just after; launches made to compare
a kernel with its plain version do not count.  Any failure raises, so the
run exits nonzero without the final line.  The line before the last is the
kernel report, one JSON object; the last line is ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_NODES = 4096          # max-flow graph size of the slice
SEED = 7
DENSE_SHAPE = (768, 1536)   # the dense LP's documented default size
OPTIONS_SHAPE = (256, 512)  # smallest dense size at which mixed pricing stays on
OPTIONS_NODES = 1024
TIMED_RUNS = 50
HOLD_CYCLES = 100_000_000  # ~50 ms of a sleep kernel at the H100's clock
F32_TOL = 2e-5          # f32 sums run in another order (and fused) than the plain version
F64_TOL = 1e-12
OBJ_REL = 1e-9

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
    "ell_spmv": ("relp_tpu_torch/csrc/sparse_kernels.cu", "relp_tpu/ops/pallas_kernels.py:64"),
    "dense_price": ("relp_tpu_torch/csrc/dense_kernels.cu", "tools/probe_pallas.py:50"),
    "probe_scale_f32": ("relp_tpu_torch/csrc/probe_kernels.cu", "tools/probe_pallas.py:24"),
    "probe_scale_f64": ("relp_tpu_torch/csrc/probe_kernels.cu", "tools/probe_pallas.py:37"),
}


def _wrappers():
    """Every kernel wrapper by name (each carries its ``launches`` count)."""
    from relp_tpu_torch.ops.dense_kernels import dense_price
    from relp_tpu_torch.ops.probe_kernels import probe_scale_f32, probe_scale_f64
    from relp_tpu_torch.ops.sparse_kernels import ell_price, ell_spmv

    return {"ell_price": ell_price, "ell_spmv": ell_spmv, "dense_price": dense_price,
            "probe_scale_f32": probe_scale_f32, "probe_scale_f64": probe_scale_f64}


@contextlib.contextmanager
def counted(names, launches):
    """Set the named kernels' counts to 0, run the path, record the counts."""
    wrappers = _wrappers()
    for name in names:
        wrappers[name].launches = 0
    yield
    for name in names:
        launches[name] = wrappers[name].launches


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
    with counted(("probe_scale_f32", "probe_scale_f64"), launches), \
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


def _compare(label, kernel_fn, plain_fn, tol, smi):
    """Launch, synchronise, compare with the plain version, then time both."""
    import torch

    got = kernel_fn()
    torch.cuda.synchronize()
    want = plain_fn()
    torch.cuda.synchronize()
    err = (got - want).abs()
    bound = tol + tol * want.abs()
    if not bool(torch.isfinite(got).all()) or bool((err > bound).any()):
        raise AssertionError(f"[kernels] {label}: max abs err {float(err.max()):.3e} "
                             f"exceeds {tol:g} (rel/abs)")
    ms, plain_ms = _device_ms(kernel_fn), _device_ms(plain_fn)
    host_ms, plain_host_ms = _host_ms(kernel_fn), _host_ms(plain_fn)
    print(f"[kernels] {label}: max_abs_err {float(err.max()):.3e} "
          f"(bound {tol:g}·(1 + |plain|)) "
          f"device kernel {ms * 1e3:.2f} us plain {plain_ms * 1e3:.2f} us; "
          f"per call from the host kernel {host_ms * 1e3:.1f} us plain "
          f"{plain_host_ms * 1e3:.1f} us [{smi}]")
    return float(err.max()), ms, plain_ms


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
    from relp_tpu_torch.simplex.driver import _device_matrix, _round_up
    from relp_tpu_torch.utils.config import DEFAULT_CONFIG

    presolve(general)
    cf = build_computational_form(general, scale=True)
    m_pad, n_pad = _round_up(cf.m, 8), _round_up(cf.n, 128)
    op, fmt = _device_matrix(cf, m_pad, n_pad, DEFAULT_CONFIG, dev)
    if fmt != expect:
        raise AssertionError(f"[kernels] operator is {fmt}, expected {expect}")
    return op


def _kernels_ell(smi, dev, rng):
    import torch

    from relp_tpu_torch.ops.sparse_kernels import (
        ell_price, ell_price_plain, ell_spmv, ell_spmv_plain,
    )

    op = _operator(slice_problem()[0], dev, "ell")
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
    report = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        tag = "f32" if dtype == torch.float32 else "f64"
        yd, cd, xd = y.to(dtype), c.to(dtype), x.to(dtype)
        for pool, (data_t, rows_t) in pools.items():
            dd = data_t.to(dtype).contiguous()
            report[("ell_price", tag, "c", pool)] = _compare(
                f"ell_price {tag} c-d {pool}",
                lambda: ell_price(dd, rows_t, yd, cd),
                lambda: ell_price_plain(dd, rows_t, yd, cd), tol, smi)
            report[("ell_price", tag, "sum", pool)] = _compare(
                f"ell_price {tag} sum {pool}",
                lambda: ell_price(dd, rows_t, yd),
                lambda: ell_price_plain(dd, rows_t, yd), tol, smi)
        # partial pricing's window: one block of four, c of the block
        dd = op.data_t.to(dtype).contiguous()
        w = n_pad // 4
        cw = cd[w:2 * w]
        _compare(f"ell_price {tag} c-d window [{w}, {2 * w}) of the slice pool",
                 lambda: ell_price(dd, op.rows_t, yd, cw, w, w),
                 lambda: ell_price_plain(dd, op.rows_t, yd, cw, w, w), tol, smi)
        rd = op.rdata_t.to(dtype).contiguous()
        label = f"K={op.rdata_t.shape[0]} m={m_pad} n={n_pad}"
        report[("ell_spmv", tag, "slice")] = _compare(
            f"ell_spmv {tag} slice {label}",
            lambda: ell_spmv(rd, op.rcols_t, xd),
            lambda: ell_spmv_plain(rd, op.rcols_t, xd), tol, smi)
    slice_pool = next(iter(pools))
    # the per-iteration hot launches of the slice: f32 fused pricing, f64 A·x
    return {
        "ell_price": report[("ell_price", "f32", "c", slice_pool)],
        "ell_spmv": report[("ell_spmv", "f64", "slice")],
    }


def _kernels_dense(smi, dev, rng):
    """``dense_price`` at the dense LP's operator, on a partial-pricing
    window of it and at a wide shape.  Nonnegative inputs, as the LP's are,
    keep the f32 sums' error relative to their size."""
    import torch

    from relp_tpu_torch.models.dense import dense_lp
    from relp_tpu_torch.ops.dense_kernels import dense_price, dense_price_plain

    op = _operator(dense_lp(*DENSE_SHAPE), dev, "dense")
    m_pad, n_pad = op.shape
    wide = torch.as_tensor(rng.uniform(0.05, 1.0, (2048, 16384)), device=dev)
    cases = {  # label -> (A, j0, w)
        f"dense LP operator m={m_pad} n={n_pad}": (op.A, 0, n_pad),
        f"window [{n_pad // 4}, {n_pad // 2}) of the dense LP operator":
            (op.A, n_pad // 4, n_pad // 4),
        "wide m=2048 n=16384": (wide, 0, 16384),
    }
    report = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        tag = "f32" if dtype == torch.float32 else "f64"
        for label, (A, j0, w) in cases.items():
            Ad = A.to(dtype).contiguous()
            v = torch.as_tensor(rng.uniform(0.0, 1.0, Ad.shape[0]), dtype=dtype, device=dev)
            c = torch.as_tensor(rng.uniform(0.0, 1.0, w), dtype=dtype, device=dev)
            report[(tag, "c", label)] = _compare(
                f"dense_price {tag} c-d {label}",
                lambda: dense_price(Ad, v, c, j0, w),
                lambda: dense_price_plain(Ad, v, c, j0, w), tol, smi)
            report[(tag, "sum", label)] = _compare(
                f"dense_price {tag} sum {label}",
                lambda: dense_price(Ad, v, None, j0, w),
                lambda: dense_price_plain(Ad, v, None, j0, w), tol, smi)
    # the dense path's hot launch: the f32 scan over the whole operator
    return {"dense_price": report[("f32", "c", next(iter(cases)))]}


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
                                lambda: probe_scale_plain(x), 0.0, smi)
    return report


def phase_kernels(smi):
    """Every kernel against its plain version on the card."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    timings = _kernels_ell(smi, dev, rng)
    timings.update(_kernels_dense(smi, dev, rng))
    timings.update(_kernels_probe(smi, dev))
    torch.cuda.empty_cache()
    return timings


def _solve_file(general, name, config=None):
    """Write ``general`` to MPS and solve it through ``api.solve(path)``;
    returns the result and the api wall (synchronised)."""
    import torch

    from relp_tpu_torch import api
    from relp_tpu_torch.io.mps_write import export_mps
    from relp_tpu_torch.utils.config import DEFAULT_CONFIG

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"{name}.mps")
        export_mps(general, path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = api.solve(path, DEFAULT_CONFIG if config is None else config)
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
    with counted(("ell_price", "ell_spmv"), launches):
        res, wall = _solve_file(general, f"maxflow_{N_NODES}")
    obj = _check_optimal("slice", res, "ell")
    met = res.simplex.metrics
    if abs(obj - flow) > 1e-6:
        raise AssertionError(f"[slice] objective {obj!r} != max-flow value {flow!r}")
    if min(launches["ell_price"], launches["ell_spmv"]) < 1 or \
            launches["ell_price"] < met.iterations:
        raise AssertionError(f"[slice] launches {launches} for {met.iterations} iterations")
    print(f"[slice] max-flow N={N_NODES} seed={SEED}: m={met.m} n={met.n} nnz={met.nnz} "
          f"(padded {met.m_padded}x{met.n_padded}) objective {obj:.12g} == scipy {flow:.12g}")
    _report_solve("slice", res, wall, smi)
    print(f"[slice] launches ell_price {launches['ell_price']} ell_spmv {launches['ell_spmv']}")


def _highs_objective(m, n):
    from scipy.optimize import linprog

    from relp_tpu_torch.models.dense import dense_lp_data

    A, b, c = dense_lp_data(m, n)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, 2), method="highs")
    if ref.status != 0:
        raise AssertionError(f"HiGHS did not solve the dense LP: {ref.message}")
    return float(ref.fun)


def phase_dense(smi, launches):
    import torch

    from relp_tpu_torch.models.dense import dense_lp

    m, n = DENSE_SHAPE
    highs = _highs_objective(m, n)
    torch.cuda.reset_peak_memory_stats()
    with counted(("dense_price",), launches):
        res, wall = _solve_file(dense_lp(m, n), f"dense_{m}x{n}")
    obj = _check_optimal("dense", res, "dense")
    met = res.simplex.metrics
    if abs(obj - highs) > OBJ_REL * abs(highs):
        raise AssertionError(f"[dense] objective {obj!r} != HiGHS {highs!r}")
    if launches["dense_price"] < met.iterations:
        raise AssertionError(f"[dense] dense_price launched {launches['dense_price']} "
                             f"times in {met.iterations} iterations")
    print(f"[dense] dense LP {m}x{n}: m={met.m} n={met.n} (padded "
          f"{met.m_padded}x{met.n_padded}) objective {obj:.15g} HiGHS {highs:.15g} "
          f"rel {abs(obj - highs) / abs(highs):.2e}")
    _report_solve("dense", res, wall, smi)
    print(f"[dense] launches dense_price {launches['dense_price']} "
          f"({launches['dense_price'] / max(met.iterations, 1):.3f}/iter)")


def phase_options(smi):
    """Each ported option solved on the card against the default config."""
    from relp_tpu_torch.models.dense import dense_lp
    from relp_tpu_torch.ops.sparse_kernels import ell_price
    from relp_tpu_torch.utils.config import SolverConfig

    m, n = OPTIONS_SHAPE
    base, wall = _solve_file(dense_lp(m, n), f"dense_{m}x{n}")
    ref = _check_optimal("options", base, "dense")
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


def phase_cli():
    from relp_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "testprob.mps")
        Path(path).write_text(WIKI_MPS)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["-q", path])
    out = buf.getvalue().strip()
    if rc != 0 or out != "objective -8":
        raise AssertionError(f"[cli] rc={rc} output {out!r}, expected 'objective -8'")
    print(f"[cli] python -m relp_tpu_torch -q testprob.mps -> {out}")


def main() -> int:
    os.environ["RELP_TPU_TORCH_DEVICE"] = "cuda"
    sys.path.insert(0, str(ROOT))
    smi = phase_device()
    import torch

    launches = {}
    phase_build()
    phase_probe(launches)
    timings = phase_kernels(smi)
    phase_slice(smi, launches)
    phase_dense(smi, launches)
    phase_options(smi)
    phase_cli()
    if "jax" in sys.modules or "relp_tpu" in sys.modules:
        raise AssertionError("the smoke run imported JAX or the JAX package")
    if min(launches[name] for name in KERNELS) < 1:
        raise AssertionError(f"a kernel was not launched on its path: {launches}")

    kernels = [
        {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": timings[name][0],
            "ms": timings[name][1], "plain_ms": timings[name][2],
        }
        for name, (source, replaces) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
