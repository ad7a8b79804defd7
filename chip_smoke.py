#!/usr/bin/env python3
"""Smoke run of relp_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printing its own lines:

1. device  — requires a CUDA device; prints ``nvidia-smi``'s name and power
             limit of the card.
2. build   — builds the CUDA kernels from ``relp_tpu_torch/csrc``.
3. kernels — ``ell_price`` (with and without ``c``) and ``ell_spmv`` against
             their plain PyTorch versions on the card, in f32 and f64, at the
             shapes of the slice's operator and on a K = 8 pool; device
             time per launch (CUDA events over batches of 50 launches) and
             the time per call as the host issues it.
4. slice   — a seeded 4,096-node max-flow LP (32,768 arcs) written to MPS
             and solved through ``relp_tpu_torch.api.solve(path)``; the
             objective must equal ``scipy``'s max-flow value and both kernels
             must have been launched by the solve.
5. cli     — ``relp_tpu_torch.cli.main(["-q", file])`` on a small MPS file.

Any failure raises, so the run exits nonzero without the final line.  The
line before the last is the kernel report, one JSON object; the last line
is ``{"ok": true, "device": {...}}``.
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
TIMED_RUNS = 50
HOLD_CYCLES = 100_000_000  # ~50 ms of a sleep kernel at the H100's clock
F32_TOL = 2e-5          # f32 sums run in another order (and fused) than the plain version
F64_TOL = 1e-12

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
    from relp_tpu_torch.ops.cuda_build import load_sparse_kernels

    t0 = time.perf_counter()
    lib = load_sparse_kernels()
    print(f"[build] {lib.path.relative_to(ROOT)} nvcc {lib.build_s:.2f} s "
          f"(load total {time.perf_counter() - t0:.2f} s)")


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
    print(f"[kernels] {label}: max_abs_err {float(err.max()):.3e} (tol {tol:g}) "
          f"device kernel {ms * 1e3:.2f} us plain {plain_ms * 1e3:.2f} us; "
          f"per call from the host kernel {host_ms * 1e3:.1f} us plain "
          f"{plain_host_ms * 1e3:.1f} us [{smi}]")
    return float(err.max()), ms, plain_ms


def slice_problem():
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import maximum_flow

    from relp_tpu_torch.models.networks import max_flow_lp, random_arcs

    arcs = random_arcs(N_NODES, 8, SEED)
    u, v, cap = (np.array(col) for col in zip(*arcs))
    graph = sp.csr_matrix((cap.astype(np.int32), (u, v)), shape=(N_NODES, N_NODES))
    flow = maximum_flow(graph, 0, N_NODES - 1).flow_value
    return max_flow_lp(N_NODES, arcs, 0, N_NODES - 1), float(flow)


def phase_kernels(smi):
    """Kernel vs plain at the slice operator's shapes and on a K = 8 pool."""
    import numpy as np
    import torch

    from relp_tpu_torch.model.computational_form import build_computational_form
    from relp_tpu_torch.ops.sparse_kernels import (
        ell_price, ell_price_plain, ell_spmv, ell_spmv_plain,
    )
    from relp_tpu_torch.presolve.engine import presolve
    from relp_tpu_torch.simplex.driver import _device_matrix, _round_up
    from relp_tpu_torch.utils.config import DEFAULT_CONFIG

    dev = torch.device("cuda")
    general, _ = slice_problem()
    presolve(general)
    cf = build_computational_form(general, scale=True)
    m_pad, n_pad = _round_up(cf.m, 8), _round_up(cf.n, 128)
    op, fmt = _device_matrix(cf, m_pad, n_pad, DEFAULT_CONFIG, dev)
    if fmt != "ell":
        raise AssertionError(f"[kernels] slice operator is {fmt}, expected ell")
    rng = np.random.default_rng(SEED)
    # a K = 8 column pool at the slice's width, rows spread over m
    K8_rows = torch.as_tensor(rng.integers(0, m_pad, (8, n_pad)).astype(np.int32), device=dev)
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
            res = _compare(f"ell_price {tag} c-d {pool}",
                           lambda: ell_price(dd, rows_t, yd, cd),
                           lambda: ell_price_plain(dd, rows_t, yd, cd), tol, smi)
            report[("ell_price", tag, "c", pool)] = res
            res = _compare(f"ell_price {tag} sum {pool}",
                           lambda: ell_price(dd, rows_t, yd),
                           lambda: ell_price_plain(dd, rows_t, yd), tol, smi)
            report[("ell_price", tag, "sum", pool)] = res
        rd = op.rdata_t.to(dtype).contiguous()
        label = f"K={op.rdata_t.shape[0]} m={m_pad} n={n_pad}"
        res = _compare(f"ell_spmv {tag} slice {label}",
                       lambda: ell_spmv(rd, op.rcols_t, xd),
                       lambda: ell_spmv_plain(rd, op.rcols_t, xd), tol, smi)
        report[("ell_spmv", tag, "slice")] = res
    slice_pool = next(iter(pools))
    # the per-iteration hot launches of the slice: f32 fused pricing, f64 A·x
    return {
        "ell_price": report[("ell_price", "f32", "c", slice_pool)],
        "ell_spmv": report[("ell_spmv", "f64", "slice")],
    }


def phase_slice(smi):
    import torch

    from relp_tpu_torch import api
    from relp_tpu_torch.io.mps_write import export_mps
    from relp_tpu_torch.model.elements import LinearProgramType
    from relp_tpu_torch.ops.sparse_kernels import ell_price, ell_spmv

    general, flow = slice_problem()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"maxflow_{N_NODES}.mps")
        export_mps(general, path)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ell_price.launches = 0
        ell_spmv.launches = 0
        t0 = time.perf_counter()
        res = api.solve(path)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"ell_price": ell_price.launches, "ell_spmv": ell_spmv.launches}
    met = res.simplex.metrics
    if res.kind is not LinearProgramType.FINITE_OPTIMUM:
        raise AssertionError(f"[slice] status {res.kind}")
    obj = res.solution.objective_value
    if abs(obj - flow) > 1e-6:
        raise AssertionError(f"[slice] objective {obj!r} != max-flow value {flow!r}")
    if met.matrix_format != "ell":
        raise AssertionError(f"[slice] matrix_format {met.matrix_format!r}, expected 'ell'")
    if met.device != "cuda":
        raise AssertionError(f"[slice] solved on {met.device!r}")
    if min(launches.values()) < 1 or launches["ell_price"] < met.iterations:
        raise AssertionError(f"[slice] launches {launches} for {met.iterations} iterations")
    print(f"[slice] max-flow N={N_NODES} seed={SEED}: m={met.m} n={met.n} nnz={met.nnz} "
          f"(padded {met.m_padded}x{met.n_padded}) objective {obj:.12g} == scipy {flow:.12g}")
    print(f"[slice] iterations {met.iterations} solve_wall {met.wall_s:.3f} s "
          f"iters/s {met.iters_per_s:.1f} api_wall {wall:.3f} s host_reads "
          f"{met.host_reads} ({met.host_reads / max(met.iterations, 1):.3f}/iter) "
          f"peak_mem {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB "
          f"launches {launches} [{smi}]")
    return launches


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

    phase_build()
    timings = phase_kernels(smi)
    launches = phase_slice(smi)
    phase_cli()
    if "jax" in sys.modules or "relp_tpu" in sys.modules:
        raise AssertionError("the smoke run imported JAX or the JAX package")

    replaces = {
        "ell_price": "relp_tpu/ops/pallas_kernels.py:126",
        "ell_spmv": "relp_tpu/ops/pallas_kernels.py:64",
    }
    kernels = [
        {
            "name": name, "route": "cuda",
            "source": "relp_tpu_torch/csrc/sparse_kernels.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": timings[name][0], "ms": timings[name][1],
            "plain_ms": timings[name][2],
        }
        for name in ("ell_price", "ell_spmv")
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
