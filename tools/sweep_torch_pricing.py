#!/usr/bin/env python3
"""Sweep the launch shapes of relp_tpu_torch's pricing and A·x kernels on one NVIDIA GPU.

    python3 tools/sweep_torch_pricing.py [--out FILE] [--only dense|ell|spmv|lanes|bricks]
                                         [--package-root DIR]

``dense_price`` and ``ell_price`` take their grids from a few constants of
their wrappers (``ops/dense_kernels.py``: blocks aimed at, fewest rows of a
slice; ``ops/sparse_kernels.py``: most blocks, whether the gathered vector is
staged) and two of their sources (rows in flight per thread, threads of an
``ell_price`` block).  This script builds the source variants, sets the
constants in turn and prints the device time per launch of each kernel at the
shapes of ``chip_smoke.py`` (timed as it times them), beside one PyTorch
call on the same inputs.  ``ell_spmv`` takes its launch shape from
``sparse_kernels.spmv_plan``; the sweep puts every shape (segments of a row
∈ {1, 2, 4, 8, 16} × row threads of a block × 1 or 4 rows a thread) in its
place in turn, holds each against the plain version, and prints the plan's
own choice last.  The lane kernels (``dense_price_lanes``,
``dense_price_select_lanes`` against a shared A) take the lanes a block
serves from ``dense_kernels.lane_group``; the sweep puts 1 (lane by lane),
4, 8 and 16 in its place in turn, under each depth of the group kernel's
ring of rows in flight (``RELP_DENSE_GROUP_STAGES``), at chip_smoke.py's
lane shapes, holds
every group size to the same bits, and prints ``lane_plan``'s own choice
beside ``addmm``.  ``--only bricks`` times ``ell_spmv`` and ``ell_price``
on the first-order operator of the max flows (N = 1,024 and 4,096) in their
natural order and in RCM order, beside ``brick_spmv`` and ``brick_price`` on
the same matrices, the brick kernels' lanes a tile × the nonzeros a lane
loads before its first gather (``RELP_BRICK_BATCH``) on the grouped RCM
operator, and the two ELL kernels at the bandwidth shape in both
orders (``sweep_bricks``).  With ``--package-root DIR`` the package is taken from another
checkout (an earlier commit unpacked beside this one), and where that one's
``ell_spmv`` has no plan to sweep its one launch shape is timed alone, so the
two can be compared within one run.  The constants in the repository are the ones this sweep
favoured; PERF.md records the readings.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


SPMV_SHAPES = (  # label, Kr, m, n: chip_smoke.py's three
    ("slice Kr=31 m=4096 n=32768", 31, 4096, 32768),
    ("short rows Kr=2 m=32768 n=4096", 2, 32768, 4096),
    ("bandwidth Kr=31 m=131072 n=1048576", 31, 131072, 1048576),
)


def sweep_spmv(say, us, rng, dev):
    """``ell_spmv`` under every launch shape, each held against the plain
    version (the segments change the order of a row's sum, so within the
    smoke run's tolerance, and bit for bit between two runs)."""
    import numpy as np
    import torch

    import chip_smoke
    from relp_tpu_torch.ops import sparse_kernels
    from relp_tpu_torch.ops.sparse_kernels import ell_spmv, ell_spmv_plain

    plan_fn = getattr(sparse_kernels, "spmv_plan", None)
    for label, Kr, m, n in SPMV_SHAPES:
        cols = torch.as_tensor(rng.integers(0, n, (Kr, m)).astype(np.int32), device=dev)
        data64 = torch.as_tensor(rng.standard_normal((Kr, m)), device=dev)
        x64 = torch.as_tensor(rng.standard_normal(n), device=dev)
        for dtype, tol in ((torch.float32, chip_smoke.F32_TOL),
                           (torch.float64, chip_smoke.F64_TOL)):
            data, x = data64.to(dtype), x64.to(dtype)
            want = ell_spmv_plain(data, cols, x)
            scale = float(ell_spmv_plain(data.abs(), cols, x.abs()).max())
            csr = chip_smoke._csr_of_pool(data, cols, n)
            tag = f"{label} {'f32' if dtype == torch.float32 else 'f64'}"
            say(f"[sweep] spmv {tag}: plain {us(lambda: ell_spmv_plain(data, cols, x)):.2f} us  "
                f"torch.mv(sparse CSR) {us(lambda: torch.mv(csr, x)):.2f} us")

            def run(name):
                got = ell_spmv(data, cols, x)
                err = float((got - want).abs().max())
                if err > tol * max(1.0, scale) or not torch.equal(got, ell_spmv(data, cols, x)):
                    raise AssertionError(f"ell_spmv {tag} {name}: max abs err {err:.3e}, or two "
                                         "runs gave different bits")
                return us(lambda: ell_spmv(data, cols, x))

            if plan_fn is None:
                say(f"[sweep] spmv {tag} this checkout's one launch shape: {run('as is'):.2f} us")
                continue
            for rows in (1, 4):
                for row_threads in (32, 64, 128, 256):
                    cells = []
                    for segments in (1, 2, 4, 8, 16):
                        seg_len = -(-Kr // segments)
                        if row_threads * segments > 512 or -(-Kr // seg_len) != segments:
                            continue
                        plan = sparse_kernels.SpmvPlan(segments, seg_len, row_threads, rows)
                        sparse_kernels.spmv_plan = lambda *_: plan
                        cells.append(f"S={segments} {run(plan):.2f}")
                    say(f"[sweep] spmv {tag} rows/thread {rows} row threads {row_threads} us: "
                        + "  ".join(cells))
            sparse_kernels.spmv_plan = plan_fn
            plan = plan_fn(m, Kr, data.element_size())
            say(f"[sweep] spmv {tag} spmv_plan's choice {tuple(plan)}: {run(plan):.2f} us")


LANE_SHAPES = (  # label, lanes, m, n: chip_smoke.py's lane rows
    ("64 x 768x1536", 64, 768, 1536),
    ("17 x 768x1536", 17, 768, 1536),
    ("16 x 1024x8192", 16, 1024, 8192),
)


def sweep_lanes(say, us, rng, dev, build):
    """The lane kernels under every group size and ring depth: each
    group size must give the bits of the lane-by-lane kernel (every lane
    keeps the single launch's order of sums)."""
    import torch

    from relp_tpu_torch.ops import dense_kernels as dk

    cases = []
    for label, L, m, n in LANE_SHAPES:
        A64 = torch.as_tensor(rng.uniform(0.05, 1.0, (m, n)), device=dev)
        V64 = torch.as_tensor(rng.uniform(0.0, 1.0, (L, m)), device=dev)
        C64 = torch.as_tensor(rng.uniform(0.0, 1.0, (L, n)), device=dev)
        for dtype in (torch.float32, torch.float64):
            A, V, C = (t.to(dtype).contiguous() for t in (A64, V64, C64))
            tag = f"{label} {'f32' if dtype == torch.float32 else 'f64'}"
            cases.append((tag, lambda A=A, V=V, C=C: dk.dense_price_lanes(A, V, C),
                          lambda A=A, V=V, C=C: torch.addmm(C, V, A, alpha=-1),
                          (L, m, n, A.element_size())))
    L, m, n = 64, 256, 512
    for dtype in (torch.float32, torch.float64):
        A = torch.as_tensor(rng.uniform(0.05, 1.0, (m, n)), dtype=dtype, device=dev)
        V = torch.as_tensor(rng.uniform(0.0, 1.0, (L, m)), dtype=dtype, device=dev)
        C = torch.as_tensor(rng.uniform(-1.0, 1.0, (L, n)), dtype=dtype, device=dev)
        sel = (torch.as_tensor(rng.integers(0, 4, (L, n + m)), device=dev),
               torch.ones(n, dtype=torch.bool, device=dev),
               torch.as_tensor(rng.uniform(0.5, 4.0, (L, n)), device=dev),
               torch.zeros(L, dtype=torch.bool, device=dev), 1e-9, True)
        tag = f"select {L} x {m}x{n} {'f32' if dtype == torch.float32 else 'f64'}"
        cases.append((tag, lambda A=A, V=V, C=C, sel=sel: dk.dense_price_select_lanes(A, V, C, *sel),
                      None, (L, m, n, A.element_size())))
    for tag, _, lib, _ in cases:
        if lib is not None:
            say(f"[sweep] lanes {tag}: torch.addmm(C, V, A, alpha=-1) {us(lib):.2f} us")

    chosen = dk.lane_group
    reference = {}
    for stages in (4, 8, 16):
        build([f"RELP_DENSE_GROUP_STAGES={stages}"])
        for group in (1, 4, 8, 16):
            if group == 1 and stages != 8:
                continue  # the lane-by-lane kernel has no ring
            dk.lane_group = lambda lanes, *_, g=group: g if lanes > 1 else 1
            dk.lane_plan.cache_clear()
            cells = []
            for tag, fn, _, _ in cases:
                got = fn()
                got = got if isinstance(got, tuple) else (got,)
                want = reference.setdefault(tag, got)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"lanes {tag} group {group} stages {stages}: other "
                                         "bits than the lane-by-lane kernel's")
                cells.append(f"{tag} {us(fn):.2f}")
            say(f"[sweep] lanes stages {stages} group {group} us: " + "; ".join(cells))
    dk.lane_group = chosen
    dk.lane_plan.cache_clear()
    build([])
    say("[sweep] lanes lane_plan's choice: " + "; ".join(
        f"{tag} group {dk.lane_plan(L, m, n, size).group} {us(fn):.2f} us"
        for tag, fn, _, (L, m, n, size) in cases))


def _padded(csc, m, n):
    import scipy.sparse as sp

    coo = csc.tocoo()
    return sp.csc_matrix((coo.data, (coo.row, coo.col)), shape=(m, n))


def _bricks_of(csc):
    """Distinct 8 × 128 bricks the nonzeros of ``csc`` touch, rows and columns."""
    import numpy as np

    coo = csc.tocoo()
    row = np.unique((coo.row // 8).astype(np.int64) * (csc.shape[1] // 128 + 1) + coo.col // 128)
    col = np.unique((coo.col // 8).astype(np.int64) * (csc.shape[0] // 128 + 1) + coo.row // 128)
    return len(row), len(col)


def sweep_bricks(say, us, rng, dev, nodes=(1024, 4096), bandwidth=(31, 131072, 1048576)):
    """ELL against the brick layout on the bricks path's matrices, with and
    without RCM ordering: ``ell_spmv`` (A·x) and ``ell_price`` (c − Aᵀy) on the
    scaled max flow in its natural order (the operator ``"auto"`` builds) and
    in the RCM order of ``pdlp_matrix="bricks"``, beside ``brick_spmv`` and
    ``brick_price`` on the grouped bricks of both orders and the flat bricks
    of the RCM order; then ``ell_spmv``/``ell_price`` at the bandwidth shape
    (Kr = 31 random columns over 131,072 rows, n = 1,048,576) in both orders,
    with the bricks that shape would need (counted, not built).  Every launch
    is held against its plain version; the layout's bytes sit beside it."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    import chip_smoke
    from relp_tpu_torch.ops.amatrix import ell_from_csc
    from relp_tpu_torch.ops import cuda_build
    from relp_tpu_torch.ops.brick_kernels import (
        LANES, brick_price, brick_price_plain, brick_spmv, brick_spmv_plain,
    )
    from relp_tpu_torch.ops.bricks import (
        bandwidth_perm, bricks_from_csc, grouped_bricks_from_csc,
    )
    from relp_tpu_torch.ops.sparse_kernels import (
        ell_price, ell_price_plain, ell_spmv, ell_spmv_plain,
    )

    def mb(*tensors):
        return chip_smoke._nbytes(*tensors) / 1e6

    def held(label, fn, plain, tol):
        got, want = fn(), plain()
        err = float((got - want).abs().max())
        if err > tol * max(1.0, float(want.abs().max())) or not torch.equal(got, fn()):
            raise AssertionError(f"{label}: max abs err {err:.3e}, or two runs differ")
        return us(fn)

    for n_nodes in nodes:
        _, csc_nat, _, _ = chip_smoke.first_order_operator(n_nodes, dev)
        grouped, csc_rcm, _, _ = chip_smoke.first_order_operator(n_nodes, dev, "bricks")
        mp, np_ = grouped.shape
        csc_nat = _padded(csc_nat, mp, np_)
        ops = {"natural": (ell_from_csc(csc_nat, mp, np_, device=dev),
                           grouped_bricks_from_csc(csc_nat, mp, np_, device=dev), None),
               "RCM": (ell_from_csc(csc_rcm, mp, np_, device=dev), grouped,
                       bricks_from_csc(csc_rcm, mp, np_, device=dev))}
        for order, csc in (("natural", csc_nat), ("RCM", csc_rcm)):
            rb, cb = _bricks_of(csc)
            say(f"[sweep] bricks max flow N={n_nodes} {mp}x{np_} nnz {csc.nnz} {order} order: "
                f"{rb} row bricks, {cb} column bricks; ELL K = {ops[order][0].data_t.shape[0]}, "
                f"Kr = {ops[order][0].rdata_t.shape[0]}")
        x64 = torch.as_tensor(rng.standard_normal(np_), device=dev)
        y64 = torch.as_tensor(rng.standard_normal(mp), device=dev)
        c64 = torch.as_tensor(rng.standard_normal(np_), device=dev)
        for dtype, tol in ((torch.float64, chip_smoke.F64_TOL), (torch.float32, chip_smoke.F32_TOL)):
            x, y, c = x64.to(dtype), y64.to(dtype), c64.to(dtype)
            tag = f"N={n_nodes} {'f32' if dtype == torch.float32 else 'f64'}"
            for order, (ell, grp, flat) in ops.items():
                e = ell.astype(dtype)
                cells = [
                    f"ell_spmv {held('ell_spmv', lambda: ell_spmv(e.rdata_t, e.rcols_t, x), lambda: ell_spmv_plain(e.rdata_t, e.rcols_t, x), tol):.2f} us "
                    f"({mb(e.rdata_t, e.rcols_t):.2f} MB)",
                    f"ell_price {held('ell_price', lambda: ell_price(e.data_t, e.rows_t, y, c), lambda: ell_price_plain(e.data_t, e.rows_t, y, c), tol):.2f} us "
                    f"({mb(e.data_t, e.rows_t):.2f} MB)"]
                for label, op in (("grouped", grp), ("flat", flat)):
                    if op is None:
                        continue
                    rt, ct = op.astype(dtype).rtiles, op.astype(dtype).ctiles
                    cells.append(
                        f"brick_spmv {label} {held('brick_spmv', lambda: brick_spmv(rt, x), lambda: brick_spmv_plain(rt, x), tol):.2f} us "
                        f"({mb(rt.ptr, rt.vals, rt.pos, rt.tile_of):.3f} MB, {rt.lanes} lanes a tile)")
                    cells.append(
                        f"brick_price {label} {held('brick_price', lambda: brick_price(ct, y, c), lambda: brick_price_plain(ct, y, c), tol):.2f} us "
                        f"({mb(ct.ptr, ct.vals, ct.pos, ct.tile_of):.3f} MB, {ct.lanes} lanes a tile)")
                say(f"[sweep] bricks {tag} {order} order: " + "; ".join(cells))
        # the brick kernels' launch shape on the grouped RCM operator: the lanes
        # of a tile (tile_lanes' choice marked) x the nonzeros a lane loads
        # before its first gather (RELP_BRICK_BATCH)
        base_flags = list(cuda_build.COMPILE_FLAGS)
        for batch in (2, 4, 8):
            cuda_build.COMPILE_FLAGS[:] = base_flags + [f"-DRELP_BRICK_BATCH={batch}"]
            cuda_build.load_kernels.cache_clear()
            cuda_build.load_kernels()
            for dtype, tol in ((torch.float64, chip_smoke.F64_TOL),
                               (torch.float32, chip_smoke.F32_TOL)):
                x, y, c = x64.to(dtype), y64.to(dtype), c64.to(dtype)
                op = grouped.astype(dtype)
                cells = []
                for lanes in LANES:
                    rt, ct = op.rtiles._replace(lanes=lanes), op.ctiles._replace(lanes=lanes)
                    cells.append(
                        f"{lanes} lanes: brick_spmv{'*' if lanes == op.rtiles.lanes else ''} "
                        f"{held('brick_spmv', lambda: brick_spmv(rt, x), lambda: brick_spmv_plain(rt, x), tol):.2f} "
                        f"brick_price{'*' if lanes == op.ctiles.lanes else ''} "
                        f"{held('brick_price', lambda: brick_price(ct, y, c), lambda: brick_price_plain(ct, y, c), tol):.2f}")
                say(f"[sweep] bricks N={n_nodes} {'f32' if dtype == torch.float32 else 'f64'} "
                    f"grouped RCM, batch {batch} us (* tile_lanes' choice): " + "; ".join(cells))
        cuda_build.COMPILE_FLAGS[:] = base_flags
        cuda_build.load_kernels.cache_clear()
        del ops, grouped
        torch.cuda.empty_cache()

    # the bandwidth shape, natural and RCM order
    Kr, m, n = bandwidth
    rows = np.repeat(np.arange(m), Kr)
    cols = rng.integers(0, n, m * Kr)
    csr = sp.csr_matrix((rng.standard_normal(m * Kr), (rows, cols)), shape=(m, n))
    csc_nat = csr.tocsc()
    rp, cp = bandwidth_perm(csc_nat)
    csc_rcm = csc_nat[rp][:, cp].tocsc()
    x64 = torch.as_tensor(rng.standard_normal(n), device=dev)
    y64 = torch.as_tensor(rng.standard_normal(m), device=dev)
    c64 = torch.as_tensor(rng.standard_normal(n), device=dev)
    for order, csc in (("natural", csc_nat), ("RCM", csc_rcm)):
        rb, cb = _bricks_of(csc)
        ell = ell_from_csc(csc, m, n, device=dev)
        say(f"[sweep] bandwidth Kr={Kr} m={m} n={n} {order} order: {rb} row bricks, {cb} "
            f"column bricks ({rb * 8192 / 1e9:.1f} / {cb * 8192 / 1e9:.1f} GB in f64: not built)")
        for dtype, tol in ((torch.float64, chip_smoke.F64_TOL), (torch.float32, chip_smoke.F32_TOL)):
            e = ell.astype(dtype)
            x, y, c = x64.to(dtype), y64.to(dtype), c64.to(dtype)
            say(f"[sweep] bandwidth {'f32' if dtype == torch.float32 else 'f64'} {order} order: "
                f"ell_spmv {held('ell_spmv', lambda: ell_spmv(e.rdata_t, e.rcols_t, x), lambda: ell_spmv_plain(e.rdata_t, e.rcols_t, x), tol):.2f} us "
                f"({mb(e.rdata_t, e.rcols_t, x):.1f} MB); ell_price c-d "
                f"{held('ell_price', lambda: ell_price(e.data_t, e.rows_t, y, c), lambda: ell_price_plain(e.data_t, e.rows_t, y, c), tol):.2f} us "
                f"(K = {e.data_t.shape[0]}, {mb(e.data_t, e.rows_t, y, c):.1f} MB)")
        del ell, e
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="file for a copy of the lines printed")
    ap.add_argument("--only", choices=("dense", "ell", "spmv", "lanes", "bricks"),
                    help="sweep one kernel (default: all five)")
    ap.add_argument("--package-root", default=str(ROOT),
                    help="checkout to import relp_tpu_torch from (default: this one)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sweep_torch_pricing: needs an NVIDIA GPU")
    sys.path[:0] = [str(Path(args.package_root).resolve()), str(ROOT)]
    import chip_smoke
    from relp_tpu_torch.ops import cuda_build, dense_kernels, sparse_kernels
    from relp_tpu_torch.ops.select_epilogue import Selection

    smi = chip_smoke.phase_device()
    dev = torch.device("cuda")
    rng = np.random.default_rng(chip_smoke.SEED)
    lines = []

    def say(line):
        print(line, flush=True)
        lines.append(line)

    def us(fn):
        return chip_smoke._device_ms(fn, batches=3) * 1e3

    def sel_for(n, m):
        return Selection(torch.as_tensor(rng.integers(0, 5, n + m), device=dev),
                         torch.ones(n, dtype=torch.bool, device=dev),
                         torch.as_tensor(rng.uniform(0.5, 4.0, n), device=dev),
                         torch.tensor(False, device=dev), 1e-9, True)

    # ---- inputs: the shapes chip_smoke.py times
    dense_cases = []
    for label, m, n, j0, w, dtype in (
            ("768x1536 f32", 768, 1536, 0, 1536, torch.float32),
            ("768x1536 f64", 768, 1536, 0, 1536, torch.float64),
            ("768x1536 f32 window 384", 768, 1536, 384, 384, torch.float32),
            ("2048x16384 f32", 2048, 16384, 0, 16384, torch.float32),
            ("2048x16384 f64", 2048, 16384, 0, 16384, torch.float64)):
        A = torch.as_tensor(rng.uniform(0.05, 1.0, (m, n)), dtype=dtype, device=dev)
        v = torch.as_tensor(rng.uniform(0.0, 1.0, m), dtype=dtype, device=dev)
        c = torch.as_tensor(rng.uniform(0.0, 1.0, w), dtype=dtype, device=dev)
        dense_cases.append((label, A, v, c, j0, w, sel_for(n, m)))
    m, n, K = 4096, 32768, 2
    idx = torch.as_tensor(rng.integers(0, m, (K, n)).astype(np.int32), device=dev)
    ell_cases = []
    for label, dtype in (("K=2 n=32768 m=4096 f32", torch.float32),
                         ("K=2 n=32768 m=4096 f64", torch.float64)):
        data = torch.as_tensor(rng.standard_normal((K, n)), dtype=dtype, device=dev)
        y = torch.as_tensor(rng.standard_normal(m), dtype=dtype, device=dev)
        c = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=dev)
        ell_cases.append((label, data, y, c, sel_for(n, m)))

    want = (lambda kernel: args.only in (None, kernel))
    say(f"[sweep] yardsticks [{smi}]")
    for label, A, v, c, j0, w, _ in dense_cases if want("dense") else ():
        At = A[:, j0:j0 + w].t()
        say(f"[sweep] dense {label}: torch.mv(A.t(), v) {us(lambda: torch.mv(At, v)):.2f} us  "
            f"torch.addmv(c, A.t(), v, alpha=-1) "
            f"{us(lambda: torch.addmv(c, At, v, alpha=-1)):.2f} us")
    for label, data, y, c, _ in ell_cases if want("ell") else ():
        csr = chip_smoke._csr_of_pool(data, idx, m)
        say(f"[sweep] ell {label}: torch.mv(sparse CSR) {us(lambda: torch.mv(csr, y)):.2f} us")

    base_flags = list(cuda_build.COMPILE_FLAGS)
    kept = (dense_kernels._TARGET_BLOCKS, dense_kernels._MIN_SLICE_ROWS,
            sparse_kernels._PRICE_BLOCKS, sparse_kernels._STAGE_BYTES,
            sparse_kernels._PRICE_CHUNK)

    def build(defines):
        cuda_build.COMPILE_FLAGS[:] = base_flags + [f"-D{d}" for d in defines]
        cuda_build.load_kernels.cache_clear()
        cuda_build.load_kernels()

    # ---- dense_price: rows in flight x blocks aimed at x fewest rows of a slice
    for unroll in (2, 4, 8) if want("dense") else ():
        build([f"RELP_DENSE_UNROLL={unroll}"])
        for target in (66, 132, 264, 528):
            for min_rows in (32, 64, 128):
                dense_kernels._TARGET_BLOCKS, dense_kernels._MIN_SLICE_ROWS = target, min_rows
                cells = []
                for label, A, v, c, j0, w, sel in dense_cases:
                    slices = dense_kernels.slices_for(A.shape[0], w, A.element_size())[0]
                    cells.append(
                        f"{label} ({slices} slices): sum "
                        f"{us(lambda: dense_kernels.dense_price(A, v, None, j0, w)):.2f} c-d "
                        f"{us(lambda: dense_kernels.dense_price(A, v, c, j0, w)):.2f} select "
                        f"{us(lambda: dense_kernels.dense_price_select(A, v, c, *sel, j0, w)):.2f}")
                say(f"[sweep] dense unroll {unroll} target {target} min_rows {min_rows} us: "
                    + "; ".join(cells))
    dense_kernels._TARGET_BLOCKS, dense_kernels._MIN_SLICE_ROWS = kept[:2]

    # ---- ell_price: threads of a block x most blocks x staged or not
    for threads in (64, 128, 256) if want("ell") else ():
        build([f"RELP_ELL_THREADS={threads}"])
        sparse_kernels._PRICE_CHUNK = 4 * threads
        for blocks in (32, 64, 132, 264):
            for stage_bytes in (kept[3], -1):
                sparse_kernels._PRICE_BLOCKS, sparse_kernels._STAGE_BYTES = blocks, stage_bytes
                cells = []
                for label, data, y, c, sel in ell_cases:
                    grid = sparse_kernels.price_plan(n, m, data.element_size())[0]
                    cells.append(
                        f"{label} ({grid} blocks): sum "
                        f"{us(lambda: sparse_kernels.ell_price(data, idx, y)):.2f} c-d "
                        f"{us(lambda: sparse_kernels.ell_price(data, idx, y, c)):.2f} select "
                        f"{us(lambda: sparse_kernels.ell_price_select(data, idx, y, c, *sel)):.2f}")
                say(f"[sweep] ell threads {threads} most blocks {blocks} "
                    f"{'staged' if stage_bytes > 0 else 'gathered through __ldg'} us: "
                    + "; ".join(cells))
    (sparse_kernels._PRICE_BLOCKS, sparse_kernels._STAGE_BYTES,
     sparse_kernels._PRICE_CHUNK) = kept[2:]
    cuda_build.COMPILE_FLAGS[:] = base_flags
    cuda_build.load_kernels.cache_clear()

    # ---- ell_spmv: segments of a row x row threads of a block x rows a thread
    if want("spmv"):
        sweep_spmv(say, us, rng, dev)

    # ---- the lane kernels: lanes a block serves x depth of the ring of rows
    if want("lanes"):
        sweep_lanes(say, us, rng, dev, build)

    # ---- ELL against bricks, with and without RCM ordering
    if want("bricks"):
        sweep_bricks(say, us, rng, dev)

    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
