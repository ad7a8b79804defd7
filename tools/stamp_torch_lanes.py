#!/usr/bin/env python3
"""Time the phases of the lane kernels' group kernel on one NVIDIA GPU.

    python3 tools/stamp_torch_lanes.py [--out FILE]

Builds the kernels of ``relp_tpu_torch/csrc`` with ``-DRELP_DENSE_STAMPS``
(a library of its own, beside the plain build), under which thread 0 of every
block of ``dense_price_group_kernel`` writes the card's ``%globaltimer`` at
the end of each phase: started, its first rows in flight, its rows summed, the
warps folded, the slice ticket taken, the slices summed (the block that
finishes a column block), done.  Then it launches ``dense_price_lanes`` and
``dense_price_select_lanes`` once each at chip_smoke.py's lane shapes, with
``lane_plan``'s group, and prints per shape the span from the first block's
start to the last block's end, when the blocks started (the waves), and each
phase's mean and 90th-percentile time over the blocks that reached it.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PHASES = ("rows in flight", "rows summed", "warps folded", "ticket", "slices summed", "done")
SHAPES = (  # label, lanes, m, n, select
    ("64 x 768x1536", 64, 768, 1536, False),
    ("17 x 768x1536", 17, 768, 1536, False),
    ("16 x 1024x8192", 16, 1024, 8192, False),
    ("select 64 x 256x512", 64, 256, 512, True),
)


def phases(stamps, n_blocks):
    """Lines describing one launch's stamps (ns) of ``n_blocks`` blocks."""
    import numpy as np

    st = stamps[:n_blocks].astype(np.int64)
    t0 = st[:, 0].min()
    starts = np.sort(st[:, 0] - t0) / 1e3
    q = lambda a, p: a[min(len(a) - 1, int(len(a) * p))]  # noqa: E731
    lines = [f"span {(st.max() - t0) / 1e3:.2f} us; blocks started at p50 {q(starts, 0.5):.2f} "
             f"p90 {q(starts, 0.9):.2f} max {starts[-1]:.2f} us"]
    for k, name in enumerate(PHASES, start=1):
        reached = np.flatnonzero(st[:, k] > 0)
        if len(reached) == 0:
            continue
        # from the block's last stamp before this one
        prev = np.array([st[b, :k][st[b, :k] > 0][-1] for b in reached])
        d = (st[reached, k] - prev) / 1e3
        lines.append(f"  -> {name:<14} {len(reached):5d} blocks: mean {d.mean():6.2f} us, "
                     f"p90 {np.percentile(d, 90):6.2f} us")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="file for a copy of the lines printed")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("stamp_torch_lanes: needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from relp_tpu_torch.ops import cuda_build
    from relp_tpu_torch.ops import dense_kernels as dk

    smi = chip_smoke.phase_device()
    cuda_build.COMPILE_FLAGS.append("-DRELP_DENSE_STAMPS")
    cuda_build.load_kernels.cache_clear()
    lib = cuda_build.load_kernels().lib
    lib.relp_dense_stamps.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.relp_dense_stamps.restype = ctypes.c_int
    buf = np.zeros((1 << 16, 8), dtype=np.uint64)

    def read():
        torch.cuda.synchronize()
        cuda_build.raise_on("relp_dense_stamps", lib.relp_dense_stamps(buf.ctypes.data, buf.nbytes))
        return buf.copy()

    dev = torch.device("cuda")
    rng = np.random.default_rng(chip_smoke.SEED)
    lines = [f"[stamps] {smi}"]
    for label, L, m, n, select in SHAPES:
        for dtype in (torch.float32, torch.float64):
            A = torch.as_tensor(rng.uniform(0.05, 1.0, (m, n)), dtype=dtype, device=dev)
            V = torch.as_tensor(rng.uniform(0.0, 1.0, (L, m)), dtype=dtype, device=dev)
            C = torch.as_tensor(rng.uniform(-1.0, 1.0, (L, n)), dtype=dtype, device=dev)
            sel = (torch.as_tensor(rng.integers(0, 4, (L, n + m)), device=dev),
                   torch.ones(n, dtype=torch.bool, device=dev),
                   torch.as_tensor(rng.uniform(0.5, 4.0, (L, n)), device=dev),
                   torch.zeros(L, dtype=torch.bool, device=dev), 1e-9, True)
            fn = ((lambda: dk.dense_price_select_lanes(A, V, C, *sel)) if select
                  else (lambda: dk.dense_price_lanes(A, V, C)))
            for _ in range(3):
                fn()
            read()  # zero the stamps
            fn()
            stamps = read()
            plan = dk.lane_plan(L, m, n, A.element_size())
            blocks = plan.col_blocks * plan.slices * plan.groups
            tag = f"{label} {'f32' if dtype == torch.float32 else 'f64'}"
            lines += [f"[stamps] {tag}, {plan.group} lanes a block, {blocks} blocks: " + line
                      if i == 0 else f"[stamps] {line}"
                      for i, line in enumerate(phases(stamps, blocks))]
    print("\n".join(lines))
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
