#!/usr/bin/env python3
"""Where the time of relp_tpu_torch's primal iterations goes, on one NVIDIA GPU.

    python3 tools/profile_torch_slice.py [--problem maxflow|dense] [--nodes 4096]
                                         [--iters 600] [--out FILE]

Builds one of the two LPs that ``chip_smoke.py`` solves (the seeded max-flow
LP of ``--nodes`` nodes on the ELL operator, or the dense LP at 768 × 1536 on
the dense operator), lowers it on the
host (presolve, computational form), then runs the device solve for
``--iters`` iterations three times: a warm-up, a timed run, and a run under
``torch.profiler`` (CPU and CUDA activities).  Prints the wall time per
iteration, the device's busy share of the profiled wall (kernel time summed
over the run), kernel launches per iteration, and the heaviest operators by
device and by host time; ``--out`` receives the full profiler tables.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _device_attr(avg) -> str:
    """Name of the device-time field of a profiler average (it was renamed
    from ``cuda`` to ``device`` across PyTorch versions)."""
    return ("self_device_time_total" if hasattr(avg, "self_device_time_total")
            else "self_cuda_time_total")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--problem", choices=("maxflow", "dense"), default="maxflow")
    ap.add_argument("--nodes", type=int, default=4096, help="size of the max-flow graph")
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--out", help="file for the full profiler tables")
    args = ap.parse_args(argv)

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
    if args.problem == "maxflow":
        general, _ = chip_smoke.slice_problem(args.nodes)
        name = f"max-flow N={args.nodes}"
    else:
        from relp_tpu_torch.models.dense import dense_lp

        m, n = chip_smoke.DENSE_SHAPE
        general, name = dense_lp(m, n), f"dense LP {m}x{n}"
    presolve(general)
    cf = build_computational_form(general, scale=True)
    config = SolverConfig(max_iter=args.iters)

    def run():
        res = solve_computational_form(cf, config, device="cuda")
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
        f"[profile] {name}: m={met.m} n={met.n} "
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
