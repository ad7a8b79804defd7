"""Toolchain probe:  python -m relp_tpu_torch.probe

The counterpart of ``tools/probe_pallas.py``: builds the CUDA kernels and
runs three probes on the device, one line each:

1. ``probe_scale_f32``: ``2·x`` on an f32 [8, 128] of ones;
2. ``probe_scale_f64``: ``2·x`` on an f64 [8, 128] of ones;
3. the pricing grid: ``c − π@A`` through ``dense_price`` at the probe's
   shapes (m = 128, n = 1024, all ones), one launch per 256-column block as
   the TPU kernel's grid, where every entry must be 1 − 128 = −127.

Unlike the TPU tool it exits nonzero when any probe fails.  On a CPU device
:func:`run_probes` runs the kernels' plain versions (a check of the probe
itself).
"""

from __future__ import annotations

import sys

import torch

from relp_tpu_torch.ops.dense_kernels import dense_price
from relp_tpu_torch.ops.probe_kernels import probe_scale_f32, probe_scale_f64
from relp_tpu_torch.utils.device import resolve_device

M, N, BN = 128, 1024, 256


def _scale(fn, dtype, dev):
    x = torch.ones((8, 128), dtype=dtype, device=dev)
    out = fn(x)
    return out, torch.full_like(x, 2.0)


def _pricing_grid(dev):
    pi = torch.ones(M, dtype=torch.float32, device=dev)
    A = torch.ones((M, N), dtype=torch.float32, device=dev)
    c = torch.ones(N, dtype=torch.float32, device=dev)
    out = torch.cat([dense_price(A, pi, c[j0:j0 + BN], j0=j0, w=BN)
                     for j0 in range(0, N, BN)])
    return out, torch.full_like(c, 1.0 - M)


PROBES = {
    "f32 elementwise (probe_scale_f32)": lambda dev: _scale(probe_scale_f32, torch.float32, dev),
    "f64 elementwise (probe_scale_f64)": lambda dev: _scale(probe_scale_f64, torch.float64, dev),
    f"f32 pricing grid (dense_price, m={M} n={N} bn={BN})": _pricing_grid,
}


def run_probes(dev: torch.device) -> int:
    """Run the three probes on ``dev``, one line each; returns the number
    that failed."""
    failed = 0
    for name, probe in PROBES.items():
        try:
            got, want = probe(dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ok = torch.equal(got, want)
            detail = got.flatten()[:2].tolist()
        except (RuntimeError, ValueError, TypeError) as e:  # a build or launch failure
            ok, detail = False, f"{type(e).__name__}: {str(e)[:300]}"
        failed += not ok
        print(f"{name}: {'OK' if ok else 'FAIL'} {detail}", flush=True)
    return failed


def main() -> int:
    return 1 if run_probes(resolve_device("cuda")) else 0


if __name__ == "__main__":
    sys.exit(main())
