"""Peaks of the card and the least bytes of the port's kernels.

The least time of a launch is each input byte read once and each output
byte written once at the card's memory bandwidth, counted from the LP's own
shapes, whatever kernel implements the work.  Where a kernel has several
modes, the mode that moves the fewest bytes is counted, so that no share can
pass 100 %.
"""

from __future__ import annotations

# NVIDIA H100 SXM (NVIDIA's data sheet, dense rates): HBM3 bandwidth
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
DEFAULT_PEAK_BYTES_PER_S = 3.35e12


def peak_bytes_per_s(kind: str) -> float:
    return PEAK_BYTES_PER_S.get(kind, DEFAULT_PEAK_BYTES_PER_S)


def dense_price_bytes(m: int, n: int, elem: int) -> int:
    """c − Aᵀ·v, Aᵀ·v or the fused selection: A and v read once (the n
    values written or read besides are left out)."""
    return m * n * elem + m * elem


def elem_of(kernel_name: str) -> int:
    """Bytes of one element of a launch, from its template argument."""
    return 8 if "<double" in kernel_name else 4
