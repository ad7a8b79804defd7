"""Wrapper and plain version of the dense-operator CUDA kernel.

``dense_price`` replaces ``pricing_kernel`` (``tools/probe_pallas.py``), the
fused ``c − π@A`` over a grid of column blocks; the kernel is in
``relp_tpu_torch/csrc/dense_kernels.cu``.  It reads a row-major, contiguous
``A[m, n]`` (the ``DenseMatrix`` layout) once per call and reuses only the
vector, so it is memory-bound at large shapes and launch-bound at the
solver's dense shapes.  Neighbouring threads take neighbouring columns and
walk the rows (coalesced row reads); narrow windows split the rows over a
second grid dimension; partial sums are combined in a fixed order, never
with atomics, so pivot choices repeat from run to run.

A wrapper given CPU tensors computes the plain PyTorch version.  Given CUDA
tensors it launches the kernel or raises: there is no fallback.  The
wrapper counts its launches in a plain integer attribute, ``launches``.
"""

from __future__ import annotations

from typing import Optional

import torch

from relp_tpu_torch.ops.sparse_kernels import window

_FLOATS = (torch.float32, torch.float64)
_COLS = 32           # columns of a kernel block (csrc kCols)
_MIN_SLICE_ROWS = 128
_TARGET_BLOCKS = 264  # two blocks per SM of an H100 (132 SMs)


def dense_price_plain(A: torch.Tensor, v: torch.Tensor, c: Optional[torch.Tensor] = None,
                      j0: int = 0, w: Optional[int] = None) -> torch.Tensor:
    """``c − v @ A[:, j0:j0+w]`` (or the product alone when ``c`` is None)."""
    w = A.shape[1] - j0 if w is None else w
    acc = v @ A[:, j0:j0 + w]
    return acc if c is None else c - acc


def _check(A, v, c, w):
    tensors = [A, v] + ([] if c is None else [c])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"dense_price: tensors on several devices {sorted(map(str, devices))}")
    if A.dtype not in _FLOATS:
        raise TypeError(f"dense_price: A must be float32 or float64, got {A.dtype}")
    if v.dtype != A.dtype or (c is not None and c.dtype != A.dtype):
        raise TypeError(f"dense_price: vectors must have A's dtype {A.dtype}")
    if A.dim() != 2 or v.shape != (A.shape[0],) or (c is not None and c.shape != (w,)):
        raise ValueError(
            f"dense_price: A must be [m, n], v [m] and c [w]; got {tuple(A.shape)}, "
            f"{tuple(v.shape)}, {None if c is None else tuple(c.shape)} (w={w})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("dense_price: all tensors must be contiguous")
    return devices.pop()


def slices_for(m: int, w: int) -> tuple[int, int]:
    """``(slices, rows_per_slice)``: how many row slices the kernel's grid
    splits ``m`` rows into, so that a narrow window still fills the card."""
    col_blocks = -(-w // _COLS)
    slices = 1
    if col_blocks < _TARGET_BLOCKS:
        slices = max(1, min(-(-m // _MIN_SLICE_ROWS), -(-_TARGET_BLOCKS // col_blocks)))
    rows = max(1, -(-m // slices))
    return max(1, -(-m // rows)), rows


def dense_price(A: torch.Tensor, v: torch.Tensor, c: Optional[torch.Tensor] = None,
                j0: int = 0, w: Optional[int] = None) -> torch.Tensor:
    """Dense pricing over the column window ``[j0, j0+w)`` (default: all)
    of a row-major ``A[m, n]``: ``out[j] = c[j] − Σ_i v[i]·A[i, j0+j]`` with
    ``c`` of length ``w``; without ``c`` the sum alone (``vᵀA``, the devex
    pivot row).  float32 or float64."""
    w = window(A.shape[1] if A.dim() == 2 else 0, j0, w)
    dev = _check(A, v, c, w)
    if dev.type == "cpu":
        return dense_price_plain(A, v, c, j0, w)
    if dev.type != "cuda":
        raise ValueError(f"dense_price: unsupported device {dev}")
    from relp_tpu_torch.ops.cuda_build import load_kernels, raise_on

    lib = load_kernels().lib
    m, n = A.shape
    out = torch.empty(w, dtype=A.dtype, device=dev)
    slices, rows = slices_for(m, w)
    partial = torch.empty((slices, w), dtype=A.dtype, device=dev) if slices > 1 else None
    fn = lib.relp_dense_price_f32 if A.dtype == torch.float32 else lib.relp_dense_price_f64
    with torch.cuda.device(dev):
        err = fn(
            A.data_ptr(), v.data_ptr(), None if c is None else c.data_ptr(),
            out.data_ptr(), None if partial is None else partial.data_ptr(),
            m, n, j0, w, slices, rows, torch.cuda.current_stream(dev).cuda_stream,
        )
    raise_on("dense_price", err)
    dense_price.launches += 1
    return out


dense_price.launches = 0
