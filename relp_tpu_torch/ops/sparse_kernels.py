"""Wrappers and plain versions of the sparse-operator CUDA kernels.

``ell_price`` replaces ``brick_pricing_pallas`` and ``ell_spmv`` replaces
``brick_spmv_pallas`` (both in ``relp_tpu/ops/pallas_kernels.py``).  The
kernels are in ``relp_tpu_torch/csrc/sparse_kernels.cu``.  Both are
memory-bound gathers (a value and an index per slot, about 12 bytes in f32
and 16 in f64, nothing reused but the gathered vector); at the main path's
shapes (n ≈ 32k columns, K = 2) a launch moves under 1 MB, so launch latency
bounds them.  Their design: one thread per output element walking its K
slots in order over K-major pools, so that neighbouring threads read
neighbouring addresses, with the gathered vector read through the read-only
cache; gather, product, sum and subtraction are one launch.

An ELL pool here is K-major: ``data_t[K, n]`` values and ``idx_t[K, n]``
int32 indices, padding slots holding (index 0, value 0).  Every index must
lie inside the gathered vector; the operator constructors check that once.

A wrapper given CPU tensors computes the plain PyTorch version.  Given CUDA
tensors it launches the kernel or raises: there is no fallback.  Each
wrapper counts its launches in a plain integer attribute, ``launches``.
"""

from __future__ import annotations

from typing import Optional

import torch

_FLOATS = (torch.float32, torch.float64)


def ell_price_plain(data_t: torch.Tensor, idx_t: torch.Tensor, y: torch.Tensor,
                    c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``c − Σ_k data_t[k]·y[idx_t[k]]`` (or the sum alone when ``c`` is None)."""
    acc = (data_t * y[idx_t]).sum(0)
    return acc if c is None else c - acc


def ell_spmv_plain(rdata_t: torch.Tensor, rcols_t: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """``Σ_k rdata_t[k]·x[rcols_t[k]]`` — A·x over the row-major twin."""
    return (rdata_t * x[rcols_t]).sum(0)


def _check(name, data_t, idx_t, vec, c=None):
    tensors = [data_t, idx_t, vec] + ([] if c is None else [c])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devices))}")
    if data_t.dtype not in _FLOATS:
        raise TypeError(f"{name}: values must be float32 or float64, got {data_t.dtype}")
    if vec.dtype != data_t.dtype or (c is not None and c.dtype != data_t.dtype):
        raise TypeError(f"{name}: vectors must have the values' dtype {data_t.dtype}")
    if idx_t.dtype != torch.int32:
        raise TypeError(f"{name}: indices must be int32, got {idx_t.dtype}")
    if data_t.dim() != 2 or idx_t.shape != data_t.shape:
        raise ValueError(
            f"{name}: values and indices must both be [K, n], got "
            f"{tuple(data_t.shape)} and {tuple(idx_t.shape)}"
        )
    if data_t.shape[0] < 1:
        raise ValueError(f"{name}: the pool needs K >= 1 slots")
    if vec.dim() != 1 or (c is not None and c.shape != (data_t.shape[1],)):
        raise ValueError(f"{name}: bad vector shapes")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: all tensors must be contiguous")
    return devices.pop()


def _raise_on(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def ell_price(data_t: torch.Tensor, idx_t: torch.Tensor, y: torch.Tensor,
              c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pricing over a K-major ELL column pool: ``out[j] = c[j] − Σ_k
    data_t[k,j]·y[idx_t[k,j]]``; without ``c`` the sum alone (the devex
    pivot row).  float32 or float64."""
    dev = _check("ell_price", data_t, idx_t, y, c)
    if dev.type == "cpu":
        return ell_price_plain(data_t, idx_t, y, c)
    if dev.type != "cuda":
        raise ValueError(f"ell_price: unsupported device {dev}")
    from relp_tpu_torch.ops.cuda_build import load_sparse_kernels

    lib = load_sparse_kernels().lib
    K, n = data_t.shape
    out = torch.empty(n, dtype=data_t.dtype, device=dev)
    fn = lib.relp_ell_price_f32 if data_t.dtype == torch.float32 else lib.relp_ell_price_f64
    with torch.cuda.device(dev):
        err = fn(
            data_t.data_ptr(), idx_t.data_ptr(), y.data_ptr(),
            None if c is None else c.data_ptr(), out.data_ptr(), n, K,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on("ell_price", err)
    ell_price.launches += 1
    return out


ell_price.launches = 0


def ell_spmv(rdata_t: torch.Tensor, rcols_t: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """A·x over a K-major row-major ELL twin: ``y[i] = Σ_k
    rdata_t[k,i]·x[rcols_t[k,i]]``.  float32 or float64."""
    dev = _check("ell_spmv", rdata_t, rcols_t, x)
    if dev.type == "cpu":
        return ell_spmv_plain(rdata_t, rcols_t, x)
    if dev.type != "cuda":
        raise ValueError(f"ell_spmv: unsupported device {dev}")
    from relp_tpu_torch.ops.cuda_build import load_sparse_kernels

    lib = load_sparse_kernels().lib
    K, m = rdata_t.shape
    out = torch.empty(m, dtype=rdata_t.dtype, device=dev)
    fn = lib.relp_ell_spmv_f32 if rdata_t.dtype == torch.float32 else lib.relp_ell_spmv_f64
    with torch.cuda.device(dev):
        err = fn(
            rdata_t.data_ptr(), rcols_t.data_ptr(), x.data_ptr(),
            out.data_ptr(), m, K, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on("ell_spmv", err)
    ell_spmv.launches += 1
    return out


ell_spmv.launches = 0
