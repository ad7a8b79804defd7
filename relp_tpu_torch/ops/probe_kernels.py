"""Wrappers and plain versions of the toolchain-probe CUDA kernels.

``probe_scale_f32`` and ``probe_scale_f64`` replace ``f32_kernel`` and
``f64_kernel`` (``tools/probe_pallas.py``): ``2·x`` elementwise, one kernel
instantiation per type, in ``relp_tpu_torch/csrc/probe_kernels.cu``.  They
exist to check that a machine's ``nvcc``, driver and ctypes binding work
(``python -m relp_tpu_torch.probe``).

A wrapper given CPU tensors computes the plain PyTorch version.  Given CUDA
tensors it launches the kernel or raises.  Each wrapper counts its launches
in a plain integer attribute, ``launches``.
"""

from __future__ import annotations

import torch


def probe_scale_plain(x: torch.Tensor) -> torch.Tensor:
    """``2·x``."""
    return x * 2


def _probe_scale(name: str, dtype: torch.dtype, x: torch.Tensor):
    """``2·x`` through the probe kernel of ``dtype``; returns ``(out,
    launched)``."""
    if x.dtype != dtype:
        raise TypeError(f"{name}: x must be {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if x.device.type == "cpu":
        return probe_scale_plain(x), False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    from relp_tpu_torch.ops.cuda_build import load_kernels, raise_on

    out = torch.empty_like(x)
    fn = getattr(load_kernels().lib, f"relp_{name}")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), x.numel(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    raise_on(name, err)
    return out, True


def probe_scale_f32(x: torch.Tensor) -> torch.Tensor:
    """``2·x`` for a float32 tensor (replaces ``f32_kernel``)."""
    out, launched = _probe_scale("probe_scale_f32", torch.float32, x)
    probe_scale_f32.launches += launched
    return out


def probe_scale_f64(x: torch.Tensor) -> torch.Tensor:
    """``2·x`` for a float64 tensor (replaces ``f64_kernel``)."""
    out, launched = _probe_scale("probe_scale_f64", torch.float64, x)
    probe_scale_f64.launches += launched
    return out


probe_scale_f32.launches = 0
probe_scale_f64.launches = 0
