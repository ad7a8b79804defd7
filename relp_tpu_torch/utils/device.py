"""Explicit device selection.

The port runs where the caller says: ``device=None`` means the
``RELP_TPU_TORCH_DEVICE`` environment variable, which defaults to
``"cuda"``.  There is no silent fallback to the CPU: asking for CUDA on a
machine without a usable GPU raises.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

DEVICE_ENV = "RELP_TPU_TORCH_DEVICE"

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device(device if device is not None
                       else os.environ.get(DEVICE_ENV, "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' (or set {DEVICE_ENV}=cpu) to run on "
            "the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev
