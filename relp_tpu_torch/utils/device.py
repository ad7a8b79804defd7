"""Explicit device selection.

The port runs where the caller says: ``device=None`` means the
``RELP_TPU_TORCH_DEVICE`` environment variable, which defaults to
``"cuda"``.  There is no silent fallback to the CPU: asking for CUDA on a
machine without a usable GPU raises.

:func:`visible_devices` is the counterpart of ``jax.devices()``: the devices
a mesh may take by default (``parallel/mesh.py``).  The port's device lists
are explicit: a caller may pass any list, and a list may repeat a device.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Union

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


def as_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without an index gets
    the current one, so that two names of one card compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def visible_devices(device: DeviceLike = None) -> List[torch.device]:
    """The devices of ``device``'s kind this process can use: every CUDA
    card (``torch.cuda.device_count()``) or the one CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def device_list(devices: Optional[Sequence[Union[str, torch.device]]],
                device: DeviceLike = None) -> List[torch.device]:
    """``devices`` as ``torch.device`` objects, or ``visible_devices(device)``
    when it is None."""
    if devices is None:
        return visible_devices(device)
    return [as_device(d) for d in devices]
