"""Scenario-batched solves: many same-shape LPs at once (the DP analogue).

Port of ``relp_tpu/parallel/batched.py``.  The JAX package vmaps the whole
two-phase solve (``solve_core(nested=True)``) over a leading scenario axis;
here :func:`relp_tpu_torch.simplex.core.solve_core_lanes` runs the lanes
together, each lane masked so that a finished one stops changing, against
one shared dense ``A`` (a 2-D ``A``: one device copy serves every lane) or a
stacked ``A[L, m, n]``.

Differences from the JAX package: one call per solve, so the chunked
continuation (``device_chunk_iters`` and its warm-start loop, which served
the TPU's execution watchdog) is not ported; a ``mesh`` is ROADMAP.md
queue 1's multi-device item and raises.
"""

from __future__ import annotations

import numpy as np
import torch

from relp_tpu_torch.simplex.core import SolveOutput, solve_core_lanes
from relp_tpu_torch.utils.config import SolverConfig
from relp_tpu_torch.utils.device import DeviceLike, resolve_device


def _tensor(v, dev, dtype=torch.float64):
    if torch.is_tensor(v):
        return v.to(device=dev, dtype=dtype).contiguous()
    return torch.as_tensor(np.asarray(v), dtype=dtype, device=dev).contiguous()


def solve_batched(A, b, c, lb, ub, cfg: SolverConfig, max_iter: int, mesh=None,
                  warm=None, device: DeviceLike = None) -> SolveOutput:
    """Solve a stack of LPs: ``b`` ``[L, m]``, ``c``, ``lb``, ``ub``
    ``[L, n]`` and ``A`` either ``[m, n]`` (shared by every lane) or
    ``[L, m, n]``, numpy arrays or tensors.

    ``warm`` optionally carries stacked warm-start arrays ``dict(basis0,
    vstat0, art_sign0, phase0)`` (one row per scenario), as the JAX package
    takes them.  ``device=None`` takes a tensor ``A``'s device, else reads
    ``RELP_TPU_TORCH_DEVICE``.  Returns a ``SolveOutput`` whose fields carry a
    leading lane axis."""
    if mesh is not None:
        raise NotImplementedError(
            "solve_batched(mesh=...) is not ported to relp_tpu_torch yet "
            "(ROADMAP.md queue 1, multi-device)")
    if device is None and torch.is_tensor(A):
        dev = A.device
    else:
        dev = resolve_device(device)
    A_t, b_t, c_t, lb_t, ub_t = (_tensor(v, dev) for v in (A, b, c, lb, ub))
    kw = {}
    if warm is not None:
        kw = dict(basis0=_tensor(warm["basis0"], dev, torch.int64),
                  vstat0=_tensor(warm["vstat0"], dev, torch.int64),
                  art_sign0=_tensor(warm["art_sign0"], dev),
                  phase0=_tensor(warm["phase0"], dev, torch.int64))
    with torch.no_grad():
        return solve_core_lanes(A_t, b_t, c_t, lb_t, ub_t, cfg, max_iter, **kw)
