"""Scenario-batched solves: many same-shape LPs at once (the DP analogue).

Port of ``relp_tpu/parallel/batched.py``.  The JAX package vmaps the whole
two-phase solve (``solve_core(nested=True)``) over a leading scenario axis;
here :func:`relp_tpu_torch.simplex.core.solve_core_lanes` runs the lanes
together, each lane masked so that a finished one stops changing, against
one shared dense ``A`` (a 2-D ``A``: one device copy serves every lane) or a
stacked ``A[L, m, n]``, under every primal option of the config (the eta
inverse, partial pricing, the trace, the invariant check), as the JAX
package's vmapped ``solve_core`` takes them.

With a ``mesh`` (``parallel/mesh.py``) the scenarios go over 'batch': the
lanes are cut into one group per 'batch' row, in order, and group ``i`` runs
on row ``i``'s first device; the outputs come back in lane order on the first
row's device (the groups' traces padded with zero rows to the longest).
The lane count must divide by the 'batch' size (the JAX
package's ``device_put`` with ``P("batch")`` raises likewise).  Under a mesh
that spans processes (``multihost.global_solver_mesh``) a process solves the
groups of the rows it owns and returns their lanes; ``multihost.
process_allgather`` assembles the fleet.

Differences from the JAX package: one call per solve, so the chunked
continuation (``device_chunk_iters`` and its warm-start loop, which served
the TPU's execution watchdog) is not ported; the groups of one process run
one after another; the columns are not split over 'cols' inside the lane
engine (the JAX package splits them when the 'cols' size divides the column
count, for the same answer).
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


def lane_groups(L: int, mesh):
    """``(row, lanes)`` of the 'batch' rows this process holds: row ``i``
    takes the ``L / batch`` lanes from ``i·L/batch``.  Raises ``ValueError``
    when ``L`` does not divide by the 'batch' size."""
    rows = mesh.shape["batch"]
    if L % rows != 0:
        raise ValueError(f"{L} scenarios do not divide over the 'batch' axis of size {rows}")
    per = L // rows
    return [(i, slice(i * per, (i + 1) * per)) for i in mesh.local_rows()]


def gather_lanes(outs, dev):
    """The lane groups' outputs (NamedTuples with a leading lane axis on every
    tensor field) as one, in order, on ``dev``; integer fields add up."""
    first = outs[0]
    return type(first)(*(
        torch.cat([getattr(o, f).to(dev) for o in outs]) if torch.is_tensor(getattr(first, f))
        else sum(getattr(o, f) for o in outs)
        for f in first._fields))


def solve_batched(A, b, c, lb, ub, cfg: SolverConfig, max_iter: int, mesh=None,
                  warm=None, device: DeviceLike = None) -> SolveOutput:
    """Solve a stack of LPs: ``b`` ``[L, m]``, ``c``, ``lb``, ``ub``
    ``[L, n]`` and ``A`` either ``[m, n]`` (shared by every lane) or
    ``[L, m, n]``, numpy arrays or tensors.

    ``warm`` optionally carries stacked warm-start arrays ``dict(basis0,
    vstat0, art_sign0, phase0)`` (one row per scenario), as the JAX package
    takes them.  ``device=None`` takes a tensor ``A``'s device, else reads
    ``RELP_TPU_TORCH_DEVICE``; a ``mesh`` places the lane groups on its
    'batch' rows instead.  ``cfg`` is taken as it is, every primal option
    included.  Returns a ``SolveOutput`` whose fields carry a leading lane
    axis (``trace`` ``[L, T, 8]``, ``viol`` ``[L]``: see
    :func:`~relp_tpu_torch.simplex.core.solve_core_lanes`)."""
    if mesh is not None:
        groups = lane_groups(b.shape[0], mesh)
        if not groups:
            raise ValueError("this process holds no 'batch' row of the mesh")

        def part(v, lanes):  # a lane's rows; one phase0 for every lane stays as it is
            return v if np.ndim(v) == 0 else v[lanes]

        outs = [solve_batched(part(A, lanes) if A.ndim == 3 else A,
                              *(v[lanes] for v in (b, c, lb, ub)), cfg, max_iter,
                              warm=None if warm is None else
                              {k: part(v, lanes) for k, v in warm.items()},
                              device=mesh.devices[row][0])
                for row, lanes in groups]
        # a group that ran fewer steps gets zero trace rows up to the longest
        T = max(o.trace.shape[1] for o in outs)
        outs = [o._replace(trace=torch.nn.functional.pad(o.trace, (0, 0, 0, T - o.trace.shape[1])))
                for o in outs]
        return gather_lanes(outs, mesh.devices[groups[0][0]][0])
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
