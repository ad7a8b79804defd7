"""Multi-process execution entry points.

Port of ``relp_tpu/parallel/multihost.py``.  Each process calls
:func:`initialize_distributed` (a ``torch.distributed`` process group: gloo
when the port's device is the CPU, NCCL on CUDA), after which
:func:`global_solver_mesh` lays out

- the **'batch' axis across processes**: a process owns the 'batch' rows of
  its devices and solves their scenarios (``parallel.solve_batched``,
  ``fom.solve_pdhg_batched``), with no traffic between processes during a
  solve, and
- the **'cols' axis over a process's own devices** (``parallel/sharded.py``).

PyTorch has no global array, so a process holds its own lanes, and
:func:`process_allgather` (the counterpart of JAX's
``multihost_utils.process_allgather(..., tiled=True)``) gathers a result
across the processes in rank order, once, after the solve.
"""

from __future__ import annotations

from typing import Optional

import torch

from relp_tpu_torch.parallel.mesh import SolverMesh
from relp_tpu_torch.utils.device import DeviceLike, resolve_device, visible_devices


def _join(coordinator_address: str, num_processes: int, process_id: int,
          device: DeviceLike = None) -> None:
    """Join (or start, as rank 0) the process group of ``num_processes``
    processes at ``coordinator_address`` (``host:port``): NCCL when
    ``device`` (default ``RELP_TPU_TORCH_DEVICE``) is CUDA, else gloo.
    :func:`initialize_distributed`'s path for more than one process; a
    group of one is made only to test that path."""
    import torch.distributed as dist

    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: DeviceLike = None) -> None:
    """Join the multi-process runtime (idempotent; nothing for one process)."""
    if num_processes is None or num_processes <= 1:
        return
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return
    _join(coordinator_address, num_processes, process_id, device)


def _world():
    """``(processes, this process's rank)``: (1, 0) outside a process group."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def global_solver_mesh(batch: Optional[int] = None, cols: Optional[int] = None,
                       device: DeviceLike = None) -> SolverMesh:
    """Mesh over every process's devices: 'batch' across processes, 'cols'
    within.  Defaults: batch = number of processes, cols = the local device
    count (every process is taken to see as many devices as this one, as JAX
    takes it).  A row's devices are named as their process sees them."""
    n_proc, rank = _world()
    local = visible_devices(device)
    if batch is None:
        batch = n_proc
    if cols is None:
        cols = (n_proc * len(local)) // batch
    flat = [(p, d) for p in range(n_proc) for d in local]
    if batch * cols != len(flat):
        raise ValueError(f"mesh {batch}x{cols} does not cover {len(flat)} devices")
    rows = [flat[i * cols:(i + 1) * cols] for i in range(batch)]
    owners = []
    for row in rows:
        procs = {p for p, _ in row}
        if len(procs) != 1:
            raise ValueError("a 'batch' row of the global mesh must lie within one process")
        owners.append(procs.pop())
    return SolverMesh([[d for _, d in row] for row in rows], owners=owners, rank=rank)


def process_allgather(t: torch.Tensor) -> torch.Tensor:
    """``t`` of every process concatenated along axis 0 in rank order (every
    process passes a tensor of the same shape); ``t`` itself outside a
    process group (a group of one still runs the collective).  Under NCCL
    the tensor travels on this process's card."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return t
    n_proc, _ = _world()
    on = t
    if dist.get_backend() == "nccl":
        on = t.to(torch.device("cuda", torch.cuda.current_device()))
    parts = [torch.empty_like(on) for _ in range(n_proc)]
    dist.all_gather(parts, on.contiguous())
    return torch.cat(parts).to(t.device)
