"""Distributed execution: device meshes, sharded pricing, batched solves.

Port of ``relp_tpu/parallel/``:

- ``mesh.py`` — the ('batch' × 'cols') mesh, a grid of torch devices,
- ``sharded.py`` — the simplex and first-order solves with the column pool
  split over 'cols' (each device prices its block, the lead device keeps
  B⁻¹ and the row state and chooses among the blocks' candidates),
- ``batched.py`` — scenario batching: many same-shape LPs as lanes of one
  engine, their groups spread over 'batch',
- ``multihost.py`` — ``torch.distributed`` process groups, 'batch' across
  processes,
- ``dryrun.py`` — every path above on a list of devices, with the scaling
  table (the counterpart of ``__graft_entry__.dryrun_multichip``).
"""

from relp_tpu_torch.parallel.batched import solve_batched
from relp_tpu_torch.parallel.mesh import make_solver_mesh
from relp_tpu_torch.parallel.multihost import global_solver_mesh, initialize_distributed
from relp_tpu_torch.parallel.sharded import solve_sharded

__all__ = [
    "global_solver_mesh",
    "initialize_distributed",
    "make_solver_mesh",
    "solve_batched",
    "solve_sharded",
]
