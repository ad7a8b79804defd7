"""Device mesh construction.

Port of ``relp_tpu/parallel/mesh.py``.  Meshes are 2-D: ('batch', 'cols').
'cols' shards the column pool of one solve (``parallel/sharded.py``: each
device prices its column block, the lead device combines the candidates);
'batch' spreads independent scenario LPs (``parallel/batched.py``,
``fom.solve_pdhg_batched``).  Single-device meshes are (1, 1).

PyTorch has no mesh object, so :class:`SolverMesh` is a small grid of
``torch.device``: ``devices[i][j]`` is the device of 'batch' row ``i`` and
'cols' column ``j``, and ``shape`` maps the axis names to their sizes, as
``jax.sharding.Mesh.shape`` does.  A device list may repeat a device (two
shards on one card, or ``["cpu"] * 8`` in place of the JAX tests' eight
virtual CPU devices).  A mesh over several processes
(``multihost.global_solver_mesh``) also records which process owns each
row; a process solves only the rows it owns.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from relp_tpu_torch.utils.device import DeviceLike, device_list


class SolverMesh:
    """A ``batch × cols`` grid of devices; ``owners[i]`` is the rank of the
    process that holds row ``i`` and ``rank`` this process's."""

    def __init__(self, devices: Sequence[Sequence[torch.device]],
                 owners: Optional[Sequence[int]] = None, rank: int = 0):
        self.devices: Tuple[Tuple[torch.device, ...], ...] = tuple(tuple(r) for r in devices)
        if not self.devices or len({len(r) for r in self.devices}) != 1 or not self.devices[0]:
            raise ValueError("a mesh needs equal, non-empty rows of devices")
        self.owners = tuple(owners) if owners is not None else (rank,) * len(self.devices)
        self.rank = rank

    @property
    def shape(self) -> dict:
        return {"batch": len(self.devices), "cols": len(self.devices[0])}

    def local_rows(self) -> list:
        """The 'batch' rows this process holds."""
        return [i for i, owner in enumerate(self.owners) if owner == self.rank]


def make_solver_mesh(batch: int = 1, cols: Optional[int] = None,
                     devices: Optional[Sequence] = None,
                     device: DeviceLike = None) -> SolverMesh:
    """A ('batch', 'cols') mesh over ``devices`` (default: the visible
    devices of ``device``'s kind), filled row by row; ``cols=None`` takes
    ``len(devices) // batch``.  Raises ``ValueError`` unless ``batch·cols``
    is the number of devices."""
    devices = device_list(devices, device)
    if cols is None:
        cols = len(devices) // batch
    if batch * cols != len(devices):
        raise ValueError(f"mesh {batch}x{cols} does not cover {len(devices)} devices")
    return SolverMesh([devices[i * cols:(i + 1) * cols] for i in range(batch)])
