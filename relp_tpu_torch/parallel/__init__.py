"""Scenario-batched solves: many same-shape LPs at once.

Port of ``relp_tpu/parallel/``'s ``batched.py`` (``solve_batched``).  The
device meshes, the column-sharded solve and the multi-host setup
(``mesh.py``, ``sharded.py``, ``multihost.py``) are ROADMAP.md queue 1's
multi-device item and are not ported yet.
"""

from relp_tpu_torch.parallel.batched import solve_batched

__all__ = ["solve_batched"]
