"""LP model families (network formulations, counterpart of reference
``src/data/linear_program/network/``; the dense resource-allocation LP)."""

from relp_tpu_torch.models.dense import dense_lp, dense_lp_data
from relp_tpu_torch.models.networks import (
    ArcIncidence,
    max_flow_lp,
    random_arcs,
    shortest_path_lp,
    solve_max_flow,
    solve_shortest_path,
)

__all__ = [
    "ArcIncidence",
    "dense_lp",
    "dense_lp_data",
    "max_flow_lp",
    "random_arcs",
    "shortest_path_lp",
    "solve_max_flow",
    "solve_shortest_path",
]
