"""Network problems as LP formulations.

Counterpart of reference ``src/data/linear_program/network/``
(representation.rs: ``ArcIncidenceMatrix``; shortest_path.rs / max_flow.rs:
LP formulations exposed as matrix providers).  Differences by design:

- arc capacities become native variable bounds (the engine is a
  bounded-variable simplex), replacing the reference max-flow's per-arc
  capacity slack columns (max_flow.rs:22-119) — m shrinks to the node
  balance rows alone;
- the redundant node row is dropped exactly like the reference drops the
  source row (shortest_path.rs:31).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from relp_tpu_torch.model.elements import Objective, RangedConstraintRelation
from relp_tpu_torch.model.general_form import GeneralForm, Variable

INF = float("inf")

Arc = Tuple[int, int, float]  # (from, to, length-or-capacity)


@dataclass
class ArcIncidence:
    """Node-arc incidence: entry (v, a) = +1 if arc a enters v, -1 if it
    leaves v (reference ``ArcIncidenceMatrix``, network/representation.rs)."""

    nr_nodes: int
    arcs: List[Tuple[int, int]]

    def matrix(self, drop_nodes: Sequence[int] = ()) -> sp.csc_matrix:
        drop = set(drop_nodes)
        keep = [v for v in range(self.nr_nodes) if v not in drop]
        row_of = {v: i for i, v in enumerate(keep)}
        data, rows, cols = [], [], []
        for a, (u, v) in enumerate(self.arcs):
            if u in row_of:
                data.append(-1.0)
                rows.append(row_of[u])
                cols.append(a)
            if v in row_of:
                data.append(1.0)
                rows.append(row_of[v])
                cols.append(a)
        return sp.csc_matrix(
            (data, (rows, cols)), shape=(len(keep), len(self.arcs))
        )


def random_arcs(nr_nodes: int, arcs_per_node: int = 8, seed: int = 7,
                max_capacity: int = 99) -> List[Arc]:
    """A seeded random simple digraph: ``arcs_per_node · nr_nodes`` distinct
    arcs ``(u, v, capacity)`` with ``u != v`` and integer capacities in
    ``[1, max_capacity]``, drawn from ``numpy.random.default_rng(seed)``
    (distinct, so every arc's LP column has its own name)."""
    rng = np.random.default_rng(seed)
    n_arcs = arcs_per_node * nr_nodes
    if n_arcs > nr_nodes * (nr_nodes - 1):
        raise ValueError("more arcs than distinct node pairs")
    keys = np.zeros(0, dtype=np.int64)
    while keys.size < n_arcs:
        u = rng.integers(0, nr_nodes, n_arcs)
        v = rng.integers(0, nr_nodes - 1, n_arcs)
        v = v + (v >= u)  # skip u itself
        keys = np.concatenate([keys, u * nr_nodes + v])
        _, first = np.unique(keys, return_index=True)
        keys = keys[np.sort(first)][:n_arcs]
    cap = rng.integers(1, max_capacity + 1, n_arcs)
    return [(int(k // nr_nodes), int(k % nr_nodes), float(w))
            for k, w in zip(keys, cap)]


def shortest_path_lp(
    nr_nodes: int, arcs: Sequence[Arc], source: int, sink: int
) -> GeneralForm:
    """min Σ length_a x_a  s.t.  N'x = e_sink (source row dropped), x >= 0.

    Mirrors reference ``shortest_path::Primal`` (network/shortest_path.rs:
    16-112): unit flow into the sink, flow conservation elsewhere, source
    row dropped as redundant.  The optimal objective is the s→t distance.
    """
    inc = ArcIncidence(nr_nodes, [(u, v) for u, v, _ in arcs])
    A = inc.matrix(drop_nodes=[source])
    keep = [v for v in range(nr_nodes) if v != source]
    b = np.zeros(len(keep))
    b[keep.index(sink)] = 1.0
    variables = [
        Variable(name=f"arc_{u}_{v}", cost=float(w), lower=0.0, upper=INF)
        for u, v, w in arcs
    ]
    types = [RangedConstraintRelation.equal() for _ in keep]
    return GeneralForm(
        objective=Objective.MINIMIZE,
        A=A,
        constraint_types=types,
        b=b,
        variables=variables,
        name=f"shortest_path_{source}_{sink}",
    )


def max_flow_lp(
    nr_nodes: int, arcs: Sequence[Arc], source: int, sink: int
) -> GeneralForm:
    """max (flow out of source)  s.t.  conservation at internal nodes,
    0 <= x_a <= capacity_a.

    Mirrors reference ``max_flow::Primal`` (network/max_flow.rs:22-119) with
    capacities as native bounds instead of slack columns.
    """
    inc = ArcIncidence(nr_nodes, [(u, v) for u, v, _ in arcs])
    A = inc.matrix(drop_nodes=[source, sink])
    m = A.shape[0]
    variables = []
    for u, v, cap in arcs:
        out_of_s = 1.0 if u == source else 0.0
        into_s = 1.0 if v == source else 0.0
        variables.append(
            Variable(
                name=f"arc_{u}_{v}",
                cost=out_of_s - into_s,  # maximize net flow out of source
                lower=0.0,
                upper=float(cap),
            )
        )
    types = [RangedConstraintRelation.equal() for _ in range(m)]
    return GeneralForm(
        objective=Objective.MAXIMIZE,
        A=A,
        constraint_types=types,
        b=np.zeros(m),
        variables=variables,
        name=f"max_flow_{source}_{sink}",
    )


def solve_shortest_path(
    nr_nodes: int, arcs: Sequence[Arc], source: int, sink: int, config=None,
    device=None,
) -> Optional[float]:
    """Returns the shortest s→t distance, or None if unreachable."""
    from relp_tpu_torch.model.elements import LinearProgramType
    from relp_tpu_torch.simplex.driver import solve_general_form
    from relp_tpu_torch.utils.config import DEFAULT_CONFIG

    res = solve_general_form(shortest_path_lp(nr_nodes, arcs, source, sink),
                             config or DEFAULT_CONFIG, device=device)
    if res.kind is not LinearProgramType.FINITE_OPTIMUM:
        return None
    return res.solution.objective_value


def solve_max_flow(
    nr_nodes: int, arcs: Sequence[Arc], source: int, sink: int, config=None,
    device=None,
) -> float:
    from relp_tpu_torch.model.elements import LinearProgramType
    from relp_tpu_torch.simplex.driver import solve_general_form
    from relp_tpu_torch.utils.config import DEFAULT_CONFIG

    res = solve_general_form(max_flow_lp(nr_nodes, arcs, source, sink),
                             config or DEFAULT_CONFIG, device=device)
    if res.kind is not LinearProgramType.FINITE_OPTIMUM:
        raise ValueError(f"max-flow LP: {res.kind}")
    return res.solution.objective_value
