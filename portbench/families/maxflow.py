"""The maximum flow of a random network, A held sparse.

A plain NumPy copy of ``relp_tpu_torch/models/networks.py::random_arcs`` and
``max_flow_lp``: ``nodes`` nodes, ``arcs_per_node · nodes`` distinct arcs
``u → v`` (``u ≠ v``) with integer capacities U{1..``max_capacity``}, drawn
from ``default_rng(seed)``; source 0, sink ``nodes − 1``.  The LP has a row
for each other node (+1 where an arc enters it, −1 where one leaves) and
maximises the net flow out of the source, ``0 ≤ x ≤ capacity``.

``extra["flow"]`` is ``scipy.sparse.csgraph.maximum_flow``'s integral flow on
each arc, worked out without the program: a feasible point whose value
``c·flow`` is the optimum.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import maximum_flow

from portbench.families.lp import LP


def random_arcs(nodes: int, arcs_per_node: int, seed, max_capacity: int = 99):
    """``(tail, head, capacity)`` arrays as the port's ``random_arcs`` draws them."""
    rng = np.random.default_rng(seed)
    n_arcs = arcs_per_node * nodes
    if n_arcs > nodes * (nodes - 1):
        raise ValueError("more arcs than distinct node pairs")
    keys = np.zeros(0, dtype=np.int64)
    while keys.size < n_arcs:
        u = rng.integers(0, nodes, n_arcs)
        v = rng.integers(0, nodes - 1, n_arcs)
        v = v + (v >= u)  # skip u itself
        keys = np.concatenate([keys, u * nodes + v])
        _, first = np.unique(keys, return_index=True)
        keys = keys[np.sort(first)][:n_arcs]
    cap = rng.integers(1, max_capacity + 1, n_arcs)
    return keys // nodes, keys % nodes, cap.astype(np.float64)


def arc_flow(nodes: int, tail, head, capacity) -> np.ndarray:
    """A maximum flow from node 0 to node ``nodes − 1`` on each arc, by
    ``scipy.sparse.csgraph.maximum_flow``; the capacities must be whole."""
    cap = np.asarray(capacity)
    if not np.array_equal(cap, np.round(cap)):
        raise ValueError("maximum_flow takes whole capacities")
    graph = sp.csr_matrix((cap.astype(np.int32), (tail, head)), shape=(nodes, nodes))
    net = maximum_flow(graph, 0, nodes - 1).flow  # antisymmetric: net flow u → v
    return np.maximum(np.asarray(net[tail, head]).ravel(), 0).astype(np.float64)


def max_flow_lp(nodes: int, tail, head, capacity, name: str) -> LP:
    """The port's ``max_flow_lp`` with A sparse (CSC), and ``extra["flow"]``."""
    row_of = np.arange(nodes) - 1  # node v's row; the source's and the sink's are -1
    row_of[nodes - 1] = -1
    arcs = np.arange(tail.size)
    out, into = row_of[tail] >= 0, row_of[head] >= 0
    A = sp.csc_matrix((np.concatenate([-np.ones(out.sum()), np.ones(into.sum())]),
                       (np.concatenate([row_of[tail[out]], row_of[head[into]]]),
                        np.concatenate([arcs[out], arcs[into]]))),
                      shape=(nodes - 2, tail.size))
    m, n = A.shape
    return LP(name=name, maximize=True, m=m, n=n, b=np.zeros(m),
              c=(tail == 0).astype(np.float64) - (head == 0),
              lb=np.zeros(n), ub=np.asarray(capacity, np.float64),
              row_names=[f"r{i}" for i in range(m)],
              col_names=[f"arc_{u}_{v}" for u, v in zip(tail, head)],
              sparse=A, extra={"flow": arc_flow(nodes, tail, head, capacity)})


def make(config: dict, seed: int, k: int) -> LP:
    """The configuration's base network (``base_seed``); the kinds draw
    their requests from it."""
    nodes = int(config["nodes"])
    tail, head, cap = random_arcs(nodes, int(config["arcs_per_node"]),
                                  int(config["base_seed"]),
                                  int(config["max_capacity"]))
    return max_flow_lp(nodes, tail, head, cap, f"max_flow_0_{nodes - 1}")
