"""Goldfarb and Grigoriadis's RMF maximum-flow networks, as the DIMACS
generator ``genrmf`` lays them out, A held sparse.

``frames`` frames of ``frame × frame`` grid nodes.  In a frame every node has
an arc to each of its grid neighbours, both ways, of capacity
``c2 · frame²``; node i of frame f has one arc to node π_f(i) of frame f + 1,
π_f a random permutation, of capacity U{``c1``..``c2``}.  The source is the
first node of the first frame, the sink the last node of the last one.
Node (f, r, q) is numbered ``f · frame² + r · frame + q``, so the source is 0
and the sink ``nodes − 1``, and the LP is ``families/maxflow.py``'s: a row
for each other node, the net flow out of the source maximised,
``0 ≤ x ≤ capacity``, and ``extra["flow"]`` SciPy's maximum flow on each arc.

The permutations and capacities come from ``default_rng(base_seed)``, not
from ``genrmf``'s own random generator: the network is one of the family,
not the file ``genrmf`` writes for a seed.
"""

from __future__ import annotations

import numpy as np

from portbench.families.lp import LP
from portbench.families.maxflow import max_flow_lp


def rmf_arcs(frame: int, frames: int, c1: int, c2: int, seed):
    """``(tail, head, capacity)`` arrays of the RMF network, sorted by tail
    and head."""
    rng = np.random.default_rng(seed)
    a2 = frame * frame
    node = np.arange(frames * a2).reshape(frames, frame, frame)
    pairs = [(node[:, :, :-1], node[:, :, 1:]), (node[:, :-1, :], node[:, 1:, :])]
    grid_tail = np.concatenate([u.ravel() for u, v in pairs] + [v.ravel() for u, v in pairs])
    grid_head = np.concatenate([v.ravel() for u, v in pairs] + [u.ravel() for u, v in pairs])
    perm = np.stack([rng.permutation(a2) for _ in range(frames - 1)])
    layer = node.reshape(frames, a2)
    next_tail = layer[:-1].ravel()
    next_head = np.take_along_axis(layer[1:], perm, axis=1).ravel()
    next_cap = rng.integers(c1, c2 + 1, next_tail.size)
    tail = np.concatenate([grid_tail, next_tail])
    head = np.concatenate([grid_head, next_head])
    cap = np.concatenate([np.full(grid_tail.size, c2 * a2), next_cap]).astype(np.float64)
    order = np.lexsort((head, tail))
    return tail[order], head[order], cap[order]


def make(config: dict, seed: int, k: int) -> LP:
    """The configuration's base network (``base_seed``); the kinds draw
    their requests from it."""
    frame, frames = int(config["frame"]), int(config["frames"])
    tail, head, cap = rmf_arcs(frame, frames, int(config["c1"]), int(config["c2"]),
                               int(config["base_seed"]))
    return max_flow_lp(frame * frame * frames, tail, head, cap,
                       f"genrmf_{frame}x{frame}x{frames}")
