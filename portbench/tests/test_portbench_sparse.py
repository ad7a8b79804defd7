"""A sparse A through the reference: the operator from the nonzeros against
the dense one, the interior point from either form, and the max-flow family
against the port's generator and against scipy's maximum flow."""

import json
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from portbench.families import dense, maxflow
from portbench.families.lp import LP
from portbench.kinds.base import general_form
from portbench.reference import ipm
from portbench.reference.operator import Operator


def both_ways(lp: LP):
    """``(dense LP, sparse LP)`` of one LP."""
    A = lp.A
    held_dense = A.toarray() if sp.issparse(A) else A
    return (LP(**{**lp.__dict__, "dense": held_dense, "sparse": None}),
            LP(**{**lp.__dict__, "dense": None, "sparse": sp.csr_matrix(held_dense)}))


def small_lps():
    yield dense.make(dict(rows=16, cols=32, upper=2.0, base_seed=3), 0, 0)
    t, h, c = maxflow.random_arcs(64, 8, 7)
    yield maxflow.max_flow_lp(64, t, h, c, "flow64")


def rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("which", [0, 1])
def test_sparse_operator_matches_dense(which):
    d, s = both_ways(list(small_lps())[which])
    dop, sop = Operator(d), Operator(s)
    assert sop.dense is None
    held = sum(t.numel() for t in vars(sop).values() if torch.is_tensor(t))
    if which == 1:
        assert held < d.m * d.n  # the nonzeros alone: no [m, n] array
    rng = np.random.default_rng(which)
    x = torch.as_tensor(rng.normal(size=d.n))
    y = torch.as_tensor(rng.normal(size=d.m))
    theta = torch.as_tensor(rng.uniform(1e-3, 10, size=d.n))
    assert rel(sop.mv(x), dop.mv(x)) <= 1e-13
    assert rel(sop.rmv(y), dop.rmv(y)) <= 1e-13
    assert rel(sop.normal(theta), dop.normal(theta)) <= 1e-13


@pytest.mark.parametrize("which", [0, 1])
def test_reference_objective_from_either_form(which):
    d, s = both_ways(list(small_lps())[which])
    a, b = ipm.solve(d), ipm.solve(s)
    assert abs(a.objective - b.objective) <= 1e-9 * (1 + abs(a.objective))


def test_an_lp_holds_one_form():
    lp = next(small_lps())
    with pytest.raises(ValueError):
        LP(**{**lp.__dict__, "sparse": sp.csr_matrix(lp.dense)})
    with pytest.raises(ValueError):
        LP(**{**lp.__dict__, "dense": None})
    with pytest.raises(ValueError):
        LP(**{**lp.__dict__, "dense": None, "sparse": sp.coo_matrix(lp.dense)})


def test_maxflow_matches_the_port():
    from relp_tpu_torch.models.networks import max_flow_lp, random_arcs

    N = 64
    lp = maxflow.make(dict(nodes=N, arcs_per_node=8, base_seed=7, max_capacity=99), 0, 0)
    port = max_flow_lp(N, random_arcs(N, 8, seed=7), 0, N - 1)
    mine = general_form(lp)
    assert sp.issparse(lp.sparse) and lp.dense is None
    assert np.array_equal(mine.A.toarray(), port.A.toarray())
    assert np.array_equal(lp.sparse.toarray(), port.A.toarray())
    assert np.array_equal(mine.b, port.b) and mine.objective == port.objective
    for got in (mine, port):
        assert [v.cost for v in got.variables] == list(lp.c)
        assert [(v.lower, v.upper) for v in got.variables] == list(zip(lp.lb, lp.ub))
        assert [v.name for v in got.variables] == lp.col_names
        assert got.row_names == lp.row_names


def flow_is_feasible(lp: LP):
    f = lp.extra["flow"]
    assert np.array_equal(f, np.round(f)) and np.all(f >= 0) and np.all(f <= lp.ub)
    assert np.abs(lp.sparse @ f).max() == 0


def cut(lp: LP, tail, head, seed: int, arcs: int = 16):
    """``lp`` with ``arcs`` flow-carrying arcs, drawn from ``seed``, cut to
    half their flow, and the cut network's maximum flow value (scipy's, on
    the capacities doubled, so that they stay whole)."""
    carrying = np.flatnonzero(lp.extra["flow"] > 0)
    J = np.random.default_rng(seed).choice(carrying, arcs, replace=False)
    ub = lp.ub.copy()
    ub[J] = lp.extra["flow"][J] / 2
    value = lp.c @ maxflow.arc_flow(lp.m + 2, tail, head, 2 * ub) / 2
    return LP(**{**lp.__dict__, "ub": ub, "name": lp.name + "_cut"}), value


def check_flow(nodes: int, device: str):
    """The reference on the base network (seed 7) and on one cut: its KKT,
    its objective against scipy's flow value, and its seconds."""
    tail, head, cap = maxflow.random_arcs(nodes, 8, 7)
    lp = maxflow.max_flow_lp(nodes, tail, head, cap, f"max_flow_0_{nodes - 1}")
    flow_is_feasible(lp)
    cut_lp, cut_value = cut(lp, tail, head, 11)
    readings = []
    for case, value in ((lp, lp.c @ lp.extra["flow"]), (cut_lp, cut_value)):
        t0 = time.perf_counter()
        ref = ipm.solve(case, torch.float64, device)
        seconds = time.perf_counter() - t0
        assert ref.kkt <= 1e-8
        assert abs(ref.objective - value) <= 1e-9 * abs(value)
        readings.append(dict(lp=case.name, objective=ref.objective, flow=float(value),
                             kkt=ref.kkt, seconds=seconds))
    return readings


def test_reference_finds_the_maximum_flow():
    check_flow(128, "cpu")


@pytest.mark.cuda
def test_reference_finds_the_maximum_flow_on_the_card():
    """N = 4,096 (4,094 rows × 32,768 arcs): the seconds of each solve and
    the peak device memory go to standard output as one JSON line."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.cuda.reset_peak_memory_stats()
    readings = check_flow(4096, "cuda")
    peak = torch.cuda.max_memory_allocated()
    print(json.dumps({"maxflow_reference": readings, "memory_peak_bytes": peak,
                      "card": torch.cuda.get_device_name()}))
    assert peak < 2**30
