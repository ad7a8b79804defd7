"""``driver.device_problem`` (a computational form padded and on the device,
with the operator that ``matrix_format`` picks) and what a solve's record
says it ran on: ``matrix_format`` and ``inverse_bytes``.

Warm re-solves of a max flow after its capacity cuts (arcs that carry flow
cut to half their flow, as portbench's ``kinds/cut.py`` draws them) on the
ELL and on the dense operator agree in status and objective with each
other and with scipy's maximum flow, and each x meets A x = b and its
bounds; the x's are not compared, since a max flow has many optimal
vertices and the two operators round differently.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import maximum_flow

from relp_tpu_torch.model.computational_form import build_computational_form
from relp_tpu_torch.model.elements import Objective, RangedConstraintRelation
from relp_tpu_torch.model.general_form import GeneralForm, Variable
from relp_tpu_torch.models.networks import max_flow_lp, random_arcs
from relp_tpu_torch.simplex import driver
from relp_tpu_torch.simplex import status as st
from relp_tpu_torch.simplex.driver import device_problem, solve_computational_form
from relp_tpu_torch.simplex.reoptimize import reoptimize_with_bounds
from relp_tpu_torch.utils import metrics
from relp_tpu_torch.utils.config import SolverConfig

DUAL = SolverConfig(algorithm="dual", scale=False, presolve=False)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def flow_form(nodes):
    """The computational form of the max flow on ``random_arcs(nodes, 8, 7)``
    and the arcs."""
    arcs = random_arcs(nodes, 8, seed=7)
    return build_computational_form(max_flow_lp(nodes, arcs, 0, nodes - 1), scale=False), arcs


def dense_form(m, n, seed=3):
    """min c·x, A x = A x0, 0 <= x <= 2, A dense (portbench's dense family)."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.05, 1.0, (m, n))
    b, c = A @ rng.uniform(0.2, 1.0, n), rng.uniform(0.1, 1.0, n)
    general = GeneralForm(
        objective=Objective.MINIMIZE, A=sp.csc_matrix(A),
        constraint_types=[RangedConstraintRelation.equal()] * m, b=b,
        variables=[Variable(f"x{j}", cost=float(c[j]), lower=0.0, upper=2.0) for j in range(n)],
        name="dense", row_names=[f"r{i}" for i in range(m)])
    return build_computational_form(general, scale=False)


def arc_flow(nodes, arcs, capacity):
    """scipy's maximum flow from node 0 to node ``nodes − 1`` on each arc
    (whole capacities)."""
    tail, head = (np.array([a[i] for a in arcs]) for i in (0, 1))
    graph = sp.csr_matrix((np.asarray(capacity, np.int32), (tail, head)), shape=(nodes, nodes))
    net = maximum_flow(graph, 0, nodes - 1).flow
    return np.maximum(np.asarray(net[tail, head]).ravel(), 0).astype(np.float64)


@pytest.mark.parametrize("case, fmt, want", [
    ("flow1024", "auto", "ell"), ("dense32x64", "auto", "dense"),
    ("dense32x64", "ell", "ell"), ("flow128", "ell", "ell"), ("flow1024", "ell", "ell"),
])
def test_the_operator_matrix_format_picks(case, fmt, want):
    cf = flow_form(int(case[4:]))[0] if case.startswith("flow") else dense_form(32, 64)
    P = device_problem(cf, dataclasses.replace(DUAL, matrix_format=fmt), "cpu")
    assert P.A.format == want
    assert P.A.shape == (P.m_pad, P.n_pad) and P.A.device.type == "cpu"
    for v, size in ((P.b, P.m_pad), (P.c, P.n_pad), (P.lb, P.n_pad), (P.ub, P.n_pad)):
        assert v.dtype == torch.float64 and v.shape == (size,)


@pytest.mark.parametrize("algorithm", ["dual", "primal"])
@pytest.mark.parametrize("case", ["flow128", "dense32x64"])
def test_padded_as_the_solve_pads(monkeypatch, case, algorithm):
    """The vectors, sizes, budget and format equal those of the padding that
    ``solve_computational_form`` makes; its record names the format, and
    ``inverse_bytes`` where the device dual ran."""
    cf = flow_form(128)[0] if case == "flow128" else dense_form(32, 64)
    cfg = dataclasses.replace(DUAL, algorithm=algorithm)
    made, real = [], driver._Padded.of

    def keep(*args):
        made.append(real(*args))
        return made[-1]

    monkeypatch.setattr(driver._Padded, "of", keep)
    res = solve_computational_form(cf, cfg, device="cpu")
    rec = metrics.recent()[-1]
    assert res.is_optimal and rec.call == "solve"
    P = device_problem(cf, cfg, "cpu")
    p = made[0]
    for got, want in ((P.b, p.b), (P.c, p.c), (P.lb, p.lb), (P.ub, p.ub)):
        assert np.array_equal(got.numpy(), want)
    assert (P.m_pad, P.n_pad, P.max_iter) == (p.m_pad, p.n_pad, p.max_iter)
    assert P.A.format == p.device_A().format == rec.matrix_format
    assert rec.inverse_bytes == (P.m_pad ** 2 * 8 if algorithm == "dual" else 0)


@pytest.fixture(scope="module")
def flow128():
    """The max flow N = 128 solved cold by the dual, and scipy's flow."""
    nodes = 128
    cf, arcs = flow_form(nodes)
    root = solve_computational_form(cf, DUAL, device="cpu")
    assert root.is_optimal
    capacity = np.array([a[2] for a in arcs])
    # the net flow out of the source, per unit of each arc's flow
    source = np.array([(u == 0) - (v == 0) for u, v, _ in arcs], np.float64)
    prior = SimpleNamespace(**{k: torch.as_tensor(getattr(root, k))
                               for k in ("basis", "vstat", "art_sign")})
    return dict(nodes=nodes, cf=cf, arcs=arcs, prior=prior, capacity=capacity, source=source,
                flow=arc_flow(nodes, arcs, capacity))


@pytest.mark.parametrize("member", [0, 1, 2, 3])
def test_cut_resolves_on_ell_and_dense_agree(flow128, member):
    F = flow128
    cf, flow = F["cf"], F["flow"]
    carrying = np.flatnonzero(flow > 0)
    J = np.random.default_rng([17, member]).choice(carrying, 16, replace=False)
    cut = F["capacity"].copy()
    cut[J] = flow[J] / 2
    # scipy's maximum flow of the cut network, on capacities doubled to stay whole
    value = F["source"] @ arc_flow(F["nodes"], F["arcs"], 2 * cut) / 2
    objectives = {}
    for fmt in ("ell", "dense"):
        P = device_problem(cf, dataclasses.replace(DUAL, matrix_format=fmt), "cpu")
        ub = P.ub.clone()
        ub[torch.as_tensor(J)] = torch.as_tensor(flow[J] / 2)
        out = reoptimize_with_bounds(P.A, P.b, P.c, P.lb, ub, F["prior"], config=DUAL,
                                     max_iter=P.max_iter)
        rec = metrics.recent()[-1]
        assert rec.call == "reoptimize" and rec.engine == "dual"
        assert rec.matrix_format == fmt and rec.inverse_bytes == P.m_pad ** 2 * 8
        assert int(out.status) == st.OPTIMAL
        x = out.x.numpy()[: cf.n]
        assert np.abs(cf.A @ x - cf.b).max() <= 1e-9
        assert x.min() >= -1e-9 and (x - ub.numpy()[: cf.n]).max() <= 1e-9
        objectives[fmt] = -float(out.obj)  # the engine minimises the negated flow
    assert abs(objectives["ell"] - objectives["dense"]) <= 1e-9 * abs(objectives["dense"])
    assert abs(objectives["dense"] - value) <= 1e-9 * value

