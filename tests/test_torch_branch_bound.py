"""The port's branch-and-bound (relp_tpu_torch/models/branch_bound.py) against
the JAX package's, on the CPU: the ten cases of tests/test_branch_bound.py on
the port, each held against the JAX package (padded as the port pads,
``bucket_shapes=False``): kinds and objectives equal (1e-9 relative), values
equal where the optimum is unique, node and LP-iteration counts equal where
the searches agree, which they do on all of these."""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import relp_tpu  # noqa: F401  (x64 on the CPU backend)
from relp_tpu.model import elements as jax_el
from relp_tpu.model.general_form import GeneralForm as JaxGeneral
from relp_tpu.model.general_form import Variable as JaxVariable
from relp_tpu.models.branch_bound import _gomory_cuts as jax_gomory_cuts
from relp_tpu.models.branch_bound import solve_mip as jax_solve_mip
from relp_tpu.utils.config import SolverConfig as JaxConfig
from relp_tpu_torch.model import elements as el
from relp_tpu_torch.model.computational_form import build_computational_form
from relp_tpu_torch.model.general_form import GeneralForm, Variable
from relp_tpu_torch.models.branch_bound import MipResult, _gomory_cuts, solve_mip
from relp_tpu_torch.providers.variable import FeasibilityLogic, fractional_mask
from relp_tpu_torch.simplex import status as st
from relp_tpu_torch.simplex.core import solve_core
from relp_tpu_torch.simplex.driver import _round_up
from relp_tpu_torch.simplex.reoptimize import reoptimize_with_bounds
from relp_tpu_torch.utils.config import DEFAULT_CONFIG, SolverConfig

INF = float("inf")
OBJ_REL = 1e-9
MAX, MIN = "MAXIMIZE", "MINIMIZE"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The vectors here are tens of elements: a simplex step is a few hundred
    tiny ops, which a pool of threads only slows down (and, with several test
    workers on one machine, starves the others)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mip(pkg, A, kinds, b, vars_, objective=MIN):
    elements, general, variable = pkg
    rel = elements.RangedConstraintRelation
    mk = {"==": rel.equal, "<=": rel.less, ">=": rel.greater}
    return general(
        objective=getattr(elements.Objective, objective),
        A=sp.csc_matrix(np.asarray(A, float)),
        constraint_types=[mk[k]() for k in kinds],
        b=np.asarray(b, float),
        variables=[variable(
            name=v["name"], cost=v["cost"], lower=v["lower"], upper=v["upper"],
            variable_type=getattr(elements.VariableType, v.get("kind", "CONTINUOUS")))
            for v in vars_],
    )


PORT = (el, GeneralForm, Variable)
JAX = (jax_el, JaxGeneral, JaxVariable)


def IV(name, cost, upper=1.0):
    return dict(name=name, cost=cost, lower=0.0, upper=upper, kind="INTEGER")


def CV(name, cost, upper):
    return dict(name=name, cost=cost, lower=0.0, upper=upper)


def both(spec, opts=None, same_values=True, **kw):
    """Solve one MIP in both packages and hold the port to the JAX result
    (``same_values=False`` where the optimum is not unique)."""
    opts = opts or {}
    rj = jax_solve_mip(_mip(JAX, *spec), JaxConfig(bucket_shapes=False, **opts), **kw)
    rt = solve_mip(_mip(PORT, *spec), SolverConfig(**opts), device="cpu", **kw)
    assert isinstance(rt, MipResult) and rt.kind.value == rj.kind.value
    if rj.objective is not None:
        assert rt.objective == pytest.approx(rj.objective, rel=OBJ_REL, abs=OBJ_REL)
        if same_values:
            assert rt.values == pytest.approx(rj.values, abs=1e-9)
        assert rt.best_bound == pytest.approx(rj.best_bound, rel=OBJ_REL, abs=OBJ_REL)
    # the searches agree on every fixture here: same tree, same pivots
    assert (rt.nodes, rt.lp_iterations) == (rj.nodes, rj.lp_iterations)
    return rt


KNAPSACK = ([[5, 7, 4, 3]], ["<="], [14],
            [IV("a", 8), IV("b", 11), IV("c", 6), IV("d", 4)], MAX)
GENERAL_INT = ([[3, 5], [4, 1]], ["<=", "<="], [14, 9],
               [IV("x", 3, upper=4.0), IV("y", 4, upper=4.0)], MAX)


def test_feasibility_logic():
    fl = FeasibilityLogic(el.VariableType.INTEGER)
    assert fl.is_feasible(3.0) and fl.is_feasible(2.9999999)
    assert not fl.is_feasible(2.5)
    assert fl.closest_feasible(2.6) == 3.0
    cont = FeasibilityLogic(el.VariableType.CONTINUOUS)
    assert cont.is_feasible(2.5) and cont.closest_feasible(2.5) == 2.5
    mask = fractional_mask(np.array([1.0, 1.5, 2.5]), np.array([True, True, False]))
    assert mask.tolist() == [False, True, False]


def test_knapsack():
    # max 8a+11b+6c+4d st 5a+7b+4c+3d <= 14, binary → 21 (b,c,d)
    res = both(KNAPSACK)
    assert res.is_optimal
    assert res.objective == pytest.approx(21.0, abs=1e-6)
    assert res.values == {"a": 0.0, "b": 1.0, "c": 1.0, "d": 1.0}
    assert res.nodes >= 1


def test_integer_rounding_matters():
    # min x+y st x+2y >= 5, 2x+y >= 5, integer → LP relaxation 10/3, integer optimum 4
    # (1, 3), (2, 2) and (3, 1) are all optimal: a tie between two equal
    # ratios parts the packages' pivot paths, the port ends at (1, 3) and the
    # JAX package at (3, 1), in as many nodes and LP iterations
    res = both(([[1, 2], [2, 1]], [">=", ">="], [5, 5],
                [IV("x", 1, upper=10), IV("y", 1, upper=10)]), same_values=False)
    assert res.values["x"] + res.values["y"] == 4.0
    assert res.is_optimal
    assert res.objective == pytest.approx(4.0, abs=1e-6)
    assert res.best_bound <= res.objective + 1e-6


def test_mip_infeasible():
    # x+y == 0.5 has no integer solution
    res = both(([[1, 1]], ["=="], [0.5], [IV("x", 1), IV("y", 1)]))
    assert res.kind is el.LinearProgramType.INFEASIBLE


def test_mixed_integer_continuous():
    # min -x - 10y, x cont in [0, 3.7], y int in [0,2]; x + y <= 4 → y=2, x=2
    res = both(([[1, 1]], ["<="], [4], [CV("x", -1.0, 3.7), IV("y", -10.0, upper=2.0)]))
    assert res.is_optimal
    assert res.values["y"] == 2.0
    assert res.objective == pytest.approx(-22.0, abs=1e-6)


def test_pure_lp_delegates():
    spec = ([[1, 1]], ["<="], [4], [CV("x", -1.0, 3.0), CV("y", -2.0, 3.0)])
    res = solve_mip(_mip(PORT, *spec), device="cpu")
    ref = jax_solve_mip(_mip(JAX, *spec))
    assert res.is_optimal and res.objective == pytest.approx(-7.0, abs=1e-7)
    assert res.objective == pytest.approx(ref.objective, rel=OBJ_REL) and res.nodes == ref.nodes


def test_gomory_cuts_close_root_gap():
    """max x+y st 2x+2y <= 3, x,y binary: the root LP relaxation is
    fractional (x+y = 1.5); one GMI round derives x+y <= 1 (up to scaling)
    and the cut-strengthened root solves integrally with NO branching."""
    spec = ([[2, 2]], ["<="], [3], [IV("x", 1), IV("y", 1)], MAX)
    res = both(spec, cut_rounds=4)
    assert res.is_optimal
    assert res.objective == pytest.approx(1.0)
    assert sorted(res.values.values()) == pytest.approx([0.0, 1.0])
    # the cut made the root integral: 1 root node, no tree
    assert res.nodes == 1

    # plain B&B still gets the optimum, but needs to branch
    res0 = both(spec, cut_rounds=0)
    assert res0.is_optimal
    assert res0.objective == pytest.approx(1.0)
    assert res0.nodes > 1


@pytest.mark.parametrize("rounds", [0, 4])
def test_gomory_cuts_general_integer(rounds):
    """Non-binary integers with a fractional LP vertex: max 3x+4y st
    3x+5y <= 14, 4x+y <= 9, x,y in Z, 0<=x,y<=4 — the LP vertex (31/17, 29/17)
    is fractional; integer optimum 11 at (1, 2).  Cuts must not cut off the
    integer hull."""
    res = both(GENERAL_INT, cut_rounds=rounds)
    assert res.is_optimal
    assert res.objective == pytest.approx(11.0)
    assert res.values["x"] == pytest.approx(1.0)
    assert res.values["y"] == pytest.approx(2.0)


def _padded_root(spec):
    """The padded arrays ``solve_mip`` builds, and the root's primal solve."""
    config = dataclasses.replace(DEFAULT_CONFIG, scale=False, presolve=False)
    cf = build_computational_form(_mip(PORT, *spec), scale=False)
    m_pad, n_pad = _round_up(cf.m, config.row_align), _round_up(cf.n, config.col_align)
    A = np.zeros((m_pad, n_pad))
    A[: cf.m, : cf.n] = sp.csc_matrix(cf.A).toarray()
    b, c, lb, ub = np.zeros(m_pad), np.zeros(n_pad), np.zeros(n_pad), np.zeros(n_pad)
    b[: cf.m], c[: cf.n], lb[: cf.n], ub[: cf.n] = cf.b, cf.c, cf.lb, cf.ub
    mi = config.resolve_max_iter(m_pad, n_pad)
    root = solve_core(*(torch.tensor(v) for v in (A, b, c, lb, ub)), config, mi)
    assert int(root.status) == st.OPTIMAL
    return (A, b, c, lb, ub), root, config, mi, cf


def test_warm_restart_infeasible_child_detected():
    """A warm primal start whose basis is reduced-cost optimal but primal
    INFEASIBLE under tightened bounds must not report OPTIMAL.  Child x>=2,
    y>=2 of the LP below is infeasible (3*2+5*2 > 14)."""
    (A, b, c, lb, ub), root, config, mi, _ = _padded_root(GENERAL_INT)
    lb2 = lb.copy()
    lb2[0], lb2[1] = 2.0, 2.0  # jointly infeasible tightening
    out = reoptimize_with_bounds(A, b, c, lb2, ub, root, config=config, max_iter=mi,
                                 device="cpu")
    assert int(out.status) == st.INFEASIBLE


def test_gomory_cuts_equal_the_jax_packages():
    (A, b, c, lb, ub), root, _, _, cf = _padded_root(GENERAL_INT)
    integer_mask = np.zeros(A.shape[1], bool)
    integer_mask[:2] = True
    args = (A, root.x.numpy(), root.basis.numpy(), root.vstat.numpy(), root.art_sign.numpy(),
            integer_mask, lb, ub, cf.n, 16)
    gammas, deltas = _gomory_cuts(*args)
    gammas_j, deltas_j = jax_gomory_cuts(*args)
    assert len(gammas) == len(gammas_j) > 0
    np.testing.assert_array_equal(np.array(gammas), np.array(gammas_j))
    assert deltas == deltas_j
    # each cut is violated by the fractional root vertex
    assert all(float(g @ root.x.numpy()) < d - 1e-6 for g, d in zip(gammas, deltas))


def test_pseudo_cost_branching_matches_fractional():
    """config.mip_branch: the pseudo-cost product rule must find the same
    optimum as the most-fractional rule on a multi-level knapsack whose tree
    is deep enough for the pseudo-costs to engage."""
    rng = np.random.default_rng(11)
    n = 12
    w = rng.integers(3, 17, n).astype(float)
    p = (w + rng.integers(1, 6, n)).astype(float)
    w2 = rng.integers(1, 9, n).astype(float)
    spec = ([list(w), list(w2)], ["<=", "<="], [float(w.sum() * 0.4), 30.0],
            [IV(f"x{i}", float(p[i]), upper=3.0) for i in range(n)], MAX)
    res_p = both(spec, {"mip_branch": "pseudo"})
    res_f = both(spec, {"mip_branch": "fractional"})
    assert res_p.is_optimal and res_f.is_optimal
    assert res_p.objective == pytest.approx(res_f.objective, abs=1e-6)
