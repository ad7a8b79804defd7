"""Branch and bound (relp_tpu_torch/models/branch_bound.py::solve_mip) on
capacitated facility location at CPU sizes: both roots against the plain
enumeration reference (portbench/reference/mip.py) and HiGHS, the
incumbent's certificate through the benchmark's judge, cuts at an aligned
row count, the device LU's tableau rows against SciPy's, and the ``mip``
record's counters, spans and children."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.families import cfl
from portbench.kinds.mip import highs_optimum, program_form, reduced
from portbench.reference import certificate, ipm
from portbench.reference.mip import enumerate_optimum
from portbench.reference.operator import Operator
from relp_tpu_torch.model import elements as el
from relp_tpu_torch.model.general_form import GeneralForm, Variable
from relp_tpu_torch.models.branch_bound import (
    _host_tableau_rows, device_tableau_rows, solve_mip,
)
from relp_tpu_torch.ops.amatrix import DenseMatrix
from relp_tpu_torch.simplex import status as st
from relp_tpu_torch.simplex.core import solve_core
from relp_tpu_torch.utils import metrics
from relp_tpu_torch.utils.config import DEFAULT_CONFIG, SolverConfig

CASES = [(4, 6, 0), (4, 6, 1), (5, 8, 0), (5, 8, 1), (5, 8, 2)]
ROOTS = ["primal", "dual"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Vectors of tens of elements: a pool of threads only slows each step."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def instance(nf, nc, k):
    return cfl.make({"facilities": nf, "customers": nc, "ratio": 3.0, "base_seed": 1991}, 0, k)


_ENUMERATED: dict = {}


def enumerated(nf, nc, k):
    if (nf, nc, k) not in _ENUMERATED:
        lp = instance(nf, nc, k)
        _ENUMERATED[nf, nc, k] = enumerate_optimum(lp, np.flatnonzero(lp.extra["integer"]))
    return _ENUMERATED[nf, nc, k]


def last(call):
    return [r for r in metrics.recent() if r.call == call][-1]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("root", ROOTS)
def test_solve_mip_finds_the_enumerated_optimum(case, root):
    lp = instance(*case)
    res = solve_mip(program_form(lp, lp.name), SolverConfig(algorithm=root), device="cpu")
    best, y = enumerated(*case)
    assert res.is_optimal and np.isfinite(best)
    assert res.objective == pytest.approx(best, rel=1e-9, abs=1e-9)
    nf = case[0]
    assert [res.values[f"y{i}"] for i in range(nf)] == list(y)
    assert last("mip").engine == root


@pytest.mark.parametrize("case", CASES)
def test_highs_agrees_with_the_enumeration(case):
    lp = instance(*case)
    obj, x = highs_optimum(lp)
    best, y = enumerated(*case)
    assert obj == pytest.approx(best, rel=1e-9, abs=1e-9)
    np.testing.assert_array_equal(np.round(x[: case[0]]), y)


@pytest.mark.parametrize("case", CASES)
def test_the_incumbents_leaf_lp_certifies_it(case):
    """The certificate's node LP, made again by the benchmark's kind in its
    equality form (fixed columns out), reads ``res`` and ``gap`` ≤ 1e-9 at the
    certificate's x and duals, and its objective is the reference's."""
    lp = instance(*case)
    res = solve_mip(program_form(lp, lp.name), SolverConfig(algorithm="dual"), device="cpu")
    cert = res.certificate
    assert cert is not None and cert.pi.shape[0] >= lp.m + len(cert.deltas)
    red = reduced(lp, cert.lb, cert.ub, cert.gammas, cert.deltas, "leaf")
    x = np.concatenate([cert.x[: lp.n], cert.x[cert.cut_cols]])
    pi = np.concatenate([cert.pi[: lp.m], cert.pi[cert.cut_rows]])
    fixed = ~np.isnan(red.value)
    np.testing.assert_allclose(x[fixed], red.value[fixed], rtol=0, atol=1e-9)
    op = Operator(red.lp, torch.float64, "cpu")
    ref = ipm.solve(red.lp, torch.float64, "cpu", op=op)
    got = certificate.measures(red.lp, op, float(red.lp.c @ x[red.cols]), x[red.cols],
                               pi[red.rows], ref.objective)
    assert got["res"] <= 1e-9 and got["gap"] <= 1e-9 and got["obj"] <= 1e-8
    # the whole LP's objective is the MIP's
    assert red.constant + float(red.lp.c @ x[red.cols]) == pytest.approx(res.objective,
                                                                         rel=1e-9)


def _aligned_mip():
    """Nine binaries in a ring of eight rows, ``2xᵢ + 2xᵢ₊₁ + x₈ ≤ 3``,
    maximise Σ x: the root LP is fractional, and its eight rows fill the
    padding's alignment of 8 exactly."""
    A = np.zeros((8, 9))
    for i in range(8):
        A[i, i] = A[i, (i + 1) % 8] = 2.0
        A[i, 8] = 1.0
    rel = el.RangedConstraintRelation
    return GeneralForm(
        objective=el.Objective.MAXIMIZE, A=sp.csc_matrix(A),
        constraint_types=[rel.less() for _ in range(8)], b=np.full(8, 3.0),
        variables=[Variable(f"x{j}", cost=1.0, lower=0.0, upper=1.0,
                            variable_type=el.VariableType.INTEGER) for j in range(9)])


def test_cuts_get_room_at_an_aligned_row_count():
    general = _aligned_mip()
    assert general.A.shape[0] % DEFAULT_CONFIG.row_align == 0
    res = solve_mip(general, SolverConfig(), device="cpu")
    rec = last("mip")
    assert rec.cut_rounds >= 1 and rec.cuts > 0
    assert rec.m_padded >= 8 + 16 * 4
    A = general.A.toarray()  # the optimum by brute force over the 2⁹ settings
    best = max(sum(bits) for bits in np.ndindex(*(2,) * 9)
               if np.all(A @ np.array(bits) <= 3.0))
    assert res.is_optimal and res.objective == pytest.approx(best)


@pytest.mark.parametrize("case", [(4, 6, 0), (5, 8, 2)])
def test_device_tableau_rows_equal_scipys(case):
    lp = instance(*case)
    general = program_form(lp, lp.name)
    from relp_tpu_torch.model.computational_form import build_computational_form
    from relp_tpu_torch.simplex.driver import _round_up

    cf = build_computational_form(general, scale=False)
    m_pad, n_pad = _round_up(cf.m, 8), _round_up(cf.n, 128)
    A = np.zeros((m_pad, n_pad))
    A[: cf.m, : cf.n] = sp.csc_matrix(cf.A).toarray()
    vecs = [np.zeros(k) for k in (m_pad, n_pad, n_pad, n_pad)]
    for v, w in zip(vecs, (cf.b, cf.c, cf.lb, cf.ub)):
        v[: len(w)] = w
    root = solve_core(*(torch.tensor(v) for v in [A] + vecs), DEFAULT_CONFIG,
                      DEFAULT_CONFIG.resolve_max_iter(m_pad, n_pad))
    assert int(root.status) == st.OPTIMAL
    rows = list(range(0, m_pad, 3))
    host = np.array(_host_tableau_rows(A, root.basis.numpy(), root.art_sign.numpy(), rows))
    dev = device_tableau_rows(DenseMatrix(torch.tensor(A)), root.basis, root.art_sign, rows)
    np.testing.assert_allclose(dev, host, rtol=0, atol=1e-12)


def test_the_mip_record_counts_the_search():
    """One ``mip`` record a solve: its counters, its spans while a profiler
    records, and a ``reoptimize`` record for each child naming it parent."""
    lp = instance(5, 8, 0)
    general = program_form(lp, lp.name)
    with profile(activities=[ProfilerActivity.CPU]):
        res = solve_mip(general, SolverConfig(algorithm="dual"), device="cpu")
    rec = last("mip")
    kids = [r for r in metrics.recent() if r.parent == rec.solve_id]
    assert rec.status == res.kind.value and rec.engine == "dual"
    assert (rec.nodes, rec.lp_iterations) == (res.nodes, res.lp_iterations) and res.nodes > 1
    assert all(r.call == "reoptimize" for r in kids) and len(kids) == res.nodes - 1
    # every child is answered by the dual (an infeasible one on its proof),
    # so the records count the result's iterations
    assert all(r.engine == "dual" for r in kids)
    assert rec.iterations + sum(r.iterations for r in kids) == res.lp_iterations
    assert rec.node_start_misses == sum(r.start_inverse_hits == 0 for r in kids) > 0
    assert rec.incumbents >= 1 and rec.cut_rounds >= 1 and rec.cuts > 0
    assert rec.m_padded > lp.m and rec.inverse_bytes > 0
    for name in ("mip.solve", "mip.root", "mip.cuts", "mip.tree"):
        assert rec.spans[name][0] >= 1
    assert rec.spans["mip.node"][0] == len(kids)
    assert rec.spans["mip.cuts"][0] == rec.cut_rounds
    # spans are off without a profiler
    solve_mip(general, SolverConfig(algorithm="dual"), device="cpu")
    assert last("mip").spans == {}


@pytest.mark.parametrize("case", [(5, 8, 0), (5, 8, 2)])
def test_the_dual_search_prunes_an_infeasible_child_on_the_duals_proof(case):
    """Under ``"dual"`` an infeasible child ends at the dual's proof; under
    ``"primal"`` the warm primal fallback decides it, as in the JAX package.
    Both searches find the same optimum."""
    lp = instance(*case)
    general = program_form(lp, lp.name)
    kids, objective = {}, {}
    for root in ROOTS:
        res = solve_mip(general, SolverConfig(algorithm=root), device="cpu")
        rec = last("mip")
        kids[root] = {(r.engine, r.status) for r in metrics.recent()
                      if r.parent == rec.solve_id and r.status == "infeasible"}
        objective[root] = res.objective
    assert kids["dual"] == {("dual", "infeasible")}
    assert kids["primal"] == {("dual→primal", "infeasible")}
    assert objective["dual"] == pytest.approx(objective["primal"], rel=1e-9)
