"""Batched solves of the port against the JAX package on the CPU:
``relp_tpu_torch.parallel.solve_batched`` (the lane-batched primal of
``simplex/core.py::solve_core_lanes``) against
``relp_tpu.parallel.batched.solve_batched`` without a mesh, and
``relp_tpu_torch.simplex.driver.solve_general_forms_batched`` against the
JAX driver's (run with ``bucket_shapes=False``, which pads as the port
does).

Fixtures: the seeded problems of tests/test_parallel.py::problem at
(16, 64) × 4 and (8, 32) × 3, shared and stacked; a shared-A fleet of
``dense_lp(32, 64)`` with 4 scenarios perturbed as bench.py's fleet suite
perturbs them (3 % in demand and cost, numpy seed 20260819); a mixed suite
(WIKI_MPS, the inline MPS of tests/test_mps_parse.py, a dense LP, an LP
presolve settles).  Per lane: status equal, iterations equal, objective
within 1e-9 relative, the basis equal (the optima are unique); every lane
stays under 200 iterations, the JAX package's least chunk, so no chunked
continuation changes the JAX trajectory.  Duals in original row units are
held against the port's single solve of each LP.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import relp_tpu  # noqa: F401  (x64 on the CPU backend)
from relp_tpu.io.mps_convert import mps_to_general_form as jax_to_general
from relp_tpu.io.mps_parse import parse_free as jax_parse_free
from relp_tpu.model import elements as jax_el
from relp_tpu.model import general_form as jax_gf
from relp_tpu.parallel.batched import solve_batched as jax_solve_batched
from relp_tpu.simplex.driver import solve_general_forms_batched as jax_fleet
from relp_tpu.utils.config import SolverConfig as JaxConfig
from relp_tpu_torch import interop
from relp_tpu_torch.io.mps_convert import mps_to_general_form as torch_to_general
from relp_tpu_torch.io.mps_parse import parse_free as torch_parse_free
from relp_tpu_torch.model import elements as torch_el
from relp_tpu_torch.model import general_form as torch_gf
from relp_tpu_torch.parallel import solve_batched
from relp_tpu_torch.simplex import status as st
from relp_tpu_torch.simplex.core import solve_core
from relp_tpu_torch.simplex.driver import solve_general_form, solve_general_forms_batched
from relp_tpu_torch.utils.config import SolverConfig
from tests.test_mps_parse import TESTPROB
from tests.test_pipeline_fixture import WIKI_MPS


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def problem(m, n, seed):
    """tests/test_parallel.py::problem."""
    rng = np.random.default_rng(seed)
    A = np.where(rng.random((m, n)) < 0.3, rng.standard_normal((m, n)), 0.0)
    A[np.arange(m), rng.integers(0, n, m)] = 1.0
    b = A @ rng.random(n)
    c = rng.standard_normal(n)
    return A, b, c, np.zeros(n), np.full(n, 10.0)


def _stack(m, n, lanes, shared, seed0=10):
    probs = [problem(m, n, seed0 + i) for i in range(lanes)]
    if shared:
        probs = [(probs[0][0],) + p[1:] for p in probs]
    A, b, c, lb, ub = (np.stack(a) for a in zip(*probs))
    return (A[0] if shared else A), b, c, lb, ub


def _same_lanes(out, ref):
    np.testing.assert_array_equal(out.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(out.it.numpy(), np.asarray(ref.it))
    assert int(out.it.max()) < 200  # inside the JAX package's least chunk
    np.testing.assert_allclose(out.obj.numpy(), np.asarray(ref.obj), rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(out.basis.numpy(), np.asarray(ref.basis))
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("m,n,lanes", [(16, 64, 4), (8, 32, 3)])
@pytest.mark.parametrize("shared", [False, True])
def test_solve_batched_matches_the_jax_package(m, n, lanes, shared):
    arrays = _stack(m, n, lanes, shared)
    ref = jax_solve_batched(*arrays, cfg=JaxConfig(), max_iter=500)
    out = solve_batched(*arrays, cfg=SolverConfig(), max_iter=500, device="cpu")
    assert np.all(np.asarray(ref.status) == st.OPTIMAL)
    _same_lanes(out, ref)
    # the stacked output goes to the JAX package's field names and back
    back = interop.solve_output_from_numpy(interop.solve_output_to_numpy(out), device="cpu")
    assert torch.equal(back.basis, out.basis) and back.x.shape == (lanes, n)


@pytest.mark.parametrize("cfg", [dict(mixed_pricing=False),
                                 dict(pricing="dantzig", refactor_mode="full")])
def test_solve_batched_options_match_the_jax_package(cfg):
    arrays = _stack(16, 64, 4, shared=True)
    ref = jax_solve_batched(*arrays, cfg=JaxConfig(**cfg), max_iter=500)
    out = solve_batched(*arrays, cfg=SolverConfig(**cfg), max_iter=500, device="cpu")
    _same_lanes(out, ref)


def _warm(arrays, shared):
    """Each lane's optimal basis for its problem with b moved by 2 %: a
    warm start a few pivots from the optimum, some lanes already there."""
    A, b, c, lb, ub = arrays
    base = solve_batched(A, b, c, lb, ub, cfg=SolverConfig(), max_iter=500, device="cpu")
    n = c.shape[1]
    b2 = b * (1.0 + 0.02 * np.random.default_rng(5).standard_normal(b.shape))
    b2[0] = b[0]  # lane 0 starts at its optimum
    return (A, b2, c, lb, ub), dict(
        basis0=base.basis.numpy(), vstat0=base.vstat.numpy()[:, :n],
        art_sign0=base.art_sign.numpy(), phase0=np.ones(len(b), np.int64))


@pytest.mark.parametrize("shared", [False, True])
def test_warm_starts_match_the_jax_package(shared):
    arrays, warm = _warm(_stack(16, 64, 4, shared), shared)
    jwarm = {k: (v.astype(np.int32) if v.dtype.kind == "i" else v) for k, v in warm.items()}
    ref = jax_solve_batched(*arrays, cfg=JaxConfig(), max_iter=500, warm=jwarm)
    out = solve_batched(*arrays, cfg=SolverConfig(), max_iter=500, warm=warm, device="cpu")
    _same_lanes(out, ref)


def test_a_lane_that_finishes_early_stops_changing():
    """Lane 0 starts at its optimum and stops after a few steps; the others
    start from the all-artificial basis and run 10+ iterations more.  Every
    lane ends where its own single solve ends: equal iterations, basis,
    statuses and x."""
    arrays, warm = _warm(_stack(16, 64, 4, shared=True), True)
    A, b, c, lb, ub = (torch.tensor(v) for v in arrays)
    m, n = A.shape
    warm["basis0"][1:] = n + np.arange(m)
    warm["vstat0"][1:] = st.NB_LOWER
    out = solve_batched(A, b, c, lb, ub, cfg=SolverConfig(), max_iter=500, device="cpu",
                        warm=warm)
    its = out.it.tolist()
    assert max(its) - its[0] >= 10
    for s in range(len(its)):
        one = solve_core(A, b[s], c[s], lb[s], ub[s], SolverConfig(), 500,
                         basis0=torch.tensor(warm["basis0"][s]),
                         vstat0=torch.tensor(warm["vstat0"][s]),
                         art_sign0=torch.tensor(warm["art_sign0"][s]), phase0=1)
        assert int(one.it) == its[s] and int(one.status) == int(out.status[s])
        assert torch.equal(one.basis, out.basis[s]) and torch.equal(one.vstat, out.vstat[s])
        torch.testing.assert_close(one.x, out.x[s], rtol=1e-12, atol=1e-12)


def test_solve_batched_over_a_mesh():
    """The lanes of a shared A solve over the 'batch' rows of a mesh (three
    rows of one lane each) as they solve unmeshed, and a lane count that
    does not divide over 'batch' raises."""
    from relp_tpu_torch.parallel import make_solver_mesh

    arrays = _stack(8, 32, 3, True)
    mesh = make_solver_mesh(batch=3, cols=1, devices=["cpu"] * 3)
    out = solve_batched(*arrays, cfg=SolverConfig(), max_iter=100, mesh=mesh)
    flat = solve_batched(*arrays, cfg=SolverConfig(), max_iter=100, device="cpu")
    assert out.status.tolist() == flat.status.tolist() and out.it.tolist() == flat.it.tolist()
    assert torch.equal(out.basis, flat.basis)
    torch.testing.assert_close(out.obj, flat.obj, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="do not divide"):
        solve_batched(*arrays, cfg=SolverConfig(), max_iter=100,
                      mesh=make_solver_mesh(batch=2, cols=1, devices=["cpu"] * 2))


def dense_fleet(el, gf, m=32, n=64, lanes=4):
    """bench.py's DENSE fleet (relp_tpu_torch/models/dense.py's base LP,
    demand and cost moved 3 % per scenario, numpy seed 20260819)."""
    rng = np.random.default_rng(20260819)
    zb, zc = rng.standard_normal((lanes, 30_000)), rng.standard_normal((lanes, 30_000))
    g = np.random.default_rng(0xDE55E)
    A = g.uniform(0.05, 1.0, (m, n))
    x0, c0 = g.uniform(0.2, 1.0, n), g.uniform(0.1, 1.0, n)
    out = []
    for s in range(lanes):
        xs, cs = x0 * (1 + 0.03 * zb[s, :n]), c0 * (1 + 0.03 * zc[s, :n])
        out.append(gf.GeneralForm(
            objective=el.Objective.MINIMIZE, A=sp.csc_matrix(A),
            constraint_types=[el.RangedConstraintRelation.equal()] * m, b=A @ xs,
            variables=[gf.Variable(f"x{j}", cost=cs[j], lower=0.0, upper=2.0) for j in range(n)],
            name=f"dense{s}"))
    return out


def _compare_fleets(jax_res, torch_res, singles=None, iterations=True):
    for s, (a, b) in enumerate(zip(jax_res, torch_res)):
        assert a.kind.value == b.kind.value, s
        if iterations and a.simplex is not None:
            assert a.simplex.iterations == b.simplex.iterations, s
        if a.solution is not None:
            assert b.solution.objective_value == pytest.approx(a.solution.objective_value,
                                                               rel=1e-9, abs=1e-9)
        if singles is not None and singles[s].simplex is not None:
            # duals in original row units, as the single solve gives them
            np.testing.assert_allclose(b.simplex.duals, singles[s].simplex.duals,
                                       rtol=1e-7, atol=1e-7)


@pytest.mark.parametrize("warm", [False, True])
def test_dense_fleet_matches_the_jax_driver(warm):
    stats = []
    got = solve_general_forms_batched(dense_fleet(torch_el, torch_gf),
                                      SolverConfig(pdlp_fleet_warm=warm), device="cpu",
                                      stats=stats)
    ref = jax_fleet(dense_fleet(jax_el, jax_gf),
                    JaxConfig(pdlp_fleet_warm=warm, bucket_shapes=False))
    singles = [solve_general_form(g, SolverConfig(), device="cpu")
               for g in dense_fleet(torch_el, torch_gf)]
    _compare_fleets(ref, got, singles)
    assert [g["engine"] for g in stats] == ["primal"] and stats[0]["shared_A"]
    assert ("base_iterations" in stats[0]) == warm


def _settled(el, gf):
    """An LP that presolve settles: one bounded column, no rows left."""
    return gf.GeneralForm(
        objective=el.Objective.MINIMIZE, A=sp.csc_matrix(np.array([[1.0, 1.0]])),
        constraint_types=[el.RangedConstraintRelation.equal()], b=np.array([2.0]),
        variables=[gf.Variable("a", cost=1.0, lower=0.0, upper=5.0),
                   gf.Variable("b", cost=3.0, lower=2.0, upper=2.0)], name="settled")


def _suite(el, gf, to_general, parse):
    return ([to_general(parse(t)) for t in (WIKI_MPS, TESTPROB, WIKI_MPS)]
            + [dense_fleet(el, gf, 24, 40, 1)[0], _settled(el, gf)])


@pytest.mark.parametrize("algorithm", ["primal", "dual"])
def test_mixed_suite_matches_the_jax_driver(algorithm):
    stats = []
    got = solve_general_forms_batched(
        _suite(torch_el, torch_gf, torch_to_general, torch_parse_free),
        SolverConfig(algorithm=algorithm), device="cpu", stats=stats)
    ref = jax_fleet(_suite(jax_el, jax_gf, jax_to_general, jax_parse_free),
                    JaxConfig(algorithm=algorithm, bucket_shapes=False))
    singles = [solve_general_form(g, SolverConfig(), device="cpu")
               for g in _suite(torch_el, torch_gf, torch_to_general, torch_parse_free)]
    # the singleton goes to the single-solve driver, whose dual runs another
    # ratio test by default (ROADMAP queue 3): status, objective and duals
    _compare_fleets(ref, got, singles, iterations=algorithm == "primal")
    assert [r.simplex.iterations for r in got[:3]] == [r.simplex.iterations for r in ref[:3]]
    assert got[0].solution.objective_value == pytest.approx(-8.0)
    assert got[4].simplex is None  # presolve settled it: it never reached an engine
    # the two WIKI_MPS and TESTPROB share a padded shape: one lane-batched group
    assert [g["lanes"] for g in stats] == [3]
