"""The port's fleet engines against the JAX package's on the CPU: the
interior-point fleet (``driver._solve_fleet_ipm``), the first-order fleet
(``driver._solve_fleet_pdlp``) through ``solve_general_forms_batched``, and
``fom.solve_pdhg_batched``; each also against an independent reference.

- IPM fleet: tests/test_batched_driver.py's dense fixture (96 × 192, 3
  lanes, seed 0xD15E).  Against the JAX fleet: equal iterations, objective
  within 1e-6 relative; against HiGHS: 1e-6.  ``ipm_ladder="mixed"`` (the
  f32 rung, then f64; the JAX fleet ignores the ladder) against HiGHS only.
- PDLP fleet: 4 scenarios of ``max_flow_lp(random_arcs(64, 8, seed=7))``,
  each capacity scaled by 1 + 0.03·z (numpy seed 20260819) and rounded to
  thousandths (so that ``scipy.sparse.csgraph.maximum_flow``, which takes
  integers, gives the exact value of each), presolve off.  Against the JAX
  fleet: status equal, objective within 1e-6 relative; against
  ``maximum_flow``: 1e-6.  Also without the warm start and on a stacked
  (not shared) group.
- ``solve_pdhg_batched``: tests/test_pdlp.py's three-scenario LP.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.optimize import linprog
from scipy.sparse.csgraph import maximum_flow

import relp_tpu  # noqa: F401  (x64 on the CPU backend)
from relp_tpu.fom.pdhg import solve_pdhg_batched as jax_pdhg_batched
from relp_tpu.model import elements as jax_el
from relp_tpu.model import general_form as jax_gf
from relp_tpu.models.networks import max_flow_lp as jax_max_flow_lp
from relp_tpu.simplex.driver import solve_general_forms_batched as jax_fleet
from relp_tpu.utils.config import SolverConfig as JaxConfig
from relp_tpu_torch import interop
from relp_tpu_torch.fom import solve_pdhg_batched
from relp_tpu_torch.model import elements as torch_el
from relp_tpu_torch.model import general_form as torch_gf
from relp_tpu_torch.models.networks import max_flow_lp, random_arcs
from relp_tpu_torch.simplex import status as st
from relp_tpu_torch.simplex.driver import solve_general_forms_batched
from relp_tpu_torch.utils.config import SolverConfig


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def ipm_fleet(el, gf, m=96, n=192, lanes=3):
    """tests/test_batched_driver.py::test_fleet_ipm_dense_scenarios_match_highs."""
    g = np.random.default_rng(0xD15E)
    A = g.uniform(0.05, 1.0, (m, n))
    x0, c0 = g.uniform(0.2, 1.0, n), g.uniform(0.1, 1.0, n)
    z = g.standard_normal((2, lanes, n))
    out = []
    for s in range(lanes):
        xs, cs = x0 * (1 + 0.03 * z[0, s]), c0 * (1 + 0.03 * z[1, s])
        out.append(gf.GeneralForm(
            objective=el.Objective.MINIMIZE, A=sp.csc_matrix(A),
            constraint_types=[el.RangedConstraintRelation.equal()] * m, b=A @ xs,
            variables=[gf.Variable(f"x{j}", cost=cs[j], lower=0.0, upper=2.0)
                       for j in range(n)]))
    return out


def _highs(gf):
    A = gf.A.toarray()
    res = linprog([v.cost for v in gf.variables], A_eq=A, b_eq=gf.b,
                  bounds=[(v.lower, v.upper) for v in gf.variables], method="highs")
    assert res.status == 0
    return res.fun


def test_ipm_fleet_matches_the_jax_fleet_and_highs():
    stats = []
    got = solve_general_forms_batched(ipm_fleet(torch_el, torch_gf),
                                      SolverConfig(algorithm="ipm", presolve=False),
                                      device="cpu", stats=stats)
    ref = jax_fleet(ipm_fleet(jax_el, jax_gf),
                    JaxConfig(algorithm="ipm", presolve=False, bucket_shapes=False))
    assert stats[0]["engine"] == "ipm" and stats[0]["certified"] == 3
    for gf, a, b in zip(ipm_fleet(torch_el, torch_gf), ref, got):
        assert a.kind.value == b.kind.value == "finite_optimum"
        assert b.simplex.iterations == a.simplex.iterations
        assert b.solution.objective_value == pytest.approx(a.solution.objective_value, rel=1e-6)
        assert b.solution.objective_value == pytest.approx(_highs(gf), rel=1e-6)
    # the host reads one stacked tensor a chunk (and the start and the result)
    assert stats[0]["host_reads"] == stats[0]["iterations"] + 3


def test_ipm_fleet_honours_the_mixed_ladder():
    stats = []
    got = solve_general_forms_batched(
        ipm_fleet(torch_el, torch_gf),
        SolverConfig(algorithm="ipm", presolve=False, ipm_ladder="mixed"),
        device="cpu", stats=stats)
    assert stats[0]["ladder"].startswith("f32")
    for gf, r in zip(ipm_fleet(torch_el, torch_gf), got):
        assert r.solution.objective_value == pytest.approx(_highs(gf), rel=1e-6)


def flow_fleet(lanes=4, nodes=64, seeds=None):
    """Scenarios of the N = 64 max flow: capacities scaled by 1 + 0.03·z and
    rounded to thousandths; with ``seeds``, one arc set per lane."""
    z = np.random.default_rng(20260819).standard_normal((lanes, nodes * 8))
    fleets = []
    for s in range(lanes):
        arcs = random_arcs(nodes, 8, seed=7 if seeds is None else seeds[s])
        fleets.append([(u, v, round(w * (1 + 0.03 * z[s, k]), 3))
                       for k, (u, v, w) in enumerate(arcs)])
    return fleets


def _max_flow(arcs, nodes=64):
    cap = sp.csr_matrix((np.array([round(w * 1000) for *_, w in arcs], np.int64),
                         ([u for u, *_ in arcs], [v for _, v, _ in arcs])), shape=(nodes, nodes))
    return maximum_flow(cap, 0, nodes - 1).flow_value / 1000.0


@pytest.mark.parametrize("warm", [True, False])
def test_pdlp_fleet_matches_the_jax_fleet_and_maximum_flow(warm):
    fleets = flow_fleet()
    cfg = dict(algorithm="pdlp", presolve=False, pdlp_fleet_warm=warm)
    stats = []
    got = solve_general_forms_batched([max_flow_lp(64, a, 0, 63) for a in fleets],
                                      SolverConfig(**cfg), device="cpu", stats=stats)
    ref = jax_fleet([jax_max_flow_lp(64, a, 0, 63) for a in fleets],
                    JaxConfig(bucket_shapes=False, **cfg))
    info = stats[0]
    assert info["engine"] == "pdlp" and info["shared_A"] and info["lanes"] == 4
    for arcs, a, b in zip(fleets, ref, got):
        assert a.kind.value == b.kind.value == "finite_optimum"
        assert b.solution.objective_value == pytest.approx(a.solution.objective_value, rel=1e-6)
        assert b.solution.objective_value == pytest.approx(_max_flow(arcs), rel=1e-6)


def test_pdlp_fleet_on_a_stacked_group():
    fleets = flow_fleet(lanes=3, seeds=[7, 8, 9])
    stats = []
    got = solve_general_forms_batched([max_flow_lp(64, a, 0, 63) for a in fleets],
                                      SolverConfig(algorithm="pdlp", presolve=False),
                                      device="cpu", stats=stats)
    assert [g["shared_A"] for g in stats] == [False] and stats[0]["lanes"] == 3
    for arcs, r in zip(fleets, got):
        assert r.solution.objective_value == pytest.approx(_max_flow(arcs), rel=1e-6)


def test_solve_pdhg_batched_matches_the_jax_package():
    """min −x1−x2 s.t. x1+x2 = b_s, 0 ≤ x ≤ 1, for three b (tests/test_pdlp.py)."""
    bs = np.array([0.5, 1.0, 1.5])
    A = np.tile(np.array([[1.0, 1.0]]), (3, 1, 1))
    args = (A, bs.reshape(3, 1), np.tile([-1.0, -1.0], (3, 1)), np.zeros((3, 2)),
            np.ones((3, 2)))
    ref = jax_pdhg_batched(*args, tol=1e-8)
    out = solve_pdhg_batched(*args, tol=1e-8, device="cpu")
    assert out.status.tolist() == [st.OPTIMAL] * 3 == np.asarray(ref.status).tolist()
    np.testing.assert_allclose(out.x.sum(1).numpy(), bs, atol=1e-6)
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), atol=1e-6)
    assert out.it.tolist() == np.asarray(ref.it).tolist()
    # the lane-batched state goes to the JAX package's fields and back, copied
    fields = interop.pdhg_state_to_numpy(out)
    assert fields["x"].shape == (3, 2) and fields["eta"].shape == (3,)
    back = interop.pdhg_state_from_numpy(fields, device="cpu")
    assert torch.equal(back.x, out.x) and back.x.data_ptr() != out.x.data_ptr()


def test_stacked_problem_arrays_cross_over_copied():
    A = np.random.default_rng(1).standard_normal((3, 4, 5))
    b, c, lb, ub = np.ones((3, 4)), np.ones((3, 5)), np.zeros((3, 5)), np.full((3, 5), np.inf)
    t = interop.stacked_problem_from_numpy(A, b, c, lb, ub, device="cpu")
    assert t["A"].shape == (3, 4, 5) and t["ub"].dtype == torch.float64
    A[0, 0, 0] = 99.0
    assert float(t["A"][0, 0, 0]) != 99.0
    back = interop.stacked_problem_to_numpy(t)
    np.testing.assert_array_equal(back["ub"], ub)
    with pytest.raises(ValueError):
        interop.stacked_problem_from_numpy(A, b[:2], c, lb, ub, device="cpu")


def test_the_scenario_fleet_example_runs_on_the_cpu(capsys):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "examples" / "torch_scenario_fleet.py"
    spec = importlib.util.spec_from_file_location("torch_scenario_fleet", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    results = example.main(n_scenarios=4, m=16, n=32, algorithm="ipm", device="cpu")
    assert all(r.solution is not None for r in results)
    assert "solved 4/4 scenarios" in capsys.readouterr().out
