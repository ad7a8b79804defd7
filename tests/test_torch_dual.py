"""The port's dual simplex (relp_tpu_torch/simplex/dual.py) against the JAX
package's, on the CPU.

One ``DualKernel.step`` against the JAX loop body from the same ``DState``
(1e-12), ``solve_core_dual`` after bound tightening (seeds 11-13, as
tests/test_dual_simplex.py), infeasibility, both ratio tests and both weight
rules, ``algorithm="dual"`` through ``solve_general_form`` (status equal,
objective within 1e-9 relative, x within 1e-7), the two fall backs to the
primal, the host sparse-LU engine, and the loop's host reads.  Iteration
counts are compared where the pivot paths agree; the tests say where they
need not.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import relp_tpu  # noqa: F401  (x64 on the CPU backend)
from relp_tpu.io.mps_convert import mps_to_general_form as jax_to_general
from relp_tpu.io.mps_parse import parse_free as jax_parse_free
from relp_tpu.model.elements import Objective as JaxObjective
from relp_tpu.model.elements import RangedConstraintRelation as JaxRel
from relp_tpu.model.general_form import GeneralForm as JaxGeneral
from relp_tpu.model.general_form import Variable as JaxVariable
from relp_tpu.models.networks import max_flow_lp as jax_max_flow_lp
from relp_tpu.ops.amatrix import as_amatrix as jax_as_amatrix
from relp_tpu.ops.amatrix import ell_from_csc as jax_ell_from_csc
from relp_tpu.simplex import dual as jax_dual
from relp_tpu.simplex import status as st
from relp_tpu.simplex.core import solve_core as jax_solve_core
from relp_tpu.simplex.driver import solve_general_form as jax_solve_general
from relp_tpu.utils.config import SolverConfig as JaxConfig
from relp_tpu_torch.interop import dstate_from_numpy, operator_from_numpy
from relp_tpu_torch.io.mps_convert import mps_to_general_form as torch_to_general
from relp_tpu_torch.io.mps_parse import parse_free as torch_parse_free
from relp_tpu_torch.model.elements import Objective, RangedConstraintRelation
from relp_tpu_torch.model.general_form import GeneralForm, Variable
from relp_tpu_torch.models.networks import max_flow_lp, random_arcs
from relp_tpu_torch.simplex import dual as torch_dual
from relp_tpu_torch.simplex.driver import solve_general_form
from relp_tpu_torch.utils.config import SolverConfig
from tests.test_pipeline_fixture import WIKI_MPS

OBJ_REL = 1e-9
BISECT = {"dual_ratio": "bisect"}  # the JAX package's default; the port's is "sort"
X_TOL = 1e-7
STEP_TOL = 1e-12
INF = float("inf")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The vectors here are tens of elements: a simplex step is a few hundred
    tiny ops, which a pool of threads only slows down (and, with several test
    workers on one machine, starves the others)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def problem(m=16, n=48, seed=11):
    """tests/test_dual_simplex.py's seeded boxed LP."""
    rng = np.random.default_rng(seed)
    A = np.where(rng.random((m, n)) < 0.4, rng.standard_normal((m, n)), 0.0)
    A[np.arange(m), rng.integers(0, n, m)] = 1.0
    b = A @ rng.random(n)
    c = rng.standard_normal(n)
    return A, b, c, np.zeros(n), np.full(n, 10.0)


def _tightened(seed):
    """The LP, its JAX primal optimum, and the upper bounds with the largest
    basic variable's cut below its value (the old basis is then primal
    infeasible and still dual feasible)."""
    A, b, c, lb, ub = problem(seed=seed)
    n = A.shape[1]
    out = jax_solve_core(A, b, c, lb, ub, cfg=JaxConfig(), max_iter=2000)
    assert int(out.status) == st.OPTIMAL
    x = np.asarray(out.x)
    basis = np.asarray(out.basis)
    structural_basic = basis[basis < n]
    j_star = structural_basic[np.argmax(x[structural_basic])]
    ub2 = ub.copy()
    ub2[j_star] = x[j_star] * 0.6
    return (A, b, c, lb, ub2), out


def _both_operators(A, fmt):
    m, n = A.shape
    if fmt == "dense":
        return jax_as_amatrix(jnp.asarray(A)), operator_from_numpy(device="cpu", A=A)
    ell = jax_ell_from_csc(sp.csc_matrix(A), m, n)
    return ell, operator_from_numpy(device="cpu", data=ell.data, rows=ell.rows,
                                    rdata=ell.rdata, rcols=ell.rcols, m=ell.m)


@pytest.mark.parametrize("opts", [
    {"dual_ratio": "bisect"}, {"dual_ratio": "sort"},
    {"dual_ratio": "bisect", "dual_pricing": "devex"}], ids=["bisect-dse", "sort", "devex"])
@pytest.mark.parametrize("fmt", ["dense", "ell"])
def test_step_matches_the_jax_body(fmt, opts):
    (A, b, c, lb, ub2), out = _tightened(11)
    ub2[:5] = 0.3  # boxed candidates the ratio test passes: bound flips
    m, n = A.shape
    jA, tA = _both_operators(A, fmt)
    art_sign = np.asarray(out.art_sign)
    refactor, body, _ = jax_dual._make_kernel(
        jA, *(jnp.asarray(v) for v in (b, c, lb, ub2, art_sign)), JaxConfig(**opts), 2000,
        external=True)
    vstat = np.concatenate([np.asarray(out.vstat)[:n], np.zeros(m, np.int32)])
    s = refactor(jax_dual.DState(
        basis=jnp.asarray(out.basis, jnp.int32), vstat=jnp.asarray(vstat, jnp.int32),
        xB=jnp.zeros(m), Binv=jnp.eye(m), pi=jnp.zeros(m), d=jnp.zeros(n), beta=jnp.ones(m),
        status=jnp.int32(st.RUNNING), it=jnp.int32(0), since_refactor=jnp.int32(0),
        repairs=jnp.int32(0), flips=jnp.int32(0)))
    K = torch_dual.DualKernel(tA, *(torch.tensor(v) for v in (b, c, lb, ub2, art_sign)),
                              SolverConfig(**opts), 2000)
    for _ in range(5):
        ts = dstate_from_numpy([np.asarray(v) for v in s], device="cpu")
        s = body(s)
        ts, flags = K.step(ts)
        for f in dataclasses.fields(torch_dual.DState):
            np.testing.assert_allclose(getattr(ts, f.name).numpy(), np.asarray(getattr(s, f.name)),
                                       rtol=STEP_TOL, atol=STEP_TOL, err_msg=f.name)
        assert flags.tolist() == [int(s.status) == st.RUNNING, int(s.since_refactor) >= 64]
    assert int(s.flips) > 0 and int(s.it) == 5
    assert K.host_reads == 0  # a step reads nothing: its caller reads the flags


def _dual_both(args, basis, vstat, art_sign, opts=None):
    A = args[0]
    n = A.shape[1]
    opts = {**BISECT, **(opts or {})}  # the JAX default, made explicit in the port
    dj = jax_dual.solve_core_dual(*args, basis0=basis, vstat0=vstat[:n], cfg=JaxConfig(**opts),
                                  max_iter=2000, art_sign0=art_sign)
    dt = torch_dual.solve_core_dual(*args, basis0=basis, vstat0=vstat[:n],
                                    cfg=SolverConfig(**opts), max_iter=2000,
                                    art_sign0=art_sign, device="cpu")
    return dj, dt


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_dual_resolve_after_bound_tightening(seed):
    args, out = _tightened(seed)
    ref = jax_solve_core(*args, cfg=JaxConfig(), max_iter=2000)
    assert int(ref.status) == st.OPTIMAL
    dj, dt = _dual_both(args, np.asarray(out.basis), np.asarray(out.vstat),
                        np.asarray(out.art_sign))
    assert int(dt.status) == int(dj.status) == st.OPTIMAL
    assert float(dt.obj) == pytest.approx(float(dj.obj), rel=OBJ_REL)
    assert float(dt.obj) == pytest.approx(float(ref.obj), abs=1e-8)
    np.testing.assert_allclose(dt.x.numpy(), np.asarray(dj.x), rtol=X_TOL, atol=X_TOL)
    # the pivot paths agree on these: same iterations, flips and basis
    assert int(dt.it) == int(dj.it) < int(ref.it)
    np.testing.assert_array_equal(np.sort(dt.basis.numpy()), np.sort(np.asarray(dj.basis)))
    assert int(dt.phase) == 2 and dt.trace.shape == (0, 8)


def test_dual_detects_infeasible():
    A, b, c, lb, ub = problem(seed=14)
    out = jax_solve_core(A, b, c, lb, ub, cfg=JaxConfig(), max_iter=2000)
    assert int(out.status) == st.OPTIMAL
    # clamp every variable near zero while b stays far away
    args = (A, b, c, lb, np.full(A.shape[1], 1e-3))
    dj, dt = _dual_both(args, np.asarray(out.basis), np.asarray(out.vstat),
                        np.asarray(out.art_sign))
    assert int(dt.status) == int(dj.status) == st.INFEASIBLE


@pytest.mark.parametrize("opts", [
    {"dual_ratio": "sort"}, {"dual_pricing": "devex"},
    {"dual_ratio": "sort", "dual_pricing": "devex"}, {"refactor_mode": "full"},
], ids=["sort", "bisect-devex", "sort-devex", "bisect-full-refactor"])
def test_dual_options_match_jax(opts):
    args, out = _tightened(12)
    args[4][:8] = 0.4  # more of the basis pushed out of its bounds: a longer run
    dj, dt = _dual_both(args, np.asarray(out.basis), np.asarray(out.vstat),
                        np.asarray(out.art_sign), opts)
    assert int(dt.status) == int(dj.status) == st.OPTIMAL
    assert float(dt.obj) == pytest.approx(float(dj.obj), rel=OBJ_REL)
    np.testing.assert_allclose(dt.x.numpy(), np.asarray(dj.x), rtol=X_TOL, atol=X_TOL)
    assert int(dt.it) == int(dj.it)


def test_host_reads_at_most_one_per_iteration():
    args, out = _tightened(12)
    args[4][:8] = 0.4
    n = args[0].shape[1]
    common = dict(basis0=np.asarray(out.basis), vstat0=np.asarray(out.vstat)[:n],
                  max_iter=2000, art_sign0=np.asarray(out.art_sign), device="cpu")
    full = torch_dual.solve_core_dual(*args, cfg=SolverConfig(refactor_mode="full"), **common)
    its = int(full.it)
    assert its > 3
    # one read of the packed flags per iteration and one before the first;
    # the LU's minimum pivot is judged on the device
    assert full.host_reads == its + 1
    # the polish adds its residual check, one read per refactorization
    short = torch_dual.solve_core_dual(
        *args, cfg=SolverConfig(refactor_period=2), **common)
    assert int(short.status) == st.OPTIMAL
    refactorizations = short.host_reads - (int(short.it) + 1)
    assert int(short.it) // 2 <= refactorizations <= int(short.it) + 2


def _wiki(to_general, parse):
    return to_general(parse(WIKI_MPS))


def _boxed_general(cls_general, cls_var, rel, objective, seed=5, m=24, n=60):
    """A seeded LP with boxed, half-bounded and free columns and all three
    row kinds, feasible by construction."""
    rng = np.random.default_rng(seed)
    A = np.where(rng.random((m, n)) < 0.3, rng.standard_normal((m, n)), 0.0)
    A[np.arange(m), rng.integers(0, n, m)] = 1.0
    lower = np.where(rng.random(n) < 0.8, -rng.uniform(0.0, 2.0, n), -INF)
    upper = np.where(rng.random(n) < 0.8, rng.uniform(0.5, 3.0, n), INF)
    x0 = rng.uniform(np.maximum(lower, -2.0), np.minimum(upper, 3.0))
    row = A @ x0
    kinds = rng.integers(0, 3, m)
    b = row + np.where(kinds == 1, 0.5, np.where(kinds == 2, -0.5, 0.0))
    # costs that keep the LP bounded: push each column toward a finite bound
    c = np.where(np.isfinite(lower), 1.0, np.where(np.isfinite(upper), -1.0, 0.0)) \
        * rng.uniform(0.1, 1.0, n)
    make = (rel.equal, rel.less, rel.greater)
    return cls_general(
        objective=objective.MINIMIZE, A=sp.csc_matrix(A),
        constraint_types=[make[k]() for k in kinds], b=b,
        variables=[cls_var(name=f"x{j}", cost=float(c[j]), lower=float(lower[j]),
                           upper=float(upper[j])) for j in range(n)])


def _max_flow(make):
    return make(48, random_arcs(48, 4, 3), 0, 47)


GENERAL = {
    "wiki": (lambda: _wiki(jax_to_general, jax_parse_free),
             lambda: _wiki(torch_to_general, torch_parse_free)),
    "max_flow_48": (lambda: _max_flow(jax_max_flow_lp), lambda: _max_flow(max_flow_lp)),
    "boxed_24x60": (
        lambda: _boxed_general(JaxGeneral, JaxVariable, JaxRel, JaxObjective),
        lambda: _boxed_general(GeneralForm, Variable, RangedConstraintRelation, Objective)),
}


def _solve_general_both(name, opts, jax_opts=None):
    make_jax, make_port = GENERAL[name]
    rj = jax_solve_general(make_jax(), JaxConfig(bucket_shapes=False, algorithm="dual",
                                                 **(jax_opts or opts)))
    rt = solve_general_form(make_port(), SolverConfig(algorithm="dual", **opts), device="cpu")
    assert rt.kind.value == rj.kind.value
    if rj.solution is not None:
        assert rt.solution.objective_value == pytest.approx(
            rj.solution.objective_value, rel=OBJ_REL, abs=OBJ_REL)
    return rj, rt


@pytest.mark.parametrize("name", sorted(GENERAL))
def test_algorithm_dual_through_solve_general_form(name):
    # each package under its own default config: the ratio tests differ
    # ("bisect" there, "sort" here) and choose the same pivots on these LPs
    rj, rt = _solve_general_both(name, {})
    assert rt.kind.value == "finite_optimum"
    assert rt.simplex.metrics.engine == "dual"
    xj, xt = dict(rj.solution.solution_values), dict(rt.solution.solution_values)
    if name != "max_flow_48":  # a max flow has many optimal flows
        assert xt == pytest.approx(xj, rel=X_TOL, abs=X_TOL)
    met = rt.simplex.metrics
    assert met.iterations == rj.simplex.iterations
    assert met.host_reads <= met.iterations + 1 + (met.iterations // 64 + 3)


@pytest.mark.parametrize("opts", [BISECT, {"dual_ratio": "sort", "dual_pricing": "devex"}],
                         ids=["bisect", "sort-devex"])
def test_algorithm_dual_options_on_the_max_flow(opts):
    _, rt = _solve_general_both("max_flow_48", opts)
    assert rt.simplex.metrics.engine == "dual"
    assert rt.simplex.metrics.bound_flips >= 0


def test_xl_engine_lu_runs_the_host_dual():
    rj, rt = _solve_general_both("boxed_24x60", {"xl_engine": "lu"})
    met = rt.simplex.metrics
    assert met.engine == "dual-lu" and met.matrix_format == "csc"
    assert met.lu_engine in ("forrest-tomlin", "product-form")
    # the host engines walk the same pivots whichever package drives them
    assert met.iterations == rj.simplex.iterations


def _general(cls_general, cls_var, rel, objective, A, kinds, b, cols):
    make = {"==": rel.equal, "<=": rel.less, ">=": rel.greater}
    return cls_general(
        objective=objective.MINIMIZE, A=sp.csc_matrix(np.asarray(A, float)),
        constraint_types=[make[k]() for k in kinds], b=np.asarray(b, float),
        variables=[cls_var(name=n_, cost=c_, lower=lo, upper=hi) for n_, c_, lo, hi in cols])


FALLBACKS = {
    # min −x over x − y = 0, x, y ≥ 0: unbounded; the temporary box binds
    "unbounded": ([[1.0, -1.0]], ["=="], [0.0], [("x", -1.0, 0.0, INF), ("y", 0.0, 0.0, INF)]),
    # min x + y over x + y = 5, x, y ≤ 1: infeasible; the dual's verdict
    # under the temporary box is no certificate, the primal's is
    "infeasible": ([[1.0, 1.0]], ["=="], [5.0], [("x", 1.0, 0.0, 1.0), ("y", 1.0, 0.0, 1.0)]),
}


@pytest.mark.parametrize("name", sorted(FALLBACKS))
def test_dual_falls_back_to_the_primal(name):
    spec = FALLBACKS[name]
    cfg = dict(algorithm="dual", presolve=False)
    rj = jax_solve_general(_general(JaxGeneral, JaxVariable, JaxRel, JaxObjective, *spec),
                           JaxConfig(bucket_shapes=False, **cfg))
    rt = solve_general_form(
        _general(GeneralForm, Variable, RangedConstraintRelation, Objective, *spec),
        SolverConfig(**cfg), device="cpu")
    assert rt.kind.value == rj.kind.value == name
    assert rt.simplex.metrics.engine == "dual→primal"


def test_dual_is_skipped_with_a_perturbation():
    # want_dual needs perturb == 0 (and no warm start): the primal solves
    _, make_port = GENERAL["wiki"]
    rt = solve_general_form(make_port(), SolverConfig(algorithm="dual", perturb=1e-7),
                            device="cpu")
    assert rt.kind.value == "finite_optimum" and rt.simplex.metrics.engine == "primal"
    assert rt.solution.objective_value == pytest.approx(-8.0, abs=1e-6)
