"""The port's interior point (relp_tpu_torch/simplex/primal_dual.py and the
``algorithm="ipm"`` branch of simplex/driver.py) against the JAX package's.

The same inputs, made with numpy from a seed, go through both packages on
the CPU:

- ``_factor``, ``_solve_normal``, ``_step_math`` and ``ls_start`` from one
  state carried across by ``relp_tpu_torch.interop``, under both ladders
  (the f64 rung, and the f32 rung of "mixed"), on a seeded dense boxed LP:
  rel 1e-10 for everything the f64 refinement produces, the f32 factor
  itself at rel 1e-5 (two f32 Cholesky factors of one matrix);
- ``solve_ipm`` on a seeded boxed LP with free columns, and whole
  ``algorithm="ipm"`` solves through ``solve_general_form`` on the four
  fixtures (``WIKI_MPS``, the N = 256 max flow, the dense LPs 64 × 128 and
  256 × 512) under ``ipm_ladder="f64"`` and ``"mixed"``: equal iterations
  and the objective within 1e-6 relative without crossover (both accept at
  a scaled-space KKT of 1e-8, not at a vertex); with crossover the
  objective within 1e-9 and the vertex equal where the optimum is unique;
- the budget fall back, the exact certificate of the crossover's vertex,
  and the ladder's validation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import relp_tpu  # noqa: F401  (x64 on the CPU backend)
from relp_tpu.api import solve as jax_solve
from relp_tpu.simplex import primal_dual as jax_pd
from relp_tpu.utils.config import SolverConfig as JaxConfig
from relp_tpu_torch import api, interop
from relp_tpu_torch.io.mps_write import export_mps
from relp_tpu_torch.models.dense import dense_lp
from relp_tpu_torch.models.networks import max_flow_lp, random_arcs
from relp_tpu_torch.numerics.exact import certify_optimal_basis
from relp_tpu_torch.simplex import primal_dual as pd
from relp_tpu_torch.utils.config import SolverConfig
from tests.test_pipeline_fixture import WIKI_MPS


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The products here are a few hundred wide: a pool of threads only
    slows them down (and starves the other test workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(1.0, float(np.max(np.abs(b)))))


def _boxed_free_lp(seed=0, m=24, n=64):
    """Seeded LP, feasible by construction, with boxed, one-sided, fixed and
    free columns (an eighth each of the last three)."""
    rng = np.random.default_rng(seed)
    A = np.where(rng.random((m, n)) < 0.3, rng.standard_normal((m, n)), 0.0)
    A[np.arange(m), rng.integers(0, n, m)] = 1.0
    kind = rng.integers(0, 8, n)
    lb = np.where(kind == 0, -np.inf, -rng.uniform(0, 1, n))
    ub = np.where(kind <= 1, np.inf, rng.uniform(1, 2, n))
    lb[kind == 2] = ub[kind == 2] = 0.5
    x0 = np.clip(rng.uniform(-1, 2, n), np.where(np.isfinite(lb), lb, -1),
                 np.where(np.isfinite(ub), ub, 2))
    # a cost that keeps the free and one-sided columns bounded: c = Aᵀy + z,
    # z ≥ 0 where only a lower bound holds, z = 0 on the free columns
    y = rng.standard_normal(m)
    z = np.where(kind == 0, 0.0, np.where(kind == 1, rng.uniform(0.1, 1, n),
                                          rng.standard_normal(n)))
    return A, A @ x0, A.T @ y + z, lb, ub


def _masked(lb, ub, free_box=1e5):
    """solve_ipm's masks of a bound set, as numpy."""
    fixed = lb == ub
    free = ~np.isfinite(lb) & ~np.isfinite(ub) & ~fixed
    lb_w, ub_w = np.where(free, -free_box, lb), np.where(free, free_box, ub)
    hl = (np.isfinite(lb_w) & ~fixed).astype(float)
    hu = (np.isfinite(ub_w) & ~fixed).astype(float)
    return (np.where(hl > 0, lb_w, 0.0), np.where(hu > 0, ub_w, 0.0), hl, hu,
            (~fixed).astype(float), np.where(fixed, lb, 0.0), float(hl.sum() + hu.sum()))


LADDERS = {"f64": (jnp.float64, torch.float64, 1), "f32": (jnp.float32, torch.float32, 3)}


def _dense_boxed_lp(seed=3, m=16, n=48):
    """Seeded dense LP over the box [0, 2], feasible by construction: its
    normal matrices stay well conditioned over the first iterations, so the
    two packages' f64-refined directions agree to rounding."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    return A, A @ rng.uniform(0.2, 1.8, n), rng.standard_normal(n), np.zeros(n), np.full(n, 2.0)


@pytest.fixture(scope="module")
def unit_case():
    """Both packages' arguments of one problem, and the JAX package's f64
    least-squares start on it."""
    A, b, c, lb, ub = _dense_boxed_lp()
    lbf, ubf, hl, hu, dmask, xfix, nb = _masked(lb, ub)
    vecs = (b, c, lbf, ubf, hl, hu, dmask)
    jargs = tuple(jnp.asarray(v) for v in vecs)
    targs = tuple(torch.tensor(v) for v in vecs)
    A64j = jnp.asarray(A)
    s = jax_pd.ls_start(A64j, A64j, *jargs, jnp.asarray(xfix), fdt=jnp.float64, n_ir=1)
    return dict(A=A, jargs=jargs, targs=targs, xfix=xfix, nb=nb,
                state=[np.asarray(v) for v in s])


@pytest.mark.parametrize("ladder", sorted(LADDERS))
def test_factor_and_normal_solve_match_jax(unit_case, ladder):
    jdt, tdt, n_ir = LADDERS[ladder]
    A = unit_case["A"]
    rng = np.random.default_rng(1)
    d = rng.uniform(1e-3, 1e3, A.shape[1]) * unit_case["targs"][6].numpy()
    Lj, jsj = jax_pd._factor(jnp.asarray(A, jdt), jnp.asarray(d), jnp.float64(1e-8), jdt)
    Lt, jst = pd._factor(torch.tensor(A).to(tdt), torch.tensor(d), 1e-8, tdt)
    fac_tol = 1e-10 if ladder == "f64" else 1e-5
    assert Lt.dtype == tdt and _rel(Lt, Lj) < fac_tol and _rel(jst, jsj) < fac_tol
    rhs = rng.standard_normal(A.shape[0])
    tj, rj = jax_pd._solve_normal(Lj, jsj, jnp.asarray(A), jnp.asarray(d), 1e-8,
                                  jnp.asarray(rhs), n_ir)
    tt, rt = pd._solve_normal(Lt, jst, torch.tensor(A), torch.tensor(d), 1e-8,
                              torch.tensor(rhs), n_ir)
    assert _rel(tt, tj) < 1e-10
    assert float(rt) < 1e-8 and float(rj) < 1e-8


def test_factor_of_an_indefinite_matrix_is_nan_as_in_jax():
    A = np.eye(4)
    d = np.array([1.0, 1.0, 1.0, 1.0])
    Lj, _ = jax_pd._factor(jnp.asarray(A), jnp.asarray(d), jnp.float64(-5.0), jnp.float64)
    Lt, _ = pd._factor(torch.tensor(A), torch.tensor(d), -5.0, torch.float64)
    assert bool(torch.isnan(Lt).all()) and bool(jnp.isnan(Lj).any())


@pytest.mark.parametrize("ladder", sorted(LADDERS))
def test_step_math_and_ls_start_match_jax(unit_case, ladder):
    jdt, tdt, n_ir = LADDERS[ladder]
    A, nb = unit_case["A"], unit_case["nb"]
    sj = jax_pd.IpmState(*(jnp.asarray(v) for v in unit_case["state"]))
    st = interop.ipm_state_from_numpy(unit_case["state"], device="cpu")
    # three iterations in a row, each from the state the last one reached
    for _ in range(3):
        sj, dj = jax_pd._step_math(jnp.asarray(A), jnp.asarray(A, jdt), *unit_case["jargs"],
                                   sj, jnp.float64(1e-8), jnp.float64(1e-10), nb, 0.9995,
                                   jdt, n_ir)
        st, dt = pd._step_math(torch.tensor(A), torch.tensor(A).to(tdt), *unit_case["targs"],
                               st, 1e-8, 1e-10, nb, 0.9995, tdt, n_ir)
        got = interop.ipm_state_to_numpy(st)
        for name, ref in zip(jax_pd.IpmState._fields, sj):
            assert _rel(got[name], ref) < 1e-10, name
        for name in ("mu", "rp", "rd", "gap", "pobj", "dobj", "alpha_p", "alpha_d", "sigma"):
            assert float(getattr(dt, name)) == pytest.approx(
                float(getattr(dj, name)), rel=1e-10, abs=1e-12), name
    # the start itself, on the rung's factor
    xfix = unit_case["xfix"]
    s0j = jax_pd.ls_start(jnp.asarray(A), jnp.asarray(A, jdt), *unit_case["jargs"],
                          jnp.asarray(xfix), fdt=jdt, n_ir=n_ir)
    s0t = pd.ls_start(torch.tensor(A), torch.tensor(A).to(tdt), *unit_case["targs"],
                      torch.tensor(xfix), fdt=tdt, n_ir=n_ir)
    for a, b in zip(s0t, s0j):
        assert _rel(a, b) < 1e-10


def test_chunk_of_several_steps_matches_jax(unit_case):
    """``ipm_chunk`` with k_max > 1 (the host loop reads one stop flag
    between steps) against the JAX device loop."""
    A, nb = unit_case["A"], unit_case["nb"]
    sj = jax_pd.IpmState(*(jnp.asarray(v) for v in unit_case["state"]))
    st = interop.ipm_state_from_numpy(unit_case["state"], device="cpu")
    oj = jax_pd.ipm_chunk(jnp.asarray(A), jnp.asarray(A), *unit_case["jargs"], sj,
                          jnp.float64(1e-8), jnp.float64(1e-10), jnp.float64(nb),
                          jnp.float64(0.9995), jnp.float64(1e-8), jnp.float64(np.inf),
                          fdt=jnp.float64, n_ir=1, k_max=5)
    ot = pd.ipm_chunk(torch.tensor(A), torch.tensor(A), *unit_case["targs"], st, 1e-8, 1e-10,
                      nb, 0.9995, 1e-8, np.inf, fdt=torch.float64, n_ir=1, k_max=5)
    assert int(ot.committed) == int(oj.committed) == 5 and int(ot.bad) == int(oj.bad)
    for name in ("delta", "rho", "best_kkt"):
        assert float(getattr(ot, name)) == pytest.approx(float(getattr(oj, name)), rel=1e-9)
    assert _rel(ot.best_x, oj.best_x) < 1e-9 and _rel(ot.state.y, oj.state.y) < 1e-9


@pytest.mark.parametrize("ladder", ["f64", "mixed"])
def test_solve_ipm_with_free_columns_matches_jax(ladder):
    A, b, c, lb, ub = _boxed_free_lp(5)
    rj = jax_pd.solve_ipm(A, b, c, lb, ub, ladder=ladder)
    rt = pd.solve_ipm(A, b, c, lb, ub, ladder=ladder, device="cpu")
    assert rj is not None and rt is not None
    (xj, yj, ij), (xt, yt, it) = rj, rt
    assert it.iterations == ij.iterations and it.converged and ij.converged
    assert it.kkt <= 1e-8 and float(c @ xt) == pytest.approx(float(c @ xj), rel=1e-6)
    # the read per chunk, the start's and the returned point's
    assert it.host_reads >= it.iterations + 2
    assert it.ladder.startswith("f64" if ladder == "f64" else "f32")


def test_ladder_is_validated():
    with pytest.raises(ValueError):
        SolverConfig(algorithm="ipm", ipm_ladder="bogus")
    with pytest.raises(ValueError):
        pd.solve_ipm(np.eye(2), np.ones(2), np.ones(2), np.zeros(2), np.ones(2),
                     ladder="bogus", device="cpu")
    cfg = SolverConfig(algorithm="ipm")
    assert (cfg.ipm_tol, cfg.ipm_accept, cfg.ipm_max_iter, cfg.ipm_ladder) == \
        (1e-8, 1e-6, 200, "auto")


@pytest.fixture(scope="module")
def lp_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("ipm")
    files = {"wiki": root / "testprob.mps", "maxflow": root / "maxflow_256.mps",
             "dense64": root / "dense_64x128.mps", "dense256": root / "dense_256x512.mps"}
    files["wiki"].write_text(WIKI_MPS)
    export_mps(max_flow_lp(256, random_arcs(256, 8, seed=7), 0, 255), str(files["maxflow"]))
    export_mps(dense_lp(64, 128), str(files["dense64"]))
    export_mps(dense_lp(256, 512), str(files["dense256"]))
    return {k: str(v) for k, v in files.items()}


def _solve_both(path, **kw):
    rj = jax_solve(path, JaxConfig(algorithm="ipm", bucket_shapes=False, **kw))
    rt = api.solve(path, SolverConfig(algorithm="ipm", **kw), device="cpu")
    assert rt.kind.value == rj.kind.value == "finite_optimum"
    return rj, rt


@pytest.mark.parametrize("ladder", ["f64", "mixed"])
@pytest.mark.parametrize("problem", ["wiki", "maxflow", "dense64", "dense256"])
def test_interior_point_matches_jax(lp_files, problem, ladder):
    rj, rt = _solve_both(lp_files[problem], pdlp_crossover=False, ipm_ladder=ladder)
    met = rt.simplex.metrics
    assert met.engine == "ipm" and met.matrix_format == "dense" and met.device == "cpu"
    # without a crossover the JAX result's iterations are the interior point's
    assert met.fo_iterations == met.iterations == rj.simplex.iterations > 0
    assert met.fo_kkt <= 1e-8
    assert met.ipm_ladder.startswith("f64" if ladder == "f64" else "f32")
    assert rt.solution.objective_value == pytest.approx(rj.solution.objective_value, rel=1e-6)
    # an interior point carries no basis
    assert rt.simplex.basis is None and rj.simplex.basis is None
    assert rt.simplex.duals == pytest.approx(rj.simplex.duals, rel=1e-5, abs=1e-6)


@pytest.mark.parametrize("problem", ["wiki", "maxflow", "dense64"])
def test_crossover_vertex_matches_jax_and_is_certified(lp_files, problem):
    rj, rt = _solve_both(lp_files[problem])
    met = rt.simplex.metrics
    assert met.engine == "ipm+crossover" and rt.simplex.basis is not None
    assert rt.solution.objective_value == pytest.approx(rj.solution.objective_value, rel=1e-9)
    if problem != "maxflow":  # a max flow's optimal vertex is not unique
        xt, xj = dict(rt.solution.solution_values), dict(rj.solution.solution_values)
        assert xt.keys() == xj.keys()
        assert [xt[k] for k in xt] == pytest.approx([xj[k] for k in xt], abs=1e-9)
    # the crossover's vertex certified optimal over ℚ (the in-repo counterpart
    # of tests/test_ipm.py::test_ipm_crossover_vertex_certified)
    cert = certify_optimal_basis(rt.cf, rt.simplex)
    assert cert.ok() and cert.basis_nonsingular
    assert float(cert.objective) == pytest.approx(rt.solution.objective_value, rel=1e-9)


def test_budget_falls_back_to_the_primal(lp_files):
    rj, rt = _solve_both(lp_files["dense64"], ipm_max_iter=1)
    assert rt.simplex.metrics.engine == "ipm→primal"
    assert rt.simplex.basis is not None
    ref = api.solve(lp_files["dense64"], SolverConfig(), device="cpu")
    assert rt.solution.objective_value == pytest.approx(ref.solution.objective_value, rel=1e-9)
    assert rt.solution.objective_value == pytest.approx(rj.solution.objective_value, rel=1e-9)
