"""The port's first-order engine (relp_tpu_torch/fom/pdhg.py and the PDLP
branch of simplex/driver.py) against the JAX package's.

The same inputs, made with numpy from a seed, go through both packages on
the CPU (the port's kernels run their plain versions there):

- ``_power_norm``, ``_kkt``, ``initial_state``, ``cast_state`` on the dense and
  the ELL operator: rel 1e-12 in f64, 1e-5 in f32;
- ``solve_pdhg_chunk``, both restart schemes, f64 and f32, from one state
  carried across by ``relp_tpu_torch.interop``: rel 1e-9 in f64 (the sums run
  in another order), 1e-4 in f32, after 2 rounds of 64 steps ("halpern") or
  of as many as the expansive start of "avg" lets two summation orders agree
  over;
- whole solves through ``api.solve`` under the same config: status equal,
  objective within 1e-6 relative without the crossover (both stop at a KKT
  tolerance, not at a vertex) and 1e-9 with it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import relp_tpu  # noqa: F401  (x64 on the CPU backend)
from relp_tpu.api import solve as jax_solve
from relp_tpu.fom import pdhg as jax_pdhg
from relp_tpu.ops.amatrix import as_amatrix as jax_as_amatrix
from relp_tpu.ops.amatrix import ell_from_csc as jax_ell_from_csc
from relp_tpu.simplex.driver import solve_computational_form as jax_solve_cf
from relp_tpu.utils.config import SolverConfig as JaxConfig
from relp_tpu_torch import api, interop
from relp_tpu_torch.fom import pdhg
from relp_tpu_torch.io.mps_write import export_mps
from relp_tpu_torch.model.computational_form import ComputationalForm as TorchCF
from relp_tpu_torch.models.networks import max_flow_lp, random_arcs
from relp_tpu_torch.ops.amatrix import DenseMatrix, ell_from_csc
from relp_tpu_torch.simplex import status as st
from relp_tpu_torch.simplex.driver import solve_computational_form as torch_solve_cf
from relp_tpu_torch.utils.config import SolverConfig as TorchConfig
from tests.test_pipeline_fixture import WIKI_MPS
from tests.test_torch_core import _boxed_sparse, _cf

M, N = 64, 256


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The vectors here are a few thousand elements: a PDHG step is a dozen
    tiny ops, which a pool of threads only slows down (and, with several
    test workers on one machine, starves the others)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


DTYPES = {"f64": (jnp.float64, torch.float64, 1e-12), "f32": (jnp.float32, torch.float32, 1e-5)}


def _lp(seed=0):
    """Seeded boxed LP (64 × 256): every column has a finite lower bound, a
    third of them no upper bound."""
    rng = np.random.default_rng(seed)
    A = np.where(rng.random((M, N)) < 0.2, rng.standard_normal((M, N)), 0.0)
    A[np.arange(M), rng.integers(0, N, M)] = 1.0  # no empty rows
    b = A @ rng.uniform(0, 1, N)
    c = rng.standard_normal(N)
    lb = np.zeros(N)
    ub = np.where(rng.random(N) < 0.3, np.inf, 2.0)
    return A, b, c, lb, ub


def _operators(A, fmt, jdt, tdt):
    """The same matrix as both packages' operator, in the given precision."""
    if fmt == "dense":
        return jax_as_amatrix(jnp.asarray(A, jdt)), DenseMatrix(torch.tensor(A, dtype=tdt))
    csc = sp.csc_matrix(A)
    ell = jax_ell_from_csc(csc, M, N, int(np.diff(csc.indptr).max()))
    ell = jax.tree.map(lambda l: l.astype(jdt) if l.dtype == jnp.float64 else l, ell)
    return ell, ell_from_csc(csc, M, N, device="cpu").astype(tdt)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    finite = np.isfinite(want)
    assert np.array_equal(got[~finite], want[~finite])
    if finite.any():
        scale = 1.0 + np.abs(want[finite]).max()
        assert np.abs(got[finite] - want[finite]).max() <= rel * scale


def _assert_states_close(got: pdhg.PdhgState, want, rel, names=pdhg.PdhgState._fields):
    for name in names:
        leaf = getattr(got, name)
        ref = np.asarray(getattr(want, name))
        assert str(leaf.dtype).split(".")[-1] == str(ref.dtype), name   # the dtype carries through
        if leaf.dtype in (torch.int32, torch.int64):
            assert int(leaf) == int(ref), name
        else:
            _close(leaf.numpy(), ref, rel)


@pytest.mark.parametrize("fmt", ["dense", "ell"])
@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_norm_kkt_and_states_match_jax(fmt, prec):
    jdt, tdt, rel = DTYPES[prec]
    A, b, c, lb, ub = _lp()
    Aj, At = _operators(A, fmt, jdt, tdt)
    vj = [jnp.asarray(v, jdt) for v in (b, c, lb, ub)]
    vt = [torch.tensor(v, dtype=tdt) for v in (b, c, lb, ub)]
    norm_j, norm_t = jax_pdhg._power_norm(Aj), pdhg._power_norm(At)
    assert norm_t.dim() == 0 and norm_t.dtype == tdt
    _close(norm_t, norm_j, rel)

    rng = np.random.default_rng(1)
    x, y = rng.uniform(0, 2, N), rng.standard_normal(M)
    kkt_j = jax_pdhg.kkt_residual(Aj, *vj, jnp.asarray(x, jdt), jnp.asarray(y, jdt))
    kkt_t = pdhg.kkt_residual(At, *vt, torch.tensor(x, dtype=tdt), torch.tensor(y, dtype=tdt))
    assert kkt_t.dtype == tdt
    _close(kkt_t, kkt_j, rel)

    eta0 = 0.9 / float(norm_j)
    s_j = jax_pdhg.initial_state(Aj, vj[2], vj[3], eta0, dtype=jdt)
    s_t = pdhg.initial_state(At, vt[2], vt[3], eta0, dtype=tdt)
    _assert_states_close(s_t, s_j, rel)

    # cast_state: the other precision, the cached products recomputed
    other = "f32" if prec == "f64" else "f64"
    jdt2, tdt2, _ = DTYPES[other]
    Aj2, At2 = _operators(A, fmt, jdt2, tdt2)
    moved_j = s_j._replace(x=jnp.asarray(x, jdt), x_anchor=jnp.asarray(x[::-1].copy(), jdt))
    moved_t = s_t._replace(x=torch.tensor(x, dtype=tdt),
                           x_anchor=torch.tensor(x[::-1].copy(), dtype=tdt))
    _assert_states_close(pdhg.cast_state(moved_t, At2, tdt2),
                         jax_pdhg.cast_state(moved_j, Aj2, jdt2), 1e-5)


@pytest.mark.parametrize("fmt", ["dense", "ell"])
@pytest.mark.parametrize("variant", ["halpern", "avg"])
@pytest.mark.parametrize("prec,rel", [("f64", 1e-9), ("f32", 1e-4)])
def test_chunk_matches_jax_from_the_same_state(fmt, variant, prec, rel):
    jdt, tdt, _ = DTYPES[prec]
    A, b, c, lb, ub = _lp()
    Aj, At = _operators(A, fmt, jdt, tdt)
    vj = [jnp.asarray(v, jdt) for v in (b, c, lb, ub)]
    vt = [torch.tensor(v, dtype=tdt) for v in (b, c, lb, ub)]
    s_j = jax_pdhg.initial_state(Aj, vj[2], vj[3], 0.9 / float(jax_pdhg._power_norm(Aj)),
                                 dtype=jdt)
    # "halpern" compares after 2 rounds of 64 steps.  The adaptive step of
    # "avg" is expansive at the start on this LP: a rounding difference (the
    # sums run in another order) grows about 30-fold with every doubling of the
    # steps, from 1e-16 after 8 to 1e-7 after 128 in f64, so "avg" compares
    # after 2 rounds of 32 steps in f64 and of 8 steps in f32
    round_len = 64 if variant == "halpern" else (32 if prec == "f64" else 8)
    out_j = jax_pdhg.solve_pdhg_chunk(Aj, *vj, s_j, round_len=round_len, max_rounds=2,
                                      variant=variant)
    s_t = interop.pdhg_state_from_numpy([np.asarray(v) for v in s_j], device="cpu")
    stats = {}
    out_t = pdhg.solve_pdhg_chunk(At, *vt, s_t, round_len=round_len, max_rounds=2,
                                  variant=variant, stats=stats)
    _assert_states_close(out_t, out_j, rel,
                         ("x", "y", "ax", "eta", "omega", "kkt", "steps", "status", "it"))
    assert int(out_t.it) == 2 * round_len and int(out_t.status) == st.RUNNING
    # one read on entry (the state's status), one after each round
    assert stats["rounds"] == 2 and stats["host_reads"] == 3
    assert stats["last"][:2] == (st.RUNNING, 2 * round_len)
    # and back: the JAX package continues from the port's state
    back = interop.pdhg_state_to_numpy(out_t)
    s_back = jax_pdhg.PdhgState(**{k: jnp.asarray(v) for k, v in back.items()})
    more_j = jax_pdhg.solve_pdhg_chunk(Aj, *vj, s_back, round_len=round_len, max_rounds=1,
                                       variant=variant)
    more_t = pdhg.solve_pdhg_chunk(At, *vt, out_t, round_len=round_len, max_rounds=1,
                                   variant=variant, assume_running=True)
    _assert_states_close(more_t, more_j, rel, ("x", "y", "kkt", "it"))


def test_interop_copies_every_leaf():
    A, b, c, lb, ub = _lp()
    At = DenseMatrix(torch.tensor(A))
    s = pdhg.initial_state(At, torch.tensor(lb), torch.tensor(ub), 0.1)
    fields = interop.pdhg_state_to_numpy(s)
    again = interop.pdhg_state_from_numpy(fields, device="cpu")
    for name, leaf in again._asdict().items():
        assert leaf.dtype == getattr(s, name).dtype and torch.equal(leaf, getattr(s, name))
        assert leaf.data_ptr() != getattr(s, name).data_ptr()
        if fields[name].ndim:
            fields[name][...] = 7            # writing the numpy side moves neither state
    assert float(again.x.max()) == 0.0 and float(s.x.max()) == 0.0


@pytest.mark.parametrize("variant", ["avg", "halpern"])
def test_chunk_solves_the_tiny_lp(variant):
    """min −x1 − x2  s.t. x1 + x2 = 1, 0 ≤ x ≤ 1 (tests/test_pdlp.py)."""
    A = torch.tensor([[1.0, 1.0]], dtype=torch.float64)
    b = torch.tensor([1.0], dtype=torch.float64)
    c = torch.tensor([-1.0, -1.0], dtype=torch.float64)
    lb, ub = torch.zeros(2, dtype=torch.float64), torch.ones(2, dtype=torch.float64)
    s = pdhg.initial_state(A, lb, ub, 0.9 / float(pdhg._power_norm(A)))
    stats = {}
    s = pdhg.solve_pdhg_chunk(A, b, c, lb, ub, s, round_len=64, max_rounds=64,
                              variant=variant, stats=stats)
    assert int(s.status) == st.OPTIMAL
    assert abs(float((A @ s.x - b)[0])) < 1e-6
    assert float(c @ s.x) == pytest.approx(-1.0, abs=1e-6)
    assert stats["rounds"] < 64 and stats["host_reads"] == stats["rounds"] + 1
    # a finished state comes back untouched
    again = pdhg.solve_pdhg_chunk(A, b, c, lb, ub, s, round_len=64, max_rounds=4, variant=variant)
    assert again is s


@pytest.fixture(scope="module")
def lp_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("pdlp")
    wiki = root / "testprob.mps"
    wiki.write_text(WIKI_MPS)
    flow = root / "maxflow_256.mps"
    export_mps(max_flow_lp(256, random_arcs(256, 8, seed=7), 0, 255), str(flow))
    return {"wiki": str(wiki), "maxflow": str(flow)}


def _solve_both_files(path, **kw):
    rj = jax_solve(path, JaxConfig(algorithm="pdlp", bucket_shapes=False, **kw))
    rt = api.solve(path, TorchConfig(algorithm="pdlp", **kw), device="cpu")
    assert rt.kind.value == rj.kind.value == "finite_optimum"
    return rj, rt


# mixed precision takes rounds of 32 steps here: the JAX package checks its
# f32 stage in f64 only every 256 rounds, 65,536 steps of the default length
NO_CROSSOVER = {
    "halpern-f64": dict(pdlp_precision="f64"),
    "avg-f64": dict(pdlp_precision="f64", pdlp_variant="avg"),
    "halpern-auto": dict(),      # auto is f64 in the port, and on the CPU in the JAX package
    "halpern-mixed-refine4": dict(pdlp_precision="mixed", pdlp_refine=4, pdlp_round=32),
    "halpern-mixed-refine0": dict(pdlp_precision="mixed", pdlp_refine=0, pdlp_round=32),
    "avg-mixed-refine0": dict(pdlp_precision="mixed", pdlp_refine=0, pdlp_round=32,
                              pdlp_variant="avg"),
}


@pytest.mark.parametrize("problem", ["wiki", "maxflow"])
@pytest.mark.parametrize("case", sorted(NO_CROSSOVER))
def test_first_order_point_matches_jax(lp_files, problem, case):
    kw = NO_CROSSOVER[case]
    rj, rt = _solve_both_files(lp_files[problem], pdlp_crossover=False, **kw)
    assert rt.solution.objective_value == pytest.approx(rj.solution.objective_value, rel=1e-6)
    met = rt.simplex.metrics
    assert met.engine == "pdlp" and met.device == "cpu"
    assert met.fo_iterations == met.iterations > 0 and met.fo_kkt < 1e-6
    assert met.fo_round_reads == met.fo_rounds             # one read after every round
    mixed = kw.get("pdlp_precision") == "mixed"
    assert (met.fo_f32_iterations > 0) == mixed
    if not kw.get("pdlp_refine", 4) or not mixed:
        assert met.fo_refines == 0
    # a first-order point carries no basis
    assert rt.simplex.basis is None and rt.simplex.vstat is None and rj.simplex.basis is None
    assert rt.simplex.duals.shape == rj.simplex.duals.shape


@pytest.mark.parametrize("problem", ["wiki", "maxflow"])
def test_crossover_reaches_the_vertex_jax_reaches(lp_files, problem):
    rj, rt = _solve_both_files(lp_files[problem])
    assert rt.solution.objective_value == pytest.approx(rj.solution.objective_value, rel=1e-9)
    met = rt.simplex.metrics
    assert met.engine == "pdlp+crossover"
    assert met.iterations > met.fo_iterations > 0
    assert rt.simplex.basis is not None and rj.simplex.basis is not None
    if problem == "maxflow":
        assert rt.solution.objective_value == 181.0        # scipy's max-flow value, exactly
        assert met.push_pivots > 1000


def test_crossover_on_a_boxed_lp_matches_jax():
    args = _boxed_sparse(128, 1024, 0.03, seed=5)
    rj = jax_solve_cf(_cf(relp_tpu.model.computational_form.ComputationalForm, *args[:3],
                          lb=args[3], ub=args[4]),
                      JaxConfig(algorithm="pdlp", bucket_shapes=False))
    rt = torch_solve_cf(_cf(TorchCF, *args[:3], lb=args[3], ub=args[4]),
                        TorchConfig(algorithm="pdlp"), device="cpu")
    assert rt.kind.value == rj.kind.value == "finite_optimum"
    assert rt.objective == pytest.approx(rj.objective, rel=1e-9)
    assert rt.metrics.engine == "pdlp+crossover" and rt.basis is not None
    # and the primal engine agrees with the vertex
    rp = torch_solve_cf(_cf(TorchCF, *args[:3], lb=args[3], ub=args[4]), TorchConfig(),
                        device="cpu")
    assert rp.metrics.engine == "primal"
    assert rt.objective == pytest.approx(rp.objective, rel=1e-9)


def test_every_host_read_of_an_f64_run_is_counted(lp_files):
    """One read after each round and the operator norm's before the first:
    ``_run_pdlp`` adds none of its own under the default (f64) precision."""
    rt = api.solve(lp_files["maxflow"], TorchConfig(algorithm="pdlp", pdlp_crossover=False),
                   device="cpu")
    met = rt.simplex.metrics
    assert met.engine == "pdlp" and met.fo_f32_iterations == 0
    assert met.host_reads == met.fo_rounds + 1 == met.fo_round_reads + 1


def test_a_device_failure_in_the_crossover_is_not_taken_to_the_host(lp_files, monkeypatch):
    """Out of device memory in the certifying re-solve reaches the caller:
    the host LU engine does not quietly take the device's work."""
    from relp_tpu_torch.simplex import driver

    calls = []

    def no_memory(self, *args, **kwargs):
        calls.append(args)
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (made up)")

    monkeypatch.setattr(driver._Padded, "solve_core", no_memory)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        api.solve(lp_files["maxflow"], TorchConfig(algorithm="pdlp"), device="cpu")
    assert len(calls) == 1


def test_duals_match_the_primal_engine(lp_files):
    """PDHG's y against the simplex duals, both in original row units, on a
    nondegenerate instance (tests/test_pdlp.py does the same on SC50B)."""
    fo = api.solve(lp_files["wiki"], TorchConfig(algorithm="pdlp"), device="cpu")
    sx = api.solve(lp_files["wiki"], TorchConfig(), device="cpu")
    np.testing.assert_allclose(fo.simplex.duals, sx.simplex.duals, rtol=1e-4, atol=1e-5)
    # the first-order point's own y, in original row units, on the max flow
    # (its duals are the 0/1 of a minimum cut)
    raw = api.solve(lp_files["maxflow"], TorchConfig(algorithm="pdlp", pdlp_crossover=False),
                    device="cpu")
    ref = jax_solve(lp_files["maxflow"], JaxConfig(algorithm="pdlp", bucket_shapes=False,
                                                  pdlp_crossover=False))
    np.testing.assert_allclose(raw.simplex.duals, ref.simplex.duals, rtol=1e-4, atol=1e-5)


def test_a_budget_too_small_falls_back_to_the_primal(lp_files):
    """256 iterations cannot certify optimality: the primal solves instead,
    as in the JAX package, and the metrics say so."""
    rj = jax_solve(lp_files["wiki"], JaxConfig(algorithm="pdlp", max_iter=256))
    rt = api.solve(lp_files["wiki"], TorchConfig(algorithm="pdlp", max_iter=256), device="cpu")
    assert rt.kind.value == rj.kind.value == "finite_optimum"
    assert rt.solution.objective_value == pytest.approx(rj.solution.objective_value, rel=1e-9)
    met = rt.simplex.metrics
    assert met.engine == "pdlp→primal"
    assert met.fo_iterations == 256 and met.iterations > 256
    assert rt.simplex.basis is not None


@pytest.mark.parametrize("kw", [dict(perturb=1e-6), dict(algorithm="primal")])
def test_the_primal_is_not_routed_through_pdlp(lp_files, kw):
    cfg = TorchConfig(**{"algorithm": "pdlp", **kw})
    res = api.solve(lp_files["wiki"], cfg, device="cpu")
    assert res.simplex.metrics.engine == "primal" and res.simplex.metrics.fo_iterations == 0
    assert res.solution.objective_value == pytest.approx(-8.0, rel=1e-9)


def test_chunk_refuses_an_unknown_variant():
    A = torch.eye(2, dtype=torch.float64)
    z = torch.zeros(2, dtype=torch.float64)
    s = pdhg.initial_state(A, z, z + 1, 0.5)
    with pytest.raises(ValueError, match="variant"):
        pdhg.solve_pdhg_chunk(A, z, z, z, z + 1, s, variant="nesterov")
