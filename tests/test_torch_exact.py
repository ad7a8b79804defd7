"""The port's exact verifier and optimality certificate
(relp_tpu_torch/numerics/exact.py and the CLI's ``--verify``) against the
JAX package's.

Both packages' exact code is host ``fractions.Fraction`` arithmetic, so the
results must be equal as rationals, not close:

- ``ExactVerifier.check`` of the port's solution on ``WIKI_MPS`` (objective
  exactly −8) and on the inline TESTPROB of tests/test_mps_parse.py: equal
  objective and violations;
- ``certify_optimal_basis`` and ``polish_to_certified`` on the bases of the
  port's primal, dual, ``pdlp+crossover`` and ``ipm+crossover`` solves of
  ``WIKI_MPS``, the N = 256 max flow and seeded boxed LPs, and on bases
  perturbed by one swap (which the polish repairs with exact pivots): equal
  certificates and equal pivot counts;
- ``_refine_solve_sparse`` against dense ``Fraction`` elimination (ported
  from tests/test_exact_verifier.py);
- ``--verify``: exit code 0 on ``WIKI_MPS``, 3 when the solver's basis is
  deliberately perturbed (the certificate fails).
"""

import copy
import dataclasses
from fractions import Fraction

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import relp_tpu  # noqa: F401  (x64 on the CPU backend)
from relp_tpu.numerics import exact as jax_exact
from relp_tpu_torch import api, cli
from relp_tpu_torch.io.mps_write import export_mps
from relp_tpu_torch.model.computational_form import ComputationalForm as TorchCF
from relp_tpu_torch.models.networks import max_flow_lp, random_arcs
from relp_tpu_torch.numerics import exact
from relp_tpu_torch.simplex import driver
from relp_tpu_torch.simplex import status as st
from relp_tpu_torch.simplex.driver import solve_computational_form
from relp_tpu_torch.utils.config import SolverConfig
from tests.test_mps_parse import TESTPROB
from tests.test_pipeline_fixture import WIKI_MPS
from tests.test_torch_core import _boxed_sparse, _cf
from tests.test_torch_ranging import jax_cf_of, jax_result_of


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lp_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("exact")
    files = {"wiki": root / "testprob.mps", "testprob": root / "testprob_markers.mps",
             "maxflow": root / "maxflow_256.mps"}
    files["wiki"].write_text(WIKI_MPS)
    files["testprob"].write_text(TESTPROB)
    export_mps(max_flow_lp(256, random_arcs(256, 8, seed=7), 0, 255), str(files["maxflow"]))
    return {k: str(v) for k, v in files.items()}


@pytest.mark.parametrize("problem", ["wiki", "testprob"])
def test_exact_check_equals_jax(lp_files, problem):
    res = api.solve(lp_files[problem], device="cpu")
    values = res.solution.as_dict()
    ct = exact.ExactVerifier(lp_files[problem]).check(values)
    cj = jax_exact.ExactVerifier(lp_files[problem]).check(values)
    assert (ct.objective, ct.max_row_violation, ct.max_bound_violation) == \
        (cj.objective, cj.max_row_violation, cj.max_bound_violation)
    assert ct.ok() and isinstance(ct.objective, Fraction)
    if problem == "wiki":  # an integral optimum: the float solution is exact
        assert ct.objective == Fraction(-8)
    assert exact.verify_against_file(lp_files[problem], values) == ct
    # a moved value is seen, exactly, by both
    bad = dict(values)
    bad[sorted(bad)[-1]] += 0.5  # X3 / ZTHREE: a column of the equality row
    bt, bj = (mod.ExactVerifier(lp_files[problem]).check(bad) for mod in (exact, jax_exact))
    assert bt.max_row_violation == bj.max_row_violation and not bt.ok()


def _certify_both(cf, res):
    """Both packages' certificate, then polish, of one basis (each on its
    own copy: the polish writes the pivoted basis back)."""
    ct = exact.certify_optimal_basis(cf, res)
    cj = jax_exact.certify_optimal_basis(jax_cf_of(cf), jax_result_of(res))
    assert dataclasses.astuple(ct) == dataclasses.astuple(cj)
    rt, rj = copy.deepcopy(res), jax_result_of(res)
    pt, nt = exact.polish_to_certified(cf, rt)
    pj, nj = jax_exact.polish_to_certified(jax_cf_of(cf), rj)
    assert dataclasses.astuple(pt) == dataclasses.astuple(pj) and nt == nj
    assert np.array_equal(rt.basis, rj.basis) and np.array_equal(rt.vstat, rj.vstat)
    return ct, pt, nt


ENGINES = {"primal": "primal", "dual": "dual", "pdlp": "pdlp+crossover",
           "ipm": "ipm+crossover"}


@pytest.mark.parametrize("problem", ["wiki", "maxflow"])
@pytest.mark.parametrize("algorithm", sorted(ENGINES))
def test_certificate_and_polish_equal_jax(lp_files, problem, algorithm):
    res = api.solve(lp_files[problem], SolverConfig(algorithm=algorithm), device="cpu")
    assert res.simplex.metrics.engine == ENGINES[algorithm]
    cert, polished, pivots = _certify_both(res.cf, res.simplex)
    assert polished.ok() and polished.basis_nonsingular
    assert float(polished.objective) == pytest.approx(res.solution.objective_value, rel=1e-9)


def _boxed_cf(seed, m=40, n=96):
    cf = _cf(TorchCF, *_boxed_sparse(m, n, 0.1, seed))
    cf.A = sp.csc_matrix(cf.A)
    return cf


@pytest.mark.parametrize("seed", [0, 1])
def test_certificate_on_seeded_boxed_lps_equals_jax(seed):
    cf = _boxed_cf(seed)
    res = solve_computational_form(cf, SolverConfig(algorithm="dual"), device="cpu")
    cert, polished, _ = _certify_both(cf, res)
    assert polished.ok()


def _swapped(res, n, k=1):
    """``res`` with its k-th structural basic column swapped for the k-th
    nonbasic one (a basis that is no longer optimal, or singular)."""
    out = copy.deepcopy(res)
    structural = np.flatnonzero(out.basis < n)
    nonbasic = np.flatnonzero((out.vstat[:n] == st.NB_LOWER) | (out.vstat[:n] == st.NB_UPPER))
    j_out, j_in = out.basis[structural[k]], nonbasic[k]
    out.basis[structural[k]] = j_in
    out.vstat[j_in] = st.BASIC
    out.vstat[j_out] = st.NB_LOWER
    return out


def test_polish_of_a_perturbed_basis_equals_jax():
    cf = _boxed_cf(0, 24, 64)
    res = solve_computational_form(cf, SolverConfig(), device="cpu")
    cert, polished, pivots = _certify_both(cf, _swapped(res, cf.n))
    assert not cert.ok() and polished.ok() and pivots > 0
    assert float(polished.objective) == pytest.approx(res.objective, rel=1e-9)


def test_refine_solve_matches_dense_elimination():
    """The scalable exact solver (f64-LU refinement + rational
    reconstruction) agrees with dense Fraction elimination, in both
    packages."""
    from scipy.sparse.linalg import splu

    rng = np.random.default_rng(5)
    m = 40
    Ad = np.where(rng.random((m, m)) < 0.15, rng.standard_normal((m, m)), 0.0)
    Ad[np.arange(m), np.arange(m)] += 3.0
    cols = [[(int(i), Fraction(float(Ad[i, j]))) for i in range(m) if Ad[i, j]]
            for j in range(m)]
    rhs = [Fraction(float(v)) for v in rng.standard_normal(m)]
    lu = splu(sp.csc_matrix(Ad), permc_spec="COLAMD")
    for trans in (False, True):
        got = exact._refine_solve_sparse(lu, cols, rhs, trans=trans)
        assert got is not None
        B = [[Fraction(float(Ad[i, j])) for j in range(m)] for i in range(m)]
        if trans:
            B = [[B[j][i] for j in range(m)] for i in range(m)]
        want = exact._solve_fraction_system(B, [rhs])[0]
        assert got == want  # exact equality over Q
        assert got == jax_exact._refine_solve_sparse(lu, cols, rhs, trans=trans)


def test_cli_verify_exit_codes(lp_files, capsys, monkeypatch):
    monkeypatch.setenv("RELP_TPU_TORCH_DEVICE", "cpu")
    assert cli.main(["--verify", "-q", lp_files["wiki"]]) == 0
    err = capsys.readouterr().err
    assert "exact check: OK  obj -8 " in err
    assert "exact optimality certificate: OPTIMAL" in err

    solve = driver.solve_general_form

    def perturbed(*args, **kwargs):
        res = solve(*args, **kwargs)
        res.simplex = _swapped(res.simplex, res.cf.n, k=0)
        return res

    monkeypatch.setattr(driver, "solve_general_form", perturbed)
    assert cli.main(["--verify", "-q", "--no-presolve", lp_files["maxflow"]]) == 3
    err = capsys.readouterr().err
    assert "exact check: OK" in err and "exact optimality certificate: NOT CERTIFIED" in err
