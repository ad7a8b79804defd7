"""The port's host LU module (relp_tpu_torch/simplex/lu_host.py) against the
JAX package's (relp_tpu/simplex/lu_host.py).

Both are the same numpy/scipy code, so the same seeded inputs must give
equal bases, statuses, pivot counts and vectors, exactly.  Both packages
prefer their native Forrest–Tomlin engine where that library builds
(tests/test_torch_ftlu.py holds them against each other on it); here both
run with ``RELP_TPU_NO_FTLU=1``, the documented switch to the product form.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from relp_tpu.simplex import lu_host as jax_lu
from relp_tpu.simplex import status as jax_st
from relp_tpu.utils.config import SolverConfig as JaxConfig
from relp_tpu_torch.simplex import lu_host as torch_lu
from relp_tpu_torch.simplex import status as st
from relp_tpu_torch.utils.config import SolverConfig as TorchConfig

SEEDS = [0, 1, 2, 3]


@pytest.fixture(autouse=True)
def product_form(monkeypatch):
    monkeypatch.setenv("RELP_TPU_NO_FTLU", "1")


def _boxed_lp(seed, m=40, n=120, density=0.08):
    """Seeded sparse LP with every column boxed, feasible by construction;
    the last ``m`` columns are an identity (slacks), so a basis exists."""
    rng = np.random.default_rng(seed)
    A = sp.random(m, n - m, density=density, random_state=rng, format="csc")
    A.data = rng.standard_normal(A.nnz)
    A = sp.hstack([A, sp.identity(m)]).tocsc()
    lb = -rng.uniform(0.0, 2.0, n)
    ub = rng.uniform(0.5, 3.0, n)
    x0 = rng.uniform(lb, ub)
    return A, np.asarray(A @ x0), rng.standard_normal(n), lb, ub, x0, rng


def test_status_codes_are_the_same():
    for name in ("RUNNING", "OPTIMAL", "INFEASIBLE", "UNBOUNDED", "ITERATION_LIMIT",
                 "BASIC", "NB_LOWER", "NB_UPPER", "NB_FREE", "NB_FIXED"):
        assert getattr(st, name) == getattr(jax_st, name)


@pytest.mark.parametrize("seed", SEEDS)
def test_triangular_crash_and_reduced_costs_equal(seed):
    A, b, c, lb, ub, x0, rng = _boxed_lp(seed)
    m, n = A.shape
    cand = rng.permutation(n)[: n // 2]
    basis_j = jax_lu.triangular_crash(A, cand, n)
    basis_t = torch_lu.triangular_crash(A, cand, n)
    assert np.array_equal(basis_t, basis_j)
    assert (basis_t < n).sum() > 0 and (basis_t >= n).sum() > 0   # columns and artificials
    art_sign = np.where(rng.random(m) < 0.5, 1.0, -1.0)
    d_j, pi_j = jax_lu.reduced_costs(A, c, basis_j, art_sign, n)
    d_t, pi_t = torch_lu.reduced_costs(A, c, basis_t, art_sign, n)
    assert np.array_equal(d_t, d_j) and np.array_equal(pi_t, pi_j)
    # at a basis the basic columns price to zero
    assert np.abs(d_t[basis_t[basis_t < n]]).max() < 1e-9


def test_reduced_costs_report_a_singular_basis():
    A = sp.csc_matrix(np.array([[1.0, 1.0, 0.0], [1.0, 1.0, 0.0]]))
    for mod in (torch_lu, jax_lu):
        d, pi = mod.reduced_costs(A, np.ones(3), np.array([0, 1]), np.ones(2), 3)
        assert d is None and pi is None


@pytest.mark.parametrize("seed", SEEDS)
def test_solve_dual_lu_equal(seed):
    A, b, c, lb, ub, x0, rng = _boxed_lp(seed)
    m, n = A.shape
    # all-artificial basis, every column on the bound its cost prefers: dual feasible
    basis0 = n + np.arange(m)
    vstat0 = np.where(c >= 0, st.NB_LOWER, st.NB_UPPER).astype(np.int32)
    xn = np.where(vstat0 == st.NB_LOWER, lb, ub)
    art_sign = np.where(b - A @ xn >= 0, 1.0, -1.0)
    out_j = jax_lu.solve_dual_lu(A, b, c, lb, ub, basis0, vstat0, art_sign, JaxConfig(),
                                 5000, n_pad=n)
    out_t = torch_lu.solve_dual_lu(A, b, c, lb, ub, basis0, vstat0, art_sign, TorchConfig(),
                                   5000, n_pad=n)
    assert int(out_t.status) == int(out_j.status) == st.OPTIMAL
    assert (int(out_t.it), out_t.pivots, out_t.bound_flips) == \
        (int(out_j.it), out_j.pivots, out_j.bound_flips)
    assert out_t.pivots > 0
    for name in ("basis", "vstat", "x", "pi"):
        assert np.array_equal(np.asarray(getattr(out_t, name)), np.asarray(getattr(out_j, name)))
    x = np.asarray(out_t.x)
    assert np.abs(A @ x - b).max() < 1e-7 and (x >= lb - 1e-7).all() and (x <= ub + 1e-7).all()


def test_solve_dual_lu_detects_infeasibility():
    # two equality rows sharing x with inconsistent right-hand sides
    A = sp.csc_matrix(np.array([[1.0], [1.0]]))
    basis0 = np.array([1, 2])
    vstat0 = np.array([st.NB_LOWER, st.BASIC, st.BASIC], np.int32)
    out = torch_lu.solve_dual_lu(A, np.array([2.0, 1.0]), np.array([1.0]), np.array([0.0]),
                                 np.array([10.0]), basis0, vstat0, np.ones(2), TorchConfig(),
                                 1000, n_pad=1)
    assert int(out.status) == st.INFEASIBLE


@pytest.mark.parametrize("seed", SEEDS)
def test_primal_push_equal(seed):
    A, b, c, lb, ub, x0, rng = _boxed_lp(seed)
    m, n = A.shape
    # the slack identity as the basis; every other column superbasic at x0
    basis0 = np.arange(n - m, n)
    vstat0 = np.full(n + m, st.NB_LOWER, np.int32)
    vstat0[: n - m] = st.NB_FREE
    vstat0[basis0] = st.BASIC
    push = np.zeros(n, bool)
    push[: n - m] = True
    args = (A, b, basis0, vstat0, lb, ub, push, x0.copy(), np.ones(m), n)
    got_j = jax_lu.primal_push(*args)
    got_t = torch_lu.primal_push(*args)
    assert got_j is not None and got_t is not None
    for a, bb in zip(got_t, got_j):
        assert np.array_equal(np.asarray(a), np.asarray(bb))
    basis, vstat, pivots = got_t
    # a vertex: every boxed superbasic went to a bound or into the basis
    assert set(np.unique(vstat[:n])) <= {st.BASIC, st.NB_LOWER, st.NB_UPPER}
    assert pivots > 0
    assert (vstat[basis] == st.BASIC).all()


def test_the_port_has_the_product_form_only():
    # under RELP_TPU_NO_FTLU=1 (this module's fixture), as in the JAX package
    A, *_ = _boxed_lp(0)
    B = A[:, -A.shape[0]:]
    assert isinstance(torch_lu._make_lu(B.tocsc(), A), torch_lu._LuEta)
    v = np.arange(1.0, A.shape[0] + 1)
    lu = torch_lu._make_lu(B.tocsc(), A)
    assert np.allclose(lu.ftran(v), v) and np.allclose(lu.btran(v), v)
