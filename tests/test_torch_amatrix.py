"""The port's constraint-matrix operators and basis-inverse algebra
(relp_tpu_torch/ops/amatrix.py, ops/linalg.py) against the JAX package's.

Every operator method of the dense, ELL and hybrid classes gets the same
seeded inputs in both packages; the parametrisation follows
tests/test_amatrix.py, with a hybrid case that has spill columns.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import relp_tpu  # noqa: F401  (x64 on the CPU backend)
from relp_tpu.ops import amatrix as jam
from relp_tpu.ops.linalg import gauss_jordan_inverse
from relp_tpu.ops.linalg import inverse_residual as jax_inverse_residual
from relp_tpu.ops.linalg import rank_one_basis_update as jax_rank_one
from relp_tpu_torch.ops import amatrix as tam
from relp_tpu_torch.ops.linalg import inverse_residual, lu_inverse, rank_one_basis_update

CPU = torch.device("cpu")
F32_TOL = 2e-5  # f32 sums in another order


def _random_sparse(m, n, density, seed, spill=0):
    """Seeded sparse matrix; ``spill`` columns are made fully dense."""
    rng = np.random.default_rng(seed)
    M = sp.random(m, n, density=density, random_state=rng, format="csc")
    M.data = rng.standard_normal(M.nnz)
    if spill:
        M = M.tolil()
        for j in range(spill):
            M[:, 2 * j + 1] = rng.standard_normal((m, 1))
        M = M.tocsc()
    return M


def _operators(kind, csc, m_pad, n_pad):
    """The same matrix as a (JAX, port) operator pair, f32 shadows attached."""
    m, n = csc.shape
    if kind == "dense":
        Ad = np.zeros((m_pad, n_pad))
        Ad[:m, :n] = csc.toarray()
        return (jam.DenseMatrix(jnp.asarray(Ad)).with_f32(),
                tam.DenseMatrix(torch.from_numpy(Ad)).with_f32())
    if kind == "ell":
        return (jam.ell_from_csc(csc, m_pad, n_pad).with_f32(),
                tam.ell_from_csc(csc, m_pad, n_pad, device=CPU).with_f32())
    counts = np.diff(csc.indptr)
    k_pad = int(np.sort(counts)[-3])  # the two spill columns are the longest
    return (jam.hybrid_from_csc(csc, m_pad, n_pad, k_pad, 4).with_f32(),
            tam.hybrid_from_csc(csc, m_pad, n_pad, k_pad, 4, device=CPU).with_f32())


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("kind", ["dense", "ell", "hybrid"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape,density", [((13, 29), 0.2), ((32, 17), 0.05)])
def test_operator_methods_match_jax(kind, shape, density, seed):
    m, n = shape
    csc = _random_sparse(m, n, density, seed, spill=2 if kind == "hybrid" else 0)
    m_pad, n_pad = m + 3, n + 5
    jop, top = _operators(kind, csc, m_pad, n_pad)
    if kind == "hybrid":
        assert int((top.spill_pos >= 0).sum()) == 2
    assert tuple(jop.shape) == top.shape == (m_pad, n_pad)

    rng = np.random.default_rng(100 + seed)
    x = rng.standard_normal(n_pad)
    pi = rng.standard_normal(m_pad)
    c = rng.standard_normal(n_pad)
    Binv = rng.standard_normal((m_pad, m_pad))
    pi32 = pi.astype(np.float32)
    x_t, pi_t, c_t, Binv_t = map(torch.from_numpy, (x, pi, c, Binv))
    pi32_t = torch.from_numpy(pi32)

    np.testing.assert_allclose(_np(top.matvec(x_t)), _np(jop.matvec(x)), atol=1e-12)
    np.testing.assert_allclose(_np(top.rmatvec(pi_t)), _np(jop.rmatvec(pi)), atol=1e-12)
    np.testing.assert_allclose(_np(top.price(c_t, pi_t)), c - _np(jop.rmatvec(pi)),
                               atol=1e-12)
    np.testing.assert_allclose(_np(top.rmatvec32(pi32_t)), _np(jop.rmatvec32(pi32)),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(
        _np(top.price32(c_t.float(), pi32_t)),
        c.astype(np.float32) - _np(jop.rmatvec32(pi32)), rtol=F32_TOL, atol=F32_TOL)
    for q in [0, 1, 3, n - 1, n_pad - 1]:
        q_t = torch.tensor(q)
        np.testing.assert_allclose(_np(top.col(q_t)), _np(jop.col(q)), atol=1e-12)
        np.testing.assert_allclose(_np(top.ftran(Binv_t, q_t)),
                                   _np(jop.ftran(Binv, q)), atol=1e-10)
        np.testing.assert_allclose(_np(top.col_dot(pi_t, q_t)),
                                   _np(jop.col_dot(pi, q)), atol=1e-10)
    rows_i = np.arange(m_pad)
    cols_j = (np.arange(m_pad) * 7) % n_pad
    np.testing.assert_allclose(
        _np(top.entries(torch.from_numpy(rows_i), torch.from_numpy(cols_j))),
        _np(jop.entries(rows_i, cols_j)), atol=1e-12)
    idx = (np.arange(m_pad) * 3) % n_pad
    np.testing.assert_allclose(_np(top.cols_matrix(torch.from_numpy(idx))),
                               _np(jop.cols_matrix(jnp.asarray(idx))), atol=1e-12)


def test_ell_pool_is_k_major_with_jax_views():
    csc = _random_sparse(40, 20, 0.3, 7)
    jell = jam.ell_from_csc(csc, 40, 24)
    tell = tam.ell_from_csc(csc, 40, 24, device=CPU)
    # the kernels read the K-major pools; data/rows are the JAX [n, K] views
    assert tell.data_t.is_contiguous() and tell.rows_t.shape[1] == 24
    np.testing.assert_array_equal(tell.data.numpy(), np.asarray(jell.data))
    np.testing.assert_array_equal(tell.rows.numpy(), np.asarray(jell.rows))
    # K below the true maximum is rejected, not silently truncated
    k_true = int(np.diff(csc.indptr).max())
    with pytest.raises(ValueError):
        tam.ell_from_csc(csc, 40, 24, k_pad=k_true - 1, device=CPU)


def test_ell_rejects_out_of_range_indices():
    csc = _random_sparse(8, 6, 0.5, 3)
    ell = tam.ell_from_csc(csc, 8, 6, device=CPU)
    bad_rows = ell.rows_t.clone()
    bad_rows[0, 0] = 8
    with pytest.raises(ValueError):
        tam.EllMatrix(ell.data_t, bad_rows, 8, ell.rdata_t, ell.rcols_t)


def _spd_basis(m, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, m)) + m * np.eye(m) * 0.1


def test_lu_inverse_matches_gauss_jordan_nonsingular():
    B = _spd_basis(24, 5)
    Xj, pj = gauss_jordan_inverse(jnp.asarray(B))
    Xt, pt = lu_inverse(torch.from_numpy(B))
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), atol=1e-10)
    # partial pivoting picks the same pivots in both eliminations
    assert float(pt) == pytest.approx(float(pj), rel=1e-9)
    assert float(inverse_residual(torch.from_numpy(B), Xt)) < 1e-12


def test_lu_inverse_min_pivot_flags_singular_basis():
    B = _spd_basis(24, 6)
    B[:, 7] = B[:, 3] - 2.0 * B[:, 11]  # a dependent column
    _, pj = gauss_jordan_inverse(jnp.asarray(B))
    _, pt = lu_inverse(torch.from_numpy(B))
    singular_tol = 1e-9  # SolverConfig.singular_tol
    assert float(pj) < singular_tol and float(pt) < singular_tol
    assert float(pt) == pytest.approx(float(pj), abs=1e-12)


@pytest.mark.parametrize("apply", [True, False])
def test_rank_one_update_in_place_matches_jax(apply):
    rng = np.random.default_rng(9)
    m = 12
    Binv = rng.standard_normal((m, m))
    u = rng.standard_normal(m)
    r = 5
    want = np.asarray(jax_rank_one(jnp.asarray(Binv), jnp.asarray(u), r)) if apply else Binv
    Bt = torch.from_numpy(Binv.copy())
    out = rank_one_basis_update(Bt, torch.from_numpy(u), torch.tensor(r),
                                apply=torch.tensor(apply))
    assert out.data_ptr() == Bt.data_ptr()  # updated in place
    np.testing.assert_allclose(Bt.numpy(), want, atol=1e-12)
    X = rng.standard_normal((m, m))
    assert float(inverse_residual(torch.from_numpy(Binv), torch.from_numpy(X))) == \
        pytest.approx(float(jax_inverse_residual(jnp.asarray(Binv), jnp.asarray(X))), rel=1e-12)
