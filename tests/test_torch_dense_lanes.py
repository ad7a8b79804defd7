"""The lane kernels of the port (``dense_price_lanes``,
``dense_price_select_lanes``: relp_tpu_torch/ops/dense_kernels.py), the lane
operator (``LaneDenseMatrix``) and the batched linear algebra of
relp_tpu_torch/ops/linalg.py, against the JAX package on the CPU.

The JAX package prices a fleet as ``jax.vmap`` of ``DenseMatrix(A)``'s
``c − rmatvec(π)`` over the lanes (A shared: ``in_axes=None``; stacked:
``0``).  The same numpy inputs, made from a seed, go through both: rel
1e-12 in f64 and 1e-5 in f32 (the sums run in another order).  The
selection of every lane equals the single-vector selection of that lane
(``q`` and ``has`` equal); the wrappers run their plain versions here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import relp_tpu  # noqa: F401  (x64 on the CPU backend)
from relp_tpu.ops.amatrix import DenseMatrix as JaxDense
from relp_tpu_torch.ops.amatrix import DenseMatrix, LaneDenseMatrix
from relp_tpu_torch.ops.dense_kernels import (
    dense_price_lanes,
    dense_price_select_lanes,
    dense_price_select_plain,
)
from relp_tpu_torch.ops.linalg import (
    lu_inverse,
    rank_one_basis_update,
    rank_one_basis_update_lanes,
)

DTYPES = {"f64": (jnp.float64, torch.float64, 1e-12), "f32": (jnp.float32, torch.float32, 1e-5)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(stacked, L=6, m=24, n=200, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.uniform(-1.0, 1.0, (L, m, n) if stacked else (m, n))
    return A, rng.standard_normal((L, m)), rng.standard_normal((L, n))


def _jax_price(A, V, C, stacked, j0, w, jdt):
    def one(A_s, v, c):
        return c - JaxDense(A_s).rmatvec(v)[j0:j0 + w]
    f = jax.vmap(one, in_axes=(0 if stacked else None, 0, 0))
    return np.asarray(f(jnp.asarray(A, jdt), jnp.asarray(V, jdt), jnp.asarray(C, jdt)))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("j0,w", [(0, None), (5, 131), (128, 72)])
def test_dense_price_lanes_matches_jax_vmap(dt, stacked, j0, w):
    jdt, tdt, tol = DTYPES[dt]
    A, V, C = _data(stacked)
    width = A.shape[-1] - j0 if w is None else w
    Cw = C[:, :width]
    want = _jax_price(A, V, Cw, stacked, j0, width, jdt)
    got = dense_price_lanes(torch.tensor(A, dtype=tdt), torch.tensor(V, dtype=tdt),
                            torch.tensor(Cw, dtype=tdt), j0, w).numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())
    # the sum alone: V·A_s, the devex rows of every lane
    got_sum = dense_price_lanes(torch.tensor(A, dtype=tdt), torch.tensor(V, dtype=tdt),
                                None, j0, w).numpy()
    np.testing.assert_allclose(got_sum, Cw - want, rtol=tol, atol=tol * np.abs(want).max() * 10)


def test_dense_price_lanes_keeps_dead_lanes():
    A, V, C = _data(False)
    At, Vt, Ct = (torch.tensor(v) for v in (A, V, C))
    live = torch.tensor([True, False, True, False, False, True])
    out = torch.full(Ct.shape, 3.0, dtype=torch.float64)
    got = dense_price_lanes(At, Vt, Ct, live=live, out=out)
    assert torch.equal(got[~live], out[~live])
    assert torch.equal(got[live], dense_price_lanes(At, Vt, Ct)[live])


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("devex", [True, False])
@pytest.mark.parametrize("stacked", [False, True])
def test_select_lanes_equals_the_single_selection_of_every_lane(dt, devex, stacked):
    _, tdt, tol = DTYPES[dt]
    L, m, n = 6, 24, 200
    rng = np.random.default_rng(4)
    A, V, C = (torch.tensor(v, dtype=tdt) for v in _data(stacked, L, m, n, seed=4))
    vstat = torch.tensor(rng.integers(0, 4, (L, n + m)))
    can = torch.tensor(rng.random((L, n)) < 0.8)
    w = torch.tensor(rng.uniform(0.5, 2.0, (L, n)))
    bland = torch.tensor([False, True, False, True, False, False])
    q, has, d_q = dense_price_select_lanes(A, V, C, vstat, can, w, bland, 1e-7, devex)
    for s in range(L):
        q1, has1, d1 = dense_price_select_plain(A[s] if stacked else A, V[s], C[s], vstat[s],
                                                can[s], w[s], bland[s], 1e-7, devex)
        assert int(q[s]) == int(q1) and bool(has[s]) == bool(has1)
        assert float(d_q[s]) == pytest.approx(float(d1), rel=tol)
    # a window, and a mask of live lanes whose dead lanes keep their outputs
    live = torch.tensor([True, True, False, False, True, False])
    outs = (torch.full((L,), -1), torch.zeros(L, dtype=torch.bool), torch.zeros(L, dtype=tdt))
    qw, hw, dw = dense_price_select_lanes(A, V, C[:, 40:140].contiguous(), vstat, can, w, bland,
                                          1e-7, devex, 40, 100, live=live, outs=outs)
    assert torch.equal(qw[~live], outs[0][~live])
    for s in np.flatnonzero(live.numpy()):
        q1, _, _ = dense_price_select_plain(A[s] if stacked else A, V[s], C[s, 40:140], vstat[s],
                                            can[s], w[s], bland[s], 1e-7, devex, 40, 100)
        assert int(qw[s]) == int(q1)


def test_select_lanes_takes_a_shared_can_enter_and_checks_shapes():
    A, V, C = (torch.tensor(v) for v in _data(False))
    L, n = C.shape
    vstat = torch.zeros((L, n + 24), dtype=torch.int64)
    w = torch.ones((L, n), dtype=torch.float64)
    bland = torch.zeros(L, dtype=torch.bool)
    can = torch.ones(n, dtype=torch.bool)
    q, has, _ = dense_price_select_lanes(A, V, C, vstat, can, w, bland, 1e-7, True)
    assert q.shape == (L,) and has.dtype == torch.bool
    with pytest.raises(ValueError):
        dense_price_select_lanes(A, V, C, vstat, can, w[:, :-1], bland, 1e-7, True)
    with pytest.raises(ValueError):
        dense_price_lanes(A, V[:, :-1], C)


@pytest.mark.parametrize("stacked", [False, True])
def test_lane_operator_matches_the_single_operator_per_lane(stacked):
    L, m, n = 6, 24, 200
    A, V, C = (torch.tensor(v) for v in _data(stacked, L, m, n, seed=7))
    op = LaneDenseMatrix(A).with_f32()
    rng = np.random.default_rng(7)
    X = torch.tensor(rng.standard_normal((L, n)))
    q = torch.tensor(rng.integers(0, n, L))
    idx = torch.tensor(rng.integers(0, n, (L, m)))
    rows = torch.arange(m)
    Binv = torch.tensor(rng.standard_normal((L, m, m)))
    for s in range(L):
        one = DenseMatrix(A[s] if stacked else A).with_f32()
        torch.testing.assert_close(op.matvec(X)[s], one.matvec(X[s]), rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(op.price(C, V)[s], one.price(C[s], V[s]),
                                   rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(op.rmatvec32(V.float())[s], one.rmatvec32(V[s].float()))
        assert torch.equal(op.cols(q)[s], one.col(q[s]))
        torch.testing.assert_close(op.col_dot(V, q)[s], one.col_dot(V[s], q[s]))
        torch.testing.assert_close(op.ftran(Binv, q)[s], one.ftran(Binv[s], q[s]))
        assert torch.equal(op.entries(rows, idx)[s], one.entries(rows, idx[s]))
        assert torch.equal(op.cols_matrix(idx)[s], one.cols_matrix(idx[s]))
    sub = torch.tensor([4, 1])
    assert torch.equal(op.cols_matrix(idx[sub], sub)[1], op.cols_matrix(idx)[1])
    torch.testing.assert_close(op.matvec(X[sub], sub), op.matvec(X)[sub])


def test_batched_inverse_and_rank_one_update_match_the_single_ones():
    rng = np.random.default_rng(9)
    L, m = 5, 12
    B = torch.tensor(rng.standard_normal((L, m, m)) + 4 * np.eye(m))
    B[2] = 0.0  # a singular lane: its pivot is 0, the others' are not
    inv, piv = lu_inverse(B)
    for s in (0, 1, 3, 4):
        inv1, piv1 = lu_inverse(B[s])
        torch.testing.assert_close(inv[s], inv1, rtol=1e-12, atol=1e-12)
        assert float(piv[s]) == float(piv1)
    assert float(piv[2]) == 0.0
    Binv = torch.tensor(rng.standard_normal((L, m, m)))
    u = torch.tensor(rng.standard_normal((L, m)))
    r = torch.tensor(rng.integers(0, m, L))
    apply = torch.tensor([True, False, True, True, False])
    want = Binv.clone()
    for s in range(L):
        rank_one_basis_update(want[s], u[s], r[s], apply[s])
    got = rank_one_basis_update_lanes(Binv.clone(), u, r, apply)
    torch.testing.assert_close(got, want, rtol=1e-14, atol=1e-14)
    assert torch.equal(got[1], Binv[1]) and torch.equal(got[4], Binv[4])
