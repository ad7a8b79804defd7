"""The port's primal engine (relp_tpu_torch/simplex) against the JAX package's.

The same seeded problems go through ``solve_computational_form`` of both
packages: the hand-worked LPs of tests/test_simplex_small.py, seeded LPs of
``__graft_entry__._problem`` and seeded boxed sparse LPs under each matrix
format.  Status and objective must agree, and x where the optimum is unique.
Iteration counts are not compared: near-tie pivots may differ.  A solve
started in the JAX package also finishes in the port from the JAX state.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import relp_tpu  # noqa: F401  (x64 on the CPU backend)
from __graft_entry__ import _problem
from relp_tpu.model.computational_form import ComputationalForm as JaxCF
from relp_tpu.ops.amatrix import ell_from_csc as jax_ell_from_csc
from relp_tpu.simplex import status as jax_st
from relp_tpu.simplex.core import solve_core as jax_solve_core
from relp_tpu.simplex.driver import solve_computational_form as jax_solve_cf
from relp_tpu.utils.config import SolverConfig as JaxConfig
from relp_tpu_torch.interop import operator_from_numpy, warm_start_from_numpy
from relp_tpu_torch.model.computational_form import ComputationalForm as TorchCF
from relp_tpu_torch.simplex import status as torch_st
from relp_tpu_torch.simplex.core import solve_core as torch_solve_core
from relp_tpu_torch.simplex.driver import solve_computational_form as torch_solve_cf
from relp_tpu_torch.utils.config import SolverConfig as TorchConfig

INF = float("inf")
OBJ_REL = 1e-9


def _cf(cls, A, b, c, lb=None, ub=None, maximize=False):
    A = np.asarray(A, dtype=np.float64)
    m, n = A.shape
    lb = np.zeros(n) if lb is None else np.asarray(lb, dtype=np.float64)
    ub = np.full(n, INF) if ub is None else np.asarray(ub, dtype=np.float64)
    cf = cls(
        A=A, b=np.asarray(b, dtype=np.float64), c=np.asarray(c, dtype=np.float64),
        lb=lb, ub=ub, n_structural=n, slack_rows=np.zeros(0, dtype=np.int64),
        col_names=[f"x{j}" for j in range(n)], maximize=maximize, fixed_cost=0.0,
        row_scale=np.ones(m), col_scale=np.ones(n),
    )
    cf._orig_cost = -np.asarray(c, float) if maximize else np.asarray(c, float)
    return cf


def _solve_both(args, kwargs=None, fmt="auto"):
    """Solve one LP in both packages; JAX pads as the port does
    (``bucket_shapes=False``)."""
    kwargs = kwargs or {}
    rj = jax_solve_cf(_cf(JaxCF, *args, **kwargs),
                      JaxConfig(bucket_shapes=False, matrix_format=fmt))
    rt = torch_solve_cf(_cf(TorchCF, *args, **kwargs),
                        TorchConfig(matrix_format=fmt), device="cpu")
    return rj, rt


def _assert_same_outcome(rj, rt):
    # each package has its own LinearProgramType enum: compare the values
    assert rt.kind.value == rj.kind.value
    if rj.objective is not None:
        assert rt.objective == pytest.approx(rj.objective, rel=OBJ_REL, abs=OBJ_REL)


# the hand-worked LPs of tests/test_simplex_small.py: (A, b, c, bounds/sense)
HAND_WORKED = {
    "equality_2x2": ([[1, 1], [1, -1]], [2, 0], [1, 1], {}),
    "standard": ([[1, 1, 1, 0], [1, 3, 0, 1]], [4, 6], [-2, -3, 0, 0], {}),
    "unbounded": ([[1, -1]], [0], [-1, 0], {}),
    "infeasible": ([[1], [1]], [1, 2], [1], {}),
    "negative_rhs": ([[-1]], [-3], [1], {}),
    "upper_bounds_flip": ([[1, 1, 1]], [10], [-1, -1, 0],
                          dict(lb=[0, 0, 0], ub=[3, 3, INF])),
    "binding_upper_bound": ([[1, 1, 1]], [4], [-1, -1, 0],
                            dict(lb=[0, 0, 0], ub=[3, 3, INF])),
    "free_variable": ([[1, 1]], [-5], [0, 1], dict(lb=[-INF, 0], ub=[INF, INF])),
    "negative_lower_bounds": ([[1, 1]], [-2], [1, 1], dict(lb=[-3, -3], ub=[3, 3])),
    "degenerate": ([[1, 0, 1, 0], [1, 1, 0, 1]], [1, 1], [-1, 0, 0, 0], {}),
    "fixed": ([[1, 1]], [5], [0, 1], dict(lb=[2, 0], ub=[2, INF])),
    "rank_deficient": ([[1, 1], [1, 1], [1, -1]], [2, 2, 0], [1, 1], {}),
    "maximize": ([[1, 1, 1]], [4], [-2, -3, 0], dict(maximize=True)),
}


@pytest.mark.parametrize("name", sorted(HAND_WORKED))
def test_hand_worked_lps_match_jax(name):
    A, b, c, kw = HAND_WORKED[name]
    rj, rt = _solve_both((A, b, c), kw)
    _assert_same_outcome(rj, rt)


def _boxed_sparse(m, n, density, seed):
    """Seeded LP with every column boxed, feasible by construction."""
    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=density, random_state=rng, format="csc")
    A.data = rng.standard_normal(A.nnz)
    A = A.toarray()
    A[np.arange(m), rng.integers(0, n, m)] = 1.0  # no empty rows
    lb = -rng.uniform(0.0, 2.0, n)
    ub = rng.uniform(0.5, 3.0, n)
    b = A @ rng.uniform(lb, ub)
    c = rng.standard_normal(n)
    return A, b, c, lb, ub


def _unique_optimum(A, c, lb, ub, x, duals):
    """Dual nondegeneracy: every column at a bound has a nonzero reduced
    cost, so the optimal x is unique."""
    d = c - A.T @ duals
    at_bound = (np.abs(x - lb) <= 1e-9) | (np.abs(x - ub) <= 1e-9)
    return bool(np.all(np.abs(d[at_bound]) > 1e-7))


SEEDED = {
    # random costs over x >= 0: unbounded, in both packages
    "graft_64x256": lambda: _problem(64, 256, seed=0),
    "boxed_96x200": lambda: _boxed_sparse(96, 200, 0.05, 1),
    # m_pad·n_pad >= 2^17: mixed f32/f64 pricing is on in both packages
    "boxed_128x1024": lambda: _boxed_sparse(128, 1024, 0.01, 2),
}


@pytest.mark.parametrize("fmt", ["dense", "ell", "hybrid"])
@pytest.mark.parametrize("name", sorted(SEEDED))
def test_seeded_lps_match_jax(name, fmt):
    A, b, c, lb, ub = SEEDED[name]()
    rj, rt = _solve_both((A, b, c), dict(lb=lb, ub=ub), fmt=fmt)
    assert rt.metrics.matrix_format == fmt
    _assert_same_outcome(rj, rt)
    if rj.objective is not None and _unique_optimum(A, c, lb, ub, rj.x_structural, rj.duals):
        np.testing.assert_allclose(rt.x_structural, rj.x_structural, rtol=1e-7, atol=1e-7)


@pytest.mark.parametrize("fmt", ["dense", "ell"])
def test_state_carried_across_finishes_in_port(fmt):
    A, b, c, lb, ub = _boxed_sparse(64, 256, 0.05, 3)
    m, n = A.shape
    cfg = JaxConfig()
    if fmt == "dense":
        jA = A
        tA = operator_from_numpy(device="cpu", A=A)
    else:
        ell = jax_ell_from_csc(sp.csc_matrix(A), m, n)
        jA = ell
        tA = operator_from_numpy(device="cpu", data=ell.data, rows=ell.rows,
                                 rdata=ell.rdata, rcols=ell.rcols, m=ell.m)

    started = jax_solve_core(jA, b, c, lb, ub, cfg=cfg, max_iter=40)
    assert int(started.status) == jax_st.ITERATION_LIMIT
    state = dict(basis=np.asarray(started.basis), vstat=np.asarray(started.vstat)[:n],
                 art_sign=np.asarray(started.art_sign), phase=np.asarray(started.phase))

    jax_done = jax_solve_core(
        jA, b, c, lb, ub, cfg=cfg, max_iter=5000, basis0=jnp.asarray(state["basis"]),
        vstat0=jnp.asarray(state["vstat"]), art_sign0=jnp.asarray(state["art_sign"]),
        phase0=jnp.asarray(state["phase"]))
    warm = warm_start_from_numpy(**state, device="cpu")
    b_t, c_t, lb_t, ub_t = (torch.as_tensor(v, dtype=torch.float64) for v in (b, c, lb, ub))
    port_done = torch_solve_core(tA, b_t, c_t, lb_t, ub_t, TorchConfig(), 5000, **warm)

    assert int(jax_done.status) == jax_st.OPTIMAL
    assert int(port_done.status) == torch_st.OPTIMAL
    assert float(port_done.obj) == pytest.approx(float(jax_done.obj), rel=OBJ_REL)


@pytest.mark.parametrize("fmt", ["dense", "ell"])
def test_carried_state_never_aliases_jax_arrays(fmt):
    # the port copies what it takes from JAX: its in-place updates must not
    # write into JAX's (read-only) buffers, and taking them warns of nothing
    A, b, c, lb, ub = _boxed_sparse(64, 256, 0.05, 3)
    m, n = A.shape
    jA = jnp.asarray(A) if fmt == "dense" else jax_ell_from_csc(sp.csc_matrix(A), m, n)
    started = jax_solve_core(jA, b, c, lb, ub, cfg=JaxConfig(), max_iter=40)
    arrays = dict(basis=np.asarray(started.basis), vstat=np.asarray(started.vstat)[:n],
                  art_sign=np.asarray(started.art_sign), phase=np.asarray(started.phase))
    op_arrays = (dict(A=np.asarray(jA)) if fmt == "dense" else
                 dict(data=np.asarray(jA.data), rows=np.asarray(jA.rows),
                      rdata=np.asarray(jA.rdata), rcols=np.asarray(jA.rcols)))
    before = {k: v.copy() for k, v in {**arrays, **op_arrays}.items()}

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tA = operator_from_numpy(device="cpu", m=m if fmt == "ell" else None, **op_arrays)
        warm = warm_start_from_numpy(**arrays, device="cpu")
    tensors = [tA.A] if fmt == "dense" else [tA.data_t, tA.rows_t, tA.rdata_t, tA.rcols_t]
    tensors += [warm["basis0"], warm["vstat0"], warm["art_sign0"]]
    for t in tensors:
        assert not any(np.shares_memory(t.numpy(), a) for a in {**arrays, **op_arrays}.values())
    b_t, c_t, lb_t, ub_t = (torch.as_tensor(v, dtype=torch.float64) for v in (b, c, lb, ub))
    done = torch_solve_core(tA, b_t, c_t, lb_t, ub_t, TorchConfig(), 5000, **warm)
    assert int(done.status) == torch_st.OPTIMAL
    for k, v in before.items():
        np.testing.assert_array_equal({**arrays, **op_arrays}[k], v, err_msg=k)
