"""``reoptimize_with_bounds`` of the port against the JAX package's, on the
CPU: the three rungs of its ladder (the dual from the prior basis, the warm
primal, the cold primal), and a prior solve carried from one package into the
other through ``relp_tpu_torch.interop``.  Status equal, objective within 1e-9
relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import relp_tpu  # noqa: F401  (x64 on the CPU backend)
from relp_tpu.simplex import status as st
from relp_tpu.simplex.core import SolveOutput as JaxSolveOutput
from relp_tpu.simplex.core import solve_core as jax_solve_core
from relp_tpu.simplex.reoptimize import _repair_statuses as jax_repair_statuses
from relp_tpu.simplex.reoptimize import reoptimize_with_bounds as jax_reoptimize
from relp_tpu.utils.config import SolverConfig as JaxConfig
from relp_tpu_torch.interop import solve_output_from_numpy, solve_output_to_numpy
from relp_tpu_torch.simplex import reoptimize as torch_reoptimize_module
from relp_tpu_torch.simplex.core import solve_core
from relp_tpu_torch.simplex.reoptimize import _repair_statuses, reoptimize_with_bounds
from relp_tpu_torch.utils.config import SolverConfig
from tests.test_torch_dual import problem

OBJ_REL = 1e-9
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


def _tensors(*arrays):
    return [torch.tensor(a, dtype=torch.float64) for a in arrays]


def _solved_in_both(seed):
    A, b, c, lb, ub = problem(seed=seed)
    prior_j = jax_solve_core(A, b, c, lb, ub, cfg=JaxConfig(), max_iter=2000)
    prior_t = solve_core(*_tensors(A, b, c, lb, ub), SolverConfig(), 2000)
    assert int(prior_j.status) == int(prior_t.status) == st.OPTIMAL
    return (A, b, c, lb, ub), prior_j, prior_t


def _same(out_t, out_j):
    assert int(out_t.status) == int(out_j.status)
    if int(out_j.status) == st.OPTIMAL:
        assert float(out_t.obj) == pytest.approx(float(out_j.obj), rel=OBJ_REL)


@pytest.mark.parametrize("seed", [15, 16])
def test_first_rung_the_dual_from_the_prior_basis(seed, monkeypatch):
    (A, b, c, lb, ub), prior_j, prior_t = _solved_in_both(seed)
    ub2 = ub * (0.5 + np.random.default_rng(0).random(len(ub)))  # loosen and tighten
    out_j = jax_reoptimize(A, b, c, lb, ub2, prior_j, JaxConfig())
    # the dual answers: the primal must not be called
    monkeypatch.setattr(torch_reoptimize_module, "solve_core", None)
    out_t = reoptimize_with_bounds(A, b, c, lb, ub2, prior_t, SolverConfig(), device="cpu")
    _same(out_t, out_j)
    cold = jax_solve_core(A, b, c, lb, ub2, cfg=JaxConfig(), max_iter=2000)
    assert float(out_t.obj) == pytest.approx(float(cold.obj), abs=1e-8)
    assert int(out_t.it) < int(cold.it)


def test_second_rung_the_warm_primal_decides_what_the_dual_cannot(monkeypatch):
    # bounds clamped near zero while b stays far away: the dual reports
    # INFEASIBLE, which is not OPTIMAL, so the warm primal runs and its
    # verdict is returned; the cold primal is not needed
    (A, b, c, lb, ub), prior_j, prior_t = _solved_in_both(14)
    ub2 = np.full(len(ub), 1e-3)
    calls = []

    def watched(*args, **kwargs):
        calls.append("warm" if kwargs.get("basis0") is not None else "cold")
        return solve_core(*args, **kwargs)

    monkeypatch.setattr(torch_reoptimize_module, "solve_core", watched)
    out_j = jax_reoptimize(A, b, c, lb, ub2, prior_j, JaxConfig())
    out_t = reoptimize_with_bounds(A, b, c, lb, ub2, prior_t, SolverConfig(), device="cpu")
    assert int(out_t.status) == int(out_j.status) == st.INFEASIBLE
    assert calls == ["warm"]


def test_third_rung_the_cold_primal(monkeypatch):
    (A, b, c, lb, ub), _, prior_t = _solved_in_both(15)
    ub2 = ub * 0.9
    calls = []
    real = solve_core

    def watched(*args, **kwargs):
        calls.append("warm" if kwargs.get("basis0") is not None else "cold")
        if calls[-1] == "warm":  # a warm primal that cannot decide
            return real(*args[:5], args[5], 0, *args[7:], **kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch_reoptimize_module, "solve_core", watched)
    # a dual that cannot answer either: no iterations for it
    monkeypatch.setattr(torch_reoptimize_module, "solve_core_dual",
                        lambda *a, **k: real(*a[:5], a[7], 0))
    out = reoptimize_with_bounds(A, b, c, lb, ub2, prior_t, SolverConfig(), device="cpu")
    assert calls == ["warm", "cold"]
    ref = jax_solve_core(A, b, c, lb, ub2, cfg=JaxConfig(), max_iter=2000)
    assert int(out.status) == int(ref.status) == st.OPTIMAL
    assert float(out.obj) == pytest.approx(float(ref.obj), rel=OBJ_REL)


def test_prior_output_carried_across_packages():
    (A, b, c, lb, ub), prior_j, prior_t = _solved_in_both(16)
    ub2 = ub * (0.5 + np.random.default_rng(1).random(len(ub)))
    ref = jax_reoptimize(A, b, c, lb, ub2, prior_j, JaxConfig())
    # JAX prior -> the port
    fields = [np.asarray(v) for v in prior_j]
    before = [f.copy() for f in fields]
    carried = solve_output_from_numpy(fields, device="cpu")
    out_t = reoptimize_with_bounds(A, b, c, lb, ub2, carried, SolverConfig(), device="cpu")
    _same(out_t, ref)
    for t, a in zip(carried, fields):  # copied, never aliased
        if torch.is_tensor(t):
            assert not np.shares_memory(t.numpy(), a)
    for f, f0 in zip(fields, before):
        np.testing.assert_array_equal(f, f0)
    # the port's prior -> JAX
    arrays = solve_output_to_numpy(prior_t)
    back = JaxSolveOutput(**{k: jnp.asarray(v) for k, v in arrays.items()})
    assert back.basis.dtype == jnp.int32 and back.x.dtype == jnp.float64
    out_j = jax_reoptimize(A, b, c, lb, ub2, back, JaxConfig())
    _same(out_t, out_j)
    assert not np.shares_memory(arrays["x"], prior_t.x.numpy())


def test_repair_statuses_matches_jax():
    rng = np.random.default_rng(3)
    n = 64
    vstat = rng.integers(0, 5, n).astype(np.int32)
    lb = np.where(rng.random(n) < 0.3, -INF, rng.integers(0, 2, n).astype(float))
    ub = np.where(rng.random(n) < 0.3, INF, rng.integers(1, 3, n).astype(float))
    want = jax_repair_statuses(vstat, lb, ub)
    got = _repair_statuses(torch.tensor(vstat.astype(np.int64)), *_tensors(lb, ub))
    np.testing.assert_array_equal(got.numpy(), want)
