"""The port's basis-state checker and checkpoint (relp_tpu_torch/simplex/
validate.py, checkpoint.py) against the JAX package's, on the CPU: mirrors
tests/test_validate_checkpoint.py, holds the four residuals against the JAX
checker's on the same state (1e-12), checks the final state of a dual solve,
and loads a checkpoint written by one package in the other."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import relp_tpu  # noqa: F401  (x64 on the CPU backend)
from relp_tpu.simplex import status as st
from relp_tpu.simplex.checkpoint import BasisCheckpoint as JaxCheckpoint
from relp_tpu.simplex.core import solve_core as jax_solve_core
from relp_tpu.simplex.validate import check_state as jax_check_state
from relp_tpu.utils.config import SolverConfig as JaxConfig
from relp_tpu_torch.ops.amatrix import ell_from_csc
from relp_tpu_torch.simplex.checkpoint import BasisCheckpoint
from relp_tpu_torch.simplex.core import solve_core
from relp_tpu_torch.simplex.dual import solve_core_dual
from relp_tpu_torch.simplex.validate import StateCheck, check_state
from relp_tpu_torch.utils.config import SolverConfig

CFG = SolverConfig()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The vectors here are tens of elements: a simplex step is a few hundred
    tiny ops, which a pool of threads only slows down (and, with several test
    workers on one machine, starves the others)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def problem(m=16, n=48, seed=7):
    rng = np.random.default_rng(seed)
    A = np.where(rng.random((m, n)) < 0.4, rng.standard_normal((m, n)), 0.0)
    A[np.arange(m), rng.integers(0, n, m)] = 1.0
    b = A @ rng.random(n)
    c = rng.standard_normal(n)
    return A, b, c, np.zeros(n), np.full(n, 10.0)


def _t(*arrays):
    return [torch.tensor(a, dtype=torch.float64) for a in arrays]


def _final_state(A, out):
    """Binv and xB rebuilt from a solve's basis as the engine's refactor does."""
    m, n = A.shape
    basis = out.basis.numpy()
    is_art = basis >= n
    B = np.where(
        is_art[None, :],
        (np.arange(m)[:, None] == np.clip(basis - n, 0, m - 1)[None, :]).astype(float),
        A[:, np.clip(basis, 0, n - 1)],
    )
    xB = out.x.numpy()[np.clip(basis, 0, n - 1)] * (~is_art)
    return basis, np.linalg.inv(B), xB


@pytest.mark.parametrize("fmt", ["dense", "ell"])
def test_final_state_passes_invariants(fmt):
    A, b, c, lb, ub = problem()
    m, n = A.shape
    out = solve_core(*_t(A, b, c, lb, ub), CFG, 500)
    assert int(out.status) == st.OPTIMAL
    basis, Binv, xB = _final_state(A, out)
    op = torch.tensor(A) if fmt == "dense" else ell_from_csc(sp.csc_matrix(A), m, n, device="cpu")
    chk = check_state(op, *_t(b, c, lb, ub), out.basis, out.vstat, *_t(xB, Binv, np.ones(m)))
    assert isinstance(chk, StateCheck) and chk.ok(1e-7), chk
    want = jax_check_state(A, b, c, lb, ub, basis, out.vstat.numpy(), xB, Binv, np.ones(m))
    for got, ref in zip(chk, want):
        assert float(got) == pytest.approx(float(ref), abs=1e-12)


def test_broken_states_fail_each_residual():
    A, b, c, lb, ub = problem()
    m = A.shape[0]
    out = solve_core(*_t(A, b, c, lb, ub), CFG, 500)
    basis, Binv, xB = _final_state(A, out)
    ones = np.ones(m)

    def check(**changed):
        args = dict(b=b, c=c, lb=lb, ub=ub, xB=xB, Binv=Binv)
        args.update(changed)
        t = {k: torch.tensor(v, dtype=torch.float64) for k, v in args.items()}
        got = check_state(torch.tensor(A), t["b"], t["c"], t["lb"], t["ub"], out.basis,
                          out.vstat, t["xB"], t["Binv"], torch.tensor(ones))
        want = jax_check_state(A, args["b"], args["c"], args["lb"], args["ub"], basis,
                               out.vstat.numpy(), args["xB"], args["Binv"], ones)
        for g, w in zip(got, want):
            assert float(g) == pytest.approx(float(w), rel=1e-12, abs=1e-12)
        return got

    scaled = check(Binv=Binv * 1.01)  # π = c_B·B⁻¹ is then off too
    assert float(scaled.inverse_residual) > 1e-3 and float(scaled.basis_reduced_cost) > 1e-4
    assert float(check(xB=xB - 1.0).bound_violation) > 0.5
    bad = check(b=b + 1.0)
    assert float(bad.row_residual) > 0.5 and not bad.ok()


def test_dual_solve_final_state_passes_invariants():
    A, b, c, lb, ub = problem(seed=9)
    n = A.shape[1]
    out = solve_core(*_t(A, b, c, lb, ub), CFG, 500)
    ub2 = ub.copy()
    ub2[:6] = 0.2
    kept = []
    dual = solve_core_dual(A, b, c, lb, ub2, out.basis, out.vstat[:n], CFG, 500,
                           art_sign0=out.art_sign, device="cpu", final_state=kept)
    assert int(dual.status) == st.OPTIMAL
    (K, s), = kept
    chk = check_state(K.A, K.b, K.c, K.lb, K.ub, s.basis, s.vstat, s.xB, s.Binv, K.art_sign)
    assert chk.ok(1e-6), chk


def test_checkpoint_roundtrip(tmp_path):
    A, b, c, lb, ub = problem(seed=8)
    args = _t(A, b, c, lb, ub)
    out = solve_core(*args, CFG, 500)
    assert int(out.status) == st.OPTIMAL
    ck = BasisCheckpoint.from_solve_output(out, n_padded=A.shape[1])
    path = tmp_path / "basis.npz"
    ck.save(path)
    loaded = BasisCheckpoint.load(path)
    np.testing.assert_array_equal(loaded.basis, ck.basis)
    assert loaded.iterations == int(out.it) and loaded.n_padded == A.shape[1]

    # resume warm: should re-verify optimality in very few iterations
    basis0, vstat0 = loaded.warm_start_args()
    out2 = solve_core(*args, CFG, 500, basis0=basis0, vstat0=vstat0)
    assert int(out2.status) == st.OPTIMAL
    assert float(out2.obj) == pytest.approx(float(out.obj), abs=1e-9)
    assert int(out2.it) <= 3


def test_checkpoint_of_one_package_loads_in_the_other(tmp_path):
    A, b, c, lb, ub = problem(seed=8)
    n = A.shape[1]
    out_j = jax_solve_core(A, b, c, lb, ub, cfg=JaxConfig(), max_iter=500)
    out_t = solve_core(*_t(A, b, c, lb, ub), CFG, 500)
    JaxCheckpoint.from_solve_output(out_j, n_padded=n).save(tmp_path / "jax.npz")
    BasisCheckpoint.from_solve_output(out_t, n_padded=n).save(tmp_path / "port.npz")

    # the JAX package's file warm-starts the port
    basis0, vstat0 = BasisCheckpoint.load(tmp_path / "jax.npz").warm_start_args()
    resumed = solve_core(*_t(A, b, c, lb, ub), CFG, 500, basis0=basis0, vstat0=vstat0)
    assert int(resumed.status) == st.OPTIMAL and int(resumed.it) <= 3
    assert float(resumed.obj) == pytest.approx(float(out_j.obj), abs=1e-9)

    # the port's file warm-starts the JAX package
    loaded = JaxCheckpoint.load(tmp_path / "port.npz")
    assert loaded.basis.dtype == np.int32 and loaded.vstat.dtype == np.int32
    basis0, vstat0 = loaded.warm_start_args()
    resumed_j = jax_solve_core(A, b, c, lb, ub, cfg=JaxConfig(), max_iter=500,
                               basis0=basis0, vstat0=vstat0)
    assert int(resumed_j.status) == st.OPTIMAL and int(resumed_j.it) <= 3
    assert float(resumed_j.obj) == pytest.approx(float(out_t.obj), abs=1e-9)
