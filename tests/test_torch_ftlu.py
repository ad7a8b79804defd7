"""The port's binding of the native Forrest–Tomlin LU engine
(relp_tpu_torch/simplex/ftlu.py over native/ftlu.cpp), and the host LU module
with that engine against the JAX package's.

The six cases of tests/test_ftlu.py on the port's binding (solves against
scipy's SuperLU, 1e-10; long update sequences against the explicitly updated
matrix), then: the library is the port's own build under
``relp_tpu_torch/_build/``, written whole; ``_make_lu`` picks the engine as
the JAX package does; and ``solve_dual_lu`` and ``primal_push`` on the FT
engine equal the JAX package's on its FT engine, exactly (the same C++ source
and the same numpy code; the JAX binding loads this package's build of that
source for the comparison).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse.linalg import splu

from relp_tpu.simplex import ftlu as jax_ftlu
from relp_tpu.simplex import lu_host as jax_lu
from relp_tpu.utils.config import SolverConfig as JaxConfig
from relp_tpu_torch.simplex import ftlu
from relp_tpu_torch.simplex import lu_host as torch_lu
from relp_tpu_torch.simplex import status as st
from relp_tpu_torch.utils import native_build
from relp_tpu_torch.utils.config import SolverConfig as TorchConfig
from tests.test_torch_lu_host import _boxed_lp

pytestmark = pytest.mark.skipif(
    not ftlu.available(), reason="native ftlu build unavailable"
)


def _random_sparse(m, density, rng, diag_boost=2.0):
    A = sp.random(m, m, density=density, random_state=rng, format="csc")
    A = A + diag_boost * sp.eye(m, format="csc")  # comfortably nonsingular
    return A.tocsc()


def test_solves_match_superlu():
    rng = np.random.default_rng(7)
    for m, density in [(5, 0.8), (40, 0.2), (300, 0.02)]:
        A = _random_sparse(m, density, rng)
        F = ftlu.FtLU(A)
        ref = splu(A)
        for _ in range(3):
            v = rng.standard_normal(m)
            np.testing.assert_allclose(
                F.ftran(v), ref.solve(v), rtol=1e-10, atol=1e-10
            )
            np.testing.assert_allclose(
                F.btran(v), ref.solve(v, trans="T"), rtol=1e-10, atol=1e-10
            )


def test_singular_raises():
    A = sp.csc_matrix(np.array([[1.0, 2.0], [2.0, 4.0]]))
    with pytest.raises(RuntimeError):
        ftlu.FtLU(A)

    # structurally empty column
    B = sp.csc_matrix(np.array([[1.0, 0.0], [3.0, 0.0]]))
    with pytest.raises(RuntimeError):
        ftlu.FtLU(B)


def test_update_matches_fresh_factorization():
    rng = np.random.default_rng(3)
    m = 60
    A = _random_sparse(m, 0.1, rng).toarray()
    F = ftlu.FtLU(sp.csc_matrix(A))
    for k in range(30):
        slot = int(rng.integers(m))
        col = np.zeros(m)
        nz = rng.choice(m, size=5, replace=False)
        col[nz] = rng.standard_normal(5)
        col[slot] += 3.0  # keep the updated matrix well-conditioned
        A[:, slot] = col
        rows = np.flatnonzero(col).astype(np.int32)
        rc = F.update(slot, rows, col[rows])
        assert rc in (0, 1)
        v = rng.standard_normal(m)
        x = F.ftran(v)
        np.testing.assert_allclose(A @ x, v, rtol=1e-8, atol=1e-8)
        y = F.btran(v)
        np.testing.assert_allclose(A.T @ y, v, rtol=1e-8, atol=1e-8)
    assert F.nupdates == 30


def test_long_degenerate_update_sequence_stays_accurate():
    """The crossover regime: hundreds of updates, many nearly-parallel
    columns.  The FT engine must stay usable where product-form etas
    compound error."""
    rng = np.random.default_rng(11)
    m = 120
    A = _random_sparse(m, 0.06, rng).toarray()
    F = ftlu.FtLU(sp.csc_matrix(A))
    worst = 0.0
    refactors = 0
    for k in range(400):
        slot = int(rng.integers(m))
        base = A[:, int(rng.integers(m))]
        col = base + 1e-4 * rng.standard_normal(m)  # nearly parallel
        col[slot] += 2.0
        A[:, slot] = col
        rows = np.arange(m, dtype=np.int32)
        rc = F.update(slot, rows, col)
        if rc != 0 or F.nupdates >= 64:
            F = ftlu.FtLU(sp.csc_matrix(A))
            refactors += 1
        v = rng.standard_normal(m)
        x = F.ftran(v)
        worst = max(worst, float(np.max(np.abs(A @ x - v))))
    assert worst < 1e-6, f"FT drift {worst:.3e} over 400 updates"
    assert refactors < 40


def test_update_of_identity_slot():
    """Replace an artificial (identity) column — the crossover's common
    first move."""
    m = 10
    A = np.eye(m)
    F = ftlu.FtLU(sp.csc_matrix(A))
    col = np.zeros(m)
    col[3] = 2.0
    col[7] = -1.0
    A[:, 3] = col
    F.update(3, np.array([3, 7], np.int32), np.array([2.0, -1.0]))
    v = np.arange(1.0, m + 1)
    np.testing.assert_allclose(A @ F.ftran(v), v, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(A.T @ F.btran(v), v, rtol=1e-12, atol=1e-12)


def test_stress_backward_error_random_updates():
    """Randomized stress: 40 random matrices × random update sequences;
    the componentwise backward error of every solve stays near machine
    precision (the FT update's stability claim, quantified)."""
    rng = np.random.default_rng(123)
    worst = 0.0
    for trial in range(12):
        m = int(rng.integers(5, 120))
        density = float(rng.uniform(0.02, 0.5))
        A = sp.random(m, m, density=density, random_state=rng, format="csc")
        A = A + (0.5 + rng.random()) * sp.eye(m, format="csc")
        Ad = A.toarray()
        F = ftlu.FtLU(A.tocsc())
        nup = 0
        for _ in range(int(rng.integers(5, 40))):
            v = rng.standard_normal(m)
            x = F.ftran(v)
            normA = np.abs(Ad).sum(axis=1).max()
            bw = np.max(np.abs(Ad @ x - v)) / (
                normA * max(np.max(np.abs(x)), 1e-300) + np.max(np.abs(v))
            )
            worst = max(worst, bw)
            slot = int(rng.integers(m))
            nz = rng.choice(
                m, size=min(m, int(rng.integers(1, 8))), replace=False
            )
            col = np.zeros(m)
            col[nz] = rng.standard_normal(len(nz))
            col[slot] += 1.5 + rng.random()
            Ad[:, slot] = col
            rows = np.flatnonzero(col).astype(np.int32)
            rc = F.update(slot, rows, col[rows])
            nup += 1
            if rc != 0 or nup >= 48:
                F = ftlu.FtLU(sp.csc_matrix(Ad))
                nup = 0
    assert worst < 1e-8, f"backward error {worst:.3e}"


def test_library_is_the_ports_own_build_and_is_written_whole(tmp_path, monkeypatch):
    assert ftlu.available()
    built = sorted(native_build.BUILD_DIR.glob("libftlu_*.so"))
    assert built and native_build.BUILD_DIR.name == "_build"
    assert native_build.BUILD_DIR.parent.name == "relp_tpu_torch"
    # a fresh build directory: the library appears under its final name only
    # once g++ has finished (temporary directory, then a rename), and nothing
    # else is left behind
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "_build")
    lib = native_build._build_and_load(native_build.NATIVE_DIR / "ftlu.cpp", ("-O3",), 180)
    assert lib is not None and hasattr(lib, "ftlu_create")
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [built[0].name]
    # no source, no library: the caller takes the product form
    assert native_build._build_and_load(native_build.NATIVE_DIR / "absent.cpp", (), 10) is None


def test_make_lu_picks_the_engine_as_the_jax_package_does(monkeypatch):
    A, *_ = _boxed_lp(0)
    B = A[:, -A.shape[0]:].tocsc()
    monkeypatch.delenv("RELP_TPU_NO_FTLU", raising=False)
    assert torch_lu.lu_engine() == "forrest-tomlin"
    assert isinstance(torch_lu._make_lu(B, A), torch_lu._FtEngine)
    assert isinstance(jax_lu._make_lu(B, A), jax_lu._FtEngine) == jax_ftlu.available()
    monkeypatch.setenv("RELP_TPU_NO_FTLU", "1")
    assert torch_lu.lu_engine() == "product-form"
    assert isinstance(torch_lu._make_lu(B, A), torch_lu._LuEta)


def _jax_binding_on_the_ports_build(monkeypatch):
    """Point the JAX package's ftlu binding at this package's own build of
    the same native/ftlu.cpp (written whole under a hashed name), for one
    test: the JAX package builds straight into native/_build/libftlu.so, and
    test workers that collect at once can race on that path.  monkeypatch
    restores the binding's state afterwards."""
    monkeypatch.setattr(jax_ftlu, "_SO", Path(ftlu.load()._name))
    monkeypatch.setattr(jax_ftlu, "_lib", None)
    monkeypatch.setattr(jax_ftlu, "_lib_failed", False)
    assert jax_ftlu.available()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lu_host_on_the_ft_engine_equals_the_jax_packages(seed, monkeypatch):
    monkeypatch.delenv("RELP_TPU_NO_FTLU", raising=False)
    _jax_binding_on_the_ports_build(monkeypatch)
    A, b, c, lb, ub, x0, rng = _boxed_lp(seed)
    m, n = A.shape
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
    for name in ("basis", "vstat", "x", "pi"):
        assert np.array_equal(np.asarray(getattr(out_t, name)), np.asarray(getattr(out_j, name)))
    # the push of every superbasic, on the same engine in both packages
    basis1 = np.arange(n - m, n)
    vstat1 = np.full(n + m, st.NB_LOWER, np.int32)
    vstat1[: n - m] = st.NB_FREE
    vstat1[basis1] = st.BASIC
    push = np.zeros(n, bool)
    push[: n - m] = True
    args = (A, b, basis1, vstat1, lb, ub, push, x0.copy(), np.ones(m), n)
    for a, bb in zip(torch_lu.primal_push(*args), jax_lu.primal_push(*args)):
        assert np.array_equal(np.asarray(a), np.asarray(bb))
