"""Multi-device solves of the port against the JAX package on the CPU.

The JAX package runs its meshes on the eight virtual CPU devices that
tests/conftest.py asks XLA for; the port takes the device list explicitly,
``["cpu"] * 8`` (a list may repeat a device), so one process runs the same
shard logic.

- ``make_solver_mesh``: the JAX package's shapes and errors.
- ``solve_sharded`` of tests/test_parallel.py's ``problem(16, 64, seed=3)``
  over 2, 4 and 8 shards on the dense, ELL and hybrid operators: objective
  and x to 1e-9 against ``relp_tpu.parallel.solve_sharded``; against the
  port's single solve equal status, iterations, basis and host reads (the
  shards price their blocks with the single operator's arithmetic).
- The driver with ``mesh_cols`` ∈ {0, 1, 2, 4, −1} on the dryrun's product
  LP (``__graft_entry__._problem(24, 64, seed=9)``, presolve off), WIKI_MPS
  and a max flow at N = 128 under ``matrix_format="ell"`` and ``"hybrid"``:
  the JAX package's status and objective within 1e-9 relative at the same
  ``mesh_cols``, and the iterations of the port's ``mesh_cols=1``.  A mesh
  that cannot shard logs the JAX package's warning.
- PDLP without crossover under a mesh (objective within 1e-6 relative of the
  JAX package's): ``pdlp_matrix="bricks"`` falls back to the operator
  ``matrix_format`` picks where the mesh shards, and keeps the bricks where it
  does not.
- ``solve_batched`` and ``solve_pdhg_batched`` with a mesh against the JAX
  package's meshed calls and the port's unmeshed ones; the CLI's
  ``--mesh-cols``; the dryrun.

The JAX side pads as the port does (``bucket_shapes=False``) wherever the
padded column count shows.
"""

import logging

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import maximum_flow

import relp_tpu  # noqa: F401  (x64 on the CPU backend)
import jax
from relp_tpu.api import solve as jax_solve
from relp_tpu.fom.pdhg import solve_pdhg_batched as jax_pdhg_batched
from relp_tpu.ops import amatrix as jax_amatrix
from relp_tpu.parallel import make_solver_mesh as jax_mesh
from relp_tpu.parallel import solve_batched as jax_solve_batched
from relp_tpu.parallel import solve_sharded as jax_solve_sharded
from relp_tpu.parallel.sharded import shard_inputs as jax_shard_inputs
from relp_tpu.simplex.core import solve_core as jax_solve_core
from relp_tpu.utils.config import SolverConfig as JaxConfig
from relp_tpu_torch import api, cli
from relp_tpu_torch.fom import solve_pdhg_batched
from relp_tpu_torch.io.mps_write import export_mps
from relp_tpu_torch.models.networks import max_flow_lp, random_arcs
from relp_tpu_torch.ops.amatrix import DenseMatrix, ell_from_csc, hybrid_from_csc
from relp_tpu_torch.parallel import make_solver_mesh, solve_batched, solve_sharded
from relp_tpu_torch.parallel.dryrun import dryrun_multichip, product_lp
from relp_tpu_torch.parallel.sharded import (
    DenseShards, EllShards, HybridShards, maybe_shard, shard_operator,
)
from relp_tpu_torch.simplex import status as st
from relp_tpu_torch.simplex.core import solve_core
from relp_tpu_torch.utils.config import SolverConfig
from tests.test_pipeline_fixture import WIKI_MPS

CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")


def problem(m, n, seed):
    """tests/test_parallel.py::problem."""
    rng = np.random.default_rng(seed)
    A = np.where(rng.random((m, n)) < 0.3, rng.standard_normal((m, n)), 0.0)
    A[np.arange(m), rng.integers(0, n, m)] = 1.0
    b = A @ rng.random(n)
    c = rng.standard_normal(n)
    return A, b, c, np.zeros(n), np.full(n, 10.0)


# ---- the mesh ----

@pytest.mark.parametrize("kw", [dict(batch=2, cols=4), dict(batch=2), dict(),
                                dict(batch=8, cols=1), dict(batch=1, cols=8)])
def test_make_solver_mesh_has_the_jax_shapes(eight_devices, kw):
    ref = jax_mesh(**kw)
    mesh = make_solver_mesh(**kw, devices=CPU8)
    assert mesh.shape == dict(ref.shape)
    assert np.asarray(ref.devices).shape == (len(mesh.devices), len(mesh.devices[0]))
    assert all(d == torch.device("cpu") for row in mesh.devices for d in row)


@pytest.mark.parametrize("kw", [dict(batch=3, cols=3), dict(batch=2, cols=3), dict(batch=3)])
def test_make_solver_mesh_refuses_as_jax_does(eight_devices, kw):
    with pytest.raises(ValueError) as ref:
        jax_mesh(**kw)
    with pytest.raises(ValueError) as got:
        make_solver_mesh(**kw, devices=CPU8)
    assert str(got.value) == str(ref.value)


# ---- the column-sharded solve ----

def _operators(A):
    """The port's and the JAX package's operator of ``A`` for each kind."""
    m, n = A.shape
    csc = sp.csc_matrix(A)
    k = int(np.diff(csc.indptr).max())
    return {
        "dense": (lambda: DenseMatrix(torch.tensor(A)), lambda: A),
        "ell": (lambda: ell_from_csc(csc, m, n, device="cpu"),
                lambda: jax_amatrix.ell_from_csc(csc, m, n, k)),
        # columns with more than 6 nonzeros spill into the dense block
        "hybrid": (lambda: hybrid_from_csc(csc, m, n, 6, 64, device="cpu"),
                   lambda: jax_amatrix.hybrid_from_csc(csc, m, n, 6, 64)),
    }


@pytest.mark.parametrize("kind", ["dense", "ell", "hybrid"])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_solve_sharded_matches_jax_and_the_single_solve(eight_devices, kind, k):
    A, b, c, lb, ub = problem(16, 64, seed=3)
    make_port, make_jax = _operators(A)[kind]
    cfg = SolverConfig()
    jmesh = jax_mesh(batch=1, cols=k, devices=jax.devices()[:k])
    if kind == "hybrid":
        # relp_tpu.parallel.solve_sharded reads the column count from A.m,
        # which its HybridMatrix lacks (sharded.py:104): run its two steps
        ref = jax_solve_core(*jax_shard_inputs(jmesh, make_jax(), b, c, lb, ub),
                             cfg=JaxConfig(), max_iter=500)
    else:
        ref = jax_solve_sharded(jmesh, make_jax(), b, c, lb, ub, cfg=JaxConfig(), max_iter=500)
    mesh = make_solver_mesh(batch=1, cols=k, devices=["cpu"] * k)
    out = solve_sharded(mesh, make_port(), b, c, lb, ub, cfg, 500)
    assert int(out.status) == int(ref.status) == st.OPTIMAL
    assert float(out.obj) == pytest.approx(float(ref.obj), abs=1e-9)
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), atol=1e-9)
    t = [torch.tensor(v) for v in (b, c, lb, ub)]
    one = solve_core(make_port(), *t, cfg, 500)
    assert int(one.status) == int(out.status) and int(one.it) == int(out.it)
    assert torch.equal(one.basis, out.basis) and torch.equal(one.vstat, out.vstat)
    assert one.host_reads == out.host_reads


@pytest.mark.parametrize("cfg", [SolverConfig(pricing="bland"), SolverConfig(pricing="dantzig"),
                                 SolverConfig(mixed_pricing=False), SolverConfig(price_blocks=2),
                                 SolverConfig(inverse="eta")],
                         ids=["bland", "dantzig", "f64", "partial", "eta"])
@pytest.mark.parametrize("kind", ["dense", "ell", "hybrid"])
def test_sharded_options_take_the_single_pivots(kind, cfg):
    """Bland's rule, Dantzig, f64 pricing, partial pricing (a window may
    cross a shard boundary) and the eta inverse over 4 shards."""
    A, b, c, lb, ub = problem(16, 64, seed=3)
    make_port = _operators(A)[kind][0]
    out = solve_sharded(make_solver_mesh(batch=1, cols=4, devices=["cpu"] * 4), make_port(),
                        b, c, lb, ub, cfg, 500)
    one = solve_core(make_port(), *(torch.tensor(v) for v in (b, c, lb, ub)), cfg, 500)
    assert int(one.status) == int(out.status) == st.OPTIMAL
    assert int(one.it) == int(out.it) and torch.equal(one.basis, out.basis)
    assert one.host_reads == out.host_reads
    torch.testing.assert_close(out.x, one.x, rtol=0, atol=1e-12)


def test_sharded_operator_reads_columns_as_the_single_one():
    """Column reads by an index that stays on the device, and the products,
    against the single operator, bit for bit; the hybrid operator has no
    fused selection, as its single operator has none."""
    A = problem(16, 64, seed=3)[0]
    rng = np.random.default_rng(0)
    pi, x = torch.tensor(rng.standard_normal(16)), torch.tensor(rng.standard_normal(64))
    Binv = torch.tensor(rng.standard_normal((16, 16)))
    idx = torch.tensor([63, 0, 17, 16, 31, 32, 5, 47])
    rows = torch.arange(8)
    for kind, (make, _) in _operators(A).items():
        one = make().with_f32()
        sh = shard_operator(make(), ["cpu"] * 4).with_f32()
        assert hasattr(sh, "price_select") == hasattr(one, "price_select") == (kind != "hybrid")
        assert isinstance(sh, {"ell": EllShards, "hybrid": HybridShards}.get(kind, type(sh)))
        for q in (0, 15, 16, 40, 63):
            qt = torch.tensor(q)
            assert torch.equal(sh.col(qt), one.col(qt))
            assert torch.equal(sh.ftran(Binv, qt), one.ftran(Binv, qt))
            assert torch.equal(sh.col_dot(pi, qt), one.col_dot(pi, qt))
        assert torch.equal(sh.cols_matrix(idx), one.cols_matrix(idx))
        assert torch.equal(sh.entries(rows, idx), one.entries(rows, idx))
        assert torch.equal(sh.price(x, pi), one.price(x, pi))
        assert torch.equal(sh.rmatvec(pi), one.rmatvec(pi))
        # the CPU's plain f32 sums of a narrower block may round otherwise
        # (the card's ELL kernel sums each column in slot order, as here in f64)
        f32 = dict(rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(sh.rmatvec32(pi.float()), one.rmatvec32(pi.float()), **f32)
        torch.testing.assert_close(sh.price32(x[8:40].float(), pi.float(), 8, 32),
                                   one.price32(x[8:40].float(), pi.float(), 8, 32), **f32)
        torch.testing.assert_close(sh.rmatvec32_block(pi.float(), 8, 32),
                                   one.rmatvec32_block(pi.float(), 8, 32), **f32)
        torch.testing.assert_close(sh.matvec(x), one.matvec(x), rtol=0, atol=1e-12)
        if kind != "dense":
            assert torch.equal(sh.matvec(x), one.matvec(x))


def test_maybe_shard_places_or_skips(caplog):
    A, b, c, lb, ub = problem(16, 64, seed=3)
    got = maybe_shard(-1, 64, A, b, c, lb, ub, devices=["cpu"] * 4)
    assert got[-1] is True and isinstance(got[0], DenseShards)
    assert got[0].bounds == [(0, 16), (16, 32), (32, 48), (48, 64)]
    assert all(torch.is_tensor(v) and v.dtype == torch.float64 for v in got[1:5])
    for mesh_cols, devices in ((0, 8), (1, 8), (3, 8), (8, 4)):
        with caplog.at_level(logging.WARNING, logger="relp_tpu_torch"):
            got = maybe_shard(mesh_cols, 64, A, b, c, lb, ub, devices=["cpu"] * devices)
        assert got[-1] is False and got[0] is A
    assert [r.getMessage() for r in caplog.records] == [
        "mesh_cols=3 skipped: n_pad=64 % 3 != 0 or only 8 devices",
        "mesh_cols=8 skipped: n_pad=64 % 8 != 0 or only 4 devices"]


def test_solve_sharded_refuses_an_indivisible_mesh():
    A, b, c, lb, ub = problem(16, 64, seed=3)
    with pytest.raises(ValueError, match="not divisible"):
        solve_sharded(make_solver_mesh(batch=1, cols=3, devices=["cpu"] * 3), A, b, c, lb, ub,
                      SolverConfig(), 500)


# ---- the driver's mesh branches ----

@pytest.fixture(scope="module")
def lp_files(tmp_path_factory):
    """name -> (MPS path, port config keywords, the LP's known objective or None)."""
    root = tmp_path_factory.mktemp("mesh")
    files = {}
    gf, _ = product_lp()
    export_mps(gf, str(root / "product.mps"))
    files["product"] = (str(root / "product.mps"), dict(presolve=False), None)
    (root / "wiki.mps").write_text(WIKI_MPS)
    files["wiki"] = (str(root / "wiki.mps"), {}, -8.0)
    arcs = random_arcs(128, 8, seed=7)
    u, v, cap = (np.array(col) for col in zip(*arcs))
    flow = float(maximum_flow(sp.csr_matrix((cap.astype(np.int32), (u, v)), shape=(128, 128)),
                              0, 127).flow_value)
    export_mps(max_flow_lp(128, arcs, 0, 127), str(root / "maxflow_128.mps"))
    for fmt in ("ell", "hybrid"):
        files[f"maxflow-{fmt}"] = (str(root / "maxflow_128.mps"), dict(matrix_format=fmt), flow)
    return files


_JAX_RESULTS = {}


def _jax_result(path, kw):
    key = (path, tuple(sorted(kw.items())))
    if key not in _JAX_RESULTS:
        _JAX_RESULTS[key] = jax_solve(path, JaxConfig(bucket_shapes=False, **kw))
    return _JAX_RESULTS[key]


@pytest.mark.parametrize("mesh_cols", [0, 1, 2, 4, -1])
@pytest.mark.parametrize("name", ["product", "wiki", "maxflow-ell", "maxflow-hybrid"])
def test_driver_mesh_cols_matches_jax(eight_devices, lp_files, name, mesh_cols):
    path, kw, known = lp_files[name]
    rj = _jax_result(path, dict(kw, mesh_cols=mesh_cols))
    rt = api.solve(path, SolverConfig(mesh_cols=mesh_cols, **kw), device="cpu", devices=CPU8)
    assert rt.kind.value == rj.kind.value == "finite_optimum"
    obj = rt.solution.objective_value
    assert obj == pytest.approx(rj.solution.objective_value, rel=1e-9, abs=1e-12)
    if known is not None:
        assert obj == pytest.approx(known, rel=1e-9)
    single = api.solve(path, SolverConfig(**kw), device="cpu")
    assert rt.simplex.metrics.iterations == single.simplex.metrics.iterations
    assert rt.simplex.metrics.host_reads == single.simplex.metrics.host_reads
    assert rt.simplex.metrics.matrix_format == single.simplex.metrics.matrix_format


def test_a_mesh_that_cannot_shard_warns_as_jax_does(eight_devices, lp_files, caplog):
    path = lp_files["product"][0]
    kw = dict(presolve=False, mesh_cols=3)  # n_pad = 128
    with caplog.at_level(logging.WARNING):
        rj = _jax_result(path, kw)
        jax_msgs = [r.getMessage() for r in caplog.records if r.name == "relp_tpu"]
        caplog.clear()
        rt = api.solve(path, SolverConfig(**kw), device="cpu", devices=CPU8)
        port_msgs = [r.getMessage() for r in caplog.records if r.name == "relp_tpu_torch"]
    want = "mesh_cols=3 skipped: n_pad=128 % 3 != 0 or only 8 devices"
    assert port_msgs == [want]
    assert want in jax_msgs or not jax_msgs  # logged once per process by the JAX side
    assert rt.solution.objective_value == pytest.approx(rj.solution.objective_value, rel=1e-9)


def test_more_shards_than_devices_solve_on_one(lp_files, caplog):
    path = lp_files["wiki"][0]
    with caplog.at_level(logging.WARNING, logger="relp_tpu_torch"):
        rt = api.solve(path, SolverConfig(mesh_cols=2), device="cpu")  # one visible CPU
    assert rt.solution.objective_value == -8.0
    assert [r.getMessage() for r in caplog.records] == [
        "mesh_cols=2 skipped: n_pad=128 % 2 != 0 or only 1 devices"]


@pytest.mark.parametrize("mesh_cols,layout", [(2, "dense"), (-1, "dense"), (3, "bricks")])
def test_pdlp_bricks_under_a_mesh(eight_devices, lp_files, mesh_cols, layout, caplog):
    """A mesh that shards takes the operator matrix_format picks (dense at
    N = 128) in place of the bricks; one that cannot keeps them and warns."""
    path, _, flow = lp_files["maxflow-ell"]
    kw = dict(algorithm="pdlp", pdlp_matrix="bricks", pdlp_crossover=False, mesh_cols=mesh_cols)
    rj = _jax_result(path, kw)
    with caplog.at_level(logging.WARNING, logger="relp_tpu_torch"):
        rt = api.solve(path, SolverConfig(**kw), device="cpu", devices=CPU8)
    met = rt.simplex.metrics
    assert rt.kind.value == rj.kind.value == "finite_optimum" and met.engine == "pdlp"
    assert met.fo_matrix == layout
    assert rt.solution.objective_value == pytest.approx(rj.solution.objective_value, rel=1e-6)
    assert rt.solution.objective_value == pytest.approx(flow, rel=1e-6)
    msgs = [r.getMessage() for r in caplog.records]
    if layout == "bricks":
        assert msgs[-1] == "pdlp mesh_cols=3 skipped (n_pad=1024, 8 devices) — keeping layout bricks"


def test_pdlp_under_a_mesh_equals_the_single_ell_run(lp_files):
    """On ELL the sharded first-order solve forms every product as the
    single operator does: the same iterations and the same point."""
    path = lp_files["maxflow-ell"][0]
    kw = dict(algorithm="pdlp", pdlp_crossover=False, matrix_format="ell")
    one = api.solve(path, SolverConfig(**kw), device="cpu")
    sh = api.solve(path, SolverConfig(mesh_cols=4, **kw), device="cpu", devices=["cpu"] * 4)
    assert sh.simplex.metrics.fo_iterations == one.simplex.metrics.fo_iterations
    assert sh.solution.objective_value == one.solution.objective_value


# ---- scenarios over 'batch' ----

def _stacked(seeds, m=16, n=64):
    probs = [problem(m, n, seed=s) for s in seeds]
    return [np.stack(arrs) for arrs in zip(*probs)]


def test_solve_batched_over_a_mesh(eight_devices):
    stacked = _stacked([10, 11, 12, 13])
    ref = jax_solve_batched(*stacked, cfg=JaxConfig(), max_iter=500,
                            mesh=jax_mesh(batch=2, cols=4))
    mesh = make_solver_mesh(batch=2, cols=4, devices=CPU8)
    out = solve_batched(*stacked, cfg=SolverConfig(), max_iter=500, mesh=mesh)
    flat = solve_batched(*stacked, cfg=SolverConfig(), max_iter=500, device="cpu")
    assert out.status.tolist() == np.asarray(ref.status).tolist()
    for i in range(4):
        if int(ref.status[i]) == st.OPTIMAL:
            assert float(out.obj[i]) == pytest.approx(float(ref.obj[i]), abs=1e-8)
    assert out.it.tolist() == flat.it.tolist() and torch.equal(out.basis, flat.basis)
    assert torch.equal(out.x, flat.x) and out.x.shape == (4, 64)


def test_solve_batched_over_a_mesh_with_a_shared_a_and_warm_starts():
    stacked = _stacked([20, 21, 22, 23, 24, 25], m=8, n=32)
    A = stacked[0][0]
    res = solve_batched(A, *stacked[1:], cfg=SolverConfig(), max_iter=300, device="cpu")
    warm = dict(basis0=res.basis.numpy(), vstat0=res.vstat[:, :32].numpy(),
                art_sign0=res.art_sign.numpy(), phase0=1)
    mesh = make_solver_mesh(batch=3, cols=1, devices=["cpu"] * 3)
    out = solve_batched(A, *stacked[1:], cfg=SolverConfig(), max_iter=300, mesh=mesh, warm=warm)
    flat = solve_batched(A, *stacked[1:], cfg=SolverConfig(), max_iter=300, warm=warm,
                         device="cpu")
    assert out.status.tolist() == flat.status.tolist() and out.it.tolist() == flat.it.tolist()
    assert torch.equal(out.basis, flat.basis) and out.host_reads > 0
    # a shared A's lanes go through one product X·Aᵀ, whose CPU rounding
    # depends on how many lanes it holds
    torch.testing.assert_close(out.x, flat.x, rtol=0, atol=1e-12)


def test_solve_batched_refuses_lanes_that_do_not_divide():
    stacked = _stacked([10, 11, 12])
    with pytest.raises(ValueError, match="do not divide"):
        solve_batched(*stacked, cfg=SolverConfig(), max_iter=100,
                      mesh=make_solver_mesh(batch=2, cols=1, devices=["cpu"] * 2))


def test_solve_pdhg_batched_over_a_mesh(eight_devices):
    """tests/test_pdlp.py's scenarios, four of them, over two 'batch' rows."""
    bs = np.array([0.5, 1.0, 1.5, 0.25])
    A = np.tile(np.array([[1.0, 1.0]]), (4, 1, 1))
    args = (A, bs.reshape(4, 1), np.tile([-1.0, -1.0], (4, 1)), np.zeros((4, 2)),
            np.ones((4, 2)))
    ref = jax_pdhg_batched(*args, tol=1e-8, mesh=jax_mesh(batch=2, cols=4))
    out = solve_pdhg_batched(*args, tol=1e-8, mesh=make_solver_mesh(batch=2, cols=4,
                                                                      devices=CPU8))
    flat = solve_pdhg_batched(*args, tol=1e-8, device="cpu")
    assert out.status.tolist() == [st.OPTIMAL] * 4 == np.asarray(ref.status).tolist()
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), atol=1e-6)
    assert out.it.tolist() == np.asarray(ref.it).tolist() == flat.it.tolist()
    assert torch.equal(out.x, flat.x)


# ---- the command line and the dryrun ----

def test_cli_mesh_cols(tmp_path, capsys, monkeypatch):
    path = tmp_path / "wiki.mps"
    path.write_text(WIKI_MPS)
    monkeypatch.setenv("RELP_TPU_TORCH_DEVICE", "cpu")
    for flags in (["--mesh-cols", "2"], ["--mesh-cols", "-1"], ["--mesh-cols=0"]):
        assert cli.main([*flags, "-q", str(path)]) == 0
        assert capsys.readouterr().out.strip() == "objective -8"


def test_dryrun_over_eight_devices(capsys):
    table = dryrun_multichip(CPU8)
    assert [row[0] for row in table] == [1, 2, 4, 8]
    assert all(row[3] >= 7 for row in table)
    assert capsys.readouterr().out.splitlines()[0] == \
        "devices  sharded_wall_s  batched8_wall_s  batched_optimal"
