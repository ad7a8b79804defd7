"""The port's brick operator (relp_tpu_torch/ops/bricks.py, the plain
versions of ops/brick_kernels.py) and ``pdlp_matrix="bricks"`` against the
JAX package's.

The same inputs, made with numpy from a seed, go through both packages on
the CPU (the port's kernels run their plain versions there):

- the layout arrays (flat with and without ``bucket``, grouped, the group
  breaks, the RCM orders) equal the JAX package's exactly, on the generated
  cases of tests/test_bricks.py and on edge cases (an empty tile, a tile
  whose nonzeros span every slot, a nonzero at the last column): the
  operators hold the compact form, which ``bricks.dense_bricks`` expands
  back to the JAX package's arrays, and the compact form holds each
  nonzero once, whatever the slot padding;
- ``matvec``, ``rmatvec`` and ``price`` within 1e-12 of the JAX operators
  (the sums run in another order), and the f64 re-layout bit for bit;
- the plain products in f32 against ``brick_spmv_pallas`` and
  ``brick_pricing_pallas`` in interpret mode, rel/abs 2e-5 (the tolerance of
  tests/test_pallas_kernels.py: f32 sums in another order);
- whole first-order solves under ``pdlp_matrix="bricks"``: status equal, the
  objective within 1e-6 relative without the crossover and 1e-9 with it, x
  and the duals within 1e-7 (both packages run the same f64 iteration in the
  same permuted space, so they stay within rounding of each other), the same
  ``matrix_format``, and scipy's max flow as an independent reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import maximum_flow

import relp_tpu  # noqa: F401  (x64 on the CPU backend)
from relp_tpu.api import solve as jax_solve
from relp_tpu.ops import bricks as jax_bricks
from relp_tpu.ops.pallas_kernels import brick_pricing_pallas, brick_spmv_pallas
from relp_tpu.simplex.driver import solve_computational_form as jax_solve_cf
from relp_tpu.utils.config import SolverConfig as JaxConfig
from relp_tpu_torch import api, cli
from relp_tpu_torch.io.mps_write import export_mps
from relp_tpu_torch.model.computational_form import ComputationalForm as TorchCF
from relp_tpu_torch.models.networks import max_flow_lp, random_arcs
from relp_tpu_torch.ops import brick_kernels, bricks
from relp_tpu_torch.simplex.driver import solve_computational_form as torch_solve_cf
from relp_tpu_torch.utils.config import SolverConfig as TorchConfig
from tests.test_torch_core import _boxed_sparse, _cf


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small vectors: a pool of threads only slows a PDHG step down (and
    starves the other test workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random(m, n, mp, np_, seed=42, density=0.05):
    """tests/test_bricks.py's matrix: sp.random(m, n) padded to (mp, np_)."""
    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=density, random_state=rng, format="csc")
    full = np.zeros((mp, np_))
    full[:m, :n] = A.toarray()
    return sp.csc_matrix(full)


def _skewed():
    """tests/test_bricks.py's grouped case: a sparse 512 × 768 with one dense tile."""
    A = sp.random(512, 768, density=0.01, random_state=3, format="lil")
    A[:8, :] = sp.random(8, 768, density=0.4, random_state=4).toarray()
    return sp.csc_matrix(A)


def _empty_tile():
    """A random 256 × 384 whose row tile 5 and column tile 9 are empty."""
    A = sp.random(256, 384, density=0.05, random_state=5, format="lil")
    A[40:48, :] = 0
    A[:, 72:80] = 0
    return sp.csc_matrix(A)


def _widest_tile():
    """Row tile 0 touches every column block and column tile 0 every row
    block: the tiles whose nonzeros span the most slots."""
    A = sp.random(384, 640, density=0.005, random_state=6, format="lil")
    for b in range(5):
        A[b % 8, 128 * b + 3 * b] = 1.0 + b
    for b in range(3):
        A[128 * b + 7, b % 8] = -2.0 - b
    return sp.csc_matrix(A)


def _last_column():
    """Nonzeros at the last row and the last column: the largest position words."""
    A = sp.random(128, 512, density=0.01, random_state=8, format="lil")
    A[127, 511] = 2.5
    A[0, 511] = -1.5
    A[127, 0] = 0.5
    return sp.csc_matrix(A)


def _shuffled_blocks():
    """tests/test_bricks.py's RCM case: a block diagonal hidden by shuffles."""
    rng = np.random.default_rng(1)
    A = sp.block_diag([sp.random(64, 64, density=0.2, random_state=rng)
                       for _ in range(4)]).tocsc()
    return A[rng.permutation(256)][:, rng.permutation(256)].tocsc()


MATRICES = {  # name -> (csc, m_pad, n_pad)
    "5x7": (_random(5, 7, 128, 128), 128, 128),
    "200x300": (_random(200, 300, 256, 384), 256, 384),
    "129x500": (_random(129, 500, 256, 512), 256, 512),
    "bucket": (_random(100, 200, 128, 256, seed=0, density=0.1), 128, 256),
    "skewed": (_skewed(), 512, 768),
    "zero": (sp.csc_matrix((256, 256)), 256, 256),
    "identity": (sp.identity(256, format="csc"), 256, 256),
    "shuffled-blocks": (_shuffled_blocks(), 256, 256),
    "empty-tile": (_empty_tile(), 256, 384),
    "widest-tile": (_widest_tile(), 384, 640),
    "last-column": (_last_column(), 128, 512),
}


def _bucket(b):
    return ((b + 7) // 8) * 8


def _eq(got, want):
    got = got.numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("bucket", [None, _bucket], ids=["tight", "bucket"])
def test_flat_layout_equals_the_jax_packages(name, bucket):
    csc, mp, np_ = MATRICES[name]
    want = jax_bricks.bricks_from_csc(csc, mp, np_, bucket=bucket)
    got = bricks.bricks_from_csc(csc, mp, np_, bucket=bucket, device="cpu")
    dense = bricks.dense_bricks(got)
    for leaf, arr in zip(("rdata", "ridx", "cdata", "cidx"), dense):
        _eq(arr, getattr(want, leaf))
    assert got.shape == want.shape == (mp, np_) and got.dtype == torch.float64
    if bucket is not None:
        assert got.rslots % 8 == 0 and got.cslots % 8 == 0
    # the numpy layout itself is the JAX package's
    r, c, v = bricks._coo(csc, mp, np_)
    for got_a, want_a in zip(bricks._slot_layout(r, c, v, mp, np_, got.rslots),
                             jax_bricks._slot_layout(r, c, v, mp, np_, got.rslots)):
        _eq(got_a, want_a)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_grouped_layout_equals_the_jax_packages(name):
    csc, mp, np_ = MATRICES[name]
    want = jax_bricks.grouped_bricks_from_csc(csc, mp, np_)
    got = bricks.grouped_bricks_from_csc(csc, mp, np_, device="cpu")
    rgroups, rinv, cgroups, cinv = bricks.dense_bricks(got)
    for side, g_got, inv_got in (("r", rgroups, rinv), ("c", cgroups, cinv)):
        g_want = getattr(want, f"{side}groups")
        assert len(g_got) == len(g_want) == len(getattr(got, f"{side}groups")) >= 1
        for (d, i), (dw, iw) in zip(g_got, g_want):
            _eq(d, dw)
            _eq(i, iw)
        _eq(inv_got, getattr(want, f"{side}inv"))
        _eq(getattr(got, f"{side}inv"), getattr(want, f"{side}inv"))
        # the store order of the kernels is the inverse of the JAX un-sort
        inv = getattr(got, f"{side}inv").long()
        tiles = getattr(got, f"{side}tiles")
        assert torch.equal(tiles.tile_of.long()[inv], torch.arange(len(inv)))
    # the numpy layout itself is the JAX package's
    r, c, v = bricks._coo(csc, mp, np_)
    (groups, inv), (groups_w, inv_w) = (mod._grouped_layout(r, c, v, mp, np_, 4)
                                        for mod in (bricks, jax_bricks))
    _eq(inv, inv_w)
    for (d, i), (dw, iw) in zip(groups, groups_w, strict=True):
        _eq(d, dw)
        _eq(i, iw)
    if name == "zero":   # one group of every tile, one empty slot each
        assert [d.shape for d, _ in rgroups] == [(32, 1, 8, 128)]
        assert got.rgroups == ((0, 32, 1),)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("max_groups", [1, 2, 4, 6])
def test_group_breaks_equal_the_jax_packages(seed, max_groups):
    rng = np.random.default_rng(seed)
    counts = np.sort(rng.integers(0, 12 + 10 * seed, 40 + 17 * seed))[::-1]
    assert bricks._group_breaks(counts, max_groups) == \
        jax_bricks._group_breaks(counts, max_groups)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_bandwidth_perm_equals_the_jax_packages(name):
    csc = MATRICES[name][0]
    for got, want in zip(bricks.bandwidth_perm(csc), jax_bricks.bandwidth_perm(csc)):
        _eq(got, want)
    if name == "shuffled-blocks":
        rp, cp = bricks.bandwidth_perm(csc)

        def count(M):
            C = M.tocoo()
            return len(set(zip(C.row // 8, C.col // 128)))

        assert count(csc[rp][:, cp]) < count(csc)


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("layout", ["flat", "grouped"])
def test_products_match_the_jax_operators(name, layout):
    csc, mp, np_ = MATRICES[name]
    if layout == "flat":
        want = jax_bricks.bricks_from_csc(csc, mp, np_)
        got = bricks.bricks_from_csc(csc, mp, np_, device="cpu")
    else:
        want = jax_bricks.grouped_bricks_from_csc(csc, mp, np_)
        got = bricks.grouped_bricks_from_csc(csc, mp, np_, device="cpu")
    rng = np.random.default_rng(9)
    x, y, c = rng.standard_normal(np_), rng.standard_normal(mp), rng.standard_normal(np_)
    ax = np.asarray(want.matvec(jnp.asarray(x)))
    aty = np.asarray(want.rmatvec(jnp.asarray(y)))
    np.testing.assert_allclose(got.matvec(torch.tensor(x)).numpy(), ax, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.rmatvec(torch.tensor(y)).numpy(), aty, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.price(torch.tensor(c), torch.tensor(y)).numpy(), c - aty,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(ax, csc @ x, rtol=0, atol=1e-12)   # and scipy
    # the f32 operator: the bricks cast, the ids shared
    g32 = got.astype(torch.float32)
    assert g32.dtype == torch.float32 and got.astype(torch.float64) is got
    np.testing.assert_allclose(g32.matvec(torch.tensor(x, dtype=torch.float32)).numpy(), ax,
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("layout", ["flat", "grouped"])
def test_values_survive_the_relayout_bit_for_bit(layout):
    vals = np.array([1e-300, 1.0 + 2**-52, -1e300, 3.141592653589793])
    rows, cols = [0, 3, 130, 7], [0, 129, 2, 255]
    A = sp.csc_matrix((vals, (rows, cols)), shape=(256, 256))
    build = bricks.bricks_from_csc if layout == "flat" else bricks.grouped_bricks_from_csc
    B = build(A, 256, 256, device="cpu")
    for v, i, j in zip(vals, rows, cols):
        x = torch.zeros(256, dtype=torch.float64)
        x[j] = 1.0
        assert B.matvec(x)[i].item() == v
        y = torch.zeros(256, dtype=torch.float64)
        y[i] = 1.0
        assert B.rmatvec(y)[j].item() == v


@pytest.mark.parametrize("seed", [7, 11])
def test_plain_products_match_the_pallas_kernels_in_f32(seed):
    A = sp.random(256, 512, density=0.02, random_state=np.random.default_rng(seed),
                  format="csc")
    B = bricks.bricks_from_csc(A, 256, 512, device="cpu").astype(torch.float32)
    rdata, ridx, cdata, cidx = bricks.dense_bricks(B)
    assert rdata.dtype == cdata.dtype == np.float32
    rng = np.random.default_rng(seed + 1)
    x, pi, c = (rng.standard_normal(k).astype(np.float32) for k in (512, 256, 512))
    # the Pallas kernels read the dense bricks the compact form expands to
    y_pl = np.asarray(brick_spmv_pallas(rdata, ridx, x, interpret=True))
    d_pl = np.asarray(brick_pricing_pallas(cdata, cidx, pi, c, interpret=True))
    y_t = brick_kernels.brick_spmv_plain(B.rtiles, torch.tensor(x))
    d_t = brick_kernels.brick_price_plain(B.ctiles, torch.tensor(pi), torch.tensor(c))
    assert y_t.dtype == d_t.dtype == torch.float32
    assert y_t.numpy() == pytest.approx(y_pl, rel=2e-5, abs=2e-5)
    assert d_t.numpy() == pytest.approx(d_pl, rel=2e-5, abs=2e-5)
    # the wrappers on CPU tensors are the plain versions and count nothing
    before = (brick_kernels.brick_spmv.launches, brick_kernels.brick_price.launches)
    assert torch.equal(brick_kernels.brick_spmv(B.rtiles, torch.tensor(x)), y_t)
    assert before == (brick_kernels.brick_spmv.launches, brick_kernels.brick_price.launches)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    B = bricks.bricks_from_csc(sp.identity(128, format="csc"), 128, 128, device="cpu")
    x = torch.ones(128, dtype=torch.float64)
    t = B.rtiles
    with pytest.raises(TypeError):
        brick_kernels.brick_spmv(t, x.float())
    with pytest.raises(ValueError):
        brick_kernels.brick_spmv(t, x[:100])
    with pytest.raises(ValueError):
        brick_kernels.brick_price(B.ctiles, x, x[:64])
    with pytest.raises(ValueError, match="multiples of 128"):
        bricks.bricks_from_csc(sp.identity(100, format="csc"), 100, 128, device="cpu")
    # what the kernels index without a bounds check is refused where the tiles are built
    bad_ptr = t.ptr.clone()
    bad_ptr[3], bad_ptr[4] = bad_ptr[4], bad_ptr[3] - 1
    with pytest.raises(ValueError, match="offsets"):
        brick_kernels.brick_tiles(bad_ptr, t.vals, t.pos, None, 128)
    with pytest.raises(ValueError, match="column outside"):
        brick_kernels.brick_tiles(t.ptr, t.vals, t.pos + 8 * 128, None, 128)
    with pytest.raises(TypeError):
        brick_kernels.brick_tiles(t.ptr, t.vals.to(torch.float16), t.pos, None, 128)
    with pytest.raises(ValueError, match="permutation"):
        brick_kernels.brick_tiles(t.ptr, t.vals, t.pos, torch.zeros(16, dtype=torch.int32), 128)
    with pytest.raises(ValueError, match="inconsistent"):
        bricks.BrickMatrix(B.rtiles, 1, B.ctiles, 1, 256, 128)


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("layout", ["flat", "bucket", "grouped"])
def test_compact_form_holds_each_nonzero_once(name, layout):
    """Per orientation the compact form holds every nonzero of A once, its
    value bit for bit and its (row, column) in the position word, tiles in
    the layout's order and each tile's nonzeros in the bricks' slot order;
    slot padding adds no entry."""
    csc, mp, np_ = MATRICES[name]
    if layout == "grouped":
        op = bricks.grouped_bricks_from_csc(csc, mp, np_, device="cpu")
    else:
        op = bricks.bricks_from_csc(csc, mp, np_, bucket=_bucket if layout == "bucket" else None,
                                    device="cpu")
    coo = csc.tocoo()
    for tiles, rows, cols, width in ((op.rtiles, coo.row, coo.col, np_),
                                     (op.ctiles, coo.col, coo.row, mp)):
        assert tiles.vals.shape == tiles.pos.shape == (csc.nnz,) and tiles.width == width
        ptr = tiles.ptr.numpy().astype(np.int64)
        pos = tiles.pos.numpy().astype(np.int64)
        assert ptr[0] == 0 and ptr[-1] == csc.nnz and (np.diff(ptr) >= 0).all()
        s = np.repeat(np.arange(tiles.tiles), np.diff(ptr))
        orig = s if tiles.tile_of is None else tiles.tile_of.numpy()[s]
        got = sorted(zip(orig * 8 + (pos & 7), pos >> 3, tiles.vals.numpy()))
        assert got == sorted(zip(rows.tolist(), cols.tolist(), coo.data.tolist()))
        # slot order inside each tile: by block, then row-major in the brick
        key = s * (width // 128) + (pos >> 3) // 128
        key = (key * 8 + (pos & 7)) * 128 + (pos >> 3) % 128
        assert (np.diff(key) > 0).all()
        assert tiles.lanes == brick_kernels.tile_lanes(csc.nnz, tiles.tiles)
    if name == "zero":
        assert op.rtiles.ptr.abs().sum() == 0 and op.rtiles.lanes == 8


@pytest.fixture(scope="module")
def flow_file(tmp_path_factory):
    """A max flow at N = 128 as an MPS file, with scipy's max-flow value."""
    arcs = random_arcs(128, 8, seed=7)
    u, v, cap = (np.array(col) for col in zip(*arcs))
    graph = sp.csr_matrix((cap.astype(np.int32), (u, v)), shape=(128, 128))
    path = tmp_path_factory.mktemp("bricks") / "maxflow_128.mps"
    export_mps(max_flow_lp(128, arcs, 0, 127), str(path))
    return str(path), float(maximum_flow(graph, 0, 127).flow_value)


def _values(res):
    return np.array([v for _, v in res.solution.solution_values])


@pytest.mark.parametrize("crossover,rel", [(False, 1e-6), (True, 1e-9)])
def test_max_flow_on_bricks_matches_jax(flow_file, crossover, rel):
    path, flow = flow_file
    kw = dict(algorithm="pdlp", pdlp_matrix="bricks", pdlp_crossover=crossover)
    rj = jax_solve(path, JaxConfig(bucket_shapes=False, **kw))
    rt = api.solve(path, TorchConfig(**kw), device="cpu")
    assert rt.kind.value == rj.kind.value == "finite_optimum"
    assert rt.solution.objective_value == pytest.approx(rj.solution.objective_value, rel=rel)
    assert rt.solution.objective_value == pytest.approx(flow, rel=rel)
    np.testing.assert_allclose(_values(rt), _values(rj), rtol=0, atol=1e-7)
    np.testing.assert_allclose(rt.simplex.duals, rj.simplex.duals, rtol=0, atol=1e-7)
    met = rt.simplex.metrics
    assert met.matrix_format == rj.simplex.metrics.matrix_format
    assert met.fo_matrix == "bricks" and met.fo_iterations > 0 and met.fo_setup_s > 0
    assert met.engine == ("pdlp+crossover" if crossover else "pdlp")
    if crossover:
        assert rt.solution.objective_value == flow


def test_boxed_lp_on_bricks_matches_jax():
    args = _boxed_sparse(64, 256, 0.05, seed=5)
    kw = dict(algorithm="pdlp", pdlp_matrix="bricks", pdlp_crossover=False)
    rj = jax_solve_cf(_cf(relp_tpu.model.computational_form.ComputationalForm, *args[:3],
                          lb=args[3], ub=args[4]), JaxConfig(bucket_shapes=False, **kw))
    rt = torch_solve_cf(_cf(TorchCF, *args[:3], lb=args[3], ub=args[4]), TorchConfig(**kw),
                        device="cpu")
    assert rt.kind.value == rj.kind.value == "finite_optimum"
    assert rt.objective == pytest.approx(rj.objective, rel=1e-6)
    np.testing.assert_allclose(rt.x_structural, rj.x_structural, rtol=0, atol=1e-7)
    np.testing.assert_allclose(rt.duals, rj.duals, rtol=0, atol=1e-7)
    assert rt.metrics.matrix_format == rj.metrics.matrix_format
    assert rt.metrics.fo_matrix == "bricks" and rt.metrics.engine == "pdlp"


def test_cli_runs_the_brick_operator(flow_file, capsys, monkeypatch):
    path, flow = flow_file
    seen = []
    price = bricks.brick_price

    def counting(*args, **kwargs):
        seen.append(1)
        return price(*args, **kwargs)

    monkeypatch.setattr(bricks, "brick_price", counting)
    monkeypatch.setenv("RELP_TPU_TORCH_DEVICE", "cpu")
    rc = cli.main(["--algorithm", "pdlp", "--pdlp-matrix", "bricks", "-q", path])
    assert rc == 0 and capsys.readouterr().out.strip() == f"objective {flow:.12g}"
    assert len(seen) > 100   # every PDHG step priced on the bricks
