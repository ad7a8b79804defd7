"""Tests of relp_tpu_torch that need an NVIDIA GPU (the ``cuda`` marker).

They skip where there is no GPU.  The machine with the card has no JAX, so
this file imports none, and it runs there without tests/conftest.py (which
imports the JAX package):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.optimize import linprog
from scipy.sparse.csgraph import maximum_flow

from relp_tpu_torch import api, probe
from relp_tpu_torch.io.mps_write import export_mps
from relp_tpu_torch.models.dense import dense_lp, dense_lp_data
from relp_tpu_torch.models.networks import max_flow_lp, random_arcs
from relp_tpu_torch.ops.dense_kernels import (
    dense_price,
    dense_price_lanes,
    dense_price_lanes_plain,
    dense_price_plain,
    dense_price_select,
    dense_price_select_lanes,
    dense_price_select_lanes_plain,
    dense_price_select_plain,
    lane_plan,
)
from relp_tpu_torch.ops.brick_kernels import (
    brick_price,
    brick_price_plain,
    brick_spmv,
    brick_spmv_plain,
    brick_tiles,
)
from relp_tpu_torch.ops.bricks import bricks_from_csc, grouped_bricks_from_csc
from relp_tpu_torch.ops.probe_kernels import probe_scale_f32, probe_scale_f64
from relp_tpu_torch.ops.sparse_kernels import (
    ell_price,
    ell_price_plain,
    ell_price_select,
    ell_price_select_plain,
    ell_spmv,
    ell_spmv_plain,
)
from relp_tpu_torch.utils.config import SolverConfig

pytestmark = pytest.mark.cuda

# f32 sums run in another order than the plain version's
TOLS = [(torch.float32, 2e-5), (torch.float64, 1e-12)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", TOLS)
def test_kernels_match_plain_versions(cuda, dtype, tol):
    rng = np.random.default_rng(3)
    m, n, K = 4096, 32768, 8
    data = torch.as_tensor(rng.standard_normal((K, n)), dtype=dtype, device=cuda)
    idx = torch.as_tensor(rng.integers(0, m, (K, n)).astype(np.int32), device=cuda)
    y = torch.as_tensor(rng.standard_normal(m), dtype=dtype, device=cuda)
    c = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=cuda)
    launches = ell_price.launches
    for got, want in (
        (ell_price(data, idx, y, c), ell_price_plain(data, idx, y, c)),
        (ell_price(data, idx, y), ell_price_plain(data, idx, y)),
    ):
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert ell_price.launches == launches + 2

    rdata = torch.as_tensor(rng.standard_normal((K, m)), dtype=dtype, device=cuda)
    rcols = torch.as_tensor(rng.integers(0, n, (K, m)).astype(np.int32), device=cuda)
    x = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=cuda)
    launches = ell_spmv.launches
    got = ell_spmv(rdata, rcols, x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ell_spmv_plain(rdata, rcols, x), rtol=tol, atol=tol)
    assert ell_spmv.launches == launches + 1


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("m,n,Kr", [
    (4096, 32768, 31),    # the max-flow row pool: 4 segments of 8 slots, the last of 7
    (4093, 32764, 31),    # unaligned m: the scalar edge path
    (4098, 1000, 5),      # Kr not a multiple of the segments, m % 4 == 2
    (777, 64, 1),         # Kr = 1
    (32768, 4096, 2),     # short rows: one segment
    (135200, 5000, 7),    # enough rows for 4 a thread with 16-byte loads
    (135203, 5000, 7),    # ... and its edge
])
def test_ell_spmv_matches_plain_version_and_repeats_its_bits(cuda, dtype, tol, m, n, Kr):
    rng = np.random.default_rng(m + Kr)
    rdata = torch.as_tensor(rng.standard_normal((Kr, m)), dtype=dtype, device=cuda)
    rcols = torch.as_tensor(rng.integers(0, n, (Kr, m)).astype(np.int32), device=cuda)
    x = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=cuda)
    launches = ell_spmv.launches
    got, again = ell_spmv(rdata, rcols, x), ell_spmv(rdata, rcols, x)
    torch.cuda.synchronize()
    assert ell_spmv.launches == launches + 2
    assert torch.equal(got, again)
    # the segments' sums meet in another order than the plain version's
    torch.testing.assert_close(got, ell_spmv_plain(rdata, rcols, x), rtol=tol,
                               atol=tol * float(Kr) ** 0.5)


@pytest.mark.parametrize("plan", [(1, 31, 256, 1), (2, 16, 128, 1), (4, 8, 64, 4), (8, 4, 32, 4),
                                  (16, 2, 32, 1), (16, 2, 32, 4), (11, 3, 32, 1)])
def test_ell_spmv_under_every_launch_shape(cuda, plan, monkeypatch):
    from relp_tpu_torch.ops import sparse_kernels

    rng = np.random.default_rng(5)
    m, n, Kr = 4101, 9000, 31
    monkeypatch.setattr(sparse_kernels, "spmv_plan",
                        lambda *_: sparse_kernels.SpmvPlan(*plan))
    for mm in (m, m - 1):        # unaligned, and aligned (4100)
        rdata = torch.as_tensor(rng.standard_normal((Kr, mm)), device=cuda)
        rcols = torch.as_tensor(rng.integers(0, n, (Kr, mm)).astype(np.int32), device=cuda)
        x = torch.as_tensor(rng.standard_normal(n), device=cuda)
        got = ell_spmv(rdata, rcols, x)
        torch.testing.assert_close(got, ell_spmv_plain(rdata, rcols, x), rtol=1e-12, atol=1e-11)
        assert torch.equal(got, ell_spmv(rdata, rcols, x))


def test_ell_spmv_refuses_a_plan_that_misses_slots(cuda, monkeypatch):
    from relp_tpu_torch.ops import sparse_kernels

    monkeypatch.setattr(sparse_kernels, "spmv_plan",
                        lambda *_: sparse_kernels.SpmvPlan(2, 3, 32, 1))  # covers 6 of 7 slots
    rdata = torch.ones(7, 64, dtype=torch.float64, device=cuda)
    rcols = torch.zeros(7, 64, dtype=torch.int32, device=cuda)
    launches = ell_spmv.launches
    with pytest.raises(RuntimeError):
        ell_spmv(rdata, rcols, torch.ones(4, dtype=torch.float64, device=cuda))
    assert ell_spmv.launches == launches


def test_wrapper_refuses_mixed_devices(cuda):
    data = torch.ones(2, 8, dtype=torch.float64, device=cuda)
    idx = torch.zeros(2, 8, dtype=torch.int32)  # left on the CPU
    y = torch.ones(4, dtype=torch.float64, device=cuda)
    launches = ell_price.launches
    with pytest.raises(ValueError):
        ell_price(data, idx, y)
    assert ell_price.launches == launches


def test_max_flow_on_the_card_goes_through_both_kernels(cuda, tmp_path):
    n_nodes = 200
    arcs = random_arcs(n_nodes, 8, seed=7)
    u, v, cap = (np.array(col) for col in zip(*arcs))
    graph = sp.csr_matrix((cap.astype(np.int32), (u, v)), shape=(n_nodes, n_nodes))
    flow = maximum_flow(graph, 0, n_nodes - 1).flow_value
    path = tmp_path / "maxflow_200.mps"
    export_mps(max_flow_lp(n_nodes, arcs, 0, n_nodes - 1), path)

    price0, spmv0 = ell_price.launches, ell_spmv.launches
    res = api.solve(path, SolverConfig(matrix_format="ell"), device=cuda)
    assert res.kind.value == "finite_optimum"
    assert res.solution.objective_value == pytest.approx(flow, abs=1e-6)
    assert res.simplex.metrics.device.startswith("cuda")
    assert ell_price.launches - price0 >= res.simplex.iterations
    assert ell_spmv.launches > spmv0


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("m,n,j0,w", [
    (768, 1536, 0, None),      # the dense slice's operator
    (768, 1536, 384, 384),     # one partial-pricing block of four
    (128, 1024, 256, 256),     # the probe's grid block
    (2048, 16384, 0, None),    # wide: bandwidth shows
    (1000, 333, 5, 300),       # ragged rows, columns and window: lda % 4 != 0
    (768, 1536, 383, 386),     # unaligned window start: the scalar edge path
    (300, 1000, 0, 998),       # aligned rows, ragged last vector
    (5000, 64, 0, None),       # more slices than warps meet in one column block
])
def test_dense_price_matches_plain_version(cuda, dtype, tol, m, n, j0, w):
    rng = np.random.default_rng(5)
    A = torch.as_tensor(rng.uniform(-1.0, 1.0, (m, n)), dtype=dtype, device=cuda)
    v = torch.as_tensor(rng.standard_normal(m), dtype=dtype, device=cuda)
    width = n - j0 if w is None else w
    c = torch.as_tensor(rng.standard_normal(width), dtype=dtype, device=cuda)
    launches = dense_price.launches
    for cc in (c, None):
        got = dense_price(A, v, cc, j0, w)
        torch.cuda.synchronize()
        want = dense_price_plain(A, v, cc, j0, w)
        # f32 sums of m terms in another order: scale the tolerance by |v|·|A|
        scale = float((v.abs() @ A[:, j0:j0 + width].abs()).max())
        torch.testing.assert_close(got, want, rtol=tol, atol=tol * max(1.0, scale))
        # the same result on every run: partial sums combine in a fixed order
        assert torch.equal(dense_price(A, v, cc, j0, w), got)
    assert dense_price.launches == launches + 4


def test_ell_price_window_matches_plain_version(cuda):
    rng = np.random.default_rng(4)
    m, n, K = 4096, 32768, 3
    data = torch.as_tensor(rng.standard_normal((K, n)), dtype=torch.float32, device=cuda)
    idx = torch.as_tensor(rng.integers(0, m, (K, n)).astype(np.int32), device=cuda)
    y = torch.as_tensor(rng.standard_normal(m), dtype=torch.float32, device=cuda)
    j0, w = 8192, 8192
    c = torch.as_tensor(rng.standard_normal(w), dtype=torch.float32, device=cuda)
    got = ell_price(data, idx, y, c, j0, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ell_price_plain(data, idx, y, c, j0, w), rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got, c - ell_price(data, idx, y)[j0:j0 + w], rtol=2e-5, atol=2e-5)


def test_probe_passes_on_the_card(cuda, capsys):
    f32, f64, price = probe_scale_f32.launches, probe_scale_f64.launches, dense_price.launches
    assert probe.main() == 0
    out = capsys.readouterr().out
    assert out.count(": OK") == 3, out
    assert (probe_scale_f32.launches - f32, probe_scale_f64.launches - f64) == (1, 1)
    assert dense_price.launches - price == 4  # one per 256-column block


def test_dense_lp_on_the_card_goes_through_dense_price(cuda, tmp_path):
    m, n = 96, 192
    A, b, c = dense_lp_data(m, n)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, 2), method="highs")
    path = tmp_path / "dense.mps"
    export_mps(dense_lp(m, n), path)
    price0 = dense_price.launches
    res = api.solve(path, device=cuda)
    assert res.kind.value == "finite_optimum"
    assert res.solution.objective_value == pytest.approx(ref.fun, rel=1e-9)
    assert res.simplex.metrics.matrix_format == "dense"
    assert dense_price.launches - price0 >= res.simplex.iterations


def _selection(rng, n, n_extra, cuda, *, bland=False, w_const=None):
    """Seeded selection inputs over an n-column pool: every status, some
    columns barred from entering, devex weights in [0.5, 4)."""
    vstat = torch.as_tensor(rng.integers(0, 5, n + n_extra), device=cuda)
    can_enter = torch.as_tensor(rng.random(n) < 0.9, device=cuda)
    w = rng.uniform(0.5, 4.0, n) if w_const is None else np.full(n, w_const)
    return dict(vstat=vstat, can_enter=can_enter, w=torch.as_tensor(w, device=cuda),
                bland=torch.tensor(bland, device=cuda), eps_dual=1e-9)


def _assert_same_choice(got, want, tol):
    torch.cuda.synchronize()
    (q, has, d_q), (q0, has0, d_q0) = got, want
    assert q.dtype == torch.int64 and has.dtype == torch.bool and d_q.dtype == d_q0.dtype
    assert (int(q), bool(has)) == (int(q0), bool(has0))
    torch.testing.assert_close(d_q, d_q0, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("devex,bland", [(True, False), (False, False), (True, True)])
@pytest.mark.parametrize("m,n,j0,w", [
    (768, 1536, 0, None), (768, 1536, 384, 384), (1000, 333, 5, 300), (2048, 16384, 0, None)])
def test_dense_price_select_matches_plain_version(cuda, dtype, tol, devex, bland, m, n, j0, w):
    rng = np.random.default_rng(11)
    A = torch.as_tensor(rng.uniform(-1.0, 1.0, (m, n)), dtype=dtype, device=cuda)
    v = torch.as_tensor(rng.standard_normal(m), dtype=dtype, device=cuda)
    width = n - j0 if w is None else w
    c = torch.as_tensor(rng.standard_normal(width), dtype=dtype, device=cuda)
    sel = _selection(rng, n, m, cuda, bland=bland)
    launches = dense_price_select.launches
    got = dense_price_select(A, v, c, **sel, devex=devex, j0=j0, w_cols=w)
    scale = float((v.abs() @ A[:, j0:j0 + width].abs()).max())
    _assert_same_choice(got, dense_price_select_plain(A, v, c, **sel, devex=devex, j0=j0, w_cols=w),
                        tol * max(1.0, scale))
    # the ticket counters are back at zero: a second launch gives the same bits
    again = dense_price_select(A, v, c, **sel, devex=devex, j0=j0, w_cols=w)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert dense_price_select.launches == launches + 2


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("devex,bland", [(True, False), (False, False), (True, True)])
@pytest.mark.parametrize("m,n,K,j0,w", [
    (4096, 32768, 2, 0, None),     # the max-flow slice: y staged in shared memory
    (4096, 32768, 3, 8192, 8192),  # one partial-pricing block
    (300, 1001, 5, 3, 990),        # n and j0 not multiples of 4: the scalar edge path
    (70000, 8192, 4, 0, None),     # y too large for shared memory (f32: 273 KB)
])
def test_ell_price_select_matches_plain_version(cuda, dtype, tol, devex, bland, m, n, K, j0, w):
    rng = np.random.default_rng(12)
    data = torch.as_tensor(rng.standard_normal((K, n)), dtype=dtype, device=cuda)
    idx = torch.as_tensor(rng.integers(0, m, (K, n)).astype(np.int32), device=cuda)
    y = torch.as_tensor(rng.standard_normal(m), dtype=dtype, device=cuda)
    width = n - j0 if w is None else w
    c = torch.as_tensor(rng.standard_normal(width), dtype=dtype, device=cuda)
    sel = _selection(rng, n, m, cuda, bland=bland)
    launches = ell_price_select.launches
    got = ell_price_select(data, idx, y, c, **sel, devex=devex, j0=j0, w_cols=w)
    _assert_same_choice(
        got, ell_price_select_plain(data, idx, y, c, **sel, devex=devex, j0=j0, w_cols=w),
        10 * tol)
    again = ell_price_select(data, idx, y, c, **sel, devex=devex, j0=j0, w_cols=w)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert ell_price_select.launches == launches + 2
    # the d-writing kernel on the same pool (staged, edge and large-y paths)
    torch.testing.assert_close(ell_price(data, idx, y, c, j0, w),
                               ell_price_plain(data, idx, y, c, j0, w), rtol=10 * tol, atol=10 * tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_select_ties_go_to_the_lowest_column_across_blocks(cuda, dtype):
    # equal scores over many blocks: all weights 1, all |d| equal; then a
    # strictly better column late in the pool, then a NaN weight before it
    m, n = 64, 40000
    y = torch.zeros(m, dtype=dtype, device=cuda)
    c = torch.full((n,), -1.0, dtype=dtype, device=cuda)
    sel = dict(vstat=torch.zeros(n + m, dtype=torch.int64, device=cuda),
               can_enter=torch.ones(n, dtype=torch.bool, device=cuda),
               w=torch.ones(n, dtype=torch.float64, device=cuda),
               bland=torch.tensor(False, device=cuda), eps_dual=1e-9)
    data = torch.zeros((2, n), dtype=dtype, device=cuda)
    idx = torch.zeros((2, n), dtype=torch.int32, device=cuda)
    A = torch.zeros((m, n), dtype=dtype, device=cuda)

    def both(j0=0, w=None):
        out = [ell_price_select(data, idx, y, c[j0:j0 + (w or n - j0)].contiguous(), **sel,
                                devex=True, j0=j0, w_cols=w),
               dense_price_select(A, y, c[j0:j0 + (w or n - j0)].contiguous(), **sel,
                                  devex=True, j0=j0, w_cols=w)]
        torch.cuda.synchronize()
        return [(int(q), bool(has), float(d_q)) for q, has, d_q in out]

    assert both() == [(0, True, -1.0)] * 2
    assert both(1234, 30000) == [(1234, True, -1.0)] * 2
    sel["vstat"][:5000] = 2                      # basic: the tie starts at 5000
    assert both() == [(5000, True, -1.0)] * 2
    c[33333] = -2.0                              # one better column, far in
    assert both() == [(33333, True, -2.0)] * 2
    sel["w"][20000] = float("nan")               # NaN score: the greatest, as torch.argmax has it
    want = dense_price_select_plain(A, y, c, **sel, devex=True)
    assert int(want[0]) == 20000
    assert both() == [(20000, True, -1.0)] * 2
    sel["bland"] = torch.tensor(True, device=cuda)   # Bland: the smallest improving index
    assert both() == [(5000, True, -1.0)] * 2
    sel["vstat"][:] = 2                          # nothing may enter: the window's first column
    assert both(100, 2000) == [(100, False, -1.0)] * 2


def _dual_start_of(general, dev, **opts):
    """The padded problem, its dual start and a fresh kernel and state on ``dev``."""
    from relp_tpu_torch.model.computational_form import build_computational_form
    from relp_tpu_torch.presolve.engine import presolve
    from relp_tpu_torch.simplex import driver
    from relp_tpu_torch.simplex.dual import DualKernel, initial_state

    presolve(general)
    cf = build_computational_form(general, scale=True)
    cfg = SolverConfig(algorithm="dual", matrix_format="ell", refactor_mode="full", **opts)
    p = driver._Padded.of(cf, cfg, dev)
    lb_d, ub_d, warm, _, _ = driver._dual_start(p)
    A = p.device_A()[0]
    vec = [torch.tensor(v, dtype=torch.float64, device=dev)
           for v in (p.b, p.c, lb_d, ub_d, warm["art_sign0"])]
    K = DualKernel(A, *vec, cfg, 10_000)
    s = K.refactor(initial_state(warm["basis0"], warm["vstat0"], p.m_pad, p.n_pad, cfg, dev))
    return K, s


@pytest.mark.parametrize("opts", [{"dual_ratio": "bisect"}, {"dual_ratio": "sort"},
                                  {"dual_ratio": "sort", "dual_pricing": "devex"}],
                         ids=["bisect", "sort", "sort-devex"])
def test_dual_step_on_the_card_matches_the_cpu_step(cuda, opts):
    # the same start on both devices, 40 steps side by side: the card's step
    # launches ell_price (pivot row) and ell_spmv (flips), the CPU's their
    # plain versions; every field within 1e-9, the pivots equal
    import dataclasses

    arcs = random_arcs(300, 8, seed=5)
    Kc, sc = _dual_start_of(max_flow_lp(300, arcs, 0, 299), torch.device("cpu"), **opts)
    Kg, sg = _dual_start_of(max_flow_lp(300, arcs, 0, 299), cuda, **opts)
    price0, spmv0 = ell_price.launches, ell_spmv.launches
    for _ in range(40):
        sc, fc = Kc.step(sc)
        sg, fg = Kg.step(sg)
        assert fg.tolist() == fc.tolist()
        for f in dataclasses.fields(sc):
            a, b = getattr(sg, f.name).cpu(), getattr(sc, f.name)
            if a.dtype.is_floating_point:
                assert torch.allclose(a, b, rtol=1e-9, atol=1e-9), f.name
            else:
                assert torch.equal(a, b), f.name
    assert ell_price.launches - price0 >= 40 and ell_spmv.launches - spmv0 >= 40
    assert Kg.host_reads == 0


def test_dual_on_the_card_reaches_the_max_flow(cuda, tmp_path):
    n_nodes = 300
    arcs = random_arcs(n_nodes, 8, seed=5)
    u, v, cap = (np.array(col) for col in zip(*arcs))
    graph = sp.csr_matrix((cap.astype(np.int32), (u, v)), shape=(n_nodes, n_nodes))
    flow = maximum_flow(graph, 0, n_nodes - 1).flow_value
    path = tmp_path / "maxflow.mps"
    export_mps(max_flow_lp(n_nodes, arcs, 0, n_nodes - 1), path)
    for opts in ({}, {"dual_ratio": "bisect"}, {"xl_engine": "lu"}):
        res = api.solve(path, SolverConfig(algorithm="dual", matrix_format="ell", **opts))
        met = res.simplex.metrics
        assert res.kind.value == "finite_optimum"
        assert res.solution.objective_value == pytest.approx(flow, abs=1e-6)
        assert met.engine == ("dual-lu" if opts.get("xl_engine") else "dual")
        assert met.device == "cuda"


def _dead_lanes(L, group, rng, dev):
    """A live mask that kills part of the first group of lanes and, where
    there are several groups, the whole last one."""
    live = torch.as_tensor(rng.random(L) < 0.7, device=dev)
    live[0] = True
    if L > 1:
        live[1] = False
    groups = -(-L // group)
    if groups > 1:
        live[(groups - 1) * group:] = False
    return live


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("L,m,n,j0,w", [(64, 768, 1536, 0, None), (17, 300, 1100, 3, 517),
                                         (5, 100, 1000, 3, 517), (3, 256, 512, 0, None),
                                         (1, 256, 512, 3, 200)])
def test_dense_price_lanes_matches_plain_and_single_launches(cuda, dtype, tol, stacked,
                                                             L, m, n, j0, w):
    rng = np.random.default_rng(11)
    shape = (L, m, n) if stacked else (m, n)
    A = torch.as_tensor(rng.uniform(-1, 1, shape), dtype=dtype, device=cuda)
    width = n - j0 if w is None else w
    V = torch.as_tensor(rng.standard_normal((L, m)), dtype=dtype, device=cuda)
    C = torch.as_tensor(rng.standard_normal((L, width)), dtype=dtype, device=cuda)
    plan = lane_plan(L, m, width, A.element_size(), not stacked)
    assert (plan.group == 1) == (stacked or L == 1)  # lanes that share A go in groups
    for c in (C, None):
        got = dense_price_lanes(A, V, c, j0, w)
        want = dense_price_lanes_plain(A, V, c, j0, w)
        assert float((got - want).abs().max()) <= tol * (1 + float(want.abs().max()))
        # every lane is the single-vector launch on its data, bit for bit
        for s in range(L):
            one = dense_price(A[s] if stacked else A, V[s].contiguous(),
                              None if c is None else c[s].contiguous(), j0, w)
            assert torch.equal(got[s], one), s
        assert torch.equal(got, dense_price_lanes(A, V, c, j0, w))  # two launches, same bits
    live = _dead_lanes(L, plan.group, rng, cuda)
    out = torch.full((L, width), 7.0, dtype=dtype, device=cuda)
    got = dense_price_lanes(A, V, C, j0, w, live=live, out=out.clone())
    want = dense_price_lanes_plain(A, V, C, j0, w, live, out)
    assert torch.equal(got[~live], out[~live])
    assert torch.equal(got[live], dense_price_lanes(A, V, C, j0, w)[live])
    assert float((got - want).abs().max()) <= tol * (1 + float(want.abs().max()))
    dead = torch.zeros(L, dtype=torch.bool, device=cuda)
    assert torch.equal(dense_price_lanes(A, V, C, j0, w, live=dead, out=out.clone()), out)


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("devex,stacked", [(True, False), (False, True), (False, False)])
@pytest.mark.parametrize("L,j0,w_cols", [(16, 0, None), (64, 0, None), (17, 3, 517),
                                          (5, 0, None), (3, 3, 517), (1, 0, None)])
def test_dense_price_select_lanes_matches_plain_version(cuda, dtype, tol, devex, stacked,
                                                        L, j0, w_cols):
    rng = np.random.default_rng(12)
    m, n = 300, 1100
    width = n - j0 if w_cols is None else w_cols
    A = torch.as_tensor(rng.uniform(-1, 1, (L, m, n) if stacked else (m, n)), dtype=dtype,
                        device=cuda)
    V = torch.as_tensor(rng.standard_normal((L, m)), dtype=dtype, device=cuda)
    C = torch.as_tensor(rng.standard_normal((L, width)), dtype=dtype, device=cuda)
    vstat = torch.as_tensor(rng.integers(0, 4, (L, n + m)), device=cuda)
    can = torch.as_tensor(rng.random((L, n)) < 0.9, device=cuda)
    wts = torch.as_tensor(rng.uniform(0.5, 2.0, (L, n)), device=cuda)
    bland = torch.as_tensor(rng.random(L) < 0.3, device=cuda)
    args = (vstat, can, wts, bland, 1e-7, devex, j0, w_cols)
    q, has, d_q = dense_price_select_lanes(A, V, C, *args)
    q0, has0, d0 = dense_price_select_lanes_plain(A, V, C, *args)
    assert torch.equal(q, q0) and torch.equal(has, has0)
    assert float((d_q - d0).abs().max()) <= tol * (1 + float(d0.abs().max()))
    again = dense_price_select_lanes(A, V, C, *args)  # two launches, same bits
    assert all(torch.equal(a, b) for a, b in zip((q, has, d_q), again))
    for s in range(L):  # each lane is the single-vector selection, bit for bit
        one = dense_price_select(A[s] if stacked else A, V[s].contiguous(), C[s].contiguous(),
                                 vstat[s].contiguous(), can[s].contiguous(),
                                 wts[s].contiguous(), bland[s], 1e-7, devex, j0, w_cols)
        assert int(one[0]) == int(q[s]) and bool(one[1]) == bool(has[s])
        assert torch.equal(one[2], d_q[s])
    plan = lane_plan(L, m, width, A.element_size(), not stacked)
    live = _dead_lanes(L, plan.group, rng, cuda)
    keep = (torch.full((L,), -1, dtype=torch.int64, device=cuda),
            torch.zeros(L, dtype=torch.bool, device=cuda),
            torch.full((L,), 9.0, dtype=dtype, device=cuda))
    outs = dense_price_select_lanes(A, V, C, *args, live=live,
                                    outs=tuple(t.clone() for t in keep))
    for got, kept, full in zip(outs, keep, (q, has, d_q)):
        assert torch.equal(got[~live], kept[~live])
        assert torch.equal(got[live], full[live])


@pytest.mark.parametrize("algorithm", ["primal", "ipm", "pdlp"])
def test_fleets_on_the_card_match_the_cpu(cuda, algorithm):
    from relp_tpu_torch.models.dense import dense_lp
    from relp_tpu_torch.simplex.driver import solve_general_forms_batched

    def fleet():
        out = []
        rng = np.random.default_rng(20260819)
        for s in range(4):
            g = dense_lp(32, 64)
            g.b = g.b * (1.0 + 0.03 * rng.standard_normal(len(g.b)))
            out.append(g)
        return out

    cfg = SolverConfig(algorithm=algorithm, presolve=False)
    launches = dense_price_lanes.launches
    on_card = solve_general_forms_batched(fleet(), cfg, device="cuda")
    # the primal's devex rows and the first-order fleet's C − Y·A go through
    # the lane kernel; the interior point's products are batched GEMMs
    assert (dense_price_lanes.launches > launches) == (algorithm != "ipm")
    on_cpu = solve_general_forms_batched(fleet(), cfg, device="cpu")
    for a, b in zip(on_card, on_cpu):
        assert a.kind == b.kind
        assert a.solution.objective_value == pytest.approx(b.solution.objective_value,
                                                           rel=1e-6)


def _ragged_matrix(m, n, seed):
    """Row tile t touches 1 + (5t mod 6) column blocks: the grouped layout
    cuts the tiles into groups of unequal lengths and slot counts."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for t in range(m // 8):
        for blk in rng.choice(n // 128, 1 + (5 * t) % 6, replace=False):
            rows.append(8 * t + rng.integers(0, 8, 4))
            cols.append(128 * blk + rng.integers(0, 128, 4))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return sp.csc_matrix((rng.standard_normal(rows.size), (rows, cols)), shape=(m, n))


def _empty_tile_matrix(m, n, seed):
    """The ragged matrix with row tile 5 and column tile 10 emptied."""
    A = _ragged_matrix(m, n, seed).tolil()
    A[40:48, :] = 0
    A[:, 80:88] = 0
    A = A.tocsc()
    A.eliminate_zeros()
    return A


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("layout", ["flat", "grouped"])
@pytest.mark.parametrize("matrix", ["ragged", "zero", "identity", "empty-tile", "heavy"])
def test_brick_kernels_match_plain_versions_and_repeat_their_bits(cuda, dtype, tol, layout,
                                                                  matrix):
    m, n = 512, 768
    csc = {"ragged": lambda: _ragged_matrix(m, n, 5),
           "zero": lambda: sp.csc_matrix((m, n)),
           "identity": lambda: sp.eye(m, n, format="csc"),
           "empty-tile": lambda: _empty_tile_matrix(m, n, 5),
           "heavy": lambda: sp.random(m, n, density=0.1, random_state=12, format="csc")}[matrix]()
    build = bricks_from_csc if layout == "flat" else grouped_bricks_from_csc
    B = build(csc, m, n, device=cuda).astype(dtype)
    rt, ct = B.rtiles, B.ctiles
    assert rt.vals.device.type == "cuda" and rt.vals.numel() == csc.nnz
    assert (rt.tile_of is None) == (ct.tile_of is None) == (layout == "flat")
    counts = rt.ptr[1:] - rt.ptr[:-1]
    if layout == "grouped" and matrix == "ragged":   # groups of unequal slot counts
        assert len(B.rgroups) > 1 and len({g[2] for g in B.rgroups}) > 1
    if matrix == "empty-tile":
        assert int((counts == 0).sum()) >= 1 and int((ct.ptr[1:] == ct.ptr[:-1]).sum()) >= 1
    if matrix == "heavy":   # a warp a tile, several batches of a lane's nonzeros
        assert rt.lanes == ct.lanes == 32 and int(counts.max()) > 4 * 32
    rng = np.random.default_rng(11)
    x = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=cuda)
    y = torch.as_tensor(rng.standard_normal(m), dtype=dtype, device=cuda)
    c = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=cuda)
    spmv0, price0 = brick_spmv.launches, brick_price.launches
    for fn, plain in ((lambda: brick_spmv(rt, x), lambda: brick_spmv_plain(rt, x)),
                      (lambda: brick_price(ct, y, c), lambda: brick_price_plain(ct, y, c)),
                      (lambda: brick_price(ct, y), lambda: brick_price_plain(ct, y))):
        got = fn()
        again = fn()
        want = plain()
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert (brick_spmv.launches - spmv0, brick_price.launches - price0) == (2, 4)
    # and against scipy, in f64
    if dtype == torch.float64:
        A = csc.toarray()
        np.testing.assert_allclose(B.matvec(x).cpu().numpy(), A @ x.cpu().numpy(), atol=1e-12)
        np.testing.assert_allclose(B.price(c, y).cpu().numpy(),
                                   c.cpu().numpy() - A.T @ y.cpu().numpy(), atol=1e-12)


def test_brick_kernels_refuse_what_they_do_not_take(cuda):
    B = bricks_from_csc(sp.identity(128, format="csc"), 128, 128, device=cuda)
    x = torch.ones(128, dtype=torch.float64, device=cuda)
    t = B.rtiles
    with pytest.raises(ValueError, match="several devices"):
        brick_spmv(t, x.cpu())
    with pytest.raises(TypeError):
        brick_price(B.ctiles, x, x.float())
    with pytest.raises(TypeError):      # the wrong dtype
        brick_spmv(t, x.float())
    # what the kernels index without a bounds check, refused where the tiles are built
    bad = t.ptr.clone()
    bad[3] = 100                        # a non-monotone offset
    with pytest.raises(ValueError, match="offsets"):
        brick_tiles(bad, t.vals, t.pos, None, 128)
    with pytest.raises(ValueError, match="column outside"):
        brick_tiles(t.ptr, t.vals, t.pos + 8 * 128, None, 128)
    with pytest.raises(TypeError):
        brick_tiles(t.ptr, t.vals, t.pos.long(), None, 128)


@pytest.mark.parametrize("crossover", [False, True])
def test_pdlp_on_bricks_on_the_card_matches_the_cpu(cuda, tmp_path, crossover):
    n_nodes = 256
    arcs = random_arcs(n_nodes, 8, seed=7)
    u, v, cap = (np.array(col) for col in zip(*arcs))
    graph = sp.csr_matrix((cap.astype(np.int32), (u, v)), shape=(n_nodes, n_nodes))
    flow = maximum_flow(graph, 0, n_nodes - 1).flow_value
    path = tmp_path / "maxflow_256.mps"
    export_mps(max_flow_lp(n_nodes, arcs, 0, n_nodes - 1), path)
    cfg = SolverConfig(algorithm="pdlp", pdlp_matrix="bricks", pdlp_crossover=crossover)
    spmv0, price0 = brick_spmv.launches, brick_price.launches
    card = api.solve(path, cfg, device=cuda)
    met = card.simplex.metrics
    assert met.fo_matrix == "bricks" and met.device.startswith("cuda")
    assert min(brick_spmv.launches - spmv0, brick_price.launches - price0) >= met.fo_iterations
    cpu = api.solve(path, cfg, device="cpu")
    assert card.kind == cpu.kind
    assert card.simplex.metrics.engine == cpu.simplex.metrics.engine
    # the same f64 iteration, sums in another order
    assert card.solution.objective_value == pytest.approx(cpu.solution.objective_value,
                                                          rel=1e-9 if crossover else 1e-6)
    assert card.solution.objective_value == pytest.approx(flow, rel=1e-9 if crossover else 1e-5)


def _selection_state(n, m, seed, dev, bland):
    """A made-up state to choose from: statuses over every class, a few
    columns that cannot enter, devex weights in [1, 4)."""
    from relp_tpu_torch.ops.select_epilogue import Selection

    rng = np.random.default_rng(seed)
    vstat = torch.as_tensor(rng.integers(0, 4, n + m), device=dev)
    can_enter = torch.as_tensor(rng.random(n) > 0.05, device=dev)
    w = torch.as_tensor(1.0 + 3.0 * rng.random(n), device=dev)
    return lambda devex: Selection(vstat, can_enter, w, torch.tensor(bland, device=dev),
                                   1e-7, devex)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["ell", "dense"])
@pytest.mark.parametrize("devex,bland", [(True, False), (False, False), (True, True)])
def test_sharded_pricing_chooses_as_the_single_operator(cuda, dtype, kind, devex, bland):
    """Two shards on one card choose the single operator's ``(q, has, d_q)``
    bit for bit: the ELL max-flow pool at N = 4,096 (each column summed in
    slot order) and the dense 256 × 512 LP (whose column blocks keep the
    single launch's row plan), over the whole pool and over a window that
    crosses the shard boundary."""
    from relp_tpu_torch.ops.amatrix import DenseMatrix, ell_from_csc
    from relp_tpu_torch.ops.dense_kernels import slices_for
    from relp_tpu_torch.parallel.sharded import shard_operator

    if kind == "ell":
        arcs = random_arcs(4096, 8, seed=7)
        csc = max_flow_lp(4096, arcs, 0, 4095).A.tocsc()
        m, n = 4096, 32768
        one = ell_from_csc(csc, m, n, device=cuda)
    else:
        A, _, _ = dense_lp_data(256, 512)
        m, n = A.shape
        one = DenseMatrix(torch.as_tensor(A, device=cuda))
        assert slices_for(m, n, 4) == slices_for(m, n // 2, 4)
        assert slices_for(m, n, 8) == slices_for(m, n // 2, 8)
    one = one.with_f32()
    sh = shard_operator(one, [torch.device("cuda", 0)] * 2)
    rng = np.random.default_rng(11)
    pi = torch.as_tensor(rng.standard_normal(m), dtype=dtype, device=cuda)
    c = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=cuda)
    sel = _selection_state(n, m, 5, cuda, bland)(devex)
    launches = (ell_price_select if kind == "ell" else dense_price_select).launches
    if dtype == torch.float64:
        got, want = sh.price_select(c, pi, sel), one.price_select(c, pi, sel)
        windows = []
    else:
        got, want = sh.price32_select(c, pi, sel), one.price32_select(c, pi, sel)
        lo, w = n // 4, n // 2
        windows = [(sh.price32_select(c[lo:lo + w], pi, sel, lo, w),
                    one.price32_select(c[lo:lo + w], pi, sel, lo, w))]
    torch.cuda.synchronize()
    for g, x in [(got, want)] + windows:
        assert int(g[0]) == int(x[0]) and bool(g[1]) == bool(x[1])
        assert torch.equal(g[2], x[2]) and g[2].dtype == dtype
    calls = 1 + len(windows)
    assert (ell_price_select if kind == "ell" else dense_price_select).launches == \
        launches + 3 * calls  # two shards and the single operator per call


def test_sharded_max_flow_on_the_card_takes_the_single_pivots(cuda, tmp_path):
    """The N = 1,024 max flow over two shards of one card: the single
    solve's iterations, host reads and objective, scipy's max flow."""
    arcs = random_arcs(1024, 8, seed=7)
    u, v, cap = (np.array(col) for col in zip(*arcs))
    flow = maximum_flow(sp.csr_matrix((cap.astype(np.int32), (u, v)), shape=(1024, 1024)),
                        0, 1023).flow_value
    path = tmp_path / "maxflow_1024.mps"
    export_mps(max_flow_lp(1024, arcs, 0, 1023), str(path))
    one = api.solve(path, SolverConfig(matrix_format="ell"), device=cuda)
    launches = ell_price_select.launches
    sh = api.solve(path, SolverConfig(matrix_format="ell", mesh_cols=2), device=cuda,
                   devices=["cuda:0", "cuda:0"])
    assert sh.solution.objective_value == one.solution.objective_value == flow
    m1, m2 = one.simplex.metrics, sh.simplex.metrics
    assert m2.iterations == m1.iterations and m2.host_reads == m1.host_reads
    assert ell_price_select.launches - launches >= 2 * m2.iterations
