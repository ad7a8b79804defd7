"""The launch plan of the lane kernels (``lane_plan``, ``lane_group`` in
relp_tpu_torch/ops/dense_kernels.py) and their plain versions at ragged
lane counts with partly dead groups.

The plan is a pure function of the lane count, the window and the element
size: lanes that share A go to blocks of 4, 8 or 16 lanes, and every lane's
rows keep the single-vector launch's split (``slices_for``), which is what
keeps each lane bit-equal to ``dense_price`` on the card.  These tests hold
that every lane falls in exactly one group, that the row split is the
single launch's, and that the scratch asked of the workspace covers what
the kernel indexes.  The plain versions are held against ``jax.vmap`` of the
JAX package's ``DenseMatrix`` pricing (rel 1e-12 in f64, 1e-5 in f32: the
sums run in another order), with the rows of dead lanes left as they were.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import relp_tpu  # noqa: F401  (x64 on the CPU backend)
from relp_tpu.ops.amatrix import DenseMatrix as JaxDense
from relp_tpu_torch.ops.dense_kernels import (
    block_cols,
    dense_price_lanes,
    dense_price_lanes_plain,
    dense_price_select_lanes,
    dense_price_select_plain,
    lane_group,
    lane_plan,
    slices_for,
)

LANES = (1, 2, 3, 4, 5, 8, 15, 16, 17, 63, 64, 65, 1000, 65535)
SHAPES = ((768, 1536), (1024, 8192), (256, 512), (300, 1100), (100, 517), (5000, 64), (1, 5))
DTYPES = {"f64": (jnp.float64, torch.float64, 1e-12), "f32": (jnp.float32, torch.float32, 1e-5)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("L", LANES)
@pytest.mark.parametrize("itemsize", [4, 8])
def test_every_lane_falls_in_exactly_one_group(L, itemsize):
    for m, w in SHAPES:
        plan = lane_plan(L, m, w, itemsize)
        assert plan.group in (1, 4, 8, 16)
        assert plan.groups == -(-L // plan.group) <= 65535
        # lane s is slot s % group of grid row s // group: one place per lane,
        # and no grid row without a lane
        seen = {(s // plan.group, s % plan.group) for s in range(L)}
        assert len(seen) == L
        assert {z for z, _ in seen} == set(range(plan.groups))
        assert plan.group == 1 or plan.group <= 4 or L >= plan.group


@pytest.mark.parametrize("L", LANES)
@pytest.mark.parametrize("itemsize", [4, 8])
def test_the_row_split_is_the_single_launch_s(L, itemsize):
    for m, w in SHAPES:
        for shared in (True, False):
            plan = lane_plan(L, m, w, itemsize, shared)
            assert (plan.slices, plan.rows_per_slice) == slices_for(m, w, itemsize)
            single = lane_plan(1, m, w, itemsize)
            assert (plan.slices, plan.rows_per_slice, plan.col_blocks) == \
                (single.slices, single.rows_per_slice, single.col_blocks)
            assert plan.slices * plan.rows_per_slice >= m
            assert (plan.slices - 1) * plan.rows_per_slice < max(m, 1)


@pytest.mark.parametrize("L", LANES)
@pytest.mark.parametrize("itemsize", [4, 8])
def test_the_workspace_covers_what_the_kernel_indexes(L, itemsize):
    for m, w in SHAPES:
        for shared in (True, False):
            plan = lane_plan(L, m, w, itemsize, shared)
            assert plan.col_blocks * block_cols(itemsize) >= w
            assert (plan.col_blocks - 1) * block_cols(itemsize) < max(w, 1)
            # tickets: counters[s] for lane s; slice counters from counters[L]:
            # grid row z's column block b at L + z * col_blocks + b
            rows = L if plan.group == 1 else plan.groups
            if plan.slices > 1:
                assert plan.n_counters >= L + rows * plan.col_blocks
                # lane s's sums of slice sl: a row of w (a group: of whole column blocks)
                row = w if plan.group == 1 else plan.col_blocks * block_cols(itemsize)
                last_row_of_sums = (L - 1) * plan.slices + plan.slices - 1
                assert plan.partial_bytes >= (last_row_of_sums + 1) * row * itemsize
            else:
                assert plan.n_counters >= L
            assert plan.n_slots >= L * plan.col_blocks  # slot of lane s, block b


def test_the_group_size_follows_the_lanes_and_the_grid():
    # one vector and a stacked A share nothing: the lane-by-lane kernel
    assert lane_plan(1, 768, 1536, 4).group == 1
    assert lane_plan(64, 768, 1536, 4, shared=False).group == 1
    assert lane_group(1, 10_000) == 1
    # the fleets' shapes: 64 lanes of 768 x 1536 (72 blocks a group) and 16
    # of the first-order fleet's 1,024 x 8,192 take 16 lanes a block; 64
    # lanes of 256 x 512 (8 blocks a group) take 4, so that every SM has a block
    assert lane_plan(64, 768, 1536, 4).group == 16
    assert lane_plan(16, 1024, 8192, 4).group == 16
    assert lane_plan(16, 1024, 8192, 8).group == 16
    assert lane_plan(64, 256, 512, 4).group == 4
    # 17 lanes: three groups of 8 cost less than two of 16, most of one padding
    assert lane_plan(17, 768, 1536, 4).group == 8
    # fewer lanes than a group of 8: 4, with the missing lanes masked
    assert lane_plan(3, 768, 1536, 8).group == 4
    assert lane_plan(5, 768, 1536, 8).group == 4
    for L in LANES:
        for blocks in (1, 8, 72, 132, 320):
            g = lane_group(L, blocks)
            # a group of 8 or 16 is full at least once and leaves every SM a block
            assert g in (1, 4) or (L >= g and -(-L // g) * blocks >= 132)


def _jax_price(A, V, C, j0, w, jdt):
    def one(v, c):
        return c - JaxDense(A).rmatvec(v)[j0:j0 + w]
    return np.asarray(jax.vmap(one)(jnp.asarray(V, jdt), jnp.asarray(C, jdt)))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("L,j0,w", [(17, 0, None), (5, 3, 117), (3, 0, None)])
def test_ragged_lanes_with_a_partly_dead_group_match_jax_vmap(dt, L, j0, w):
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(L)
    m, n = 24, 200
    A = rng.uniform(-1.0, 1.0, (m, n))
    V = rng.standard_normal((L, m))
    width = n - j0 if w is None else w
    C = rng.standard_normal((L, width))
    want = _jax_price(A, V, C, j0, width, jdt)
    # kill part of the first group, and (at L = 17) the whole ragged last one
    live = np.ones(L, dtype=bool)
    live[1:3] = False
    if L > 16:
        live[16:] = False
    keep = np.full((L, width), 7.0)
    At, Vt, Ct = (torch.tensor(x, dtype=tdt) for x in (A, V, C))
    out = torch.tensor(keep, dtype=tdt)
    got = dense_price_lanes(At, Vt, Ct, j0, w, live=torch.tensor(live), out=out).numpy()
    np.testing.assert_allclose(got[live], want[live], rtol=tol, atol=tol * np.abs(want).max())
    assert np.array_equal(got[~live], keep[~live])
    # every live lane equals the plain price of that lane alone
    for s in np.flatnonzero(live):
        one = dense_price_lanes_plain(At, Vt[s:s + 1], Ct[s:s + 1], j0, w)[0]
        np.testing.assert_allclose(got[s], one.numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("devex", [True, False])
def test_ragged_select_lanes_with_dead_lanes_match_the_single_selection(dt, devex):
    _, tdt, tol = DTYPES[dt]
    L, m, n = 17, 24, 200
    rng = np.random.default_rng(17)
    A = torch.tensor(rng.uniform(-1.0, 1.0, (m, n)), dtype=tdt)
    V = torch.tensor(rng.standard_normal((L, m)), dtype=tdt)
    C = torch.tensor(rng.standard_normal((L, n)), dtype=tdt)
    vstat = torch.tensor(rng.integers(0, 4, (L, n + m)))
    can = torch.tensor(rng.random(n) < 0.8)  # shared by the lanes
    w = torch.tensor(rng.uniform(0.5, 2.0, (L, n)))
    bland = torch.tensor(rng.random(L) < 0.3)
    live = torch.ones(L, dtype=torch.bool)
    live[[0, 5, 16]] = False
    outs = (torch.full((L,), -1), torch.zeros(L, dtype=torch.bool), torch.full((L,), 9.0, dtype=tdt))
    q, has, d_q = dense_price_select_lanes(A, V, C, vstat, can, w, bland, 1e-7, devex,
                                           live=live, outs=outs)
    for s in range(L):
        if not live[s]:
            assert (int(q[s]), bool(has[s]), float(d_q[s])) == (-1, False, 9.0)
            continue
        q1, has1, d1 = dense_price_select_plain(A, V[s], C[s], vstat[s], can, w[s], bland[s],
                                                1e-7, devex)
        assert int(q[s]) == int(q1) and bool(has[s]) == bool(has1)
        assert float(d_q[s]) == pytest.approx(float(d1), rel=tol)
