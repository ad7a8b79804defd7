"""The port's sparse-operator kernels (relp_tpu_torch/ops/sparse_kernels.py)
against the JAX package's Pallas brick kernels and its ELL operator.

On the CPU the wrappers run their plain PyTorch versions; the Pallas
kernels run in interpret mode, as tests/test_pallas_kernels.py runs them.
Inputs are made with numpy from a seed and handed to both packages.  The
CUDA kernels themselves are compared with the plain versions on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import relp_tpu  # noqa: F401  (x64 on the CPU backend)
from relp_tpu.ops import amatrix as jax_amatrix
from relp_tpu.ops.bricks import bricks_from_csc
from relp_tpu.ops.pallas_kernels import brick_pricing_pallas, brick_spmv_pallas
from relp_tpu_torch.ops import amatrix as torch_amatrix
from relp_tpu_torch.ops.sparse_kernels import ell_price, ell_spmv

CPU = torch.device("cpu")
# f32 sums run in another order than the brick kernels' (8, 128) tiles
F32_TOL = 2e-5
F64_TOL = 1e-12

# (m, n, density, seed): the shapes of tests/test_pallas_kernels.py and a
# ragged column count (the brick layout pads it to a multiple of 128)
SHAPES = [(256, 512, 0.02, 7), (256, 512, 0.02, 11), (256, 300, 0.03, 5)]


def _random_operator(m, n, density, seed):
    rng = np.random.default_rng(seed)
    return sp.random(m, n, density=density, random_state=rng, format="csc",
                     dtype=np.float64)


def _pad128(k):
    return ((k + 127) // 128) * 128


def _t(a, dtype):
    return torch.as_tensor(np.asarray(a, dtype))


@pytest.mark.parametrize("m,n,density,seed", SHAPES)
def test_ell_price_matches_brick_pricing_pallas(m, n, density, seed):
    A = _random_operator(m, n, density, seed)
    rng = np.random.default_rng(seed + 100)
    pi = rng.standard_normal(m)
    c = rng.standard_normal(n)

    B = bricks_from_csc(A, m, _pad128(n))
    c_pad = np.zeros(_pad128(n))
    c_pad[:n] = c
    want = np.asarray(brick_pricing_pallas(
        np.asarray(B.cdata, np.float32), np.asarray(B.cidx, np.int32),
        np.asarray(pi, np.float32), np.asarray(c_pad, np.float32),
        interpret=True,
    ))[:n]

    ell = torch_amatrix.ell_from_csc(A, m, n, device=CPU)
    got = ell_price(ell.data_t.float(), ell.rows_t, _t(pi, np.float32),
                    _t(c, np.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("m,n,density,seed", SHAPES)
def test_ell_spmv_matches_brick_spmv_pallas(m, n, density, seed):
    A = _random_operator(m, n, density, seed)
    x = np.random.default_rng(seed + 200).standard_normal(n)

    B = bricks_from_csc(A, m, _pad128(n))
    x_pad = np.zeros(_pad128(n))
    x_pad[:n] = x
    want = np.asarray(brick_spmv_pallas(
        np.asarray(B.rdata, np.float32), np.asarray(B.ridx, np.int32),
        np.asarray(x_pad, np.float32), interpret=True,
    ))[:m]

    ell = torch_amatrix.ell_from_csc(A, m, n, device=CPU)
    got = ell_spmv(ell.rdata_t.float(), ell.rcols_t, _t(x, np.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("m,n,density,seed", SHAPES)
def test_f64_modes_match_jax_ell(m, n, density, seed):
    A = _random_operator(m, n, density, seed)
    rng = np.random.default_rng(seed + 300)
    pi, c, x = rng.standard_normal(m), rng.standard_normal(n), rng.standard_normal(n)
    jell = jax_amatrix.ell_from_csc(A, m, n)
    tell = torch_amatrix.ell_from_csc(A, m, n, device=CPU)
    f64 = np.float64

    np.testing.assert_allclose(
        ell_price(tell.data_t, tell.rows_t, _t(pi, f64), _t(c, f64)).numpy(),
        c - np.asarray(jell.rmatvec(pi)), rtol=F64_TOL, atol=F64_TOL)
    np.testing.assert_allclose(
        ell_price(tell.data_t, tell.rows_t, _t(pi, f64)).numpy(),
        np.asarray(jell.rmatvec(pi)), rtol=F64_TOL, atol=F64_TOL)
    np.testing.assert_allclose(
        ell_spmv(tell.rdata_t, tell.rcols_t, _t(x, f64)).numpy(),
        np.asarray(jell.matvec(x)), rtol=F64_TOL, atol=F64_TOL)


@pytest.mark.parametrize("m,n,density,seed", SHAPES)
def test_sum_mode_matches_jax_rmatvec32(m, n, density, seed):
    A = _random_operator(m, n, density, seed)
    v = np.random.default_rng(seed + 400).standard_normal(m).astype(np.float32)
    jell = jax_amatrix.ell_from_csc(A, m, n).with_f32()
    tell = torch_amatrix.ell_from_csc(A, m, n, device=CPU).with_f32()
    got = ell_price(tell.data32_t, tell.rows_t, torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(jell.rmatvec32(v)),
                               rtol=F32_TOL, atol=F32_TOL)


def test_padding_slots_contribute_zero():
    # a column pool whose every slot is padding (index 0, value 0) prices to c
    data = torch.zeros(3, 10, dtype=torch.float64)
    idx = torch.zeros(3, 10, dtype=torch.int32)
    y = torch.arange(4, dtype=torch.float64) + 1.0
    c = torch.linspace(-1.0, 1.0, 10, dtype=torch.float64)
    assert torch.equal(ell_price(data, idx, y, c), c)
    assert torch.equal(ell_spmv(data, idx, y), torch.zeros(10, dtype=torch.float64))


def test_wrappers_reject_bad_inputs_and_count_no_cpu_launch():
    data = torch.ones(2, 8, dtype=torch.float64)
    idx = torch.zeros(2, 8, dtype=torch.int32)
    y = torch.ones(4, dtype=torch.float64)
    c = torch.zeros(8, dtype=torch.float64)
    price0, spmv0 = ell_price.launches, ell_spmv.launches
    ell_price(data, idx, y, c)
    ell_spmv(data, idx, y)
    # the CPU runs the plain versions: no kernel was launched
    assert (ell_price.launches, ell_spmv.launches) == (price0, spmv0)

    with pytest.raises(TypeError):
        ell_price(data, idx.long(), y)                     # int64 indices
    with pytest.raises(TypeError):
        ell_price(data, idx, y.float())                    # mixed dtypes
    with pytest.raises(TypeError):
        ell_spmv(data.half(), idx, y.half())               # unsupported dtype
    with pytest.raises(ValueError):
        ell_price(data, idx[:1], y)                        # shape mismatch
    with pytest.raises(ValueError):
        ell_price(data, idx, y, c[:4])                     # c of the wrong length
    with pytest.raises(ValueError):
        ell_spmv(data.T.contiguous().T, idx, y)            # not contiguous
    with pytest.raises(ValueError):
        ell_price(data[:0], idx[:0], y)                    # no slots
    with pytest.raises(ValueError):
        ell_price(data, idx, torch.ones(2, 2, dtype=torch.float64))


@pytest.mark.parametrize("m", [1, 100, 4093, 4096, 32768, 131072, 1 << 20])
@pytest.mark.parametrize("Kr", [1, 2, 3, 5, 8, 31, 64, 257])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_spmv_plan_covers_every_slot_exactly_once(m, Kr, itemsize):
    from relp_tpu_torch.ops.sparse_kernels import spmv_plan

    plan = spmv_plan(m, Kr, itemsize)
    S, L, TX, R = plan
    covered = [k for s in range(S) for k in range(s * L, min(Kr, (s + 1) * L))]
    assert covered == list(range(Kr))
    assert all(s * L < Kr for s in range(S))             # no empty segment
    assert 1 <= S <= 16
    assert R in (1, 4) and (R == 1 or m % 4 == 0)
    assert 32 <= TX and TX * S <= 512
    assert S * TX * R * itemsize <= 48 * 1024             # the partial sums fit a block
    assert -(-m // (TX * R)) < 2 ** 31


def test_spmv_plan_splits_deep_rows_and_leaves_short_ones_whole():
    from relp_tpu_torch.ops.sparse_kernels import spmv_plan

    # the max-flow LP's row pool: few rows, 31 slots deep -> several segments
    assert spmv_plan(4096, 31, 8).segments > 1
    # its column pool read as the rows of the transpose: 2 slots -> one segment
    assert spmv_plan(32768, 2, 8).segments == 1
    # enough rows to fill the card: no split
    assert spmv_plan(1 << 20, 31, 8).segments == 1
