"""The dense-operator slice of the port against the JAX package: the
``dense_price`` kernel's plain version against the JAX ``DenseMatrix``
pricing, the toolchain probe, and the dense resource-allocation LP
(``relp_tpu_torch/models/dense.py``, bench.py's DENSE family) through both
packages' ``api.solve``.

Inputs are made with numpy from a seed and handed to both packages.  On
the CPU the wrappers run their plain PyTorch versions; the CUDA kernels are
compared with them on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linprog

import relp_tpu  # noqa: F401  (x64 on the CPU backend)
import relp_tpu.api
from relp_tpu.ops import amatrix as jam
from relp_tpu.utils.config import SolverConfig as JaxConfig
from relp_tpu_torch import api, probe
from relp_tpu_torch.io.mps_write import export_mps
from relp_tpu_torch.models.dense import dense_lp, dense_lp_data
from relp_tpu_torch.ops import amatrix as tam
from relp_tpu_torch.ops.dense_kernels import dense_price, dense_price_plain, slices_for
from relp_tpu_torch.utils.config import SolverConfig

F32_REL = 1e-5   # f32 sums of m products in another order
F64_REL = 1e-12
OBJ_REL = 1e-9


def _pair(A):
    """The same matrix as (JAX, port) ``DenseMatrix`` with f32 shadows."""
    return (jam.DenseMatrix(jnp.asarray(A)).with_f32(),
            tam.DenseMatrix(torch.from_numpy(A.copy())).with_f32())


def _close(got, want, rel, scale):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rel, atol=rel * scale)


@pytest.mark.parametrize("block", range(4))
def test_probe_pricing_grid_matches_jax_block(block):
    # tools/probe_pallas.py's pricing_kernel: m=128, n=1024, bn=256, all ones
    m, n, bn = 128, 1024, 256
    jop, top = _pair(np.ones((m, n)))
    j0 = block * bn
    pi32 = np.ones(m, np.float32)
    c32 = np.ones(bn, np.float32)
    want = c32 - np.asarray(jop.rmatvec32_block(jnp.asarray(pi32), jnp.int64(j0), bn))
    got = top.price32(torch.from_numpy(c32), torch.from_numpy(pi32), j0, bn)
    assert np.array_equal(got.numpy(), want)
    assert np.all(want == 1.0 - m)


@pytest.mark.parametrize("m,n,seed", [(128, 1024, 0), (96, 333, 1), (768, 1536, 2)])
def test_dense_price_matches_jax_pricing(m, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.05, 1.0, (m, n))
    pi = rng.standard_normal(m)
    c = rng.standard_normal(n)
    jop, top = _pair(A)
    scale = float((np.abs(pi) @ np.abs(A)).max())
    # f64: the fallback pass c − πᵀA and πᵀA
    _close(dense_price(top.A, torch.from_numpy(pi), torch.from_numpy(c)),
           c - np.asarray(jop.rmatvec(pi)), F64_REL, scale)
    _close(top.rmatvec(torch.from_numpy(pi)), jop.rmatvec(pi), F64_REL, scale)
    # f32: the scan and the devex row
    pi32 = pi.astype(np.float32)
    _close(top.rmatvec32(torch.from_numpy(pi32)), jop.rmatvec32(jnp.asarray(pi32)), F32_REL, scale)
    _close(top.price32(torch.from_numpy(c.astype(np.float32)), torch.from_numpy(pi32)),
           c.astype(np.float32) - np.asarray(jop.rmatvec32(jnp.asarray(pi32))), F32_REL, scale)


@pytest.mark.parametrize("blocks", [2, 4, 8])
def test_dense_price_windows_match_jax_blocks(blocks):
    rng = np.random.default_rng(blocks)
    m, n = 64, 512
    A = rng.standard_normal((m, n))
    jop, top = _pair(A)
    v32 = rng.standard_normal(m).astype(np.float32)
    scale = float((np.abs(v32) @ np.abs(A)).max())
    bsize = n // blocks
    for b in range(blocks):
        j0 = b * bsize
        want = np.asarray(jop.rmatvec32_block(jnp.asarray(v32), jnp.int64(j0), bsize))
        _close(top.rmatvec32_block(torch.from_numpy(v32), j0, bsize), want, F32_REL, scale)
        # the window of the full product
        full = dense_price_plain(top.A32, torch.from_numpy(v32))
        _close(dense_price_plain(top.A32, torch.from_numpy(v32), j0=j0, w=bsize),
               full[j0:j0 + bsize], F32_REL, scale)


def test_dense_operator_routes_through_dense_price():
    rng = np.random.default_rng(7)
    A = rng.standard_normal((16, 40))
    op = tam.DenseMatrix(torch.from_numpy(A)).with_f32()
    pi = torch.from_numpy(rng.standard_normal(16))
    c = torch.from_numpy(rng.standard_normal(40))
    launches = dense_price.launches
    assert torch.equal(op.price(c, pi), dense_price_plain(op.A, pi, c))
    assert torch.equal(op.price32(c.float(), pi.float()), dense_price_plain(op.A32, pi.float(), c.float()))
    assert torch.equal(op.rmatvec32_block(pi.float(), 8, 16),
                       dense_price_plain(op.A32, pi.float(), j0=8, w=16))
    assert dense_price.launches == launches  # the CPU runs the plain version


def test_grid_split_covers_every_row():
    for m, w in [(768, 1536), (768, 384), (128, 1024), (2048, 16384), (1, 5), (5000, 64), (0, 7)]:
        slices, rows = slices_for(m, w)
        assert slices >= 1 and rows >= 1
        assert slices * rows >= m and (slices - 1) * rows < max(m, 1)
    assert slices_for(2048, 16384) == (1, 2048)   # wide: one slice, one launch
    assert slices_for(768, 1536)[0] > 1          # narrow: rows split over the grid


def test_dense_price_rejects_bad_inputs():
    A = torch.ones(4, 8, dtype=torch.float64)
    v = torch.ones(4, dtype=torch.float64)
    with pytest.raises(TypeError):
        dense_price(A, v.float())                               # mixed dtypes
    with pytest.raises(TypeError):
        dense_price(A.half(), v.half())                         # unsupported dtype
    with pytest.raises(ValueError):
        dense_price(A, torch.ones(3, dtype=torch.float64))      # v of the wrong length
    with pytest.raises(ValueError):
        dense_price(A, v, torch.ones(8, dtype=torch.float64), j0=2, w=4)  # c not of width w
    with pytest.raises(ValueError):
        dense_price(A, v, j0=6, w=4)                            # window past the end
    with pytest.raises(ValueError):
        dense_price(A.T.contiguous().T, v)                      # not contiguous


def test_probe_runs_on_the_cpu(capsys):
    assert probe.run_probes(torch.device("cpu")) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and all(": OK" in line for line in lines)
    assert "-127.0" in lines[2]


@pytest.mark.parametrize("m,n", [(48, 96), (96, 192)])
def test_dense_lp_matches_jax_and_highs(m, n, tmp_path):
    A, b, c = dense_lp_data(m, n)
    highs = linprog(c, A_eq=A, b_eq=b, bounds=(0, 2), method="highs")
    path = tmp_path / f"dense_{m}x{n}.mps"
    export_mps(dense_lp(m, n), path)

    rt = api.solve(path, SolverConfig(), device="cpu")
    rj = relp_tpu.api.solve(path, JaxConfig(bucket_shapes=False))
    assert rt.kind.value == rj.kind.value == "finite_optimum"
    assert rt.simplex.metrics.matrix_format == "dense"
    assert rt.solution.objective_value == pytest.approx(rj.solution.objective_value, rel=OBJ_REL)
    assert rt.solution.objective_value == pytest.approx(highs.fun, rel=OBJ_REL)
    assert rt.simplex.iterations == rj.simplex.iterations
