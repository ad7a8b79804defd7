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
from scipy.sparse.csgraph import maximum_flow

from relp_tpu_torch import api
from relp_tpu_torch.io.mps_write import export_mps
from relp_tpu_torch.models.networks import max_flow_lp, random_arcs
from relp_tpu_torch.ops.sparse_kernels import (
    ell_price,
    ell_price_plain,
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
