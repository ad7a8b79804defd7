"""The entering-column selection fused into the port's pricing wrappers
(``dense_price_select``, ``ell_price_select``; relp_tpu_torch/ops) against
``PrimalKernel._select`` over the priced ``d`` and against the JAX package's
choice.

The JAX package's ``pick`` is a closure of ``_make_primal_kernel``
(relp_tpu/simplex/core.py:353-369), so ``_jax_pick`` restates its arithmetic
with ``jnp`` over the JAX operators' pricing; the end-to-end tests compare
the entering column of every iteration through ``trace_iters``.  Inputs are
made with numpy from a seed and handed to both packages.  On the CPU the
wrappers run their plain PyTorch versions; the CUDA kernels are compared
with them on the card by tests/test_torch_cuda.py.

Tolerances: ``q`` and ``has`` exact; ``d_q`` 1e-6 relative in f32 and 1e-12
in f64, scaled by the size of the terms summed (sums in another order).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import relp_tpu  # noqa: F401  (x64 on the CPU backend)
import relp_tpu.api
from relp_tpu.ops import amatrix as jam
from relp_tpu.utils.config import SolverConfig as JaxConfig
from relp_tpu_torch import api
from relp_tpu_torch.io.mps_write import export_mps
from relp_tpu_torch.models.dense import dense_lp
from relp_tpu_torch.ops import amatrix as tam
from relp_tpu_torch.ops import select_epilogue
from relp_tpu_torch.ops.dense_kernels import dense_price_select, dense_price_select_plain
from relp_tpu_torch.ops.select_epilogue import Selection
from relp_tpu_torch.ops.sparse_kernels import (
    ell_price_select,
    ell_price_select_plain,
    price_plan,
)
from relp_tpu_torch.simplex import status as st
from relp_tpu_torch.simplex.core import PrimalKernel
from relp_tpu_torch.utils.config import SolverConfig

EPS = 1e-9
M, N = 48, 256
REL = {"f32": 1e-6, "f64": 1e-12}


def _problem(seed, kind):
    """A seeded operator pair (JAX, port) of ``kind`` with pricing inputs and
    a selection state in which every status occurs."""
    rng = np.random.default_rng(seed)
    if kind == "dense":
        A = rng.uniform(-1.0, 1.0, (M, N))
        jop = jam.DenseMatrix(jnp.asarray(A)).with_f32()
        top = tam.DenseMatrix(torch.from_numpy(A.copy())).with_f32()
    else:
        A = sp.random(M, N, density=0.08, random_state=rng, format="csc", dtype=np.float64)
        jop = jam.ell_from_csc(A, M, N).with_f32()
        top = tam.ell_from_csc(A, M, N, device="cpu").with_f32()
        A = A.toarray()
    pi = rng.standard_normal(M)
    c = rng.standard_normal(N)
    vstat = rng.integers(0, 5, N + M)
    can_enter = rng.random(N) < 0.9
    w = rng.uniform(0.5, 4.0, N)
    return A, jop, top, pi, c, vstat, can_enter, w


def _jax_pick(d, vs, can, w, bland, devex, n):
    """``pick`` of relp_tpu/simplex/core.py:353-369, restated."""
    imp_l = ((vs == st.NB_LOWER) | (vs == st.NB_FREE)) & (d < -EPS)
    imp_u = ((vs == st.NB_UPPER) | (vs == st.NB_FREE)) & (d > EPS)
    viol = jnp.where(imp_l, -d, 0.0) + jnp.where(imp_u, d, 0.0)
    viol = jnp.where(can & (vs != st.BASIC), viol, 0.0)
    score = viol * viol / w if devex else viol
    j_best = jnp.argmax(score)
    j_bland = jnp.argmin(jnp.where(viol > 0, jnp.arange(d.shape[0]), n))
    j = jnp.where(bland, j_bland, j_best)
    return int(j), bool(viol[j] > 0)


def _port_select(kernel, d, vstat, can_enter, w, bland, devex, lo):
    """``PrimalKernel._select`` over ``d`` (the engine's own code, on a
    stand-in that carries only what it reads)."""
    n = can_enter.shape[0]
    fake = types.SimpleNamespace(
        cfg=types.SimpleNamespace(eps_dual=EPS, pricing="devex" if devex else "dantzig"),
        n=n, can_enter=can_enter, col_ids=torch.arange(n))
    state = types.SimpleNamespace(w=w, bland=bland)
    q, has = kernel._select(fake, d.to(torch.float64), state, vstat[lo:lo + d.shape[0]], lo=lo)
    return int(q), bool(has)


@pytest.mark.parametrize("window", [(0, N), (64, 64)], ids=["whole", "window"])
@pytest.mark.parametrize("mode", ["devex", "dantzig", "bland"])
@pytest.mark.parametrize("tag", ["f32", "f64"])
@pytest.mark.parametrize("kind", ["dense", "ell"])
def test_price_select_matches_select_and_jax_pick(kind, tag, mode, window):
    j0, wc = window
    A, jop, top, pi, c, vstat, can_enter, w = _problem(3, kind)
    devex, bland = mode == "devex", mode == "bland"
    ft = torch.float32 if tag == "f32" else torch.float64
    sel = Selection(torch.from_numpy(vstat), torch.from_numpy(can_enter), torch.from_numpy(w),
                    torch.tensor(bland), EPS, devex)
    v, cw = torch.from_numpy(pi).to(ft), torch.from_numpy(c[j0:j0 + wc]).to(ft)
    if kind == "dense":
        pool = (top.A32 if tag == "f32" else top.A,)
        fused, plain = dense_price_select, dense_price_select_plain
    else:
        pool = (top.data32_t if tag == "f32" else top.data_t), top.rows_t
        fused, plain = ell_price_select, ell_price_select_plain
    q, has, d_q = fused(*pool, v, cw, *sel, j0, wc)
    assert (q.dtype, has.dtype, d_q.dtype) == (torch.int64, torch.bool, ft)
    assert q.dim() == has.dim() == d_q.dim() == 0

    # the wrapper on the CPU is its plain version, bit for bit
    q0, has0, d_q0 = plain(*pool, v, cw, *sel, j0, wc)
    assert (int(q), bool(has)) == (int(q0), bool(has0)) and torch.equal(d_q, d_q0)

    # ... and the engine's _select over the priced d
    if tag == "f32":
        d = top.price32(cw, v, j0, wc)
    else:
        d = top.price(torch.from_numpy(c), v)[j0:j0 + wc]
    assert (int(q), bool(has)) == _port_select(PrimalKernel, d, *sel[:4], devex, j0)
    assert torch.equal(d_q, d[int(q) - j0])

    # ... and the JAX package's pick over its own pricing of the same inputs
    if tag == "f32":
        dj = (jnp.asarray(c, jnp.float32) - jop.rmatvec32(jnp.asarray(pi, jnp.float32)))
        dj = dj.astype(jnp.float64)
    else:
        dj = jnp.asarray(c) - jop.rmatvec(jnp.asarray(pi))
    jq, jhas = _jax_pick(dj[j0:j0 + wc], jnp.asarray(vstat[j0:j0 + wc]),
                         jnp.asarray(can_enter[j0:j0 + wc]), jnp.asarray(w[j0:j0 + wc]),
                         bland, devex, N)
    assert (int(q) - j0, bool(has)) == (jq, jhas)
    scale = float((np.abs(pi) @ np.abs(A)).max())
    np.testing.assert_allclose(float(d_q), float(dj[int(q)]), rtol=REL[tag], atol=REL[tag] * scale)


def _tie_case(kind, n=600):
    """An operator of zeros: every reduced cost is ``c``."""
    if kind == "dense":
        return (torch.zeros(4, n, dtype=torch.float64),), dense_price_select
    return (torch.zeros(2, n, dtype=torch.float64), torch.zeros(2, n, dtype=torch.int32)), \
        ell_price_select


@pytest.mark.parametrize("kind", ["dense", "ell"])
def test_ties_no_improving_column_and_nan_scores(kind):
    n = 600
    pool, fused = _tie_case(kind, n)
    y = torch.zeros(4, dtype=torch.float64)
    c = torch.full((n,), -1.0, dtype=torch.float64)
    vstat = torch.zeros(n + 4, dtype=torch.int64)
    can_enter = torch.ones(n, dtype=torch.bool)
    w = torch.ones(n, dtype=torch.float64)

    def choose(bland=False, devex=True, j0=0, wc=None):
        q, has, d_q = fused(*pool, y, c[j0:j0 + (wc or n - j0)].contiguous(), vstat, can_enter, w,
                            torch.tensor(bland), EPS, devex, j0, wc)
        return int(q), bool(has), float(d_q)

    # all scores equal: the lowest column, as torch.argmax and jnp.argmax give
    assert choose() == (0, True, -1.0)
    assert choose(j0=100, wc=300) == (100, True, -1.0)
    assert int(jnp.argmax(jnp.ones(n))) == 0
    vstat[:250] = st.BASIC
    can_enter[250:260] = False
    assert choose() == choose(devex=False) == choose(bland=True) == (260, True, -1.0)
    # a NaN score is the greatest (torch.argmax's order), whatever else is there
    c[400] = -5.0
    assert choose() == (400, True, -5.0)
    w[300] = float("nan")
    assert choose() == (300, True, -1.0)
    assert choose(bland=True) == (260, True, -1.0)       # Bland's rule reads no score
    w[300] = 1.0
    # nothing improves: the window's first column, has False
    c[:] = 0.5
    assert choose() == choose(bland=True) == (0, False, 0.5)
    assert choose(j0=64, wc=128) == (64, False, 0.5)
    # every column basic or fixed
    c[:] = -1.0
    vstat[:n:2], vstat[1:n:2] = st.BASIC, st.NB_FIXED
    assert choose() == (0, False, -1.0)
    assert choose(bland=True, j0=8, wc=80) == (8, False, -1.0)
    # an upper-bounded and a free column improve by their sign
    vstat[10], vstat[20], c[10], c[20] = st.NB_UPPER, st.NB_FREE, 2.0, 3.0
    assert choose(devex=False) == (20, True, 3.0)
    c[20] = EPS / 2                                   # inside the tolerance: no violation
    assert choose(devex=False) == (10, True, 2.0)


def test_f32_reduced_costs_are_widened_before_the_tolerance_and_the_score():
    # eps whose float32 rounding lies above it: d32 = float32(eps) exceeds eps
    # once widened to f64, so an upper-bounded column improves; compared in
    # f32 against float32(eps) it would not
    eps = next(e for e in (1e-9, 2e-9, 3e-9, 5e-9, 7e-9) if float(np.float32(e)) > e)
    d32 = np.float32(eps)
    assert float(d32) > eps and not (d32 > np.float32(eps))
    A, y = torch.zeros(2, 8, dtype=torch.float32), torch.zeros(2, dtype=torch.float32)
    ones = torch.ones(8, dtype=torch.float64)
    q, has, d_q = dense_price_select(
        A, y, torch.full((8,), float(d32), dtype=torch.float32),
        torch.full((10,), st.NB_UPPER), torch.ones(8, dtype=torch.bool), ones,
        torch.tensor(False), eps, True)
    assert (int(q), bool(has)) == (0, True) and d_q.dtype == torch.float32
    # viol²/w in f64: column 5 scores 1.00000004 against column 2's 1; in f32
    # both round to 1 and the tie would go to column 2
    c = torch.zeros(8, dtype=torch.float32)
    c[2], c[5] = -3.0, -float(np.float32(1 + 2.0 ** -23))
    w = ones.clone()
    w[2], w[5] = 9.0, 1.0000002
    a32 = np.float32(1 + 2.0 ** -23)
    assert np.float32(a32 * a32) / np.float32(1.0000002) == np.float32(1.0)
    q, has, _ = dense_price_select(A, y, c, torch.zeros(10, dtype=torch.int64),
                                   torch.ones(8, dtype=torch.bool), w, torch.tensor(False),
                                   EPS, True)
    assert (int(q), bool(has)) == (5, True)


def test_select_wrappers_reject_bad_inputs():
    A = torch.ones(4, 8, dtype=torch.float64)
    v, c = torch.ones(4, dtype=torch.float64), torch.ones(8, dtype=torch.float64)
    good = dict(vstat=torch.zeros(12, dtype=torch.int64), can_enter=torch.ones(8, dtype=torch.bool),
                w=torch.ones(8, dtype=torch.float64), bland=torch.tensor(False),
                eps_dual=EPS, devex=True)
    dense_price_select(A, v, c, **good)
    with pytest.raises(ValueError):
        dense_price_select(A, v, None, **good)                                # no costs
    with pytest.raises(TypeError):
        dense_price_select(A, v, c, **{**good, "vstat": good["vstat"].int()})  # int32 statuses
    with pytest.raises(TypeError):
        dense_price_select(A, v, c, **{**good, "w": good["w"].float()})       # f32 weights
    with pytest.raises(TypeError):
        dense_price_select(A, v, c, **{**good, "bland": False})               # a host flag
    with pytest.raises(ValueError):
        dense_price_select(A, v, c, **{**good, "can_enter": good["can_enter"][:4]})
    with pytest.raises(ValueError):
        dense_price_select(A, v, c[:0], **good, j0=3, w_cols=0)               # empty window
    data, idx = torch.ones(2, 8, dtype=torch.float64), torch.zeros(2, 8, dtype=torch.int32)
    ell_price_select(data, idx, v, c, **good)
    with pytest.raises(ValueError):
        ell_price_select(data, idx, v, c, **{**good, "vstat": good["vstat"][:6]})
    # the codes the kernels compare against are the engine's
    assert (select_epilogue.NB_LOWER, select_epilogue.NB_UPPER, select_epilogue.BASIC,
            select_epilogue.NB_FREE) == (st.NB_LOWER, st.NB_UPPER, st.BASIC, st.NB_FREE)


def test_ell_price_plan_stages_where_the_vector_fits():
    assert price_plan(32768, 4096, 4) == (64, True)       # the max-flow slice: 16 KB staged
    assert price_plan(32768, 4096, 8)[1]                  # 32 KB in f64
    assert price_plan(8192, 70000, 4) == (16, False)      # 273 KB: gathered through the cache
    assert price_plan(8192, 28000, 8)[1] and not price_plan(8192, 29000, 8)[1]
    assert price_plan(1, 8, 4)[0] == 1 and price_plan(10**7, 8, 4)[0] == 264


@pytest.mark.parametrize("pricing", ["devex", "dantzig", "bland"])
def test_entering_columns_match_jax_through_the_trace(pricing, tmp_path):
    # the dense operator takes the fused route in every pricing branch; the
    # trace's column 6 is the entering column of each iteration
    path = tmp_path / "dense.mps"
    export_mps(dense_lp(24, 48), path)
    opts = dict(pricing=pricing, trace_iters=True)
    rt = api.solve(path, SolverConfig(**opts), device="cpu")
    rj = relp_tpu.api.solve(path, JaxConfig(bucket_shapes=False, **opts))
    assert rt.kind.value == rj.kind.value == "finite_optimum"
    assert rt.simplex.iterations == rj.simplex.iterations
    tq = np.asarray(rt.simplex.trace)[:, 6]
    jq = np.asarray(rj.simplex.trace)[: rt.simplex.iterations, 6]
    np.testing.assert_array_equal(tq, jq)


def test_operators_offer_the_fused_route_and_hybrid_does_not():
    A, _, top, pi, c, vstat, can_enter, w = _problem(5, "ell")
    sel = Selection(torch.from_numpy(vstat), torch.from_numpy(can_enter), torch.from_numpy(w),
                    torch.tensor(False), EPS, True)
    dense = tam.DenseMatrix(torch.from_numpy(A.copy())).with_f32()
    pi_t, c_t = torch.from_numpy(pi), torch.from_numpy(c)
    for op in (dense, top):
        q, has, d_q = op.price_select(c_t, pi_t, sel)
        d = op.price(c_t, pi_t)
        assert (int(q), bool(has)) == _port_select(PrimalKernel, d, *sel[:4], True, 0)
        assert torch.equal(d_q, d[int(q)])
        q32, has32, _ = op.price32_select(c_t[64:128].float(), pi_t.float(), sel, 64, 64)
        d32 = op.price32(c_t[64:128].float(), pi_t.float(), 64, 64)
        assert (int(q32), bool(has32)) == _port_select(PrimalKernel, d32, *sel[:4], True, 64)
    hybrid = tam.hybrid_from_csc(sp.csc_matrix(A), M, N, 4, 128, device="cpu")
    assert not hasattr(hybrid, "price_select") and not hasattr(hybrid, "price32_select")
