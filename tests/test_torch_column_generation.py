"""The port's column pool and column generation (relp_tpu_torch/providers/)
against the JAX package's.

The fixtures are the JAX package's own: the cutting stock of
tests/test_column_generation.py (knapsack pricing over single-size starting
patterns, and the pool of every pattern, which prices out at once) and the
masked 10,000-column pool of tests/test_lazy_pool_10k.py (every 7th column
active, seed 3).  Both packages run on the CPU (the port's ``dense_price*``
kernels run their plain versions there); required equal: status, rounds,
the generated columns' names and data, total simplex iterations, and the
objective within 1e-9 relative.
"""

import numpy as np
import pytest
import torch

import relp_tpu  # noqa: F401  (x64 on the CPU backend)
from relp_tpu.providers import ColumnPool as JaxPool
from relp_tpu.providers import remove_rows as jax_remove_rows
from relp_tpu.providers import solve_with_column_generation as jax_cg
from relp_tpu.simplex.core import solve_core as jax_solve_core
from relp_tpu.utils.config import SolverConfig as JaxConfig
from relp_tpu_torch.model.elements import LinearProgramType
from relp_tpu_torch.ops import dense_kernels
from relp_tpu_torch.providers import ColumnPool, MatrixProvider, remove_rows
from relp_tpu_torch.providers import solve_with_column_generation
from relp_tpu_torch.simplex import status as st
from relp_tpu_torch.simplex.core import solve_core
from relp_tpu_torch.utils.config import SolverConfig
from tests.test_column_generation import all_patterns, knapsack_pricing, make_pool
from tests.test_lazy_pool_10k import build_pool


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _as_port(pool) -> ColumnPool:
    return ColumnPool(A=pool.A.copy(), b=pool.b.copy(), c=pool.c.copy(), lb=pool.lb.copy(),
                      ub=pool.ub.copy(), names=list(pool.names),
                      active=None if pool.active is None else pool.active.copy())


def _both(pool, **cfg):
    rj = jax_cg(pool, knapsack_pricing, JaxConfig(scale=False, **cfg))
    rt = solve_with_column_generation(_as_port(pool), knapsack_pricing,
                                      SolverConfig(scale=False, **cfg), device="cpu")
    return rj, rt


@pytest.mark.parametrize("start", ["single_size", "all_patterns"])
def test_column_generation_matches_jax(start):
    init = (np.diag((10.0 // np.array([3.0, 4.0, 5.0])).astype(float)) if start == "single_size"
            else all_patterns())
    before = dense_kernels.dense_price.launches + dense_kernels.dense_price_select.launches
    rj, rt = _both(make_pool(init))
    assert rt.kind is LinearProgramType.FINITE_OPTIMUM and rj.kind.value == rt.kind.value
    assert rt.rounds == rj.rounds and rt.total_iterations == rj.total_iterations
    assert rt.pool.names == rj.pool.names
    assert np.array_equal(rt.pool.A, rj.pool.A)
    assert rt.objective == pytest.approx(rj.objective, rel=1e-9)
    assert rt.x == pytest.approx(np.asarray(rj.x), abs=1e-9)
    if start == "single_size":
        assert rt.rounds >= 2 and len(rt.pool.names) > len(init) + 3  # columns were added
    else:
        assert rt.rounds == 1                                         # priced out at once
    # on the CPU the pricing wrappers run their plain versions: no launch
    assert dense_kernels.dense_price.launches + dense_kernels.dense_price_select.launches == before


def test_column_generation_on_the_example_cutting_stock():
    """examples/column_range.py's instance (width 100, four sizes), which
    grows the pool over several rounds."""
    import itertools

    width, sizes = 100.0, np.array([45.0, 36.0, 31.0, 14.0])
    demand = np.array([97.0, 610.0, 395.0, 211.0])

    def pricing(pi, pool):
        best_val, best = -1.0, None
        for combo in itertools.product(*[range(int(width // s) + 1) for s in sizes]):
            a = np.array(combo, dtype=float)
            if a @ sizes <= width and float(pi @ a) > best_val + 1e-12:
                best_val, best = float(pi @ a), a
        if best is None or best_val <= 1.0 + 1e-7:
            return None
        return best.reshape(-1, 1), [1.0], [0.0], [np.inf], None

    m = len(demand)
    init = np.diag((width // sizes).astype(float))
    kw = dict(A=np.concatenate([init, -np.eye(m)], axis=1), b=demand.copy(),
              c=np.concatenate([np.ones(m), np.zeros(m)]), lb=np.zeros(2 * m),
              ub=np.full(2 * m, np.inf),
              names=[f"p{j}" for j in range(m)] + [f"s{i}" for i in range(m)])
    rj = jax_cg(JaxPool(**kw), pricing, JaxConfig(scale=False))
    rt = solve_with_column_generation(ColumnPool(**kw), pricing, SolverConfig(scale=False),
                                      device="cpu")
    assert (rt.rounds, rt.total_iterations, rt.pool.names) == \
        (rj.rounds, rj.total_iterations, rj.pool.names)
    assert rt.objective == pytest.approx(rj.objective, rel=1e-9)
    assert rt.objective == pytest.approx(452.25, abs=1e-9)  # the LP bound, 452¼ rolls


def test_round_limit_reports_iteration_limit():
    rt = solve_with_column_generation(
        _as_port(make_pool(np.diag([3.0, 2.0, 2.0]))), knapsack_pricing,
        SolverConfig(scale=False), max_rounds=1, device="cpu")
    assert rt.kind is LinearProgramType.ITERATION_LIMIT and rt.rounds == 1 and rt.x is None


def test_pool_and_remove_rows_match_jax():
    pool = build_pool(m=12, n_pool=40, active_every=3, seed=1)
    port = _as_port(pool)
    assert isinstance(port, MatrixProvider) and port.pool() is port
    assert (port.nr_rows, port.nr_columns) == (12, 40)
    assert np.array_equal(port.column(5), pool.column(5))
    for a, b in zip(port.masked_arrays(), pool.masked_arrays()):
        assert np.array_equal(a, b)
    rows = [0, 4, 11]
    cut, cut_j = remove_rows(port, rows), jax_remove_rows(pool, rows)
    assert cut.nr_rows == 9 and cut.nr_columns == 40
    for name in ("A", "b", "c", "lb", "ub", "active"):
        assert np.array_equal(getattr(cut, name), getattr(cut_j, name)), name
    grown = port.with_columns(np.ones((12, 2)), [1.0, 2.0], [0.0, 0.0], [1.0, 1.0])
    grown_j = pool.with_columns(np.ones((12, 2)), [1.0, 2.0], [0.0, 0.0], [1.0, 1.0])
    assert grown.names == grown_j.names and grown.names[-2:] == ["gen0", "gen1"]
    assert np.array_equal(grown.active, grown_j.active) and grown.active[-2:].all()


def _pad_solve_both(pool):
    """The masked pool padded as tests/test_lazy_pool_10k.py pads it (rows to
    64, columns to 512), solved by both packages' ``solve_core``."""
    A, b, c, lb, ub = pool.masked_arrays()
    m, n = A.shape
    mp, npad = ((m + 63) // 64) * 64, ((n + 511) // 512) * 512
    Ap = np.zeros((mp, npad))
    Ap[:m, :n] = A
    vecs = [np.zeros(mp), np.zeros(npad), np.zeros(npad), np.zeros(npad)]
    for v, src in zip(vecs, (b, c, lb, ub)):
        v[: len(src)] = src
    oj = jax_solve_core(Ap, *vecs, cfg=JaxConfig(scale=False), max_iter=5000)
    ot = solve_core(torch.tensor(Ap), *(torch.tensor(v) for v in vecs),
                    SolverConfig(scale=False), 5000)
    return oj, ot


def test_masked_pool_pricing_10k_matches_jax():
    pool = build_pool()
    oj, ot = _pad_solve_both(pool)
    assert int(ot.status) == int(oj.status) == st.OPTIMAL
    assert int(ot.it) == int(oj.it)
    x = ot.x[: pool.nr_columns].numpy()
    # inactive virtual columns never enter
    assert np.all(x[~pool.active] == 0.0)
    assert float(ot.obj) > 0
    assert float(ot.obj) == pytest.approx(float(oj.obj), rel=1e-9)
    assert np.array_equal(ot.basis.numpy(), np.asarray(oj.basis))


def test_activating_columns_only_improves_as_in_jax():
    masked, full = build_pool(), build_pool()
    full.active = np.ones(full.nr_columns, dtype=bool)
    (oj1, ot1), (oj2, ot2) = _pad_solve_both(masked), _pad_solve_both(full)
    assert int(ot2.status) == int(oj2.status) == st.OPTIMAL
    assert float(ot2.obj) <= float(ot1.obj) + 1e-9
    assert float(ot2.obj) == pytest.approx(float(oj2.obj), rel=1e-9)
    assert int(ot2.it) == int(oj2.it)
