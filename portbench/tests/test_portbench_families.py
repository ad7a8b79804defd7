"""The generator against the port's own, and the reference against scipy."""

import pytest
import torch
from scipy.optimize import linprog

import numpy as np

from portbench import pool
from portbench.families import dense
from portbench.reference import certificate, ipm
from portbench.reference.operator import Operator


def test_dense_data_matches_the_port():
    from relp_tpu_torch.models.dense import dense_lp_data

    A, x0, c0 = dense.dense_data(24, 48, 5)
    A2, b2, c2 = dense_lp_data(24, 48, 5)
    assert np.array_equal(A, A2) and np.array_equal(A @ x0, b2) and np.array_equal(c0, c2)


@pytest.mark.parametrize("seed", [99, 2**31 + 5])
def test_every_cycle_takes_the_whole_pool(seed):
    for cycle in range(3):
        seen = sorted(pool.member(seed, 16 * cycle + k, 16) for k in range(1, 17))
        assert seen == list(range(16))
    assert pool.member(seed, 0, 16) == 0


@pytest.mark.parametrize("shape", [(16, 32), (40, 96)])
def test_reference_solves_dense_lp(shape):
    lp = dense.make(dict(rows=shape[0], cols=shape[1], upper=2.0, base_seed=3), 0, 0)
    sol = ipm.solve(lp)
    h = linprog(lp.c, A_eq=lp.dense, b_eq=lp.b, bounds=list(zip(lp.lb, lp.ub)), method="highs")
    assert abs(sol.objective - h.fun) <= 1e-9 * (1 + abs(h.fun))
    m = certificate.measures(lp, Operator(lp), h.fun, h.x, h.eqlin.marginals, sol.objective)
    assert m["res"] < 1e-9 and m["gap"] < 1e-9 and m["obj"] < 1e-9


def test_reference_in_float32_misses():
    lp = dense.make(dict(rows=40, cols=96, upper=2.0, base_seed=3), 0, 0)
    ref = ipm.solve(lp)
    low = ipm.solve(lp, torch.float32)
    m = certificate.measures(lp, Operator(lp), low.objective, low.x, low.y, ref.objective)
    assert max(m.values()) > 1e-7


def test_gap_reads_a_poor_dual():
    """The gap is taken against the LP's own bounds: duals off the optimum,
    such as a row's dual left at 0, read a gap although x is optimal."""
    lp = dense.make(dict(rows=40, cols=96, upper=2.0, base_seed=3), 0, 0)
    sol = ipm.solve(lp)
    op = Operator(lp)
    y = sol.y.copy()
    y[3] = 0.0
    assert certificate.measures(lp, op, sol.objective, sol.x, sol.y, sol.objective)["gap"] < 1e-9
    assert certificate.measures(lp, op, sol.objective, sol.x, y, sol.objective)["gap"] > 1e-6
