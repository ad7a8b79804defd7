"""Capacitated facility location in its strong formulation, A held dense.

    min Σᵢ fᵢ yᵢ + Σᵢⱼ cᵢⱼ xᵢⱼ
    s.t. Σᵢ xᵢⱼ = 1              every customer j
         Σⱼ dⱼ xᵢⱼ ≤ sᵢ yᵢ       every facility i
         xᵢⱼ ≤ yᵢ                every pair
         0 ≤ x ≤ 1,  y ∈ {0, 1}

The data follow the generator of Cornuéjols, Sridharan and Thizy (EJOR 50,
1991, §5): facilities and customers uniform in the unit square,
``dⱼ ~ U[5, 35]``, ``sᵢ ~ U[10, 160]`` rescaled so that ``Σ s = ratio · Σ d``,
``fᵢ = U[0, 90] + U[100, 110]·√sᵢ`` and ``cᵢⱼ = 10 · dⱼ · ‖pᵢ − qⱼ‖``, drawn in
that order from ``default_rng(base_seed + k)`` for instance ``k``.

The LP is the equality form with a slack column for each ``≤`` row, every
bound finite: a capacity row's slack lies in ``[0, sᵢ]`` and a pair's in
``[0, 1]``, the most the row's activity allows.  Columns are ``y`` (``I``),
``x`` (``I·J``, facility-major), then the slacks in row order; rows are the
customers (``J``), the capacities (``I``), then the pairs (``I·J``,
facility-major).  ``extra`` holds ``integer`` (the ``y`` columns), ``less``
(the rows written ``≤``, whose slacks are the columns from ``n_struct`` on)
and ``n_struct``, so that a kind can hand the program the inequality form.
"""

from __future__ import annotations

import numpy as np

from portbench.families.lp import LP


def cfl_data(facilities: int, customers: int, ratio: float, seed):
    """``(f, c, d, s)``: fixed costs ``[I]``, assignment costs ``[I, J]``,
    demands ``[J]`` and capacities ``[I]``."""
    rng = np.random.default_rng(seed)
    fac = rng.uniform(0.0, 1.0, (facilities, 2))
    cus = rng.uniform(0.0, 1.0, (customers, 2))
    d = rng.uniform(5.0, 35.0, customers)
    s = rng.uniform(10.0, 160.0, facilities)
    s *= ratio * d.sum() / s.sum()
    f = rng.uniform(0.0, 90.0, facilities) + rng.uniform(100.0, 110.0, facilities) * np.sqrt(s)
    dist = np.sqrt(((fac[:, None, :] - cus[None, :, :]) ** 2).sum(-1))
    return f, 10.0 * d[None, :] * dist, d, s


def cfl_lp(f, cost, d, s, name: str) -> LP:
    nf, nc = cost.shape
    pairs = nf * nc
    n_struct = nf + pairs
    m, n = nc + nf + pairs, n_struct + nf + pairs
    A = np.zeros((m, n))
    fi = np.repeat(np.arange(nf), nc)            # each pair's facility
    cj = np.tile(np.arange(nc), nf)              # and customer
    x = nf + np.arange(pairs)                    # the pairs' x columns
    A[cj, x] = 1.0                               # customers
    cap = nc + np.arange(nf)
    A[cap[fi], x] = d[cj]                        # capacities
    A[cap, np.arange(nf)] = -s
    link = nc + nf + np.arange(pairs)
    A[link, x] = 1.0                             # pairs
    A[link, fi] = -1.0
    less = np.concatenate([cap, link])
    A[less, n_struct + np.arange(nf + pairs)] = 1.0
    b = np.zeros(m)
    b[:nc] = 1.0
    c = np.concatenate([f, cost.ravel(), np.zeros(nf + pairs)])
    ub = np.concatenate([np.ones(n_struct), s, np.ones(pairs)])
    integer = np.zeros(n, bool)
    integer[:nf] = True
    return LP(name=name, maximize=False, m=m, n=n, b=b, c=c, lb=np.zeros(n), ub=ub,
              row_names=([f"cust{j}" for j in range(nc)] + [f"cap{i}" for i in range(nf)]
                         + [f"link{i}_{j}" for i in range(nf) for j in range(nc)]),
              col_names=([f"y{i}" for i in range(nf)]
                         + [f"x{i}_{j}" for i in range(nf) for j in range(nc)]
                         + [f"t_{r}" for r in ([f"cap{i}" for i in range(nf)]
                                               + [f"link{i}_{j}" for i in range(nf)
                                                  for j in range(nc)])]),
              dense=A, extra={"integer": integer, "less": less, "n_struct": n_struct})


def make(config: dict, seed: int, k: int) -> LP:
    """Instance ``k`` of the configuration's pool (``base_seed + k``)."""
    nf, nc = int(config["facilities"]), int(config["customers"])
    f, cost, d, s = cfl_data(nf, nc, float(config["ratio"]), int(config["base_seed"]) + k)
    return cfl_lp(f, cost, d, s, f"cfl_{nf}x{nc}_{k}")
