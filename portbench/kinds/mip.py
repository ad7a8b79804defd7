"""Mixed-integer solves from scratch: each request solves one instance of a
pool of ``cycle`` (``family.make(config, seed, q)``, q = 0..cycle−1, taken
in an order drawn from the seed; see ``pool.py``) by
``relp_tpu_torch.models.branch_bound.solve_mip`` under the cell's solver
options (``algorithm="dual"``), with its default node budget, cut rounds and
branching rule.  The timed call ends with the incumbent and its
certificate, its node's x and duals, on the host.

An instance's LP is the family's equality form; the program gets the
inequality form (the rows of ``extra["less"]`` written ``≤`` and their slack
columns left to its lowering, which appends them in row order) with the
columns of ``extra["integer"]`` integer.  ``prepare`` solves each instance
once by ``scipy.optimize.milp`` (HiGHS, ``mip_rel_gap=0``) on the host, the
instances in threads of their own.

An answer is the incumbent node's LP (``MipResult.certificate``): the
family's rows and the cuts in force, under the node's bounds.  ``lp_of``
makes it again in the benchmark's equality form with every bound finite: a
slack's upper bound is the most its row's activity allows under the node's
bounds, a cut's surplus column is bounded by ``Σ|γⱼ|·max(|lbⱼ|, |ubⱼ|) +
|δ|``, and the columns that bounds and rows fix are substituted out
(``reference/mip.py::fixed_out``).  The answer reads its x on the free
columns, its duals on the kept rows and its objective on that LP.  It is not
``ok`` where the status is no proven optimum, an integer column of the
incumbent lies more than 1e-6 off a whole number, the MIP objective lies
more than 1e-9 relative from HiGHS's, or a fixed column's value differs
from the program's x by more than 1e-9 relative.

The kind refuses a program whose ``MipResult`` carries no certificate
before any solve: its answers cannot be judged.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from portbench import pool
from portbench.families.lp import LP
from portbench.kinds.base import Answer, Kind as Base
from portbench.reference.mip import fixed_out

INT_TOL = 1e-6   # an integer column's distance from a whole number
MIP_REL = 1e-9   # the MIP objective against HiGHS's, relative
FIX_REL = 1e-9   # a fixed column's value against the program's x, relative


def has_certificate(result_type) -> bool:
    """Whether the program's ``MipResult`` carries an incumbent's LP."""
    return "certificate" in {f.name for f in dataclasses.fields(result_type)}


def program_form(lp: LP, name: str):
    """The program's ``GeneralForm`` of a family LP: the rows of
    ``extra["less"]`` written ``≤`` without their slack columns, the
    columns of ``extra["integer"]`` integer."""
    import scipy.sparse as sp

    from relp_tpu_torch.model.elements import (
        Objective, RangedConstraintRelation, VariableType,
    )
    from relp_tpu_torch.model.general_form import GeneralForm, Variable

    ns = int(lp.extra["n_struct"])
    less = np.zeros(lp.m, bool)
    less[lp.extra["less"]] = True
    rel = RangedConstraintRelation
    kinds = {True: VariableType.INTEGER, False: VariableType.CONTINUOUS}
    return GeneralForm(
        objective=Objective.MAXIMIZE if lp.maximize else Objective.MINIMIZE,
        A=sp.csc_matrix(lp.A[:, :ns]),
        constraint_types=[rel.less() if less[i] else rel.equal() for i in range(lp.m)],
        b=lp.b,
        variables=[Variable(lp.col_names[j], cost=float(lp.c[j]), lower=float(lp.lb[j]),
                            upper=float(lp.ub[j]),
                            variable_type=kinds[bool(lp.extra["integer"][j])])
                   for j in range(ns)],
        name=name, row_names=list(lp.row_names))


def highs_optimum(lp: LP):
    """``(objective, x)`` of HiGHS's proven optimum (``mip_rel_gap=0``)."""
    import scipy.sparse as sp
    from scipy.optimize import Bounds, LinearConstraint, milp

    res = milp(lp.c, constraints=LinearConstraint(sp.csr_matrix(lp.A), lp.b, lp.b),
               integrality=lp.extra["integer"].astype(int), bounds=Bounds(lp.lb, lp.ub),
               options={"mip_rel_gap": 0})
    if res.status != 0:
        raise RuntimeError(f"HiGHS ended {res.message!r} on {lp.name}")
    return float(res.fun), np.asarray(res.x)


def leaf_lp(lp: LP, lb, ub, gammas, deltas, name: str) -> LP:
    """The node LP in equality form, every bound finite: ``lp``'s rows and,
    for each cut ``t``, ``γ_t·x − s_t = δ_t`` with its surplus ``s_t`` the
    column ``lp.n + t``; ``lb``, ``ub`` the node's bounds over those
    columns (the slacks' and surpluses' upper bounds may be infinite: they
    are set here)."""
    m, n, K = lp.m, lp.n, len(deltas)
    A0 = lp.dense if lp.sparse is None else lp.sparse.toarray()
    A = np.zeros((m + K, n + K))
    A[:m, :n] = A0
    if K:
        A[m:, :n + K] = gammas[:, :n + K]
        A[m + np.arange(K), n + np.arange(K)] = -1.0
    lb = np.asarray(lb[:n + K], np.float64).copy()
    ub = np.asarray(ub[:n + K], np.float64).copy()
    ns, less = int(lp.extra["n_struct"]), np.asarray(lp.extra["less"])
    R = A0[less, :ns]  # the slacks' rows over the structural columns
    ub[ns:n] = np.minimum(ub[ns:n], lp.b[less] - np.minimum(R * lb[:ns], R * ub[:ns]).sum(1))
    for t in range(K):
        g = gammas[t, :n + t]
        live = g != 0.0
        ub[n + t] = min(ub[n + t], float(np.abs(g[live]) @ np.maximum(
            np.abs(lb[:n + t][live]), np.abs(ub[:n + t][live]))) + abs(float(deltas[t])))
    names = [f"cut{t}" for t in range(K)]
    return LP(name=name, maximize=lp.maximize, m=m + K, n=n + K,
              b=np.concatenate([lp.b, np.asarray(deltas, np.float64)]),
              c=np.concatenate([lp.c, np.zeros(K)]), lb=lb, ub=ub,
              row_names=list(lp.row_names) + names,
              col_names=list(lp.col_names) + [f"s_{nm}" for nm in names], dense=A)


def reduced(lp: LP, lb, ub, gammas, deltas, name: str):
    """``leaf_lp`` with its fixed columns out (``reference/mip.py::Reduced``)."""
    leaf = leaf_lp(lp, lb, ub, gammas, deltas, name)
    red = fixed_out(leaf, leaf.lb, leaf.ub, name)
    if red is None:
        raise ValueError(f"the node LP {name} has a row that cannot hold")
    return red


class Kind(Base):
    def setup(self) -> None:
        from relp_tpu_torch.models.branch_bound import MipResult, solve_mip
        from relp_tpu_torch.utils.config import SolverConfig

        if not has_certificate(MipResult):
            raise RuntimeError("the program's MipResult carries no certificate of its incumbent, "
                               "so its answers cannot be judged")
        cfg = SolverConfig(**self.cell["solver"])
        if cfg.scale or cfg.presolve:
            raise ValueError("solve_mip runs on the unscaled, unpresolved form")
        self.solver, self.solve_mip = cfg, solve_mip
        t0 = time.perf_counter()
        self.prepare()
        self.notes.append(f"(HiGHS on {len(self.instances)} instances: "
                          f"{time.perf_counter() - t0:.3f} s)")
        self.generals = [program_form(lp, lp.name) for lp in self.instances]
        self.request(0)  # warm-up: the kernels, the graphs' first captures

    def prepare(self) -> None:
        size = int(self.cell["traffic"]["cycle"])
        self.instances = [self.family.make(self.config, self.seed, q) for q in range(size)]
        # HiGHS gives up the interpreter's lock while it solves: one thread an instance
        with ThreadPoolExecutor(size) as pool_:
            self.highs = list(pool_.map(highs_optimum, self.instances))
        self.leaves: dict = {}  # key -> reference/mip.py::Reduced

    def member(self, k: int) -> int:
        return pool.member(self.seed, k, int(self.cell["traffic"]["cycle"]))

    def keys(self, k: int) -> list:
        """The LP of request ``k`` without the program (the control): the
        instance's LP with its integer columns fixed at HiGHS's optimum."""
        return [("fixed", self.member(k))]

    def request(self, k: int) -> dict:
        from relp_tpu_torch.model.elements import LinearProgramType

        q = self.member(k)
        with self.timed():
            t0 = time.perf_counter()
            res = self.solve_mip(self.generals[q], self.solver, device=self.device)
            wall = time.perf_counter() - t0
        lp = self.instances[q]
        ans = Answer(key=None, ok=False)
        cert = res.certificate
        if res.kind is LinearProgramType.FINITE_OPTIMUM and cert is not None:
            ans = self.answer(q, res)
        return dict(wall=wall, answers=[ans], iterations=res.lp_iterations, nodes=res.nodes,
                    instance=q, m=lp.m, n=lp.n)

    def answer(self, q: int, res) -> Answer:
        lp, cert = self.instances[q], res.certificate
        integer = np.flatnonzero(lp.extra["integer"])
        x_int = cert.x[integer]
        highs = self.highs[q][0]
        ok = (bool(np.all(np.abs(x_int - np.round(x_int)) <= INT_TOL))
              and abs(res.objective - highs) <= MIP_REL * (1.0 + abs(highs)))
        K = len(cert.deltas)
        if not (np.array_equal(cert.cut_rows, lp.m + np.arange(K))
                and np.array_equal(cert.cut_cols, lp.n + np.arange(K))
                and not np.any(cert.gammas[:, lp.n + K:])):
            raise ValueError("the certificate's cuts lie outside the rows and columns after "
                             "the instance's own")
        digest = hashlib.sha1()
        for v in (cert.lb, cert.ub, cert.gammas, cert.deltas):
            digest.update(np.ascontiguousarray(v, np.float64).tobytes())
        key = ("leaf", q, digest.hexdigest())
        red = self.leaves.get(key)
        if red is None:
            red = self.leaves[key] = reduced(lp, cert.lb, cert.ub, cert.gammas, cert.deltas,
                                             f"{lp.name}_leaf")
        x = np.concatenate([cert.x[:lp.n], cert.x[cert.cut_cols]])
        fixed = ~np.isnan(red.value)
        ok = ok and bool(np.all(np.abs(x[fixed] - red.value[fixed])
                                <= FIX_REL * (1.0 + np.abs(red.value[fixed]))))
        pi = np.concatenate([cert.pi[:lp.m], cert.pi[cert.cut_rows]])
        xs = x[red.cols]
        sense = -1.0 if lp.maximize else 1.0
        return Answer(key=key, ok=ok, objective=float(red.lp.c @ xs), x=xs,
                      y=sense * pi[red.rows])

    def lp_of(self, key) -> LP:
        red = self.leaves.get(key)
        if red is None:
            kind, q = key[0], key[1]
            if kind != "fixed":
                raise KeyError(key)
            lp = self.instances[q]
            integer = np.flatnonzero(lp.extra["integer"])
            lb, ub = lp.lb.copy(), lp.ub.copy()
            lb[integer] = ub[integer] = np.round(self.highs[q][1][integer])
            red = self.leaves[key] = reduced(lp, lb, ub, np.zeros((0, lp.n)), [],
                                             f"{lp.name}_fixed")
        return red.lp

    def release(self) -> None:
        self.generals = None
