"""Warm re-solves after tightened bounds: set-up solves the configuration's
base LP once, cold, under the cell's solver options (``algorithm="dual"``);
each request then tightens the upper bound of ``bounds`` distinct columns
(one of a pool of ``cycle`` what-ifs that the traffic fixes, taken in an
order drawn from the seed; see ``pool.py``) to that column's value in the
family's feasible point ``x0`` and re-solves warm from the base solve's basis through
``relp_tpu_torch.simplex.reoptimize.reoptimize_with_bounds``, as
``models/branch_bound.py::solve_mip`` drives it: the unscaled computational
form padded, one dense operator on the device, bounds moved per call.  Every
request starts from the base, so x0 stays feasible and each has an optimum.
The timed call ends with x and the duals on the host.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np

from portbench import pool
from portbench.families.lp import LP
from portbench.kinds.base import Answer, Kind as Base, general_form


class Kind(Base):
    def setup(self) -> None:
        import scipy.sparse as sp
        import torch

        from relp_tpu_torch.model.computational_form import build_computational_form
        from relp_tpu_torch.ops.amatrix import DenseMatrix
        from relp_tpu_torch.simplex.driver import _round_up, solve_computational_form
        from relp_tpu_torch.simplex.reoptimize import reoptimize_with_bounds
        from relp_tpu_torch.utils.config import SolverConfig

        self.reoptimize = reoptimize_with_bounds
        self.prepare()
        cfg = SolverConfig(**self.cell["solver"])
        if cfg.scale or cfg.presolve:
            raise ValueError("re-solves run on the unscaled, unpresolved form, as solve_mip")
        self.solver = cfg
        cf = build_computational_form(general_form(self.base), scale=False)
        t0 = time.perf_counter()
        root = solve_computational_form(cf, cfg, device=self.device)
        self.notes.append(f"(base solve: {root.iterations} iterations, "
                          f"{time.perf_counter() - t0:.3f} s, engine {root.metrics.engine})")
        if not root.is_optimal or root.basis is None:
            raise RuntimeError(f"the base solve ended {root.kind}")
        # the engine works on the minimisation; answers are in the LP's own sense
        self.sense = -1.0 if cf.maximize else 1.0
        m, n = cf.m, cf.n
        m_pad, n_pad = _round_up(m, cfg.row_align), _round_up(n, cfg.col_align)
        A = np.zeros((m_pad, n_pad))
        A[:m, :n] = sp.csc_matrix(cf.A).toarray()

        def pad(v, size):
            out = np.zeros(size)
            out[: len(v)] = v
            return out

        f64 = dict(dtype=torch.float64, device=self.device)
        self.A_op = DenseMatrix(torch.tensor(A, **f64))
        self.b_t = torch.tensor(pad(cf.b, m_pad), **f64)
        self.c_t = torch.tensor(pad(cf.c, n_pad), **f64)
        self.lb0, self.ub0 = pad(cf.lb, n_pad), pad(cf.ub, n_pad)
        self.max_iter = cfg.resolve_max_iter(m_pad, n_pad)
        self.prior = SimpleNamespace(**{k: torch.as_tensor(getattr(root, k), device=self.device)
                                        for k in ("basis", "vstat", "art_sign")})
        self.request(0)  # warm-up: the cell's own shapes

    def prepare(self) -> None:
        self.base = self.family.make(self.config, self.seed, 0)
        if "x0" not in self.base.extra:
            raise ValueError(f"family {self.config['family']} gives no feasible x0 to bound by")

    def columns(self, k: int) -> np.ndarray:
        """The columns request ``k`` bounds: what-if ``pool.member`` of the
        traffic's pool, each drawn from ``(pool_seed, member)``."""
        t = self.cell["traffic"]
        q = pool.member(self.seed, k, int(t["cycle"]))
        rng = np.random.default_rng([int(t["pool_seed"]), q])
        return rng.choice(self.base.n, int(t["bounds"]), replace=False)

    def request(self, k: int) -> dict:
        from relp_tpu_torch.simplex import status as st

        J = self.columns(k)
        ub = self.ub0.copy()
        ub[J] = self.base.extra["x0"][J]
        with self.timed():
            t0 = time.perf_counter()
            out = self.reoptimize(self.A_op, self.b_t, self.c_t, self.lb0, ub, self.prior,
                                  config=self.solver, max_iter=self.max_iter)
            x = out.x.cpu().numpy()
            y = out.pi.cpu().numpy()
            status, its, obj = int(out.status), int(out.it), float(out.obj)
            wall = time.perf_counter() - t0
        m, n = self.base.m, self.base.n
        ans = Answer(key=k, ok=status == st.OPTIMAL, objective=self.sense * obj, x=x[:n],
                     y=self.sense * y[:m])
        return dict(wall=wall, answers=[ans], iterations=its, m=m, n=n)

    def lp_of(self, key) -> LP:
        lp = self.base
        ub = lp.ub.copy()
        J = self.columns(key)
        ub[J] = lp.extra["x0"][J]
        return LP(**{**lp.__dict__, "ub": ub, "name": f"{lp.name}_resolve_{key}"})

    def release(self) -> None:
        self.A_op = self.b_t = self.c_t = self.prior = None
