"""Warm re-solves after capacity cuts, on the driver's own operator: set-up
solves the configuration's base LP once, cold, under the cell's solver
options (``algorithm="dual"``); each request then cuts ``bounds`` distinct
arcs that carry flow in the family's maximum flow (``extra["flow"]``; one of
a pool of ``cycle`` what-ifs that the traffic fixes, taken in an order drawn
from the seed; see ``pool.py``) to half their flow, and re-solves warm from
the base solve's basis through
``relp_tpu_torch.simplex.reoptimize.reoptimize_with_bounds``, on the padded
problem and the operator that ``relp_tpu_torch.simplex.driver.device_problem``
gives: the one ``matrix_format`` picks, as the base solve ran on.

Half the flow is a feasible point, ``x0 = flow / 2``, and a cut arc's upper
bound is its value there: ``resolve``'s request and ``lp_of`` serve the cut
as they serve a tightened bound.  Every request starts from the base, and
x = 0 is always feasible, so each has an optimum.  The timed call ends with
x and the duals on the host.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np

from portbench import pool
from portbench.families.lp import LP
from portbench.kinds import resolve
from portbench.kinds.base import general_form


class Kind(resolve.Kind):
    def setup(self) -> None:
        import torch

        from relp_tpu_torch.model.computational_form import build_computational_form
        from relp_tpu_torch.simplex.driver import device_problem, solve_computational_form
        from relp_tpu_torch.simplex.reoptimize import reoptimize_with_bounds
        from relp_tpu_torch.utils import metrics
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
                          f"{time.perf_counter() - t0:.3f} s, engine {root.metrics.engine}, "
                          f"{root.metrics.matrix_format})")
        if not root.is_optimal or root.basis is None:
            raise RuntimeError(f"the base solve ended {root.kind}")
        # the engine works on the minimisation; answers are in the LP's own sense
        self.sense = -1.0 if cf.maximize else 1.0
        P = device_problem(cf, cfg, self.device)
        self.A_op, self.b_t, self.c_t = P.A, P.b, P.c
        self.lb0, self.ub0 = P.lb.cpu().numpy(), P.ub.cpu().numpy()
        self.max_iter = P.max_iter
        self.prior = SimpleNamespace(**{k: torch.as_tensor(getattr(root, k), device=self.device)
                                        for k in ("basis", "vstat", "art_sign")})
        self.request(0)  # warm-up: the cell's own shapes
        ran = metrics.recent()[-1]
        if ran.call != "reoptimize" or ran.matrix_format != P.A.format:
            raise RuntimeError(f"the warm-up re-solve names operator {ran.matrix_format!r}, "
                               f"not {P.A.format!r}")
        self.notes.append(f"(re-solves on {P.A.format}, m_pad {P.m_pad}, n_pad {P.n_pad})")

    def prepare(self) -> None:
        base = self.family.make(self.config, self.seed, 0)
        if "flow" not in base.extra:
            raise ValueError(f"family {self.config['family']} gives no flow to cut")
        flow = base.extra["flow"]
        self.carrying = np.flatnonzero(flow > 0)
        self.base = LP(**{**base.__dict__, "extra": {**base.extra, "x0": flow / 2}})

    def columns(self, k: int) -> np.ndarray:
        """The arcs request ``k`` cuts: what-if ``pool.member`` of the
        traffic's pool, drawn from the arcs that carry flow with
        ``(pool_seed, member)``."""
        t = self.cell["traffic"]
        q = pool.member(self.seed, k, int(t["cycle"]))
        rng = np.random.default_rng([int(t["pool_seed"]), q])
        return rng.choice(self.carrying, int(t["bounds"]), replace=False)
