"""How far an answer ``(objective, x, y)`` of an LP is from optimal, worked
out in float64 from the LP's own arrays and bounds; ``y`` are the row duals
in the LP's own sense (a maximisation's duals are those of ``max``).

- ``res``: primal residual, ``max(|A x − b|∞, bound violation) / (1 + |b|∞)``;
- ``gap``: the duality gap at ``(x, y)``: with every bound finite, any ``y``
  is dual feasible, and the dual objective ``b·y + Σ min(lb·d, ub·d)`` of
  the minimisation (``d = c − Aᵀy``) bounds its optimum from below, so
  ``gap = |c·x − dual| / (1 + |c·x| + |dual|)`` with the primal residual
  bounds how far ``x`` is from optimal;
- ``obj``: ``|objective − reference| / (1 + |reference|)``, the answer's
  objective against the reference solve's.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.families.lp import LP
from portbench.reference.operator import Operator


def measures(lp: LP, op: Operator, objective: float, x, y, reference: float) -> dict:
    """The three readings of an answer."""
    f = dict(dtype=torch.float64, device=op.device)
    x_t = torch.as_tensor(np.asarray(x, np.float64), **f)
    sense = -1.0 if lp.maximize else 1.0
    y_t = torch.as_tensor(sense * np.asarray(y, np.float64), **f)
    b = torch.as_tensor(lp.b, **f)
    c = torch.as_tensor(sense * lp.c, **f)
    lb = torch.as_tensor(lp.lb, **f)
    ub = torch.as_tensor(lp.ub, **f)
    viol = torch.maximum(lb - x_t, x_t - ub).max().clamp(min=0)
    res = float(torch.maximum((op.mv(x_t) - b).abs().max(), viol)) / (1.0 + float(b.abs().max()))
    d = c - op.rmv(y_t)
    dual = float(b @ y_t + torch.minimum(lb * d, ub * d).sum())
    primal = float(c @ x_t)
    return {
        "res": res,
        "gap": abs(primal - dual) / (1.0 + abs(primal) + abs(dual)),
        "obj": abs(objective - reference) / (1.0 + abs(reference)),
    }
