"""Top-level convenience API: ``solve(path)`` runs the whole pipeline —
import → GeneralForm → presolve → computational form → the engine
``config.algorithm`` names (primal or dual simplex, or the first-order
engine) on the device → named solution.  Mixed-integer programs go through
``relp_tpu_torch.models.branch_bound.solve_mip``."""

from __future__ import annotations

import os
from typing import Union

from relp_tpu_torch.io import import_lp
from relp_tpu_torch.simplex.driver import GeneralFormResult, solve_general_form
from relp_tpu_torch.utils.config import DEFAULT_CONFIG, SolverConfig
from relp_tpu_torch.utils.device import DeviceLike


def solve(path: Union[str, os.PathLike], config: SolverConfig = DEFAULT_CONFIG,
          device: DeviceLike = None) -> GeneralFormResult:
    """Solve the LP in an ``.mps``/``.sif`` file.  ``device=None`` reads
    ``RELP_TPU_TORCH_DEVICE`` (default ``"cuda"``)."""
    return solve_general_form(import_lp(path), config, device=device)
