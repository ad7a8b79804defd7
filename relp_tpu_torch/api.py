"""Top-level convenience API: ``solve(path)`` runs the whole pipeline —
import → GeneralForm → presolve → computational form → the engine
``config.algorithm`` names (primal or dual simplex, the first-order engine or
the interior point) on the device → named solution; ``ranging_of(result)``
ranges its optimal basis.  Mixed-integer programs go through
``relp_tpu_torch.models.branch_bound.solve_mip``."""

from __future__ import annotations

import os
from typing import Union

from relp_tpu_torch.io import import_lp
from relp_tpu_torch.simplex.driver import GeneralFormResult, solve_general_form
from relp_tpu_torch.utils.config import DEFAULT_CONFIG, SolverConfig
from relp_tpu_torch.utils.device import DeviceLike


def solve(path: Union[str, os.PathLike], config: SolverConfig = DEFAULT_CONFIG,
          device: DeviceLike = None, devices=None) -> GeneralFormResult:
    """Solve the LP in an ``.mps``/``.sif`` file.  ``device=None`` reads
    ``RELP_TPU_TORCH_DEVICE`` (default ``"cuda"``); ``devices`` is what
    ``config.mesh_cols`` shards over (default: every visible device of that
    kind)."""
    return solve_general_form(import_lp(path), config, device=device, devices=devices)


def ranging_of(result: GeneralFormResult):
    """Sensitivity ranging for a finished :func:`solve` result.

    Returns :class:`relp_tpu_torch.analysis.RangingResult` (cost and rhs
    intervals over which the optimal basis stays valid, with reduced costs
    and dual slopes).  Raises ValueError when the result carries no vertex
    basis (presolved away, non-optimal, or a first-order or interior-point
    solve without crossover).

    Like the CLI, ranging is relative to the PRESOLVED model the device
    solved: presolve may have substituted fixed variables into b and
    tightened bounds, so rhs values and ranges can differ from the original
    file.  Solve with ``SolverConfig(presolve=False)`` to range the model
    exactly as written.
    """
    from relp_tpu_torch.analysis import ranging

    if result.cf is None or result.simplex is None:
        raise ValueError("result carries no device solve to range over")
    return ranging(result.cf, result.simplex, row_names=result.row_names)
