"""relp_tpu_torch — the relp_tpu linear programming solver on PyTorch/CUDA.

A port of the JAX package ``relp_tpu`` (which stays the reference) to
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.  It runs the
primal path with the JAX package's primal options: MPS file → GeneralForm →
presolve → computational form → two-phase bounded-variable revised simplex
(dense, ELL or hybrid operator; dense or eta inverse) → named Solution; the
dual simplex (``algorithm="dual"``) with bound reoptimization and branch and
bound on it; the first-order engine (``algorithm="pdlp"``); the interior
point (``algorithm="ipm"``); and fleets of LPs at once
(``simplex.driver.solve_general_forms_batched``, ``parallel.solve_batched``,
``fom.solve_pdhg_batched``).
``python -m relp_tpu_torch.probe`` checks a machine's CUDA toolchain.

The device is explicit: ``api.solve(path, config, device=None)`` with
``None`` meaning the ``RELP_TPU_TORCH_DEVICE`` environment variable
(default ``"cuda"``); asking for CUDA without a usable GPU raises.

Layout (module names mirror the JAX package's):
    model/      problem representations (GeneralForm, elements, Solution)
    io/         MPS parsing, conversion and writing
    presolve/   presolving rules + postsolve reconstruction
    models/     LP model families (network flows, the dense LP), branch and bound
    providers/  per-variable feasibility logic
    simplex/    the primal (core, also lane-batched), dual and interior-point
                engines, reoptimization, the host LU engines, state checker
                and checkpoint, and the host driver (one LP, or a fleet:
                solve_general_forms_batched)
    fom/        the first-order (restarted PDHG) engine, one LP or a fleet
    parallel/   scenario-batched solves (solve_batched: the lane-batched primal)
    ops/        constraint-matrix operators (one LP's and a fleet's lanes), CUDA
                kernels, linear algebra
    csrc/       CUDA C++ sources of the kernels (built at first use)
    utils/      config, device selection, metrics
"""

import torch

# Pricing with a dense operator is an f32 matrix product; keep it full f32
# on the card (TF32 would keep about three decimal digits).
torch.backends.cuda.matmul.allow_tf32 = False

from relp_tpu_torch.model.elements import (  # noqa: E402
    ConstraintRelation,
    LinearProgramType,
    Objective,
    RangedConstraintRelation,
    VariableType,
)
from relp_tpu_torch.model.solution import Solution  # noqa: E402
from relp_tpu_torch.utils.config import SolverConfig  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "ConstraintRelation",
    "LinearProgramType",
    "Objective",
    "RangedConstraintRelation",
    "Solution",
    "SolverConfig",
    "VariableType",
    "__version__",
]
