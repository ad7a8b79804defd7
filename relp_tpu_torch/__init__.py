"""relp_tpu_torch — the relp_tpu linear programming solver on PyTorch/CUDA.

A port of the JAX package ``relp_tpu`` (which stays the reference) to
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.  It runs the
primal path with the JAX package's primal options: MPS file → GeneralForm →
presolve → computational form → two-phase bounded-variable revised simplex
(dense, ELL or hybrid operator; dense or eta inverse) → named Solution.
``python -m relp_tpu_torch.probe`` checks a machine's CUDA toolchain.

The device is explicit: ``api.solve(path, config, device=None)`` with
``None`` meaning the ``RELP_TPU_TORCH_DEVICE`` environment variable
(default ``"cuda"``); asking for CUDA without a usable GPU raises.

Layout (module names mirror the JAX package's):
    model/      problem representations (GeneralForm, elements, Solution)
    io/         MPS parsing, conversion and writing
    presolve/   presolving rules + postsolve reconstruction
    models/     LP model families (network flows, the dense LP)
    simplex/    the primal engine (core) and its host driver
    ops/        constraint-matrix operators, CUDA kernels, linear algebra
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
