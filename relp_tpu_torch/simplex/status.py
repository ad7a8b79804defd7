"""Integer status codes used inside the jitted solver state."""

from __future__ import annotations

from relp_tpu_torch.model.elements import LinearProgramType

# Solve status
RUNNING = 0
OPTIMAL = 1
INFEASIBLE = 2
UNBOUNDED = 3
ITERATION_LIMIT = 4
NUMERICAL = 5

STATUS_TO_TYPE = {
    OPTIMAL: LinearProgramType.FINITE_OPTIMUM,
    INFEASIBLE: LinearProgramType.INFEASIBLE,
    UNBOUNDED: LinearProgramType.UNBOUNDED,
    ITERATION_LIMIT: LinearProgramType.ITERATION_LIMIT,
    NUMERICAL: LinearProgramType.NUMERICAL_ERROR,
}

# Variable status (vstat); the TPU analogue of "is this column in the basis"
# plus at-which-bound bookkeeping for the bounded-variable simplex.
NB_LOWER = 0   # nonbasic at (finite) lower bound
NB_UPPER = 1   # nonbasic at (finite) upper bound
BASIC = 2
NB_FREE = 3    # nonbasic free variable, held at 0
NB_FIXED = 4   # lb == ub; never enters
