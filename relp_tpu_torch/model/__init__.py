"""Problem representations: elements, GeneralForm, computational form, Solution.

Counterpart of the reference's ``src/data/linear_program/`` layer (SURVEY §2.3).
"""

from relp_tpu_torch.model.elements import (
    BoundDirection,
    ConstraintRelation,
    LinearProgramType,
    Objective,
    RangedConstraintRelation,
    VariableType,
)
from relp_tpu_torch.model.general_form import GeneralForm, Variable
from relp_tpu_torch.model.computational_form import ComputationalForm
from relp_tpu_torch.model.solution import Solution

__all__ = [
    "BoundDirection",
    "ComputationalForm",
    "ConstraintRelation",
    "GeneralForm",
    "LinearProgramType",
    "Objective",
    "RangedConstraintRelation",
    "Solution",
    "Variable",
    "VariableType",
]
