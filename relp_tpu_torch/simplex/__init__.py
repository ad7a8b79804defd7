"""The bounded-variable revised simplex: primal and dual engines and their host driver."""

from relp_tpu_torch.simplex.driver import (
    GeneralFormResult,
    SimplexResult,
    solve_computational_form,
    solve_general_form,
)

__all__ = [
    "GeneralFormResult",
    "SimplexResult",
    "solve_computational_form",
    "solve_general_form",
]
