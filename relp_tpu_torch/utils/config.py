"""Solver configuration of the PyTorch port.

Field names and defaults are those of ``relp_tpu.utils.config.SolverConfig``
for every field this package honours, so a config reads the same in both
packages.  Fields that existed only for the TPU (``device_chunk_iters``,
``refactor_external_m``, ``newton_refactor``, ``bucket_shapes``) are gone;
fields of engines not yet ported raise ``NotImplementedError`` when set to
anything but their default, naming the ROADMAP.md entry that will port them.
"""

from __future__ import annotations

import dataclasses

# field -> (default, ROADMAP.md entry that ports the engine behind it)
_UNPORTED = {
    "algorithm": ("primal", "queue 1, dual simplex / IPM / PDLP"),
    "inverse": ("dense", "queue 1, eta (block product-form) inverse"),
    "price_blocks": (1, "queue 1, partial pricing"),
    "trace_iters": (False, "queue 1, per-iteration trace"),
    "check_every_n": (0, "queue 1, in-loop invariant check"),
    "perturb": (0.0, "queue 1, anti-degeneracy perturbation"),
    "mesh_cols": (1, "queue 1, multi-device"),
}

_CHOICES = {
    "refactor_mode": ("polish", "full"),
    "pricing": ("devex", "dantzig", "bland"),
    "matrix_format": ("auto", "dense", "ell", "hybrid"),
}


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Tolerances and policies for the float64 bounded-variable revised
    simplex (the meaning of each field is documented on the JAX package's
    ``SolverConfig``)."""

    # ``max_iter <= 0``: choose ``max_iter_factor * (m + n)`` at solve time
    max_iter: int = 0
    max_iter_factor: int = 40
    # rebuild the basis inverse from the basis columns every this many pivots
    refactor_period: int = 64

    eps_dual: float = 1e-7
    eps_pivot: float = 1e-7
    eps_ratio: float = 1e-9
    harris_delta: float = 1e-8
    eps_feas: float = 1e-7
    eps_zero: float = 1e-11
    # a refactorization pivot below this marks the basis singular -> repair
    singular_tol: float = 1e-9

    inverse: str = "dense"
    # "polish": one Newton-Schulz step on the maintained inverse, with an
    # LU rebuild when its residual check fails; "full": always the LU
    refactor_mode: str = "polish"
    # scan the column pool in f32, confirm the chosen column in f64
    mixed_pricing: bool = True
    trace_iters: bool = False
    check_every_n: int = 0
    # switch to Bland's rule after this many consecutive degenerate pivots
    bland_trigger: int = 100
    price_blocks: int = 1
    pricing: str = "devex"
    # "auto" picks ELL for m_pad >= 1024 with short columns, else dense;
    # ELL with a few very long columns becomes "hybrid"
    matrix_format: str = "auto"
    algorithm: str = "primal"
    perturb: float = 0.0
    mesh_cols: int = 1

    scale: bool = True
    presolve: bool = True
    # slack crash basis (reference PartialInitialBasis)
    crash_basis: bool = False
    # pad row/column counts up to multiples of these
    row_align: int = 8
    col_align: int = 128

    def __post_init__(self):
        for name, (default, entry) in _UNPORTED.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"SolverConfig.{name}={getattr(self, name)!r} is not ported "
                    f"to relp_tpu_torch yet (ROADMAP.md {entry})"
                )
        for name, allowed in _CHOICES.items():
            if getattr(self, name) not in allowed:
                raise ValueError(
                    f"SolverConfig.{name} must be one of {allowed}, "
                    f"got {getattr(self, name)!r}"
                )

    def resolve_max_iter(self, m: int, n: int) -> int:
        if self.max_iter > 0:
            return self.max_iter
        return max(1000, self.max_iter_factor * (m + n))


DEFAULT_CONFIG = SolverConfig()
