"""Solver configuration of the PyTorch port.

Field names and defaults are those of ``relp_tpu.utils.config.SolverConfig``
for every field this package honours, so a config reads the same in both
packages.  Fields that existed only for the TPU (``device_chunk_iters``,
``newton_refactor``, ``bucket_shapes``) are gone.  ``refactor_external_m``
stays with the JAX package's name and default, but not with its TPU meaning
(move the refactorization out of the loop): this package's primal loop always
refactorizes outside its step.  Here it is the size gate of the engine
routing, as it also is in the JAX driver: above it a dual solve, and a cold
primal one, runs the host sparse-LU dual first (``xl_engine``).  Every choice
field is validated: an unknown value is a ``ValueError``, ``mesh_cols`` must
be an int and ``refactor_external_m`` an int of at least 1.
"""

from __future__ import annotations

import dataclasses
import numbers

_CHOICES = {
    "algorithm": ("primal", "dual", "pdlp", "ipm"),
    "inverse": ("dense", "eta"),
    "refactor_mode": ("polish", "full"),
    "pricing": ("devex", "dantzig", "bland"),
    "matrix_format": ("auto", "dense", "ell", "hybrid"),
    "pdlp_variant": ("halpern", "avg"),
    "pdlp_scale": ("ruiz", "ruiz+pc"),
    "pdlp_precision": ("auto", "mixed", "f64"),
    "pdlp_matrix": ("auto", "ell", "bricks"),
    "dual_pricing": ("dse", "devex"),
    "dual_ratio": ("bisect", "sort"),
    "mip_branch": ("pseudo", "fractional"),
    "xl_engine": ("auto", "lu", "dense", "primal"),
    "ipm_ladder": ("auto", "mixed", "f64"),
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

    # basis inverse: "dense" (explicit B⁻¹, one in-place rank-1 update per
    # pivot) or "eta" (block product form: pivots compose into an
    # (m × eta_block) pending block, folded into B⁻¹ every eta_block pivots)
    inverse: str = "dense"
    eta_block: int = 16
    # "polish": one Newton-Schulz step on the maintained inverse, with an
    # LU rebuild when its residual check fails; "full": always the LU
    refactor_mode: str = "polish"
    # scan the column pool in f32, confirm the chosen column in f64
    mixed_pricing: bool = True
    # record one row of per-iteration metrics on the device (SolveOutput.
    # trace: phase, cB·xB, artificial mass, d_q, step, events, q, r), in
    # buffers of trace_capacity rows
    trace_iters: bool = False
    trace_capacity: int = 8192
    # every N iterations recompute the BFS invariants (row residual, basic
    # bound violation) and keep the worst; 0 = off
    check_every_n: int = 0
    # switch to Bland's rule after this many consecutive degenerate pivots
    bland_trigger: int = 100
    # partial pricing: scan one of price_blocks column blocks per iteration
    # (block-cyclic), the full pass when it offers no confirmed candidate;
    # needs mixed_pricing and n_pad divisible by it; 1 = full pricing
    price_blocks: int = 1
    pricing: str = "devex"
    # "auto" picks ELL for m_pad >= 1024 with short columns, else dense;
    # ELL with a few very long columns becomes "hybrid"
    matrix_format: str = "auto"
    # "primal": the two-phase primal simplex; "dual": the bounded-variable
    # dual simplex from the all-artificial basis (simplex/dual.py), which
    # falls back to the primal when it cannot certify optimality; "pdlp": the first-order
    # restarted-PDHG engine (fom/pdhg.py) — two sparse products and vector
    # work per iteration, no basis inverse; it converges to pdlp_tol relative
    # KKT and falls back to the primal when it cannot certify optimality;
    # "ipm": the Mehrotra predictor-corrector interior point
    # (simplex/primal_dual.py) over the dense scaled operator — one
    # normal-equation product A·D·Aᵀ and one Cholesky per iteration — with
    # the same crossover and fall back as "pdlp"
    algorithm: str = "primal"
    pdlp_tol: float = 1e-8
    pdlp_round: int = 256
    # when the best KKT has not improved by 10 % within pdlp_plateau
    # iterations (0 = never) the driver stops and accepts the best point iff
    # its KKT <= pdlp_accept, else tries the other variant, else falls back
    pdlp_accept: float = 1e-6
    pdlp_plateau: int = 32768
    # restart scheme: "halpern" (reflected Halpern iteration, restarts to
    # T(z)) or "avg" (running-average restarts)
    pdlp_variant: str = "halpern"
    # "ruiz": 10 ∞-norm Ruiz passes; "ruiz+pc" adds one Pock–Chambolle pass
    pdlp_scale: str = "ruiz+pc"
    # recover an exact vertex from the first-order point: dual-informed basis
    # guess, push of the superbasics on the host LU, warm primal re-solve
    pdlp_crossover: bool = True
    # iterate precision: "mixed" = f32 rounds with the f64 KKT of the point
    # checked after every call and an f64 endgame; "f64" = f64 throughout;
    # "auto" = f64 (on an H100 the f32 stage cost more iterations than it
    # saved on every LP measured; "mixed" stays an explicit choice)
    pdlp_precision: str = "auto"
    # most refinement zooms of the mixed-precision stage (0 = none)
    pdlp_refine: int = 4
    # fleets (solve_general_forms_batched): warm-start every scenario from one
    # base solve of the first — HiGHS on the host for the first-order fleet,
    # the single-solve driver for the simplex fleet on a shared A — whose wall
    # is inside the fleet's
    pdlp_fleet_warm: bool = True
    # interior point: iterate until the relative KKT (max of primal and dual
    # infeasibility and duality gap) reaches ipm_tol; on a stall accept the
    # best point iff it is <= ipm_accept, else fall back to the primal;
    # ipm_max_iter bounds the Mehrotra iterations (20-60 typical; 200 leaves
    # room for the one cold restart at the top rung)
    ipm_tol: float = 1e-8
    ipm_accept: float = 1e-6
    ipm_max_iter: int = 200
    # Cholesky precision ladder: "f64" factors in f64 from the start;
    # "mixed" starts on an f32 factor (a preconditioner under f64 iterative
    # refinement) and climbs to f64 when it stops contracting; "auto" = f64
    # on every device (the JAX package's "mixed" on an accelerator exists
    # because the TPU emulates f64)
    ipm_ladder: str = "auto"
    # device matrix of the first-order engine: "bricks" the grouped 8 × 128
    # brick operator (ops/bricks.py) in RCM order, its bricks compacted to
    # their nonzeros; "auto" and "ell" the operator matrix_format picks, on
    # every device: on an H100 the bricks at best tie ELL end to end (the
    # N = 4,096 max flow 1.02 s against ELL's 0.86-1.15 s, more set-up for
    # RCM, and more iterations at N = 1,024; PERF.md §6; the JAX package's
    # "auto" takes bricks on any accelerator, for the TPU's serial element
    # gathers)
    pdlp_matrix: str = "auto"
    # temporary-box magnitude of the dual start: a column with no finite
    # bound on the side sign(c_j) asks for gets ±dual_box there (the data is
    # equilibrated to O(1), so this is absolute in scaled space); a box that
    # binds at the optimum is no certificate and the primal solves instead
    dual_box: float = 1e7
    # dual row weights: "dse" keeps the exact steepest-edge norms
    # β_i = ‖B⁻¹[i,:]‖² (Forrest–Goldfarb: one more B⁻¹ matvec per pivot);
    # "devex" the reference-weight approximation from the FTRAN column alone;
    # a refactorization resets both to the exact norms
    dual_pricing: str = "dse"
    # bound-flipping ratio test: "sort" finds the blocking ratio by one
    # stable sort and a cumulative sum, "bisect" by 64 bisection steps of
    # masked O(n) reductions; the same pivot up to exact-ratio ties.  The JAX
    # package's default is "bisect" (sorts are slow on a TPU); on an H100 the
    # bisection is 512 dependent small launches of the 800 of an iteration
    # and "sort" takes half the wall per iteration (PERF.md), so it is the
    # default here
    dual_ratio: str = "sort"
    # the XL gate: a solve with m_pad > refactor_external_m is XL.  An XL
    # solve under algorithm="primal" (cold: no warm start, no perturb), or
    # whose first-order engine gave up, goes to the dual chain as under
    # algorithm="dual"; on a CUDA device a primal that is still unanswered
    # then tries the host LU dual from the slack basis (under perturb, from
    # the perturbed bounds' optimum) before the device primal.  The device
    # engines' dense B⁻¹ grows as m_pad²: on an 80 GB H100 the primal's peak
    # was 12.0 GiB at m_pad 16,376 and passes the card near 42,000 (PERF.md)
    refactor_external_m: int = 12288
    # XL engine: "auto" the host sparse-LU dual (simplex/lu_host.py) above the
    # gate, then the device dual if it cannot certify, and the device dual
    # below it; "lu" the host LU dual at any size, and no device dual after it;
    # "dense" the device dual at any size; "primal" as "dense" for the dual
    # chain, and no host-LU attempt before the primal (the JAX package's
    # externally refactorized primal is this package's only primal loop)
    xl_engine: str = "auto"
    # branch-and-bound variable selection: "pseudo" = pseudo-cost product
    # rule learned from every solved child; "fractional" = most fractional
    mip_branch: str = "pseudo"
    # anti-degeneracy: expand finite non-fixed bounds by [0.5, 1]·perturb·
    # (1+|bound|) (seeded), solve, then re-solve with the true bounds from
    # the perturbed optimum; 0 = off
    perturb: float = 0.0
    # shard the column pool of a single primal or first-order solve over this
    # many devices along the mesh's 'cols' axis (parallel/sharded.py); the
    # devices are the solve's ``devices`` list (default: every visible device
    # of its kind).  0 and 1 mean one device, k > 1 means k devices, k < 0
    # every device of the list.  The JAX package reads 0 in two ways: its
    # driver as one device (relp_tpu/simplex/driver.py:243, 913), its
    # ``maybe_shard`` as every device (relp_tpu/parallel/sharded.py:86); the
    # driver never hands 0 to ``maybe_shard``, and this package takes the
    # driver's reading.  A count that does not divide the padded column count,
    # or more devices than the list holds, logs a warning and solves on one
    # device.  The dual and the interior point ignore it.
    mesh_cols: int = 1

    scale: bool = True
    presolve: bool = True
    # slack crash basis (reference PartialInitialBasis)
    crash_basis: bool = False
    # pad row/column counts up to multiples of these
    row_align: int = 8
    col_align: int = 128

    def __post_init__(self):
        if not isinstance(self.mesh_cols, numbers.Integral) or isinstance(self.mesh_cols, bool):
            raise ValueError(f"SolverConfig.mesh_cols must be an int, got {self.mesh_cols!r}")
        m = self.refactor_external_m
        if not isinstance(m, numbers.Integral) or isinstance(m, bool) or m < 1:
            raise ValueError(
                f"SolverConfig.refactor_external_m must be an int >= 1, got {m!r}")
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
