"""Command-line interface:  python -m relp_tpu_torch <problem_file>

import → GeneralForm → presolve → primal simplex on the device → print the
solution, as ``python -m relp_tpu`` does, with its primal flags
(``--basis-in`` warm starts, ``--write-mps`` export, ``--perturb``,
``--inverse``).  The device comes from ``RELP_TPU_TORCH_DEVICE`` (default
``cuda``).  Flags of the JAX package's CLI whose engines are not ported yet
exit with a message saying so.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from relp_tpu_torch.io.errors import ImportError_
from relp_tpu_torch.model.elements import LinearProgramType
from relp_tpu_torch.utils.config import SolverConfig

# flags of `python -m relp_tpu` that this package does not carry yet
NOT_PORTED = {
    "--verify", "--algorithm", "--no-crossover",
    "--pdlp-matrix", "--pdlp-variant", "--pdlp-precision", "--pdlp-refine",
    "--pdlp-accept", "--ipm-tol", "--ipm-accept", "--ipm-max-iter",
    "--ipm-ladder", "--mip", "--mip-cuts", "--mip-branch",
    "--mesh-cols", "--xl-engine", "--dual-pricing", "--ranging",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="relp_tpu_torch",
        description="linear program solver on PyTorch/CUDA (two-phase primal "
        "revised simplex); the device comes from RELP_TPU_TORCH_DEVICE "
        "(default cuda)",
    )
    ap.add_argument("problem_file", help="path to a .mps (free) or .sif (fixed) file")
    ap.add_argument("--max-iter", type=int, default=0, help="iteration cap (0 = auto)")
    ap.add_argument("--no-scale", action="store_true", help="disable equilibration scaling")
    ap.add_argument("--no-presolve", action="store_true", help="disable presolving")
    ap.add_argument("--pricing", choices=["devex", "dantzig", "bland"], default="devex")
    ap.add_argument("--refactor", type=int, default=64, help="refactorization period")
    ap.add_argument("-q", "--quiet", action="store_true", help="objective only")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument("--basis-in", metavar="FILE", help="warm start from an MPS basis file")
    ap.add_argument(
        "--write-mps", metavar="FILE", help="export the (presolved) problem and exit"
    )
    ap.add_argument(
        "--perturb", type=float, default=0.0, metavar="EPS",
        help="anti-degeneracy bound perturbation (e.g. 1e-7; 0 = off)",
    )
    ap.add_argument(
        "--matrix-format", choices=["auto", "dense", "ell", "hybrid"],
        default="auto", help="device layout of A (auto picks by size/sparsity)",
    )
    ap.add_argument(
        "--inverse", choices=["dense", "eta"], default="dense",
        help="basis-inverse backend (eta = block product-form, large m)",
    )
    args, extra = ap.parse_known_args(argv)
    for token in extra:
        flag = token.split("=", 1)[0]
        if flag in NOT_PORTED:
            ap.exit(2, f"relp_tpu_torch: {flag} is not ported yet (see "
                       "ROADMAP.md, queue 1); use python -m relp_tpu for it\n")
    if extra:
        ap.error(f"unrecognized arguments: {' '.join(extra)}")

    config = SolverConfig(
        max_iter=args.max_iter,
        scale=not args.no_scale,
        presolve=not args.no_presolve,
        pricing=args.pricing,
        refactor_period=args.refactor,
        matrix_format=args.matrix_format,
        inverse=args.inverse,
        perturb=args.perturb,
    )

    t0 = time.perf_counter()
    try:
        from relp_tpu_torch.io import import_lp

        general = import_lp(args.problem_file)
        if args.write_mps:
            if config.presolve:
                from relp_tpu_torch.presolve.engine import presolve

                presolve(general)
            from relp_tpu_torch.io.mps_write import export_mps

            export_mps(general, args.write_mps)
            print(f"wrote {args.write_mps}", file=sys.stderr)
            return 0

        initial_basis = None
        if args.basis_in:
            from relp_tpu_torch.io.basis_file import import_basis

            initial_basis = import_basis(args.basis_in)

        from relp_tpu_torch.simplex.driver import solve_general_form

        res = solve_general_form(general, config, initial_basis=initial_basis)
    except (OSError, ImportError_) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    dt = time.perf_counter() - t0

    if args.json:
        payload = {"status": res.kind.value, "wall_s": round(dt, 4)}
        if res.solution is not None:
            payload["objective"] = res.solution.objective_value
            if not args.quiet:
                payload["values"] = dict(res.solution.solution_values)
        if res.simplex is not None:
            payload["iterations"] = res.simplex.iterations
        print(json.dumps(payload))
        return 0 if res.kind is LinearProgramType.FINITE_OPTIMUM else 1

    if res.kind is LinearProgramType.FINITE_OPTIMUM:
        sol = res.solution
        print(f"objective {sol.objective_value:.12g}")
        if not args.quiet:
            for name, value in sol.solution_values:
                print(f"  {name} = {value:.12g}")
        if res.simplex is not None:
            print(
                f"iterations {res.simplex.iterations}  wall_s {dt:.3f}  "
                f"iters/s {res.simplex.iterations / max(dt, 1e-9):.1f}",
                file=sys.stderr,
            )
        return 0
    print(f"result: {res.kind.value}")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
