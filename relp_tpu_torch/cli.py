"""Command-line interface:  python -m relp_tpu_torch <problem_file>

import → GeneralForm → presolve → solve on the device → print the solution,
as ``python -m relp_tpu`` does, with its primal flags (``--basis-in`` warm
starts, ``--write-mps`` export, ``--perturb``, ``--inverse``), its dual ones
(``--algorithm dual``, ``--dual-pricing``, ``--xl-engine``), branch-and-bound
(``--mip``, ``--mip-cuts``, ``--mip-branch``) and its first-order ones
(``--algorithm pdlp``, ``--no-crossover``, ``--pdlp-*``), the interior point
(``--algorithm ipm``, ``--ipm-*``), sensitivity ranging (``--ranging``) and the
exact check and optimality certificate (``--verify``, exit code 3 when either
fails), and the column-sharded solve (``--mesh-cols N`` over N of the visible
devices, -1 = all).  The device comes from ``RELP_TPU_TORCH_DEVICE`` (default
``cuda``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from relp_tpu_torch.io.errors import ImportError_
from relp_tpu_torch.model.elements import LinearProgramType
from relp_tpu_torch.utils.config import SolverConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="relp_tpu_torch",
        description="linear program solver on PyTorch/CUDA (two-phase primal "
        "revised simplex, dual simplex, branch-and-bound, first-order "
        "restarted PDHG or a primal-dual interior point, with crossover); the "
        "device comes from RELP_TPU_TORCH_DEVICE (default cuda)",
    )
    ap.add_argument("problem_file", help="path to a .mps (free) or .sif (fixed) file")
    ap.add_argument("--max-iter", type=int, default=0, help="iteration cap (0 = auto)")
    ap.add_argument("--no-scale", action="store_true", help="disable equilibration scaling")
    ap.add_argument("--no-presolve", action="store_true", help="disable presolving")
    ap.add_argument("--pricing", choices=["devex", "dantzig", "bland"], default="devex")
    ap.add_argument("--refactor", type=int, default=64, help="refactorization period")
    ap.add_argument("-q", "--quiet", action="store_true", help="objective only")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument(
        "--verify", action="store_true",
        help="certify the solution with the exact (rational) verifier",
    )
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
    ap.add_argument(
        "--algorithm", choices=["primal", "dual", "pdlp", "ipm"], default="primal",
        help="main solve algorithm (dual = dual simplex from scratch; "
        "pdlp = first-order restarted PDHG, the scale path; ipm = "
        "Mehrotra predictor-corrector interior point, one normal-equation "
        "product and Cholesky per iteration)",
    )
    ap.add_argument(
        "--no-crossover", action="store_true",
        help="with --algorithm pdlp/ipm: return the first-order or interior "
        "point as it is instead of recovering an exact simplex vertex from it",
    )
    ap.add_argument(
        "--pdlp-matrix", choices=["auto", "ell", "bricks"], default="auto",
        help="PDHG device matrix (auto, ell = the operator --matrix-format picks; "
        "bricks = the 8x128 brick operator in RCM order)",
    )
    ap.add_argument(
        "--pdlp-variant", choices=["halpern", "avg"], default="halpern",
        help="PDHG restart scheme (halpern = reflected Halpern iteration; "
        "avg = classic PDLP average restarts)",
    )
    ap.add_argument(
        "--pdlp-precision", choices=["auto", "mixed", "f64"], default="auto",
        help="PDHG iterate precision (mixed = f32 rounds + f64 KKT checks + f64 "
        "endgame; auto = f64)",
    )
    ap.add_argument(
        "--pdlp-refine", type=int, default=4,
        help="max iterative-refinement zooms of the mixed-precision PDHG path "
        "(0 disables: the f64 endgame takes over)",
    )
    ap.add_argument(
        "--pdlp-accept", type=float, default=1e-6, metavar="KKT",
        help="with --algorithm pdlp: accept a plateaued point whose best "
        "relative KKT is below this",
    )
    ap.add_argument(
        "--ipm-tol", type=float, default=1e-8, metavar="KKT",
        help="with --algorithm ipm: target relative KKT "
        "(max of primal/dual infeasibility and duality gap)",
    )
    ap.add_argument(
        "--ipm-accept", type=float, default=1e-6, metavar="KKT",
        help="with --algorithm ipm: accept a stalled point whose best "
        "relative KKT is below this; otherwise fall back to simplex",
    )
    ap.add_argument(
        "--ipm-max-iter", type=int, default=200, metavar="N",
        help="with --algorithm ipm: Mehrotra iteration budget "
        "(each is one normal-equation product + Cholesky)",
    )
    ap.add_argument(
        "--ipm-ladder", choices=["auto", "mixed", "f64"], default="auto",
        help="with --algorithm ipm: Cholesky precision ladder — f64, or "
        "mixed (an f32 factor first, f64 when it stops contracting); auto = f64",
    )
    ap.add_argument(
        "--mesh-cols", type=int, default=1, metavar="N",
        help="shard the column pool over N devices (-1 = all visible)",
    )
    ap.add_argument(
        "--mip", action="store_true",
        help="branch-and-bound on INTEGER (INTORG-marked) variables",
    )
    ap.add_argument(
        "--mip-cuts", type=int, default=4, metavar="N",
        help="with --mip: rounds of root-node Gomory mixed-integer cuts "
        "(0 = plain branch-and-bound)",
    )
    ap.add_argument(
        "--mip-branch", choices=["pseudo", "fractional"], default="pseudo",
        help="with --mip: branching variable selection (pseudo-cost "
        "product rule, learned online; or most-fractional)",
    )
    ap.add_argument(
        "--xl-engine", choices=["auto", "lu", "dense", "primal"], default="auto",
        help="XL-scale engine (XL: padded rows above SolverConfig."
        "refactor_external_m, 12,288): 'lu' forces the host sparse-LU dual "
        "simplex at any size; 'auto' uses it above the XL row threshold, where "
        "a cold primal solve also goes to the dual first; 'dense' runs the "
        "device dual; 'primal' stays on the device engines at any size (no "
        "host-LU routing)",
    )
    ap.add_argument(
        "--dual-pricing", choices=["dse", "devex"], default="dse",
        help="dual row weights (devex skips the per-pivot B⁻¹ matvec)",
    )
    ap.add_argument(
        "--ranging", action="store_true",
        help="post-optimal sensitivity ranging (cost and rhs intervals over "
        "which the optimal basis stays valid).  Ranging is relative to the "
        "PRESOLVED model: presolve can substitute fixed variables into b and "
        "tighten bounds, so printed rhs values/ranges may differ from the "
        "file — combine with --no-presolve to range the model exactly as written",
    )
    args = ap.parse_args(argv)

    config = SolverConfig(
        max_iter=args.max_iter,
        scale=not args.no_scale,
        presolve=not args.no_presolve,
        pricing=args.pricing,
        refactor_period=args.refactor,
        matrix_format=args.matrix_format,
        inverse=args.inverse,
        perturb=args.perturb,
        algorithm=args.algorithm,
        dual_pricing=args.dual_pricing,
        mip_branch=args.mip_branch,
        xl_engine=args.xl_engine,
        pdlp_crossover=not args.no_crossover,
        pdlp_matrix=args.pdlp_matrix,
        pdlp_variant=args.pdlp_variant,
        pdlp_precision=args.pdlp_precision,
        pdlp_refine=args.pdlp_refine,
        pdlp_accept=args.pdlp_accept,
        ipm_tol=args.ipm_tol,
        ipm_accept=args.ipm_accept,
        ipm_max_iter=args.ipm_max_iter,
        ipm_ladder=args.ipm_ladder,
        mesh_cols=args.mesh_cols,
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

        # ranging prints presolved-model quantities; the original shape tells
        # whether presolve (which mutates `general` in place) changed it
        pre_shape = (len(general.row_names), len(general.variables))

        if args.mip:
            from relp_tpu_torch.model.solution import Solution
            from relp_tpu_torch.models.branch_bound import solve_mip

            mip = solve_mip(general, config, cut_rounds=args.mip_cuts)

            class _R:  # adapt MipResult to the GeneralFormResult surface
                kind = mip.kind
                solution = (
                    Solution(objective_value=mip.objective,
                             solution_values=sorted(mip.values.items()))
                    if mip.values is not None else None
                )
                simplex = None
                mip_info = {"nodes": mip.nodes, "lp_iterations": mip.lp_iterations,
                            "best_bound": mip.best_bound}

            res = _R()
        else:
            res = solve_general_form(general, config, initial_basis=initial_basis)
    except (OSError, ImportError_) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    dt = time.perf_counter() - t0

    rng = None
    if (args.ranging and res.kind is LinearProgramType.FINITE_OPTIMUM
            and getattr(res, "cf", None) is not None and res.simplex is not None
            and res.simplex.basis is not None):
        from relp_tpu_torch.analysis import ranging as _ranging

        if config.presolve and pre_shape != (len(general.row_names), len(general.variables)):
            print(
                "ranging note: presolve modified the problem "
                f"({pre_shape[0]}x{pre_shape[1]} -> "
                f"{len(general.row_names)}x{len(general.variables)}); "
                "ranges are relative to the presolved model — rerun with "
                "--no-presolve to range the model as written",
                file=sys.stderr,
            )
        try:
            rng = _ranging(res.cf, res.simplex, row_names=general.row_names)
        except ValueError as e:
            print(f"ranging unavailable: {e}", file=sys.stderr)
    elif args.ranging:
        print("ranging unavailable: no simplex basis (presolved away, non-optimal, "
              "or first-order or interior-point solve without crossover)", file=sys.stderr)

    if args.json:
        payload = {"status": res.kind.value, "wall_s": round(dt, 4)}
        if res.solution is not None:
            payload["objective"] = res.solution.objective_value
            if not args.quiet:
                payload["values"] = dict(res.solution.solution_values)
        if res.simplex is not None:
            payload["iterations"] = res.simplex.iterations
        if getattr(res, "mip_info", None):
            payload.update(res.mip_info)
        if rng is not None:
            def fin(v):
                return v if abs(v) != float("inf") else None

            payload["ranging"] = {
                "cost": {
                    r.name: {"value": r.value, "cost": r.cost, "lo": fin(r.lo),
                             "hi": fin(r.hi), "reduced_cost": r.reduced_cost,
                             "basic": r.basic, "computed": r.computed}
                    for r in rng.cost
                },
                "rhs": {
                    r.name: {"rhs": r.rhs, "lo": fin(r.lo), "hi": fin(r.hi), "dual": r.dual}
                    for r in rng.rhs
                },
            }
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
        if rng is not None:
            print("cost ranging (name: value  cost in [lo, hi]  rc):")
            for r in rng.cost:
                print(f"  {r.name}: {r.value:.6g}  {r.cost:.6g} in "
                      f"[{r.lo:.6g}, {r.hi:.6g}]  rc={r.reduced_cost:.6g}"
                      f"{'  (basic)' if r.basic else ''}"
                      f"{'' if r.computed else '  (range not computed)'}")
            print("rhs ranging (row: rhs in [lo, hi]  dual):")
            for r in rng.rhs:
                print(f"  {r.name}: {r.rhs:.6g} in [{r.lo:.6g}, {r.hi:.6g}]  "
                      f"dual={r.dual:.6g}")
        if args.verify:
            return _verify(args.problem_file, sol, res)
        return 0
    print(f"result: {res.kind.value}")
    return 1


def _verify(problem_file, sol, res) -> int:
    """``--verify``: the exact check of the solution against the file, then
    the exact optimality certificate of the vertex basis, finished by exact
    pivots over ℚ where the float basis is out of exact optimality by
    rounding-level amounts.  3 when either fails, else 0."""
    from relp_tpu_torch.numerics.exact import ExactVerifier, polish_to_certified

    check = ExactVerifier(problem_file).check(sol.as_dict())
    ok = check.ok(tol=1e-6)
    print(f"exact check: {'OK' if ok else 'VIOLATED'}  "
          f"obj {float(check.objective):.12g}  "
          f"row_viol {float(check.max_row_violation):.3g}  "
          f"bound_viol {float(check.max_bound_violation):.3g}", file=sys.stderr)
    if getattr(res, "cf", None) is not None and res.simplex is not None \
            and res.simplex.basis is not None:
        try:
            cert, piv = polish_to_certified(res.cf, res.simplex)
        except ValueError as e:
            print(f"optimality certificate skipped: {e}", file=sys.stderr)
        else:
            extra = f"  exact_pivots {piv}" if piv else ""
            if cert.redundant_rows:
                extra += (f"  redundant_rows {cert.redundant_rows} (max residual "
                          f"{float(cert.max_redundant_residual):.3g})")
            print("exact optimality certificate: "
                  f"{'OPTIMAL' if cert.ok() else 'NOT CERTIFIED'}  "
                  f"primal_viol {float(cert.max_primal_violation):.3g}  "
                  f"dual_viol {float(cert.max_dual_violation):.3g}{extra}", file=sys.stderr)
            if not cert.ok():
                return 3
    return 0 if ok else 3


if __name__ == "__main__":
    raise SystemExit(main())
