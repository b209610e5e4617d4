"""slam_plus_plus-compatible CLI (counterpart of ``slampp_tpu/apps/main.py``).

Capability parity with the reference application (src/slam_app/Main.cpp:42,
flag surface PrintHelp :593-667, generic driver CTester::Run_and_Shout
Main.h:1335): auto-detects the problem type by peeking the dataset
(TDatasetPeeker analog), selects the solver (auto-upgrading lambda -> LM for
BA, Main.cpp:203-207), supports batch and every-N incremental modes,
marginals, solution/timing output.  The flags, defaults, routes and printed
lines are the JAX package's, except ``--platform``: ``--device`` names where
the solvers run, the card by default (an error without one) or ``cpu``.

Usage:
    python -m slampp_tpu_torch.apps.main -i dataset.g2o [--device cpu] [options]

It writes ``solution.txt`` (``-s``), ``marginals.txt`` (``-dm``),
``system.mtx`` and ``system_matrix.png`` (``-dsm``) into the working
directory, as the reference does.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

# LM on mono BA (edge_p2c only) takes the observation-driven Schur engine
# from this many observations on (the JAX package's SLAMPP_BIGBA_THRESHOLD
# default; the port reads no environment variable)
BIGBA_THRESHOLD = 20000

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_arg_parser():
    p = argparse.ArgumentParser(
        prog="slam_plus_plus",
        description="sparse nonlinear least squares on PyTorch / CUDA (SLAM++ capability parity)",
    )
    p.add_argument("-i", "--input", help="input dataset (g2o/TORO/SLAM++)")
    p.add_argument("-rmut", "--run-matrix-unit-tests", action="store_true",
                   help="run the random block-matrix unit tests and exit "
                        "(reference BlockUnit.cpp; tests/test_torch_block_unit.py)")
    p.add_argument("-rmb", "--run-matrix-benchmarks", action="store_true",
                   help="check and time the CUDA kernels on the card and exit "
                        "(reference BlockBench.h; chip_smoke.py --kernels, writes "
                        "kernel_bench.csv)")
    p.add_argument(
        "-nls",
        "--nonlinear-solver",
        default="lambda",
        choices=["lambda", "lambda-lm", "lambda-dl", "A", "L", "fastL", "spcg"],
        help="nonlinear solver (spcg = spanning-tree-preconditioned CG, "
        "NonlinearSolver_SPCG.h)",
    )
    p.add_argument("-po", "--pose-only", action="store_true", help="pose-only mode")
    p.add_argument("-us", "--use-schur", action="store_true", help="Schur complement solve")
    p.add_argument("-dm", "--do-marginals", action="store_true", help="marginal covariances")
    p.add_argument("-dsm", "--dump-system-matrix", action="store_true",
                   help="write the system matrix as system.mtx (MatrixMarket)"
                        " and a sparsity raster system_matrix.png")
    p.add_argument("-mnsi", "--max-nonlinear-solve-iters", type=int, default=5)
    p.add_argument("-nset", "--nonlinear-solve-error-thresh", type=float, default=0.01)
    p.add_argument("-mfnsi", "--max-final-nonlinear-solve-iters", type=int, default=None)
    p.add_argument("-fnset", "--final-nonlinear-solve-error-thresh", type=float, default=None)
    p.add_argument(
        "-nsp", "--nonlinear-solve-period", type=int, default=0,
        help="incremental: nonlinear solve every N vertices (0 = batch)",
    )
    p.add_argument("-lsp", "--linear-solve-period", type=int, default=0)
    p.add_argument("-s", "--solution", default="solution.txt", help="solution output file")
    p.add_argument("-ns", "--no-solution", action="store_true")
    p.add_argument("-nb", "--no-bitmaps", action="store_true", help="skip plot output")
    p.add_argument("-p", "--plot", default=None,
                   help="write trajectory plot to this file (needs matplotlib)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--no-detailed-timing", action="store_true")
    p.add_argument("--robust", default=None, choices=[None, "huber", "cauchy", "tukey", "fair", "welsch", "logistic", "hampel"])
    p.add_argument("--json", action="store_true", help="print a JSON result line")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the solvers run: the CUDA card (default; an error "
                        "without one) or the CPU")
    return p


def _build_solver(args, records, problem, device):
    """(system, solver, incremental solves or markers while streaming, route
    name) as the JAX CLI routes them (slampp_tpu/apps/main.py:118-229)."""
    from slampp_tpu_torch.graph.system import GraphSystem
    from slampp_tpu_torch.io.parser import build_system
    from slampp_tpu_torch.solvers import (
        DoglegSolver,
        GaussNewtonSolver,
        IncrementalSolver,
        LevenbergMarquardtSolver,
    )

    is_ba = problem.startswith("ba")
    solver_kind = args.nonlinear_solver
    if solver_kind in ("lambda", "A", "L", "fastL", "spcg") and is_ba:
        # the reference auto-upgrades lambda to LM for BA (Main.cpp:203-207)
        solver_kind = "lambda-lm"
    use_schur = args.use_schur or is_ba

    if is_ba and args.nonlinear_solve_period > 0:
        # incremental BA: optimize at CONSISTENCY_MARKER records (the
        # reference's CParseLoop_ConsistencyMarker path, Main.h:1066-1074;
        # markers delimit states where no vertices are orphaned)
        system = GraphSystem()
        n_markers = 0

        def on_marker(s):
            nonlocal n_markers
            n_markers += 1
            lm = LevenbergMarquardtSolver(s, use_schur=True, pad=True, device=device)
            lm.optimize(args.max_nonlinear_solve_iters, args.nonlinear_solve_error_thresh)
            if args.verbose:
                print(f"marker #{n_markers}: chi2={lm.chi2():.2f}")

        build_system(records, problem=problem, system=system, on_marker=on_marker)
        solver = LevenbergMarquardtSolver(system, use_schur=True, verbose=args.verbose,
                                          device=device)
        return system, solver, n_markers, solver_kind
    if args.nonlinear_solve_period > 0:
        system = GraphSystem()
        if solver_kind in ("L", "fastL"):
            # FastL (the resident-system engine) for non-robust SE(2) / SE(3),
            # the windowed solver otherwise
            from slampp_tpu_torch.solvers import FastLSolver, WindowedIncrementalSolver

            inc_cls = WindowedIncrementalSolver
            if problem in ("se2", "se3") and not args.robust:
                inc_cls = FastLSolver
            inc = inc_cls(system, solve_period=args.nonlinear_solve_period,
                          max_iterations=args.max_nonlinear_solve_iters, verbose=args.verbose,
                          device=device)
        else:
            inc = IncrementalSolver(system, solve_period=args.nonlinear_solve_period,
                                    max_iterations=args.max_nonlinear_solve_iters,
                                    min_dx_norm=args.nonlinear_solve_error_thresh,
                                    verbose=args.verbose, device=device)
        build_system(records, problem=problem, system=system,
                     on_edge=lambda s, n: inc.incremental_step())
        return system, inc, inc.n_solves, solver_kind

    system = build_system(records, problem=problem)
    if args.robust:
        # swap edge types for their robust (IRLS-weighted) variants
        # (reference: CRobustify_ErrorNorm_Default, RobustUtils.h:60)
        from slampp_tpu_torch.models.robust import apply_robust_to_system

        apply_robust_to_system(system, loss=args.robust)
    if solver_kind == "lambda-lm":
        # mono BA at venice class goes through the observation-driven Schur
        # engine, never a dense Hessian (reference -us BA at any scale,
        # Main.cpp:203-207 -> LinearSolver_Schur.h:1623)
        engine = ("big_ba" if problem == "ba" and set(system.edge_type_names) == {"edge_p2c"}
                  and system.n_edges >= BIGBA_THRESHOLD else "dense")
        solver = LevenbergMarquardtSolver(system, use_schur=use_schur, verbose=args.verbose,
                                          engine=engine, device=device)
    elif solver_kind == "lambda-dl":
        solver = DoglegSolver(system, verbose=args.verbose, device=device)
    elif solver_kind == "spcg":
        # subgraph (spanning-tree) preconditioned CG (CNonlinearSolver_SPCG,
        # NonlinearSolver_SPCG.h:61)
        from slampp_tpu_torch.linear.spcg import SPCGSolver

        solver = SPCGSolver(system, verbose=args.verbose, device=device)
    elif solver_kind == "A":
        # normal equations from the exported Jacobian A (CNonlinearSolver_A,
        # NonlinearSolver_A.h:314)
        from slampp_tpu_torch.solvers.a_solver import ASolver

        solver = ASolver(system, verbose=args.verbose, device=device)
    else:
        solver = GaussNewtonSolver(system, use_schur=use_schur, verbose=args.verbose,
                                   device=device)
    return system, solver, 0, solver_kind


def _dump_system_matrix(system, device) -> None:
    """-dsm: system.mtx (MatrixMarket) and a sparsity raster (Main.h:126,
    1449-1493), assembled sparsely, never as a dense Hessian.  A raster that
    fails is skipped, as in the reference, with a line saying why."""
    from slampp_tpu_torch.core.bsm import BlockSparseMatrix
    from slampp_tpu_torch.core.sparse_dump import assemble_sparse_csr
    from slampp_tpu_torch.graph.types import get_vertex_type

    dims = {get_vertex_type(t).dim for t, _ in system.vertex_index.values()}
    bs_u = dims.pop() if len(dims) == 1 else 1
    Hs = assemble_sparse_csr(system.snapshot(device))
    bsm = BlockSparseMatrix.from_sparse(Hs, bs_u, bs_u)
    bsm.save_matrix_market("system.mtx")
    try:
        bsm.rasterize("system_matrix.png")
    except Exception as exc:  # noqa: BLE001  (the reference skips a failed raster)
        print(f"system matrix raster skipped: {type(exc).__name__}: {exc}")
    print(f"system matrix: {bsm.shape[0]}x{bsm.shape[1]}, "
          f"{bsm.nnz_blocks} blocks -> system.mtx")


def _write_marginals(system, device, verbose) -> None:
    """-dm: marginals.txt, the diagonal of each vertex's covariance block
    (CMarginalCovariance::Dump_Diagonal, include/slam/Marginals.h:7172)."""
    from slampp_tpu_torch.marginals import MarginalCovariance

    marg = MarginalCovariance(system, device=device)
    marg.update_batch()
    d0 = marg.block_diag.get(0)
    if verbose and d0 is not None:
        print("marginals: vertex-0 covariance diag:", d0.diagonal())
    with open("marginals.txt", "w") as f:
        for vid in sorted(system.vertex_index):
            blk = marg.block_diag.get(vid)
            if blk is None:
                continue
            f.write(" ".join("%.15g" % x for x in blk.diagonal()) + "\n")


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    device = torch.device(args.device)

    if args.run_matrix_unit_tests:
        # reference -rmut (BlockUnit.cpp): random block-matrix unit tests
        # (the port's file imports no JAX, so no conftest is needed)
        return subprocess.call(
            [sys.executable, "-m", "pytest", os.path.join(ROOT, "tests", "test_torch_block_unit.py"),
             "-q", "--noconftest", "-p", "no:cacheprovider"],
            cwd=ROOT,
        )
    if args.run_matrix_benchmarks:
        # reference -rmb (BlockBench.h): the kernels against their plain
        # versions and the library on the card; kernel_bench.csv lands in the
        # working directory
        if not torch.cuda.is_available():
            raise RuntimeError("-rmb times the CUDA kernels and needs a CUDA card; "
                               "none is available")
        return subprocess.call([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--kernels"])
    if args.input is None:
        build_arg_parser().error("the following arguments are required: -i/--input")
    from slampp_tpu_torch.io.parser import detect_problem, parse_file
    from slampp_tpu_torch.utils.device import require_device

    require_device(device, "slam_plus_plus")

    t0 = time.time()
    records = parse_file(args.input)
    problem = detect_problem(records[:1000])
    t_parse = time.time() - t0

    t0 = time.time()
    system, solver, n_steps, solver_kind = _build_solver(args, records, problem, device)
    t_build = time.time() - t0

    fi = args.max_final_nonlinear_solve_iters
    ft = args.final_nonlinear_solve_error_thresh
    t0 = time.time()
    iters = solver.optimize(
        fi if fi is not None else args.max_nonlinear_solve_iters,
        ft if ft is not None else args.nonlinear_solve_error_thresh,
    )
    t_solve = time.time() - t0
    chi2 = solver.chi2()

    print(f"done. it took {t_solve:.5f} sec (solve) + {t_parse + t_build:.5f} sec (parse/build)")
    print(f"denormalized chi2 error: {chi2:.2f}")
    if not args.no_detailed_timing:
        solver.dump()

    if args.dump_system_matrix:
        _dump_system_matrix(system, device)
    if args.do_marginals:
        _write_marginals(system, device, args.verbose)

    if not args.no_solution and args.solution:
        with open(args.solution, "w") as f:
            for vid in sorted(system.vertex_index):
                st = system.vertex_state(vid)
                f.write(" ".join("%.10f" % x for x in st) + "\n")

    if args.plot and not args.no_bitmaps:
        from slampp_tpu_torch.viz.plot import plot_system

        plot_system(system, args.plot)

    if args.json:
        timer = getattr(solver, "timer", None)
        print(json.dumps({
            "problem": problem,
            "solver": solver_kind,
            "chi2": chi2,
            "iterations": iters,
            "incremental_solves": n_steps,
            "t_solve": t_solve,
            # the port's additions: the set-up split and the solver's phases
            "t_parse": t_parse,
            "t_build": t_build,
            "device": str(device),
            "phases": dict(timer.acc) if timer is not None else {},
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
