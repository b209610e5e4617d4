"""Levenberg-Marquardt on the Hessian (counterpart of
``slampp_tpu/solvers/lm.py``; reference CNonlinearSolver_Lambda_LM,
include/slam/NonlinearSolver_Lambda_LM.h:321, baseline trust-region policy
CLevenbergMarquardt_Baseline :135-243).

The reference's baseline damping policy, exactly as in the JAX package:
  * initial alpha = tau * max over edges of the max vertex-Hessian diagonal
    (f_InitialDamping, :152-199);
  * gain ratio rho = (err0 - err1) / dx.(alpha dx + eta); accept if rho > 0
    with alpha *= max(1/3, 1 - (2 rho - 1)^3), nu = 2; else alpha *= nu,
    nu *= 2 and roll back (Aftermath, :205-230);
  * damping is additive on the lambda diagonal (ApplyDamping, :235-243).
``lm_loop``, this policy for every LM solver of the port, runs on the host
and reads dx_norm, the gain-ratio denominator and the candidate's chi2 back
each iteration, as the JAX package does.
``optimize`` snapshots the host graph, runs ``optimize_graph`` on the
snapshot and writes the result back; a caller that re-optimizes holds the
device graph itself and calls ``optimize_graph`` (spans ``lm.solve`` >
``lm.iteration`` > the engine's layers, ``lm.chi2``, ``lm.accept`` /
``lm.reject``).

The Schur engines: ``use_schur`` eliminates the landmarks of the dense
Hessian (``linear/schur.py``), and on a landmark graph of
``SPARSE_SCHUR_THRESHOLD`` vertices or more takes the sparse Schur engine
instead (``linear/schur_sparse.py``, as ``engine="schur_sparse"``);
``engine="big_ba"`` runs the observation-driven BA solver
(``linear/ba_schur.BigBASolver``, float32 SC).
"""

from __future__ import annotations

import contextlib
import math
import sys

import torch

from slampp_tpu_torch.core import assembly
from slampp_tpu_torch.graph.system import GraphArrays, GraphSystem
from slampp_tpu_torch.graph.types import get_vertex_type
from slampp_tpu_torch.linear.dense import solve_spd
from slampp_tpu_torch.utils.device import require_device
from slampp_tpu_torch.utils.spans import span, spanned
from slampp_tpu_torch.utils.timer import PhaseTimer

# a landmark graph of this many vertices or more takes the sparse Schur
# engine on the Schur routes (the JAX package's SLAMPP_SPARSE_SCHUR_THRESHOLD
# default; the port reads no environment)
SPARSE_SCHUR_THRESHOLD = 1500


def sparse_schur_applies(system: GraphSystem) -> bool:
    """A landmark graph of SPARSE_SCHUR_THRESHOLD vertices or more."""
    return (system.n_vertices >= SPARSE_SCHUR_THRESHOLD
            and any(get_vertex_type(t).is_landmark for t in system.vertex_type_names))


def _damped_step(graph: GraphArrays, H: torch.Tensor, g: torch.Tensor, alpha: float):
    """(new_states, dx, denom, dx_norm) of (H + alpha I) dx = -g."""
    Hd = H.clone()
    Hd.diagonal().add_(alpha)
    dx = solve_spd(Hd, -g)
    # rho denominator: dx . (alpha dx + eta), eta = -g in this sign convention
    denom = torch.dot(dx, alpha * dx - g)
    return assembly.apply_update(graph, dx), dx, denom, torch.linalg.norm(dx)


def warn_not_positive_definite() -> None:
    # the reference aborts iterating when the factorization fails ("not pos
    # def, aborting", NonlinearSolver_Lambda.h:658-660)
    print("warning: system is not positive definite / numerical failure in the linear "
          "solve, aborting iterations", file=sys.stderr)


def lm_loop(state, step, chi2, alpha: float, max_iterations: int, min_dx_norm: float,
            spans=None, verbose: str = None):
    """The baseline policy above over an opaque ``state``, from damping
    ``alpha``: ``step(state, alpha)`` gives (candidate, gain denominator,
    |dx|), ``chi2(state)`` a float.  ``spans`` names the (iteration, accept,
    reject) spans to open, or is None; ``verbose``, a format of ``it`` (from
    1), ``verdict``, ``chi2`` and ``alpha``, is printed after each gain
    test.  Returns (the last accepted state, the accepted steps, the steps
    taken, the one that stopped the loop included, and why it stopped:
    "max_iterations", "small_step" or "not_finite")."""
    opened = span if spans else (lambda _: contextlib.nullcontext())
    it_span, accept_span, reject_span = spans or (None,) * 3
    nu = 2.0
    last_error = chi2(state)
    applied = 0
    for it in range(1, max_iterations + 1):
        with opened(it_span):
            candidate, denom, dx_norm = step(state, alpha)
            dx_norm = float(dx_norm)
            if not math.isfinite(dx_norm):  # a failed factorization
                return (state, applied, it, "not_finite")
            if dx_norm <= min_dx_norm:
                return (state, applied, it, "small_step")
            f_error = chi2(candidate)
            rho = (last_error - f_error) / max(float(denom), 1e-300)
            with opened(accept_span if rho > 0 else reject_span):
                if rho > 0:
                    alpha *= max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
                    nu = 2.0
                    state, last_error = candidate, f_error
                    applied += 1
                else:
                    alpha *= nu
                    nu *= 2.0
                if verbose:
                    print(verbose.format(it=it, verdict="accepted" if rho > 0 else "rejected",
                                         chi2=f_error, alpha=alpha))
    return (state, applied, max_iterations, "max_iterations")


class LevenbergMarquardtSolver:
    """Batch LM.  ``engine``: "dense" (the full Hessian, landmarks
    eliminated first with ``use_schur``), "v3" (the partitioned
    block-sparse engine, uniform block size, with ``refine_iters=2``),
    "schur_sparse" (observation-wise landmark elimination + the v3 pose
    solve) or "big_ba" (``BigBASolver``, mono cam / xyz BA).  ``pad`` is
    accepted for the JAX package's signature: the port compiles nothing per
    shape, so it snapshots unpadded either way."""

    name = "lambda_lm"

    def __init__(
        self,
        system: GraphSystem,
        use_schur: bool = False,
        verbose: bool = False,
        pad: bool = False,
        tau: float = 1e-3,
        engine: str = "dense",
        device="cuda",
    ):
        if engine not in ("dense", "v3", "schur_sparse", "big_ba"):
            raise ValueError(f"unknown engine {engine!r}")
        self.system = system
        self.use_schur = use_schur
        self.verbose = verbose
        self.pad = pad
        self.tau = tau
        self.engine = engine
        self.device = torch.device(device)
        self.timer = PhaseTimer()
        self.n_iterations = 0
        self._v3 = None
        self._ss = None
        self._big = None
        self._schur_plan = None

    def _resolve_engine(self) -> str:
        """dense + use_schur becomes the sparse Schur engine on a large
        landmark graph (the gate of GaussNewtonSolver._resolve_solver)."""
        if self.engine == "dense" and self.use_schur and sparse_schur_applies(self.system):
            return "schur_sparse"
        return self.engine

    def _ss_solver(self):
        if self._ss is None:
            from slampp_tpu_torch.linear.schur_sparse import SparseSchurSolver

            with self.timer.phase("schur_sparse_symbolic"):
                self._ss = SparseSchurSolver(self.system, device=self.device)
                self._ss.ensure_symbolic()
        return self._ss

    def _plan(self):
        if self._schur_plan is None:
            from slampp_tpu_torch.linear.schur import build_schur_plan

            with self.timer.phase("schur_symbolic"):
                self._schur_plan = build_schur_plan(self.system).to(self.device)
        return self._schur_plan

    def _v3_solver(self):
        if self._v3 is None:
            from slampp_tpu_torch.linear.partitioned import PartitionedSolver

            with self.timer.phase("v3_symbolic"):
                self._v3 = PartitionedSolver(self.system, refine_iters=2, device=self.device)
                self._v3.symbolic()
        return self._v3

    def optimize(self, max_iterations: int = 5, min_dx_norm: float = 0.01) -> int:
        """Up to ``max_iterations`` LM iterations; returns the accepted ones."""
        require_device(self.device, "LevenbergMarquardtSolver")
        if self.system.n_edges == 0:
            return 0
        engine = self._resolve_engine()
        if engine == "big_ba":
            # the observation-driven Schur LM, no dense Hessian at any point
            # (the reference's default BA route, Main.cpp:203-207)
            from slampp_tpu_torch.linear.ba_schur import BigBASolver

            if self._big is None:
                with self.timer.phase("big_ba_symbolic"):
                    self._big = BigBASolver(self.system, verbose=self.verbose, tau=self.tau,
                                            sc_f64=False, device=self.device)
            with self.timer.phase("solve"):
                applied = self._big.optimize(max_iterations, min_dx_norm)
            self.n_iterations += max_iterations
            return applied
        graph, applied, _ = self.optimize_graph(self.system.snapshot(self.device),
                                                max_iterations, min_dx_norm)
        self.system.update_states(graph.states)
        return applied

    @spanned("lm.solve")
    def optimize_graph(self, graph: GraphArrays, max_iterations: int = 5,
                       min_dx_norm: float = 0.01):
        """The LM loop on a device graph the caller holds (the dense, v3 and
        sparse Schur engines): up to ``max_iterations`` steps from
        ``graph``, which is left as it is.  Returns (the final graph, the
        accepted steps, the steps taken, accepted or rejected, counted as
        ``n_iterations`` counts them)."""
        require_device(self.device, "LevenbergMarquardtSolver")
        engine = self._resolve_engine()
        if engine == "big_ba":
            raise ValueError("the big_ba engine runs its own loop (BigBASolver.optimize)")
        alpha = self.tau * float(assembly.max_edge_hessian_diag(graph))

        def step(graph, alpha):
            if engine in ("v3", "schur_sparse"):
                eng = self._v3_solver() if engine == "v3" else self._ss_solver()
            else:
                with self.timer.phase("assemble"):
                    H, g, _ = assembly.assemble_dense(graph)
            with self.timer.phase("solve"):
                if engine in ("v3", "schur_sparse"):
                    new_states, denom, dx_norm, _ = eng.damped_step(graph, alpha)
                elif self.use_schur:
                    from slampp_tpu_torch.linear.schur import schur_solve_dense_damped

                    new_states, _, denom, dx_norm = schur_solve_dense_damped(
                        graph, H, g, alpha, self._plan())
                else:
                    new_states, _, denom, dx_norm = _damped_step(graph, H, g, alpha)
                return graph.replace_states(new_states), denom, float(dx_norm)

        def chi2(graph):
            with span("lm.chi2"):
                return float(assembly.graph_chi2(graph))

        graph, applied, iterations, stop = lm_loop(
            graph, step, chi2, alpha, max_iterations, min_dx_norm,
            ("lm.iteration", "lm.accept", "lm.reject"),
            self.verbose and "LM iter {it}: {verdict} chi2={chi2:.4f} alpha={alpha:.3e}")
        self.n_iterations += iterations
        if stop == "not_finite":
            warn_not_positive_definite()
        return graph, applied, iterations

    def chi2(self) -> float:
        """Denormalized chi-squared at the current linearization point."""
        require_device(self.device, "LevenbergMarquardtSolver")
        return float(assembly.graph_chi2(self.system.snapshot(self.device)))

    def dump(self) -> None:
        self.timer.dump()
