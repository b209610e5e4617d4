"""Batch Gauss-Newton on the Hessian (counterpart of
``slampp_tpu/solvers/gauss_newton.py``; the reference's lambda solver,
CNonlinearSolver_Lambda, NonlinearSolver_Lambda.h:44).

Iteration semantics of ``Optimize`` (NonlinearSolver_Lambda.h:476-668): per
iteration, refresh lambda and eta at the current linearization point,
solve, stop without applying if ||dx|| <= min_dx_norm, else retract the
states.  The loop runs on the host and reads ||dx|| back each iteration,
so the iteration counts follow the reference's.
"""

from __future__ import annotations

import math

import torch

from slampp_tpu_torch.core import assembly
from slampp_tpu_torch.graph.system import GraphArrays, GraphSystem
from slampp_tpu_torch.graph.types import get_vertex_type
from slampp_tpu_torch.linear.dense import solve_dense
from slampp_tpu_torch.solvers.lm import sparse_schur_applies, warn_not_positive_definite
from slampp_tpu_torch.utils.device import require_device
from slampp_tpu_torch.utils.timer import PhaseTimer


def _gn_step(graph: GraphArrays, update_threshold: float = 0.0, plan=None):
    """One dense GN iteration: (new_states, dx_norm, chi2 at entry).
    ``update_threshold`` > 0 gates per-vertex updates; with a SchurPlan the
    solve eliminates the landmarks first (the -us path)."""
    H, g, chi2 = assembly.assemble_dense(graph)
    if plan is not None:
        from slampp_tpu_torch.linear.schur import schur_solve

        dx = schur_solve(H, g, plan)
    else:
        dx = solve_dense(H, g)
    return assembly.apply_update_gated(graph, dx, update_threshold), torch.linalg.norm(dx), chi2


class GaussNewtonSolver:
    """The lambda solver: batch Gauss-Newton.  ``linear_solver``: "native"
    (block-sparse Cholesky, v1), "dense", "schur" (``use_schur=True``: the
    landmarks eliminated from the dense Hessian; the sparse Schur engine on
    a landmark graph of ``lm.SPARSE_SCHUR_THRESHOLD`` vertices or more),
    "schur_sparse", or "auto" (native when all vertices share one block
    size, as in the JAX package).  ``pad`` as in
    :class:`~slampp_tpu_torch.solvers.lm.LevenbergMarquardtSolver`."""

    name = "lambda"

    def __init__(
        self,
        system: GraphSystem,
        use_schur: bool = False,
        verbose: bool = False,
        pad: bool = False,
        linear_solver: str = "auto",
        device="cuda",
    ):
        if use_schur:
            linear_solver = "schur"
        if linear_solver not in ("auto", "native", "dense", "schur", "schur_sparse"):
            raise ValueError(f"unknown linear_solver {linear_solver!r}")
        self.system = system
        self.linear_solver = linear_solver
        self.use_schur = linear_solver == "schur"
        self.verbose = verbose
        self.pad = pad
        self.device = torch.device(device)
        self.timer = PhaseTimer()
        self.n_iterations = 0
        self._native = None
        self._sparse_schur = None
        self._schur_plan = None

    def _resolve_solver(self) -> str:
        if self.linear_solver == "schur" and sparse_schur_applies(self.system):
            # no dense H at any point (reference -us at any scale,
            # LinearSolver_Schur.h:1623)
            return "schur_sparse"
        if self.linear_solver != "auto":
            return self.linear_solver
        dims = {get_vertex_type(t).dim for t, _ in self.system.vertex_index.values()}
        return "native" if len(dims) == 1 else "dense"

    def _snapshot(self) -> GraphArrays:
        with self.timer.phase("snapshot"):
            return self.system.snapshot(self.device)

    def optimize(self, max_iterations: int = 5, min_dx_norm: float = 0.01) -> int:
        """Up to ``max_iterations`` GN steps; returns the iterations applied."""
        require_device(self.device, "GaussNewtonSolver")
        if self.system.n_edges == 0:
            return 0
        kind = self._resolve_solver()
        if kind == "native":
            from slampp_tpu_torch.linear.native import NativeBlockSolver

            if self._native is None:
                self._native = NativeBlockSolver(self.system, device=self.device)
            with self.timer.phase("symbolic"):
                self._native.ensure_symbolic()
        elif kind == "schur_sparse":
            from slampp_tpu_torch.linear.schur_sparse import SparseSchurSolver

            if self._sparse_schur is None:
                self._sparse_schur = SparseSchurSolver(self.system, device=self.device)
            with self.timer.phase("symbolic"):
                self._sparse_schur.ensure_symbolic()
        elif kind == "schur" and self._schur_plan is None:
            from slampp_tpu_torch.linear.schur import build_schur_plan

            with self.timer.phase("schur_symbolic"):
                self._schur_plan = build_schur_plan(self.system).to(self.device)
        graph = self._snapshot()
        applied = 0
        for _ in range(max_iterations):
            with self.timer.phase("gn_step"):
                if kind == "native":
                    new_states, dx_norm, chi2 = self._native.gn_step(graph)
                elif kind == "schur_sparse":
                    new_states, dx_norm, chi2 = self._sparse_schur.gn_step(graph)
                else:
                    plan = self._schur_plan if kind == "schur" else None
                    new_states, dx_norm, chi2 = _gn_step(graph, plan=plan)
                dx_norm = float(dx_norm)
            self.n_iterations += 1
            if self.verbose:
                print(f"iter {applied}: chi2={float(chi2):.4f} |dx|={dx_norm:.6f}")
            if not math.isfinite(dx_norm):
                warn_not_positive_definite()
                break
            if dx_norm <= min_dx_norm:
                break
            graph = graph.replace_states(new_states)
            applied += 1
        with self.timer.phase("writeback"):
            self.system.update_states(graph.states)
        return applied

    def chi2(self) -> float:
        """Denormalized chi-squared at the current linearization point."""
        require_device(self.device, "GaussNewtonSolver")
        return float(assembly.graph_chi2(self._snapshot()))

    def dump(self) -> None:
        self.timer.dump()
