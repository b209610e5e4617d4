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
from slampp_tpu_torch.solvers.lm import SCHUR_NOT_PORTED, warn_not_positive_definite
from slampp_tpu_torch.utils.device import require_device
from slampp_tpu_torch.utils.timer import PhaseTimer


def _gn_step(graph: GraphArrays, update_threshold: float = 0.0):
    """One dense GN iteration: (new_states, dx_norm, chi2 at entry).
    ``update_threshold`` > 0 gates per-vertex updates."""
    H, g, chi2 = assembly.assemble_dense(graph)
    dx = solve_dense(H, g)
    return assembly.apply_update_gated(graph, dx, update_threshold), torch.linalg.norm(dx), chi2


class GaussNewtonSolver:
    """The lambda solver: batch Gauss-Newton.  ``linear_solver``: "native"
    (block-sparse Cholesky, v1), "dense", or "auto" (native when all
    vertices share one block size, as in the JAX package).  The Schur
    routes ("schur", ``use_schur=True``, "schur_sparse") raise
    NotImplementedError.  ``pad`` as in
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
        if use_schur or linear_solver in ("schur", "schur_sparse"):
            raise NotImplementedError(SCHUR_NOT_PORTED.format("GaussNewtonSolver"))
        if linear_solver not in ("auto", "native", "dense"):
            raise ValueError(f"unknown linear_solver {linear_solver!r}")
        self.system = system
        self.linear_solver = linear_solver
        self.use_schur = use_schur
        self.verbose = verbose
        self.pad = pad
        self.device = torch.device(device)
        self.timer = PhaseTimer()
        self.n_iterations = 0
        self._native = None

    def _resolve_solver(self) -> str:
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
        graph = self._snapshot()
        applied = 0
        for _ in range(max_iterations):
            with self.timer.phase("gn_step"):
                if kind == "native":
                    new_states, dx_norm, chi2 = self._native.gn_step(graph)
                else:
                    new_states, dx_norm, chi2 = _gn_step(graph)
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
