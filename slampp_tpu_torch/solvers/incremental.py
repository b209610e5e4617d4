"""Every-N incremental Gauss-Newton (counterpart of
``slampp_tpu/solvers/incremental.py``).

Reference analogs: the incremental policies of all nonlinear solvers
(``TIncrementalSolveSetting``, IncrementalPolicy.h:172; step scheduler
``t_Incremental_Step``, NonlinearSolver_Base.h:557).  Edges stream into the
graph and every ``solve_period`` new *vertices* the solver runs a bounded
dense Gauss-Newton relinearization of the whole graph on ``device`` (one
assembly and one Cholesky per iteration).  Like the reference, a step
counts as a loop closure when its edge joins two known vertices; a step
given no vertex ids (the parser's ``on_edge`` hook) counts as one.

The JAX package took bucket-padded snapshots here to keep its jit cache
warm; the port snapshots unpadded (the padding rows were identity rows and
leave the solution of the real rows unchanged).
"""

from __future__ import annotations

import math

import torch

from slampp_tpu_torch.core import assembly
from slampp_tpu_torch.graph.system import GraphSystem
from slampp_tpu_torch.solvers.gauss_newton import _gn_step
from slampp_tpu_torch.utils.device import require_device
from slampp_tpu_torch.utils.timer import PhaseTimer


class IncrementalSolver:
    """Every-N incremental Gauss-Newton (the -nsp/-lsp CLI modes).

    Usage: call :meth:`incremental_step` after each ``system.add_edge``; the
    reference's parse loop does exactly this (ParseLoop.h:188-199).
    """

    def __init__(
        self,
        system: GraphSystem,
        solve_period: int = 1,  # new vertices per nonlinear solve (-nsp)
        max_iterations: int = 5,
        min_dx_norm: float = 0.01,
        require_loop_closure: bool = True,
        update_threshold: float = 0.0,  # FastL-style per-vertex update gate
        verbose: bool = False,
        device="cuda",
    ):
        self.device = torch.device(device)
        require_device(self.device, "IncrementalSolver")
        self.system = system
        self.solve_period = solve_period
        self.max_iterations = max_iterations
        self.min_dx_norm = min_dx_norm
        self.require_loop_closure = require_loop_closure
        self.update_threshold = update_threshold
        self.verbose = verbose
        self.timer = PhaseTimer()
        self.n_steps = 0
        self.n_solves = 0
        self.n_iterations = 0
        self._verts_at_last_solve = 0
        self._had_loop_closure = False
        self._known_vids = set()

    def incremental_step(self, edge_vertex_ids=None) -> bool:
        """Notify the solver of one appended edge; returns True if a solve ran.

        ``edge_vertex_ids``: the ids of the edge's vertices (used for the
        loop-closure gate; if omitted, every step is treated as a closure).
        """
        self.n_steps += 1
        if edge_vertex_ids is None:
            self._had_loop_closure = True
        else:
            new = [v for v in edge_vertex_ids if v not in self._known_vids]
            self._known_vids.update(edge_vertex_ids)
            if not new:
                self._had_loop_closure = True  # edge between existing vertices

        n_new = self.system.n_vertices - self._verts_at_last_solve
        if n_new < self.solve_period:
            return False
        if self.require_loop_closure and not self._had_loop_closure:
            # reference gate: no optimization until a loop closure arrives
            # (NonlinearSolver_Base.h:557-600) — odometry chains are exact
            self._verts_at_last_solve = self.system.n_vertices
            return False
        self._solve()
        self._verts_at_last_solve = self.system.n_vertices
        self._had_loop_closure = False
        return True

    def _solve(self):
        with self.timer.phase("snapshot"):
            graph = self.system.snapshot(self.device)
        self.n_solves += 1
        applied = 0
        for _ in range(self.max_iterations):
            with self.timer.phase("gn_step"):
                new_states, dx_norm, chi2 = _gn_step(graph, self.update_threshold)
                dx_norm = float(dx_norm)
            self.n_iterations += 1
            if dx_norm <= self.min_dx_norm or not math.isfinite(dx_norm):
                break
            graph = graph.replace_states(new_states)
            applied += 1
        if applied:
            with self.timer.phase("writeback"):
                self.system.update_states(graph.states)
        if self.verbose:
            print(
                f"incremental solve #{self.n_solves}: iters={applied} "
                f"chi2={float(chi2):.2f} |dx|={dx_norm:.4f}"
            )

    def optimize(self, max_iterations: int = 5, min_dx_norm: float = 0.01) -> int:
        """Final batch optimization (the reference's post-parse Optimize).
        Returns the GN iterations run over the solver's life, as the JAX
        package does."""
        save = (self.max_iterations, self.min_dx_norm)
        self.max_iterations, self.min_dx_norm = max_iterations, min_dx_norm
        self._solve()
        self.max_iterations, self.min_dx_norm = save
        return self.n_iterations

    def chi2(self) -> float:
        return float(assembly.graph_chi2(self.system.snapshot(self.device)))

    def dump(self) -> None:
        self.timer.dump()
