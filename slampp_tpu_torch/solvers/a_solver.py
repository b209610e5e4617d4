"""Gauss-Newton on the Jacobian (A) matrix (counterpart of
``slampp_tpu/solvers/a_solver.py``; reference CNonlinearSolver_A,
include/slam/NonlinearSolver_A.h:314).

Each iteration builds the weighted Jacobian A = R J (R the upper Cholesky
factor of each edge's Sigma^-1) and the weighted residual explicitly,
solves the normal equations and keeps A for ``r_A()`` (the reference's
solver_ExportsJacobian trait).  Numerically the lambda solver's step
(A^T A = lambda, A^T b = eta); the value of this solver is the exported
Jacobian.
"""

from __future__ import annotations

import math

import torch

from slampp_tpu_torch.core import assembly
from slampp_tpu_torch.graph.system import GraphArrays, GraphSystem
from slampp_tpu_torch.graph.types import get_edge_type, get_vertex_type
from slampp_tpu_torch.linear.dense import solve_dense
from slampp_tpu_torch.utils.device import require_device
from slampp_tpu_torch.utils.timer import PhaseTimer


def build_jacobian(graph: GraphArrays):
    """Dense weighted Jacobian A (m, N) and weighted residual b (m,) at the
    current linearization point; rows by edge type, then edge, then
    residual component."""
    N = graph.state_dim
    dev = graph.device
    blocks_A, blocks_b = [], []
    for name, ea in graph.edges.items():
        et = get_edge_type(name)
        vts = [get_vertex_type(t) for t in et.vertex_types]
        r, jacs = et.jacobian_fn(assembly.slot_states(et, ea, graph.states), ea.meas)
        valid = ea.valid[:, None, None]
        eye = torch.eye(et.res_dim, dtype=torch.float64, device=dev)
        # R = chol(Sigma^-1)^T, upper (BaseTypes_Binary.h:191)
        Rw = torch.linalg.cholesky(torch.where(valid, ea.sigma_inv, eye)).transpose(1, 2)
        Rw = torch.where(valid, Rw, 0.0)
        E = ea.meas.shape[0]
        A_t = torch.zeros((E, et.res_dim, N + assembly._dmax(graph)), dtype=torch.float64,
                          device=dev)
        rows = torch.arange(E, device=dev)[:, None, None]
        comp = torch.arange(et.res_dim, device=dev)[None, :, None]
        for a in range(et.arity):
            RJ = torch.einsum("eij,ejk->eik", Rw, jacs[a])
            cols = ea.offsets[:, a, None] + torch.arange(vts[a].dim, device=dev)[None, :]
            A_t.index_put_((rows, comp, cols[:, None, :]), RJ, accumulate=True)
        blocks_A.append(A_t[:, :, :N].reshape(E * et.res_dim, N))
        blocks_b.append(torch.einsum("eij,ej->ei", Rw, r).reshape(E * et.res_dim))
    return torch.cat(blocks_A, 0), torch.cat(blocks_b, 0)


class ASolver:
    """The -A CLI solver: Gauss-Newton via the explicit Jacobian."""

    name = "A"

    def __init__(self, system: GraphSystem, verbose: bool = False, device="cuda"):
        self.system = system
        self.verbose = verbose
        self.device = torch.device(device)
        self.timer = PhaseTimer()
        self.n_iterations = 0
        self._A = None
        self._b = None

    def r_A(self):
        """The weighted Jacobian of the last iteration (r_A())."""
        return self._A

    def optimize(self, max_iterations: int = 5, min_dx_norm: float = 0.01) -> int:
        require_device(self.device, "ASolver")
        if self.system.n_edges == 0:
            return 0
        graph = self.system.snapshot(self.device)
        applied = 0
        for _ in range(max_iterations):
            with self.timer.phase("jacobian"):
                A, b = build_jacobian(graph)
                self._A, self._b = A, b
            with self.timer.phase("solve"):
                H = A.T @ A
                g = A.T @ b  # the gradient of 0.5 ||r + J d||^2 at d = 0
                if graph.unary_dim > 0:
                    idx = graph.unary_offset + torch.arange(graph.unary_dim, device=self.device)
                    H[idx, idx] += graph.unary_information
                dx = solve_dense(H, g)
                dx_norm = float(torch.linalg.norm(dx))
            self.n_iterations += 1
            if dx_norm <= min_dx_norm or not math.isfinite(dx_norm):
                break
            graph = graph.replace_states(assembly.apply_update(graph, dx))
            applied += 1
        self.system.update_states(graph.states)
        return applied

    def chi2(self) -> float:
        require_device(self.device, "ASolver")
        return float(assembly.graph_chi2(self.system.snapshot(self.device)))

    def dump(self) -> None:
        self.timer.dump()
