"""Dogleg trust-region solver (counterpart of ``slampp_tpu/solvers/dogleg.py``;
reference CNonlinearSolver_Lambda_DL, include/slam/NonlinearSolver_Lambda_DL.h:242).

Classic Powell dogleg over the Gauss-Newton system: blend the GN step and
the steepest-descent (Cauchy) step inside the trust radius, and update the
radius by the gain ratio.  ``relin_threshold`` > 0 suppresses per-vertex
updates below it (fluid relinearization, NonlinearSolver_Lambda_DL.h:399).
"""

from __future__ import annotations

import math

import torch

from slampp_tpu_torch.core import assembly
from slampp_tpu_torch.graph.system import GraphArrays, GraphSystem
from slampp_tpu_torch.linear.dense import solve_spd
from slampp_tpu_torch.solvers.lm import SCHUR_NOT_PORTED, warn_not_positive_definite
from slampp_tpu_torch.utils.device import require_device
from slampp_tpu_torch.utils.timer import PhaseTimer


def _dogleg_step(graph: GraphArrays, delta: float, relin_threshold: float = 0.0):
    """Returns (new_states, dx, predicted_reduction, dx_norm, chi2_at_entry)."""
    H, g, chi2 = assembly.assemble_dense(graph)
    dx_gn = solve_spd(H, -g)
    gTg = torch.dot(g, g)
    gHg = torch.dot(g, H @ g)
    dx_sd = -(gTg / torch.clamp_min(gHg, 1e-300)) * g  # Cauchy step
    n_gn = torch.linalg.norm(dx_gn)
    n_sd = torch.linalg.norm(dx_sd)
    # walk from dx_sd toward dx_gn until hitting the radius
    d = dx_gn - dx_sd
    a = torch.dot(d, d)
    b = 2.0 * torch.dot(dx_sd, d)
    c = torch.dot(dx_sd, dx_sd) - delta * delta
    disc = torch.sqrt(torch.clamp_min(b * b - 4 * a * c, 0.0))
    t = (-b + disc) / torch.clamp_min(2 * a, 1e-300)
    blend = dx_sd + torch.clamp(t, 0.0, 1.0) * d
    dx = torch.where(
        n_gn <= delta, dx_gn,
        torch.where(n_sd >= delta, dx_sd * (delta / torch.clamp_min(n_sd, 1e-300)), blend),
    )
    # predicted reduction of the 0.5 chi2 linear model: -g.dx - 0.5 dx.H.dx
    pred = -(torch.dot(g, dx) + 0.5 * torch.dot(dx, H @ dx))
    new_states = assembly.apply_update_gated(graph, dx, relin_threshold)
    return new_states, dx, pred, torch.linalg.norm(dx), chi2


class DoglegSolver:
    """Batch dogleg.  ``engine``: "auto", "dense" or "v3" (the partitioned
    engine with ``refine_iters=2``).  "auto" is dense: the JAX package
    takes its sparse Schur engine there only on landmark graphs, and the
    port has no landmark types yet (ROADMAP.md queue 1 item 6).  ``pad`` as
    in :class:`~slampp_tpu_torch.solvers.lm.LevenbergMarquardtSolver`."""

    name = "lambda_dl"

    def __init__(
        self,
        system: GraphSystem,
        verbose: bool = False,
        pad: bool = False,
        initial_radius: float = 2.0,
        relin_threshold: float = 0.0,  # reference default in DL: 1e-5
        engine: str = "auto",
        device="cuda",
    ):
        if engine == "schur_sparse":
            raise NotImplementedError(SCHUR_NOT_PORTED.format("DoglegSolver"))
        if engine not in ("auto", "dense", "v3"):
            raise ValueError(f"unknown engine {engine!r}")
        self.system = system
        self.verbose = verbose
        self.pad = pad
        self.radius = initial_radius
        self.relin_threshold = relin_threshold
        self.engine = engine
        self.device = torch.device(device)
        self._v3 = None
        self.timer = PhaseTimer()
        self.n_iterations = 0

    def _v3_solver(self):
        if self._v3 is None:
            from slampp_tpu_torch.linear.partitioned import PartitionedSolver

            with self.timer.phase("v3_symbolic"):
                self._v3 = PartitionedSolver(self.system, refine_iters=2, device=self.device)
                self._v3.symbolic()
        return self._v3

    def optimize(self, max_iterations: int = 5, min_dx_norm: float = 0.01) -> int:
        require_device(self.device, "DoglegSolver")
        if self.system.n_edges == 0:
            return 0
        graph = self.system.snapshot(self.device)
        last_error = float(assembly.graph_chi2(graph))
        applied = 0
        for it in range(max_iterations):
            self.n_iterations += 1
            with self.timer.phase("dogleg_step"):
                if self.engine == "v3":
                    new_states, pred, dx_norm, _ = self._v3_solver().dogleg_step(
                        graph, self.radius, self.relin_threshold)
                else:
                    new_states, _, pred, dx_norm, _ = _dogleg_step(
                        graph, self.radius, self.relin_threshold)
                dx_norm = float(dx_norm)
            if not math.isfinite(dx_norm):
                warn_not_positive_definite()
                break
            if dx_norm <= min_dx_norm:
                break
            candidate = graph.replace_states(new_states)
            f_error = float(assembly.graph_chi2(candidate))
            # gain ratio against the quadratic model (x2: pred models chi2/2)
            rho = (last_error - f_error) / max(2.0 * float(pred), 1e-300)
            if rho > 0:
                graph = candidate
                last_error = f_error
                applied += 1
                if rho > 0.75:
                    self.radius = max(self.radius, 3.0 * dx_norm)
            if rho < 0.25:
                self.radius *= 0.5
                if self.radius < 1e-6:
                    break
            if self.verbose:
                print(f"DL iter {it}: chi2={f_error:.4f} rho={rho:.3f} radius={self.radius:.3e}")
        self.system.update_states(graph.states)
        return applied

    def chi2(self) -> float:
        """Denormalized chi-squared at the current linearization point."""
        require_device(self.device, "DoglegSolver")
        return float(assembly.graph_chi2(self.system.snapshot(self.device)))

    def dump(self) -> None:
        self.timer.dump()
