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
The loop runs on the host and reads dx_norm, the gain-ratio denominator and
the candidate's chi2 back each iteration, as the JAX package does.
"""

from __future__ import annotations

import math
import sys

import torch

from slampp_tpu_torch.core import assembly
from slampp_tpu_torch.graph.system import GraphArrays, GraphSystem
from slampp_tpu_torch.linear.dense import solve_spd
from slampp_tpu_torch.utils.device import require_device
from slampp_tpu_torch.utils.timer import PhaseTimer

SCHUR_NOT_PORTED = ("{}: the Schur engines (schur, schur_sparse, big_ba) are not ported yet "
                    "(ROADMAP.md queue 1 item 6)")


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


class LevenbergMarquardtSolver:
    """Batch LM.  ``engine``: "dense" (the full Hessian) or "v3" (the
    partitioned block-sparse engine, uniform block size, with
    ``refine_iters=2``).  ``pad`` is accepted for the JAX package's
    signature: the port compiles nothing per shape, so it snapshots
    unpadded either way."""

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
        if use_schur or engine in ("schur_sparse", "big_ba"):
            raise NotImplementedError(SCHUR_NOT_PORTED.format("LevenbergMarquardtSolver"))
        if engine not in ("dense", "v3"):
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
        graph = self.system.snapshot(self.device)
        alpha = self.tau * float(assembly.max_edge_hessian_diag(graph))
        nu = 2.0
        last_error = float(assembly.graph_chi2(graph))
        applied = 0
        it = 0
        while it < max_iterations:
            it += 1
            self.n_iterations += 1
            if self.engine == "v3":
                with self.timer.phase("solve"):
                    new_states, denom, dx_norm, _ = self._v3_solver().damped_step(graph, alpha)
                    dx_norm = float(dx_norm)
            else:
                with self.timer.phase("assemble"):
                    H, g, _ = assembly.assemble_dense(graph)
                with self.timer.phase("solve"):
                    new_states, _, denom, dx_norm = _damped_step(graph, H, g, alpha)
                    dx_norm = float(dx_norm)
            if not math.isfinite(dx_norm):
                warn_not_positive_definite()
                break
            if dx_norm <= min_dx_norm:
                break
            candidate = graph.replace_states(new_states)
            f_error = float(assembly.graph_chi2(candidate))
            rho = (last_error - f_error) / max(float(denom), 1e-300)
            if rho > 0:
                alpha *= max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
                nu = 2.0
                last_error = f_error
                graph = candidate
                applied += 1
                if self.verbose:
                    print(f"LM iter {it}: accepted chi2={f_error:.4f} alpha={alpha:.3e}")
            else:
                alpha *= nu
                nu *= 2.0
                if self.verbose:
                    print(f"LM iter {it}: rejected chi2={f_error:.4f} alpha={alpha:.3e}")
        self.system.update_states(graph.states)
        return applied

    def chi2(self) -> float:
        """Denormalized chi-squared at the current linearization point."""
        require_device(self.device, "LevenbergMarquardtSolver")
        return float(assembly.graph_chi2(self.system.snapshot(self.device)))

    def dump(self) -> None:
        self.timer.dump()
