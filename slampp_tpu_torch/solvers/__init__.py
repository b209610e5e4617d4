"""Batch nonlinear solvers (counterpart of ``slampp_tpu/solvers``):
Gauss-Newton, Levenberg-Marquardt and dogleg."""

from slampp_tpu_torch.solvers.dogleg import DoglegSolver
from slampp_tpu_torch.solvers.gauss_newton import GaussNewtonSolver
from slampp_tpu_torch.solvers.lm import LevenbergMarquardtSolver

__all__ = ["DoglegSolver", "GaussNewtonSolver", "LevenbergMarquardtSolver"]
