"""Nonlinear solvers (counterpart of ``slampp_tpu/solvers``): the batch
Gauss-Newton, Levenberg-Marquardt and dogleg solvers, and the incremental
ones — every-N Gauss-Newton, the windowed solver and FastL."""

from slampp_tpu_torch.solvers.dogleg import DoglegSolver
from slampp_tpu_torch.solvers.fastl import FastLSolver
from slampp_tpu_torch.solvers.gauss_newton import GaussNewtonSolver
from slampp_tpu_torch.solvers.incremental import IncrementalSolver
from slampp_tpu_torch.solvers.incremental_windowed import WindowedIncrementalSolver
from slampp_tpu_torch.solvers.lm import LevenbergMarquardtSolver

__all__ = ["DoglegSolver", "FastLSolver", "GaussNewtonSolver", "IncrementalSolver",
           "LevenbergMarquardtSolver", "WindowedIncrementalSolver"]
