"""Nonlinear solvers (counterpart of ``slampp_tpu/solvers``): the batch
Gauss-Newton, Levenberg-Marquardt and dogleg solvers, and the incremental
ones — every-N Gauss-Newton, the windowed solver and FastL.

A solver's module is imported at the first use of its name here: the BA
solvers import ``solvers/lm.py`` alone."""

import importlib

_MODULES = {"DoglegSolver": "dogleg", "FastLSolver": "fastl",
            "GaussNewtonSolver": "gauss_newton", "IncrementalSolver": "incremental",
            "LevenbergMarquardtSolver": "lm", "WindowedIncrementalSolver": "incremental_windowed"}
__all__ = list(_MODULES)


def __getattr__(name):
    if name not in _MODULES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_MODULES[name]}"), name)
