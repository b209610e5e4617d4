"""Dense SPD Cholesky solver (counterpart of ``slampp_tpu/linear/dense.py``;
reference CLinearSolver_DenseEigen, LinearSolver_Schur.h:1046).

The JAX package computes these with ``lax.linalg`` outside any Pallas
kernel, so the library calls are the port.  ``lax.linalg.cholesky`` returns
NaN for a matrix that is not positive definite and the solvers abort on a
non-finite ``dx_norm``; ``torch.linalg.cholesky`` would raise instead, so
the factor comes from ``cholesky_ex`` and a failed factorization turns into
a NaN solution, not an exception (and no host sync).
"""

from __future__ import annotations

import torch


def solve_spd(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = H^-1 b for symmetric positive definite H via Cholesky; NaN where
    the factorization fails."""
    L, info = torch.linalg.cholesky_ex(H)
    L = torch.where(info == 0, L, torch.nan)
    y = torch.linalg.solve_triangular(L, b[:, None], upper=False)
    return torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]


def solve_dense(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Gauss-Newton step dx = -H^-1 g (core/assembly.py sign convention)."""
    return solve_spd(H, -g)
