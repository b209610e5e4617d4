"""Schur-complement covariance recovery for bundle adjustment (counterpart
of ``slampp_tpu/marginals/ba_marginals.py``; reference BAMarginals.h,
CBlockVectorMAD_Impl :43, CUTTSolve_Bases_Impl :238).

Camera marginals from the inverse Schur complement, landmark
block-diagonal marginals recovered from them:

  Sigma_cc       = SC^-1
  Sigma_ll(diag) = C^-1 + C^-1 U^T Sigma_cc U C^-1   (per-landmark blocks)

SC is factored with ``torch.linalg.cholesky_ex`` and inverted by two
triangular solves, as the JAX package does with ``lax.linalg`` (library
calls, no kernel of the port's own); where SC is not positive definite the
result is NaN, as ``lax.linalg.cholesky``'s, not an exception.
"""

from __future__ import annotations

import torch

from slampp_tpu_torch.linear.schur import SchurPlan, _eliminate


def schur_marginals(H: torch.Tensor, plan: SchurPlan, alpha=0.0):
    """(Sigma_cc, Sigma_ll_blocks): the dense covariance of the reduced
    (camera) system and the (n_l, d, d) landmark diagonal blocks."""
    _, Dinv, B, _, SC = _eliminate(H, plan, alpha)
    L, info = torch.linalg.cholesky_ex(SC)
    L = torch.where(info == 0, L, torch.nan)
    eye = torch.eye(SC.shape[0], dtype=H.dtype, device=H.device)
    Y = torch.linalg.solve_triangular(L, eye, upper=False)
    Sigma_cc = torch.linalg.solve_triangular(L.T, Y, upper=True)
    # landmark diagonal: C^-1 + (C^-1 U^T) Sigma_cc (U C^-1), per landmark
    G = torch.einsum("cle,led->cld", B, Dinv)
    T = torch.einsum("ck,kld->cld", Sigma_cc, G)
    Sigma_ll = Dinv + torch.einsum("cld,cle->lde", G, T)
    return Sigma_cc, Sigma_ll
