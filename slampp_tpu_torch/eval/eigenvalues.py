"""Symmetric eigenvalue analysis of system matrices (counterpart of
``slampp_tpu/eval/eigenvalues.py``).

Capability parity with ``CSymEigsSolver`` (include/slam/Eigenvalues.h:179,
364; src/slam/Eigenvalues.cpp), used for condition-number and
observability analysis: largest-magnitude eigenpairs, and the smallest
through shift-invert backed by the framework's own factorization.

Lanczos with full reorthogonalization, a fixed number of iterations over a
dense matrix or a user-supplied matvec.  The loop runs on the host over the
device vectors; nothing in it reads a value back.  The start vector comes
from a ``torch.Generator`` seeded with ``seed`` on the device, so it is not
the JAX package's (``jax.random``): Ritz sequences differ, converged
eigenvalues agree.  The sparse operator's shift-invert goes through the
partitioned (v3) factorization in float64, so it runs the three dense
kernels (ops/dense_kernels.py).
"""

from __future__ import annotations

from typing import Callable

import torch

from slampp_tpu_torch.core import block_assembly
from slampp_tpu_torch.linear.partitioned import PartitionedSolver, _factor32, _solve_with, _spmv_fine
from slampp_tpu_torch.marginals.marginals import cholesky_nan
from slampp_tpu_torch.utils.device import require_device


def lanczos_extremal(matvec: Callable, n: int, k: int = 6, iters: int = 60, seed: int = 0,
                     dtype=torch.float64, device="cuda"):
    """Lanczos with full reorthogonalization; returns (ritz_values,
    ritz_vectors) approximating the extremal spectrum of the symmetric
    operator.  ``iters`` >= k; the cost is ``iters`` matvecs."""
    device = torch.device(device)
    iters = max(iters, k + 2)
    gen = torch.Generator(device=device).manual_seed(seed)
    v0 = torch.randn(n, generator=gen, dtype=dtype, device=device)
    V = torch.zeros(iters + 1, n, dtype=dtype, device=device)
    V[0] = v0 / torch.linalg.vector_norm(v0)
    alphas = torch.zeros(iters, dtype=dtype, device=device)
    betas = torch.zeros(iters, dtype=dtype, device=device)
    for j in range(iters):
        v = V[j]
        w = matvec(v)
        a = torch.dot(v, w)
        w = w - a * v
        if j > 0:
            w = w - betas[j - 1] * V[j - 1]
        w = w - V.T @ (V @ w)  # full reorthogonalization
        b = torch.linalg.vector_norm(w)
        V[j + 1] = torch.where(b > 1e-12, w / b, 0.0)  # a device select, not a branch
        alphas[j] = a
        betas[j] = b
    T = torch.diag(alphas) + torch.diag(betas[:-1], 1) + torch.diag(betas[:-1], -1)
    evals, evecs = torch.linalg.eigh(T)
    return evals, V[:iters].T @ evecs


def _largest(evals, ritz, k):
    idx = torch.argsort(-evals.abs())[:k]
    return evals[idx], ritz[:, idx]


def _smallest_inverted(evals_inv, ritz, k, shift):
    idx = torch.argsort(-evals_inv)[:k]  # largest of the inverse = smallest of H
    return shift + 1.0 / evals_inv[idx], ritz[:, idx]


def _condition(lmax, lmin) -> float:
    return float(lmax[0].abs() / torch.clamp_min(lmin[0].abs(), 1e-300))


def largest_eigenvalues(H: torch.Tensor, k: int = 6, iters: int = 60):
    """k largest-magnitude eigenvalues of a symmetric matrix (the
    reference's largest-magnitude mode)."""
    evals, ritz = lanczos_extremal(lambda v: H @ v, H.shape[0], k, iters, dtype=H.dtype,
                                   device=H.device)
    return _largest(evals, ritz, k)


def smallest_eigenvalues_shift_invert(H: torch.Tensor, k: int = 6, shift: float = 0.0,
                                      iters: int = 60):
    """k smallest eigenvalues by shift-invert Lanczos (reference
    SpSym_Eigenvalues smallest-eigenvalue mode, Eigenvalues.h:60) on
    (H - shift I)^-1 through a cached Cholesky factor (NaN where it
    fails)."""
    n = H.shape[0]
    L = cholesky_nan(H - shift * torch.eye(n, dtype=H.dtype, device=H.device))

    def inv_mv(v):
        y = torch.linalg.solve_triangular(L, v[:, None], upper=False)
        return torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]

    evals_inv, ritz = lanczos_extremal(inv_mv, n, k, iters, dtype=H.dtype, device=H.device)
    return _smallest_inverted(evals_inv, ritz, k, shift)


def condition_number(H: torch.Tensor, iters: int = 80) -> float:
    """Spectral condition estimate (observability analysis)."""
    lmax, _ = largest_eigenvalues(H, 1, iters)
    lmin, _ = smallest_eigenvalues_shift_invert(H, 1, 0.0, iters)
    return _condition(lmax, lmin)


# ------------------------------------------------------------- sparse operator
#
# The reference operates on the sparse block matrix at full problem size
# (CSymEigsSolver over CUberBlockMatrix, Eigenvalues.h:179; shift-invert
# through the block LDLT, :364).  Here: a matvec over the assembled
# fine-block lambda (never densified), and shift-invert through the
# partitioned (v3) factorization.


class SparseSystemOperator:
    """Symmetric operator over a GraphSystem's block lambda.

    ``matvec(x)`` takes x in the GLOBAL scalar layout; the Hessian is held
    as the fine (nnzb, bs, bs) blocks of the v3 plan — O(nnz), never
    (N, N)."""

    def __init__(self, system, target: int = 64, device="cuda"):
        self.device = torch.device(device)
        require_device(self.device, "SparseSystemOperator")
        self._ps = PartitionedSolver(system, target=target, mixed_precision=False,
                                     refine_iters=0, device=self.device)
        self._ps.symbolic()
        graph = system.snapshot(self.device)
        self.n = graph.state_dim
        self._bp, self._p = self._ps.block_plan, self._ps.plan
        self._vals, _, _ = block_assembly.assemble_blocks_sorted(graph, self._bp)
        self._factor_cache = {}

    def _to_fine(self, x: torch.Tensor) -> torch.Tensor:
        """Global layout -> (n, P) permuted fine layout."""
        xg = torch.cat([x, x.new_zeros(max(self._bp.P, self._p.bs))])
        return xg[self._bp.dx_offsets]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        p = self._p
        return block_assembly.scatter_dx(self._bp, _spmv_fine(p, self._vals[: p.nnzb],
                                                              self._to_fine(x)))

    def solve_shifted(self, x: torch.Tensor, shift: float = 0.0) -> torch.Tensor:
        """(H - shift I)^-1 x through the partitioned factorization in
        float64 (factored once per shift)."""
        p = self._p
        key = float(shift)
        if key not in self._factor_cache:
            vals = self._vals[: p.nnzb].clone()
            d = torch.arange(p.bs, device=vals.device)
            vals[: p.n, d, d] -= shift
            L, WU, _, Ls, _ = _factor32(p, vals, vals.new_zeros(p.n + 1, p.bs))
            self._factor_cache[key] = (L, WU, Ls)
        L, WU, Ls = self._factor_cache[key]
        xf = torch.cat([self._to_fine(x), x.new_zeros(1, p.bs)], 0)
        return block_assembly.scatter_dx(self._bp, _solve_with(p, L, WU, Ls, xf))


def sparse_largest_eigenvalues(system, k: int = 6, iters: int = 60, target: int = 64,
                               device="cuda"):
    """k largest-magnitude eigenpairs of the system lambda WITHOUT
    densifying (the reference's largest-magnitude mode at full size)."""
    op = SparseSystemOperator(system, target=target, device=device)
    return _largest(*lanczos_extremal(op.matvec, op.n, k, iters, device=op.device), k)


def sparse_smallest_eigenvalues_shift_invert(system, k: int = 6, shift: float = 0.0,
                                             iters: int = 60, target: int = 64, device="cuda"):
    """k smallest eigenvalues by shift-invert Lanczos through the v3
    factorization (reference Eigenvalues.h:364, block-LDLT shift-invert)."""
    op = SparseSystemOperator(system, target=target, device=device)
    evals_inv, ritz = lanczos_extremal(lambda v: op.solve_shifted(v, shift), op.n, k, iters,
                                       device=op.device)
    return _smallest_inverted(evals_inv, ritz, k, shift)


def sparse_condition_number(system, iters: int = 80, target: int = 64, device="cuda") -> float:
    """Spectral condition estimate on the sparse operator (observability
    analysis at full problem size)."""
    lmax, _ = sparse_largest_eigenvalues(system, 1, iters, target, device)
    lmin, _ = sparse_smallest_eigenvalues_shift_invert(system, 1, 0.0, iters, target, device)
    return _condition(lmax, lmin)
