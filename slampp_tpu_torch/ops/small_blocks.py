"""Unrolled batched Cholesky and triangular solves for tiny SPD blocks
(counterpart of ``slampp_tpu/ops/small_blocks.py``; the role of the
reference's fixed-block-size FBS kernels, include/slam/BlockMatrixFBS.h).

These were XLA element-wise ops in the JAX package, outside any Pallas
kernel, so they stay plain PyTorch here, with the same unrolled arithmetic
in the same order.  ``torch.linalg.cholesky`` is no substitute: with
``clamp`` > 0 a pivot is floored (static pivoting), so a block that is not
numerically positive definite still factors to finite values, and iterative
refinement (core/sparse_chol.py) absorbs the error.
"""

from __future__ import annotations

import torch


def cholesky_small(A: torch.Tensor, clamp: float = 0.0) -> torch.Tensor:
    """Batched lower Cholesky of (..., bs, bs) SPD blocks, unrolled over bs;
    pivots floored at ``clamp`` when it is positive."""
    bs = A.shape[-1]
    L = [[None] * bs for _ in range(bs)]
    for j in range(bs):
        d = A[..., j, j]
        for k in range(j):
            d = d - L[j][k] * L[j][k]
        if clamp > 0.0:
            d = torch.clamp_min(d, clamp)
        Ljj = torch.sqrt(d)
        L[j][j] = Ljj
        inv = 1.0 / Ljj
        for i in range(j + 1, bs):
            v = A[..., i, j]
            for k in range(j):
                v = v - L[i][k] * L[j][k]
            L[i][j] = v * inv
    zero = torch.zeros_like(A[..., 0, 0])
    return torch.stack(
        [torch.stack([L[i][j] if j <= i else zero for j in range(bs)], -1) for i in range(bs)], -2
    )


def cholesky_blocked(A: torch.Tensor, clamp: float = 0.0, blk: int = 8) -> torch.Tensor:
    """Batched lower Cholesky of larger blocks by ``blk``-column panels:
    each diagonal sub-block by the unrolled clamped kernel, the panel below
    it by the unrolled right solve after one batched product update."""
    bs = A.shape[-1]
    if bs <= blk:
        return cholesky_small(A, clamp)
    out = torch.zeros_like(A)
    for j0 in range(0, bs, blk):
        j1 = min(j0 + blk, bs)
        Ajj = A[..., j0:j1, j0:j1]
        if j0 > 0:
            Lleft = out[..., j0:j1, :j0]
            Ajj = Ajj - Lleft @ Lleft.transpose(-1, -2)
        Ljj = cholesky_small(Ajj, clamp)
        out[..., j0:j1, j0:j1] = Ljj
        if j1 < bs:
            W = A[..., j1:, j0:j1]
            if j0 > 0:
                W = W - out[..., j1:, :j0] @ out[..., j0:j1, :j0].transpose(-1, -2)
            out[..., j1:, j0:j1] = solve_triangular_right_transpose_small(W, Ljj)
    return out


def solve_triangular_right_transpose_small(W: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """Batched X = W L^-T for lower-triangular L (X L^T = W), unrolled.
    W: (..., m, bs); L: (..., bs, bs).  Column j of X is
    (W[:, j] - sum_{k<j} X[:, k] L[j, k]) / L[j, j]."""
    bs = L.shape[-1]
    X = []
    for j in range(bs):
        v = W[..., :, j]
        for k in range(j):
            v = v - X[k] * L[..., j, k][..., None]
        X.append(v / L[..., j, j][..., None])
    return torch.stack(X, -1)


def solve_triangular_right_transpose_blocked(W: torch.Tensor, L: torch.Tensor,
                                             blk: int = 8) -> torch.Tensor:
    """Batched X = W L^-T for larger L by column panels (pairs with
    :func:`cholesky_blocked`)."""
    bs = L.shape[-1]
    if bs <= blk:
        return solve_triangular_right_transpose_small(W, L)
    X = torch.zeros_like(W)
    for j0 in range(0, bs, blk):
        j1 = min(j0 + blk, bs)
        Wj = W[..., :, j0:j1]
        if j0 > 0:
            Wj = Wj - X[..., :, :j0] @ L[..., j0:j1, :j0].transpose(-1, -2)
        X[..., :, j0:j1] = solve_triangular_right_transpose_small(Wj, L[..., j0:j1, j0:j1])
    return X


def solve_lower_small(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched y = L^-1 b for lower-triangular L; b: (..., bs)."""
    bs = L.shape[-1]
    y = []
    for i in range(bs):
        v = b[..., i]
        for k in range(i):
            v = v - L[..., i, k] * y[k]
        y.append(v / L[..., i, i])
    return torch.stack(y, -1)


def solve_lower_transpose_small(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched x = L^-T b; b: (..., bs)."""
    bs = L.shape[-1]
    x = [None] * bs
    for i in reversed(range(bs)):
        v = b[..., i]
        for k in range(i + 1, bs):
            v = v - L[..., k, i] * x[k]
        x[i] = v / L[..., i, i]
    return torch.stack(x, -1)


def solve_lower_blocked(L: torch.Tensor, b: torch.Tensor, blk: int = 8) -> torch.Tensor:
    """Batched y = L^-1 b by column panels."""
    bs = L.shape[-1]
    if bs <= blk:
        return solve_lower_small(L, b)
    y = torch.zeros_like(b)
    for j0 in range(0, bs, blk):
        j1 = min(j0 + blk, bs)
        bj = b[..., j0:j1]
        if j0 > 0:
            bj = bj - (L[..., j0:j1, :j0] @ y[..., :j0, None])[..., 0]
        y[..., j0:j1] = solve_lower_small(L[..., j0:j1, j0:j1], bj)
    return y


def solve_lower_transpose_blocked(L: torch.Tensor, b: torch.Tensor, blk: int = 8) -> torch.Tensor:
    """Batched x = L^-T b by column panels, last panel first."""
    bs = L.shape[-1]
    if bs <= blk:
        return solve_lower_transpose_small(L, b)
    x = torch.zeros_like(b)
    starts = list(range(0, bs, blk))
    for j0 in reversed(starts):
        j1 = min(j0 + blk, bs)
        bj = b[..., j0:j1]
        if j1 < bs:
            bj = bj - (L[..., j1:, j0:j1].transpose(-1, -2) @ x[..., j1:, None])[..., 0]
        x[..., j0:j1] = solve_lower_transpose_small(L[..., j0:j1, j0:j1], bj)
    return x


def inverse_spd_small(A: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverse through the unrolled Cholesky (reference
    InverseOf_BlockDiag_FBS_Parallel, BlockMatrix.h:3165)."""
    bs = A.shape[-1]
    L = cholesky_small(A)
    eye = torch.eye(bs, dtype=A.dtype, device=A.device)
    cols = []
    for j in range(bs):
        e = eye[j].expand(A.shape[:-1])
        cols.append(solve_lower_transpose_small(L, solve_lower_small(L, e)))
    return torch.stack(cols, -1)
