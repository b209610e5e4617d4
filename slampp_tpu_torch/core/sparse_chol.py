"""Block-sparse Cholesky on the device: numeric factorization, triangular
solves, the symmetric product and the mixed-precision refined solve
(counterpart of ``slampp_tpu/core/sparse_chol.py``, the v1 engine;
reference CUberBlockMatrix::CholeskyOf, src/slam/BlockMatrix.cpp:9547, and
the block triangular solves, BlockMatrix.h:3284-3580).

The host plan (core/symbolic.py) levels the elimination tree.  Each level
then runs, as batched ops: (a) all its pending outer-product updates as one
batched product and one scatter-add, (b) all its diagonal factorizations
with the unrolled clamped kernels (ops/small_blocks.py), (c) all its column
solves.  The JAX package scanned the padded levels with ``lax.scan``; here
a Python loop on the host walks them and launches each level's ops, with
no read back to the host.

These were XLA ops in the JAX package, outside any Pallas kernel, so they
stay plain PyTorch.

Padding convention as in the JAX package: slot ``nnzb`` is a dummy block
kept equal to I (so that padded factorizations and solves stay finite), and
block row ``n`` is a dummy right-hand-side row.  Scatter-adds use
``index_add_`` (repeated destinations sum); scatter-sets whose padding
points at the dummy slot write it, and it is reset to I after each level.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slampp_tpu_torch.ops import small_blocks


class DevicePlan(NamedTuple):
    """A :class:`~slampp_tpu_torch.core.symbolic.CholeskyPlan`'s index
    arrays as int64 tensors; the per-level arrays are (n_levels, width)."""

    n: int
    nnzb: int
    diag_slot: torch.Tensor
    rows: torch.Tensor  # (nnzb,) block row of each slot
    cols: torch.Tensor  # (nnzb,) block column of each slot
    upd_dst: torch.Tensor
    upd_a: torch.Tensor
    upd_b: torch.Tensor
    lvl_diag: torch.Tensor
    lvl_offd: torch.Tensor
    lvl_offd_diag: torch.Tensor
    fwd_slot: torch.Tensor
    fwd_src: torch.Tensor
    fwd_dst: torch.Tensor
    lvl_cols: torch.Tensor
    bwd_slot: torch.Tensor
    bwd_src: torch.Tensor
    bwd_dst: torch.Tensor

    @property
    def n_levels(self) -> int:
        return self.lvl_diag.shape[0]

    def to(self, device) -> "DevicePlan":
        return self._replace(**{k: v.to(device) for k, v in self._asdict().items()
                                if isinstance(v, torch.Tensor)})


def device_plan(plan, device="cuda") -> DevicePlan:
    """The plan's arrays on ``device``."""
    return DevicePlan(
        n=int(plan.n), nnzb=int(plan.nnzb),
        **{k: torch.as_tensor(np.asarray(getattr(plan, k), np.int64), device=device)
           for k in DevicePlan._fields[2:]},
    )


def _eye(bs: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(bs, dtype=like.dtype, device=like.device)


def factorize(dp: DevicePlan, vals: torch.Tensor, clamp: float = 0.0) -> torch.Tensor:
    """Numeric block Cholesky.  ``vals``: (nnzb, bs, bs), the lower blocks of
    A in the L slot structure (fill slots zero).  Returns the L blocks in the
    same layout.  ``clamp`` > 0 floors the pivots (static pivoting for
    low-precision factors)."""
    bs = vals.shape[-1]
    eye = _eye(bs, vals)
    vals = torch.cat([vals, eye[None]], 0)  # dummy slot = I
    for lv in range(dp.n_levels):
        # (a) pending outer-product updates: dst -= A B^T
        upd_dst = dp.upd_dst[lv]
        upd = vals[dp.upd_a[lv]] @ vals[dp.upd_b[lv]].transpose(1, 2)
        mask = (upd_dst < dp.nnzb)[:, None, None]
        vals.index_add_(0, upd_dst, torch.where(mask, -upd, 0.0))
        # (b) diagonal factorization: unrolled clamped kernels, lower
        # triangle read only
        lvl_diag = dp.lvl_diag[lv]
        D = torch.where((lvl_diag < dp.nnzb)[:, None, None], vals[lvl_diag], eye)
        vals[lvl_diag] = small_blocks.cholesky_blocked(D, clamp=clamp)
        # (c) column solve: L[i, j] = W[i, j] Lj^-T
        offd_diag = dp.lvl_offd_diag[lv]
        Dj = torch.where((offd_diag < dp.nnzb)[:, None, None], vals[offd_diag], eye)
        lvl_offd = dp.lvl_offd[lv]
        vals[lvl_offd] = small_blocks.solve_triangular_right_transpose_blocked(
            vals[lvl_offd], Dj)
        vals[dp.nnzb] = eye  # keep the dummy slot = I
    return vals[:-1]


def solve(dp: DevicePlan, Lvals: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L L^T x = b given :func:`factorize`'s output; b: (n, bs)
    (reference UpperTriangularTranspose_Solve / UpperTriangular_Solve,
    BlockMatrix.h:3454, :3528, by level)."""
    bs = b.shape[-1]
    Lp = torch.cat([Lvals, _eye(bs, Lvals)[None]], 0)
    y = torch.cat([b, b.new_zeros(1, bs)], 0)  # dummy row n
    diag_for_col = torch.cat([dp.diag_slot, dp.diag_slot.new_full((1,), dp.nnzb)])

    # forward: y_j = Lj^-1 (b_j - sum_k L[j, k] y_k), level by level
    for lv in range(dp.n_levels):
        dsts = dp.fwd_dst[lv]
        contrib = torch.einsum("eij,ej->ei", Lp[dp.fwd_slot[lv]], y[dp.fwd_src[lv]])
        y.index_add_(0, dsts, torch.where((dsts < dp.n)[:, None], -contrib, 0.0))
        cs = dp.lvl_cols[lv]  # padding is the dummy row n
        y[cs] = small_blocks.solve_lower_blocked(Lp[diag_for_col[cs]], y[cs])

    # backward: x_j = Lj^-T (y_j - sum_{i>j} L[i, j]^T x_i).  The entries
    # (i, j) are grouped by level(j) and their sources x_i sit at higher
    # levels, so in descending level order each column subtracts its
    # incoming terms, then solves
    x = y
    for lv in reversed(range(dp.n_levels)):
        dsts = dp.bwd_dst[lv]
        contrib = torch.einsum("eji,ej->ei", Lp[dp.bwd_slot[lv]], x[dp.bwd_src[lv]])
        x.index_add_(0, dsts, torch.where((dsts < dp.n)[:, None], -contrib, 0.0))
        cs = dp.lvl_cols[lv]
        x[cs] = small_blocks.solve_lower_transpose_blocked(Lp[diag_for_col[cs]], x[cs])
    return x[:-1]


def spmv_symmetric(dp: DevicePlan, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x for the symmetric block matrix whose lower blocks are packed in
    ``vals`` (the A layout, before factorization); the diagonal blocks are
    symmetrized from their lower triangle."""
    bs = x.shape[-1]
    D = vals[dp.diag_slot]
    Dlow = torch.tril(D, -1)
    Dsym = Dlow + Dlow.transpose(1, 2) + _eye(bs, vals) * D
    y = torch.einsum("nij,nj->ni", Dsym, x)
    # off-diagonal blocks: y[r] += B x[c]; y[c] += B^T x[r]
    B = torch.where((dp.rows != dp.cols)[:, None, None], vals, 0.0)
    y.index_add_(0, dp.rows, torch.einsum("eij,ej->ei", B, x[dp.cols]))
    y.index_add_(0, dp.cols, torch.einsum("eji,ej->ei", B, x[dp.rows]))
    return y


def solve_refined(dp: DevicePlan, vals64: torch.Tensor, b64: torch.Tensor,
                  refine_iters: int = 2, damping_rel: float = 1e-6) -> torch.Tensor:
    """Mixed-precision solve: Jacobi-equilibrated float32 factorization with
    static relative damping and clamped pivots (clamp 1e-8), then float64
    iterative refinement against the exact operator."""
    bs = vals64.shape[-1]
    d = torch.arange(bs, device=vals64.device)
    s = 1.0 / torch.sqrt(torch.clamp_min(vals64[dp.diag_slot][:, d, d], 1e-30))  # (n, bs)
    vals_s = vals64 * s[dp.rows][:, :, None] * s[dp.cols][:, None, :]
    vals_s[dp.diag_slot[:, None], d[None, :], d[None, :]] += damping_rel
    L32 = factorize(dp, vals_s.float(), clamp=1e-8)

    def solve32(r64):
        return s * solve(dp, L32, (s * r64).float()).double()

    x = solve32(b64)
    for _ in range(refine_iters):
        x = x + solve32(b64 - spmv_symmetric(dp, vals64, x))
    return x
