"""Recursive sparse marginals on the block factor, block Takahashi
(counterpart of ``slampp_tpu/marginals/sparse_marginals.py``).

Capability parity with the reference's ICRA'15 algorithm
(``Calculate_DenseMarginals_Recurrent_FBS``, include/slam/Marginals.h:1694,
kernel :931): the covariance ONLY on the sparsity pattern of the factor L,
by the block Takahashi recurrences in reverse elimination order:

    W_j        = L[R_j, j] L[j,j]^-1
    Sigma[i,j] = - Sigma[i, R_j] W_j          (i in R_j)
    Sigma[j,j] = L[j,j]^-T L[j,j]^-1 - W_j^T Sigma[R_j, j]

Every Sigma block referenced lives on L's own pattern (the filled graph's
clique property), so Sigma shares the packed (diag | offd) layout of the v2
engine and reuses its machinery: reverse level order, contiguous window
writes, prefix-sum segment reductions, gathers.  As in core/sparse_chol2.py
the levels' exact windows are sliced with host ints, so no overhang padding
is needed.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from slampp_tpu_torch.core.sparse_chol2 import PlanV2, _pad_rows, _segment_bounds, _segsum
from slampp_tpu_torch.ops import small_blocks


class TakahashiPlan(NamedTuple):
    """Per-level recurrence tables (int64 / bool tensors on the v2 plan's
    device, padded as in the JAX package) and each level's triple count."""

    max_tk: int  # max recurrence triples per level
    # triples (grouped by level, sorted by destination offd slot):
    #   Sigma[r1, j] (this level's offd slots) <- sum_r2 Sigma(r1, r2) W(r2, j)
    tk_src_sigma: torch.Tensor  # (n_levels, max_tk) packed Sigma slot id
    tk_src_w: torch.Tensor  # (n_levels, max_tk) LOCAL offd id of W(r2, j)
    tk_transpose: torch.Tensor  # (n_levels, max_tk) bool: use Sigma^T
    tk_starts: torch.Tensor  # (n_levels, max_off)
    tk_ends: torch.Tensor
    # diagonal correction Sigma[j,j] -= W(r,j)^T Sigma[r,j], segments by column
    dg_starts: torch.Tensor  # (n_levels, max_cols) into the level's offd range
    dg_ends: torch.Tensor
    n_tk: Tuple[int, ...]  # triples per level, host ints


def takahashi_plan(plan: PlanV2) -> TakahashiPlan:
    """Host planning from the factor's own pattern (plan.rows / cols)."""
    n, n_off = plan.n, plan.n_off
    rows = plan.rows[n:]
    cols = plan.cols[n:]
    slot_of = {}
    col_rows: List[List[int]] = [[] for _ in range(n)]
    for k in range(n_off):
        i, j = int(rows[k]), int(cols[k])
        slot_of[(i, j)] = k
        col_rows[j].append(i)

    sig, wl, tr, tk_st, tk_en, dg_st, dg_en = [], [], [], [], [], [], []
    for cs, nc, os_, no, *_ in plan.levels:
        triples = []  # (dst local, sigma slot, w local, transpose)
        for si in range(no):
            j, r1 = int(cols[os_ + si]), int(rows[os_ + si])
            for r2 in col_rows[j]:
                w_local = slot_of[(r2, j)] - os_
                if r1 == r2:
                    triples.append((si, r2, w_local, False))  # diag Sigma slot = column
                elif (r1, r2) in slot_of:
                    triples.append((si, n + slot_of[(r1, r2)], w_local, False))
                else:
                    triples.append((si, n + slot_of[(r2, r1)], w_local, True))
        triples.sort(key=lambda t: t[0])
        sig.append(np.array([t[1] for t in triples], np.int64))
        wl.append(np.array([t[2] for t in triples], np.int64))
        tr.append(np.array([t[3] for t in triples], bool))
        st, en = _segment_bounds([t[0] for t in triples], no, 0)
        tk_st.append(st)
        tk_en.append(en)
        # diagonal segments: the level's offd slots grouped by column
        st, en = _segment_bounds(cols[os_ : os_ + no], nc, cs)
        dg_st.append(st)
        dg_en.append(en)

    max_tk = max(1, max((len(r) for r in sig), default=1))
    dev = plan.device

    def pad(rows_, width, fill):
        return torch.as_tensor(_pad_rows(rows_, width, fill), device=dev)

    return TakahashiPlan(
        max_tk=max_tk,
        tk_src_sigma=pad(sig, max_tk, n + n_off),
        tk_src_w=pad(wl, max_tk, plan.max_off),
        tk_transpose=pad(tr, max_tk, 0).bool(),
        tk_starts=pad(tk_st, plan.max_off, 0),
        tk_ends=pad(tk_en, plan.max_off, 0),
        dg_starts=pad(dg_st, plan.max_cols, 0),
        dg_ends=pad(dg_en, plan.max_cols, 0),
        n_tk=tuple(len(r) for r in sig),
    )


def sparse_marginals(plan: PlanV2, tk: TakahashiPlan, Ld: torch.Tensor, Loff: torch.Tensor):
    """Covariance blocks on the factor pattern, from :func:`factorize2`'s
    output.  Returns (Sigma_diag (n, P, P) full symmetric blocks, Sigma_off
    (n_off, P, P) blocks at the L pattern positions)."""
    n, n_off, P = plan.n, plan.n_off, Ld.shape[-1]
    S = Ld.new_zeros(n + n_off, P, P)  # packed [diag | offd]
    for lv in reversed(range(plan.n_levels)):
        cs, nc, os_, no = plan.levels[lv][:4]
        ntk = tk.n_tk[lv]
        Lw = Ld[cs : cs + nc]
        # Sigma[j, j] = Ljj^-T Ljj^-1 - W^T Sigma[R_j, j]
        Linv = _lower_inverse(Lw)
        Sdiag = torch.einsum("cji,cjk->cik", Linv, Linv)
        if no:
            # W = L[R_j, j] Ljj^-1, then Sigma[r1, j] = -sum_r2 Sigma(r1, r2) W(r2, j)
            W = _solve_right_lower(Loff[os_ : os_ + no], Lw[plan.off_colpos[lv, :no]])
            src = S[tk.tk_src_sigma[lv, :ntk]]
            src = torch.where(tk.tk_transpose[lv, :ntk, None, None], src.transpose(1, 2), src)
            prod = -(src @ W[tk.tk_src_w[lv, :ntk]])
            Soff = _segsum(prod, tk.tk_starts[lv, :no], tk.tk_ends[lv, :no])
            S[n + os_ : n + os_ + no] = Soff
            corr = torch.einsum("eji,ejk->eik", W, Soff)
            Sdiag = Sdiag - _segsum(corr, tk.dg_starts[lv, :nc], tk.dg_ends[lv, :nc])
        S[cs : cs + nc] = Sdiag
    return S[:n], S[n:]


def _solve_right_lower(B: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """Batched X = B L^-1 for lower-triangular L, unrolled: X L = B gives,
    last column first, X[:, j] = (B[:, j] - sum_{k>j} X[:, k] L[k, j]) / L[j, j]."""
    bs = L.shape[-1]
    X = [None] * bs
    for j in reversed(range(bs)):
        v = B[..., :, j]
        for k in range(j + 1, bs):
            v = v - X[k] * L[..., k, j][..., None]
        X[j] = v / L[..., j, j][..., None]
    return torch.stack(X, -1)


def _lower_inverse(L: torch.Tensor) -> torch.Tensor:
    """Batched inverse of lower-triangular blocks (the columns of I solved)."""
    bs = L.shape[-1]
    eye = torch.eye(bs, dtype=L.dtype, device=L.device)
    return torch.stack([small_blocks.solve_lower_blocked(L, eye[j].expand(L.shape[:-1]))
                        for j in range(bs)], -1)
