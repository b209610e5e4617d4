"""Scatter-free level-windowed block Cholesky, the v2 engine (counterpart of
``slampp_tpu/core/sparse_chol2.py``).

The v1 engine (core/sparse_chol.py) reduces its updates with scatter-adds.
v2 has none in the numeric phase, by construction:

  * block columns are renumbered so each elimination-tree level occupies a
    CONTIGUOUS range (legal: same-level columns are mutually independent);
  * diagonal blocks live in their own (n, P, P) array indexed by column;
    off-diagonal L slots are grouped by level, sorted by (column, row);
  * per level, all writes go to contiguous windows;
  * conflicting update contributions are reduced with SORTED segment sums,
    computed as differences of a prefix sum (cumsum);
  * reads are gathers.

The same schedule drives the forward and backward triangular solves.  Host
planning lives in :func:`plan_v2`; the device functions are
:func:`factorize2`, :func:`solve2`, :func:`spmv2` and the mixed-precision
:func:`solve_refined2` (equilibration, clamped float32 factor, float64
iterative refinement, as in v1).  Reference: the blockwise Cholesky of
BlockMatrix.cpp:9547.

These were XLA ops in the JAX package, outside any Pallas kernel, so they
stay plain PyTorch; the small-block arithmetic is ops/small_blocks.py.  The
JAX package scanned padded level windows with ``lax.scan``; here a Python
loop walks the levels with the plan's host ints and slices each level's
exact windows ``[cs, cs + nc)`` and ``[os, os + no)``, so no window runs
past an array's end and no padding is needed.  The loop reads nothing back
from the device, so it can be captured in a CUDA graph
(linear/native.py ``optimize_fused``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from slampp_tpu_torch.core import symbolic
from slampp_tpu_torch.ops import small_blocks


class PlanV2(NamedTuple):
    """The v2 schedule.  Per-level index tables are int64 tensors on the
    plan's device, padded as in the JAX package; ``levels`` holds each
    level's window and table lengths as host ints for the loop."""

    # static sizes
    n: int  # block columns
    n_off: int  # off-diagonal L slots
    n_levels: int
    max_cols: int  # max columns per level
    max_off: int  # max off-diagonal slots per level
    max_ud: int  # max diag-destination update sources per level
    max_uo: int  # max offd-destination update sources per level
    max_fw: int  # max forward-solve sources per level
    # host outputs for the caller
    col_order: np.ndarray  # (n,) col_order[new] = old (permuted) column
    slot_of: dict  # (i, j) -> packed slot id (diag j -> j; offd -> n + k)
    diag_slot: np.ndarray  # (n,) = arange(n)
    rows: np.ndarray  # (n + n_off,) block row of each packed slot
    cols: np.ndarray  # (n + n_off,) block column
    # host per-level windows (the JAX package's device arrays)
    lvl_col_start: np.ndarray  # (n_levels,)
    lvl_ncols: np.ndarray
    lvl_off_start: np.ndarray
    lvl_noff: np.ndarray
    # device tables, (n_levels, width); update sources with diagonal
    # destinations (sorted by destination column) and with off-diagonal
    # destinations (sorted by destination slot), as LOCAL offd ids
    ud_a: torch.Tensor  # offd slot of L[i, k]
    ud_b: torch.Tensor  # offd slot of L[j, k]
    ud_starts: torch.Tensor  # (n_levels, max_cols) segment starts into the cumsum
    ud_ends: torch.Tensor
    uo_a: torch.Tensor
    uo_b: torch.Tensor
    uo_starts: torch.Tensor  # (n_levels, max_off)
    uo_ends: torch.Tensor
    off_colpos: torch.Tensor  # (n_levels, max_off) column position of each offd slot in its level
    fw_slot: torch.Tensor  # forward solve: offd slot, grouped by destination column
    fw_src: torch.Tensor  # source block column k
    fw_starts: torch.Tensor  # (n_levels, max_cols)
    fw_ends: torch.Tensor
    bw_row: torch.Tensor  # (n_levels, max_off) block row i of each offd slot
    bw_starts: torch.Tensor  # (n_levels, max_cols) segments over the level's offd slots
    bw_ends: torch.Tensor
    # the loop's host ints per level: (cs, nc, os, no, n_ud, n_uo, n_fw)
    levels: Tuple[Tuple[int, ...], ...]
    off_rows: torch.Tensor  # (n_off,) block row of each offd slot, on the device
    off_cols: torch.Tensor  # (n_off,) block column

    @property
    def device(self) -> torch.device:
        return self.ud_a.device


def _pad_rows(rows: List[np.ndarray], width: int, fill: int) -> np.ndarray:
    out = np.full((len(rows), width), fill, np.int64)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def _segment_bounds(keys, count: int, first: int):
    """[start, end) of the runs of ``keys`` (sorted) equal to first,
    first + 1, ..., first + count - 1."""
    st = np.zeros(count, np.int64)
    en = np.zeros(count, np.int64)
    pos = 0
    for ci in range(count):
        st[ci] = pos
        while pos < len(keys) and keys[pos] == first + ci:
            pos += 1
        en[ci] = pos
    return st, en


def plan_v2(n: int, pairs: Sequence[Tuple[int, int]], device="cuda") -> PlanV2:
    """Build the v2 plan on the host and move its tables to ``device`` once.
    ``pairs`` are off-diagonal block pairs in the PERMUTED (post-ordering)
    numbering; plan_v2 further renumbers columns so levels are contiguous
    and returns that refinement in ``col_order`` (col_order[new] = old
    position)."""
    pattern, parent, level = symbolic.analyze(n, pairs)
    n_levels = int(level.max()) + 1 if n else 1

    # level-contiguous renumbering (stable within a level)
    order = sorted(range(n), key=lambda j: (level[j], j))  # new -> old
    new_of = np.empty(n, np.int64)
    new_of[np.asarray(order, np.int64)] = np.arange(n)
    pat_new: List[set] = [set() for _ in range(n)]
    level_new = np.zeros(n, np.int64)
    for j in range(n):
        pat_new[new_of[j]] = {int(new_of[i]) for i in pattern[j]}
        level_new[new_of[j]] = level[j]

    cols_by_level: List[List[int]] = [[] for _ in range(n_levels)]
    for j in range(n):
        cols_by_level[int(level_new[j])].append(j)
    for cl in cols_by_level:  # contiguity invariant
        assert not cl or cl[-1] - cl[0] == len(cl) - 1

    # off-diagonal slots grouped by level, sorted by (column, row)
    slot_of = {}
    rows_l: List[int] = []
    cols_l: List[int] = []
    off_start = np.zeros(n_levels, np.int64)
    off_count = np.zeros(n_levels, np.int64)
    for lv in range(n_levels):
        off_start[lv] = len(rows_l)
        for j in cols_by_level[lv]:
            slot_of[(j, j)] = j
            for i in sorted(pat_new[j]):
                slot_of[(i, j)] = n + len(rows_l)
                rows_l.append(i)
                cols_l.append(j)
        off_count[lv] = len(rows_l) - off_start[lv]
    n_off = len(rows_l)
    col_start = np.array([cl[0] if cl else n for cl in cols_by_level], np.int64)
    ncols = np.array([len(cl) for cl in cols_by_level], np.int64)

    # update triples grouped by the level of their destination column,
    # split by diagonal / off-diagonal destination.  For column k, for j in
    # pattern(k), for i in pattern(k) with i >= j: destination (i, j),
    # sources L[i, k] and L[j, k] (both offd slots of column k)
    ud_by_level: List[list] = [[] for _ in range(n_levels)]  # (dst col, a, b)
    uo_by_level: List[list] = [[] for _ in range(n_levels)]  # (dst slot, a, b)
    for k in range(n):
        pk = sorted(pat_new[k])
        for ji, j in enumerate(pk):
            lv = int(level_new[j])
            sb = slot_of[(j, k)] - n
            for i in pk[ji:]:
                sa = slot_of[(i, k)] - n
                if i == j:
                    ud_by_level[lv].append((j, sa, sb))
                else:
                    uo_by_level[lv].append((slot_of[(i, j)] - n, sa, sb))

    ud_a, ud_b, ud_st, ud_en = [], [], [], []
    uo_a, uo_b, uo_st, uo_en = [], [], [], []
    off_colpos, bw_row, bw_st, bw_en = [], [], [], []
    for lv in range(n_levels):
        cs, nc, os_, no = int(col_start[lv]), int(ncols[lv]), int(off_start[lv]), int(off_count[lv])
        ud = sorted(ud_by_level[lv])
        ud_a.append(np.array([a for _, a, _ in ud], np.int64))
        ud_b.append(np.array([b for _, _, b in ud], np.int64))
        st, en = _segment_bounds([d for d, _, _ in ud], nc, cs)
        ud_st.append(st)
        ud_en.append(en)
        uo = sorted(uo_by_level[lv])
        uo_a.append(np.array([a for _, a, _ in uo], np.int64))
        uo_b.append(np.array([b for _, _, b in uo], np.int64))
        st, en = _segment_bounds([d for d, _, _ in uo], no, os_)
        uo_st.append(st)
        uo_en.append(en)
        # offd local column positions (the column solves' Lj gather) and the
        # backward solve's row sources, segmented by column
        cp = np.array([cols_l[g] - cs for g in range(os_, os_ + no)], np.int64)
        off_colpos.append(cp)
        bw_row.append(np.array(rows_l[os_ : os_ + no], np.int64))
        st, en = _segment_bounds(cp, nc, 0)
        bw_st.append(st)
        bw_en.append(en)

    # forward solve: entries (i, k) grouped by level(i), sorted by i
    fw_by_level: List[list] = [[] for _ in range(n_levels)]
    for k in range(n):
        for i in pat_new[k]:
            fw_by_level[int(level_new[i])].append((i, slot_of[(i, k)] - n, k))
    fw_slot, fw_src, fw_st, fw_en = [], [], [], []
    for lv in range(n_levels):
        fw = sorted(fw_by_level[lv])
        fw_slot.append(np.array([s for _, s, _ in fw], np.int64))
        fw_src.append(np.array([k for _, _, k in fw], np.int64))
        st, en = _segment_bounds([i for i, _, _ in fw], int(ncols[lv]), int(col_start[lv]))
        fw_st.append(st)
        fw_en.append(en)

    max_cols = max(1, int(ncols.max()) if n else 1)
    max_off = max(1, int(off_count.max()) if n_levels else 1)
    max_ud = max(1, max((len(r) for r in ud_a), default=1))
    max_uo = max(1, max((len(r) for r in uo_a), default=1))
    max_fw = max(1, max((len(r) for r in fw_slot), default=1))

    rows_arr = np.concatenate([np.arange(n), np.asarray(rows_l, np.int64)])
    cols_arr = np.concatenate([np.arange(n), np.asarray(cols_l, np.int64)])

    def dev(a, width, fill):
        return torch.as_tensor(_pad_rows(a, width, fill), device=device)

    levels = tuple(
        (int(col_start[lv]), int(ncols[lv]), int(off_start[lv]), int(off_count[lv]),
         len(ud_a[lv]), len(uo_a[lv]), len(fw_slot[lv]))
        for lv in range(n_levels)
    )
    return PlanV2(
        n=n, n_off=n_off, n_levels=n_levels, max_cols=max_cols, max_off=max_off,
        max_ud=max_ud, max_uo=max_uo, max_fw=max_fw,
        col_order=np.asarray(order, np.int64), slot_of=slot_of,
        diag_slot=np.arange(n, dtype=np.int64), rows=rows_arr, cols=cols_arr,
        lvl_col_start=col_start, lvl_ncols=ncols, lvl_off_start=off_start,
        lvl_noff=off_count,
        ud_a=dev(ud_a, max_ud, n_off), ud_b=dev(ud_b, max_ud, n_off),
        ud_starts=dev(ud_st, max_cols, 0), ud_ends=dev(ud_en, max_cols, 0),
        uo_a=dev(uo_a, max_uo, n_off), uo_b=dev(uo_b, max_uo, n_off),
        uo_starts=dev(uo_st, max_off, 0), uo_ends=dev(uo_en, max_off, 0),
        off_colpos=dev(off_colpos, max_off, 0),
        fw_slot=dev(fw_slot, max_fw, n_off), fw_src=dev(fw_src, max_fw, n),
        fw_starts=dev(fw_st, max_cols, 0), fw_ends=dev(fw_en, max_cols, 0),
        bw_row=dev(bw_row, max_off, n),
        bw_starts=dev(bw_st, max_cols, 0), bw_ends=dev(bw_en, max_cols, 0),
        levels=levels,
        off_rows=torch.as_tensor(rows_arr[n:], device=device),
        off_cols=torch.as_tensor(cols_arr[n:], device=device),
    )


def _segsum(terms: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Segment sums of ``terms`` (sorted by segment) as differences of its
    exclusive prefix sum: sums[s] = cum0[ends[s]] - cum0[starts[s]] (empty
    segments give 0)."""
    cum0 = torch.cat([terms.new_zeros((1,) + terms.shape[1:]), torch.cumsum(terms, 0)], 0)
    return cum0[ends] - cum0[starts]


def factorize2(plan: PlanV2, Dvals: torch.Tensor, OffVals: torch.Tensor,
               clamp: float = 0.0):
    """Numeric factorization of the assembled lambda blocks (Dvals (n, P, P)
    diagonal panels, lower triangle read; OffVals (n_off, P, P)).  Returns
    (Ld, Loff) in the same layout; ``clamp`` > 0 floors the pivots."""
    D = Dvals.clone()
    O = OffVals.clone()
    for lv, (cs, nc, os_, no, nud, nuo, _) in enumerate(plan.levels):
        # updates with diagonal destinations, then the level's diagonal
        # panels factored as one batch
        win = D[cs : cs + nc]
        if nud:
            upd = O[plan.ud_a[lv, :nud]] @ O[plan.ud_b[lv, :nud]].transpose(1, 2)
            win = win - _segsum(upd, plan.ud_starts[lv, :nc], plan.ud_ends[lv, :nc])
        Lj = small_blocks.cholesky_blocked(win, clamp=clamp)
        D[cs : cs + nc] = Lj
        if not no:
            continue
        # updates with off-diagonal destinations, then the column solves
        # L[i, j] = W[i, j] Lj^-T
        wo = O[os_ : os_ + no]
        if nuo:
            upd = O[plan.uo_a[lv, :nuo]] @ O[plan.uo_b[lv, :nuo]].transpose(1, 2)
            wo = wo - _segsum(upd, plan.uo_starts[lv, :no], plan.uo_ends[lv, :no])
        O[os_ : os_ + no] = small_blocks.solve_triangular_right_transpose_blocked(
            wo, Lj[plan.off_colpos[lv, :no]])
    return D, O


def solve2(plan: PlanV2, Ld: torch.Tensor, Loff: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L L^T x = b with :func:`factorize2`'s output; b: (n, P)."""
    y = b.clone()
    # forward: y_j = Lj^-1 (b_j - sum_k L[j, k] y_k), level by level
    for lv, (cs, nc, _, _, _, _, nfw) in enumerate(plan.levels):
        win = y[cs : cs + nc]
        if nfw:
            contrib = torch.einsum("eij,ej->ei", Loff[plan.fw_slot[lv, :nfw]],
                                   y[plan.fw_src[lv, :nfw]])
            win = win - _segsum(contrib, plan.fw_starts[lv, :nc], plan.fw_ends[lv, :nc])
        y[cs : cs + nc] = small_blocks.solve_lower_blocked(Ld[cs : cs + nc], win)
    # backward: x_j = Lj^-T (y_j - sum_{i>j} L[i, j]^T x_i); the sources x_i
    # sit at higher levels, so descending level order has them ready
    x = y
    for lv in reversed(range(plan.n_levels)):
        cs, nc, os_, no = plan.levels[lv][:4]
        win = x[cs : cs + nc]
        if no:
            contrib = torch.einsum("eji,ej->ei", Loff[os_ : os_ + no], x[plan.bw_row[lv, :no]])
            win = win - _segsum(contrib, plan.bw_starts[lv, :nc], plan.bw_ends[lv, :nc])
        x[cs : cs + nc] = small_blocks.solve_lower_transpose_blocked(Ld[cs : cs + nc], win)
    return x


def spmv2(plan: PlanV2, Dvals: torch.Tensor, OffVals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x on the packed v2 layout (symmetric; lower triangle stored)."""
    P = x.shape[-1]
    Dlow = torch.tril(Dvals, -1)
    Dsym = Dlow + Dlow.transpose(1, 2) + torch.eye(P, dtype=Dvals.dtype, device=Dvals.device) * Dvals
    y = torch.einsum("nij,nj->ni", Dsym, x)
    y.index_add_(0, plan.off_rows, torch.einsum("eij,ej->ei", OffVals, x[plan.off_cols]))
    y.index_add_(0, plan.off_cols, torch.einsum("eji,ej->ei", OffVals, x[plan.off_rows]))
    return y


def solve_refined2(plan: PlanV2, Dvals64: torch.Tensor, OffVals64: torch.Tensor,
                   b64: torch.Tensor, refine_iters: int = 1,
                   damping_rel: float = 1e-6) -> torch.Tensor:
    """Mixed-precision v2 solve: Jacobi equilibration, float32 factor with
    static relative damping and pivots clamped at 1e-8, float64 iterative
    refinement against the exact operator (core/sparse_chol.solve_refined)."""
    P = Dvals64.shape[-1]
    d = torch.arange(P, device=Dvals64.device)
    s = 1.0 / torch.sqrt(torch.clamp_min(Dvals64[:, d, d], 1e-30))  # (n, P)
    Ds = Dvals64 * s[:, :, None] * s[:, None, :]
    Os = OffVals64 * s[plan.off_rows][:, :, None] * s[plan.off_cols][:, None, :]
    Ds[:, d, d] += damping_rel
    Ld, Lo = factorize2(plan, Ds.float(), Os.float(), clamp=1e-8)

    def solve32(r64):
        return s * solve2(plan, Ld, Lo, (s * r64).float()).double()

    x = solve32(b64)
    for _ in range(refine_iters):
        x = x + solve32(b64 - spmv2(plan, Dvals64, OffVals64, x))
    return x
