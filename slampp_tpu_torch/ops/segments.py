"""Grouped (padded-gather) segment reductions (counterpart of
``slampp_tpu/ops/segments.py``).

The host lays sorted segments out as (groups, cap) index rows, bucketed by
segment size so padding stays below ``bucket_base``x; the device does
gather + sum.  The summation order is fixed by the plan, so results are
deterministic run to run — unlike ``index_add_``, whose atomics sum in a
varying order on the card.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch


class GroupBucket(NamedTuple):
    seg_ids: torch.Tensor  # (G,) int64 segment index per group row
    idx: torch.Tensor  # (G, cap) int64 element indices (m = dummy/pad)


class GroupedSegments(NamedTuple):
    """Bucketed padded-group layout of sorted segments."""

    m: int  # total elements (dummy element at index m)
    n_seg: int
    buckets: Tuple[GroupBucket, ...]

    def to(self, device) -> "GroupedSegments":
        return GroupedSegments(
            self.m, self.n_seg,
            tuple(GroupBucket(b.seg_ids.to(device), b.idx.to(device)) for b in self.buckets),
        )


def plan_grouped_segments(
    starts: np.ndarray, ends: np.ndarray, m: int, bucket_base: int = 4,
    min_cap: int = 4, remap: np.ndarray = None,
) -> GroupedSegments:
    """Host planner: segment [starts[g], ends[g]) -> padded index rows.

    Empty segments are skipped (their sum is zero).  ``remap`` (length m+1,
    entry m = the dummy) relabels the index rows on the host."""
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    sizes = ends - starts
    if remap is not None:
        remap = np.asarray(remap, np.int64)
    buckets: List[GroupBucket] = []
    cap = min_cap
    remaining = np.flatnonzero(sizes > 0)
    while len(remaining):
        in_b = remaining[sizes[remaining] <= cap]
        remaining = remaining[sizes[remaining] > cap]
        if len(in_b):
            idx = np.full((len(in_b), cap), m, np.int64)
            rng = np.arange(cap)[None, :]
            cand = starts[in_b][:, None] + rng
            mask = rng < sizes[in_b][:, None]
            idx[mask] = cand[mask]
            if remap is not None:
                idx = remap[idx]
            buckets.append(GroupBucket(torch.from_numpy(in_b), torch.from_numpy(idx)))
        cap *= bucket_base
    return GroupedSegments(m=m, n_seg=len(starts), buckets=tuple(buckets))


def grouped_segsum_last(data: torch.Tensor, plan: GroupedSegments) -> torch.Tensor:
    """Segment sums over the LAST axis: data (..., m) -> (..., n_seg)."""
    lead = data.shape[:-1]
    dp = torch.cat([data, data.new_zeros(lead + (1,))], -1)
    out = data.new_zeros(lead + (plan.n_seg,))
    for b in plan.buckets:
        G, cap = b.idx.shape
        out[..., b.seg_ids] = dp[..., b.idx.reshape(-1)].reshape(lead + (G, cap)).sum(-1)
    return out


def grouped_segsum_first(data: torch.Tensor, plan: GroupedSegments) -> torch.Tensor:
    """Segment sums over the FIRST axis: data (m, ...) -> (n_seg, ...)."""
    trail = data.shape[1:]
    dp = torch.cat([data, data.new_zeros((1,) + trail)], 0)
    out = data.new_zeros((plan.n_seg,) + trail)
    for b in plan.buckets:
        G, cap = b.idx.shape
        out[b.seg_ids] = dp[b.idx.reshape(-1)].reshape((G, cap) + trail).sum(1)
    return out
