"""Graph partitioning for the partitioned dense-core (v3) linear solver.

Host-only NumPy; a copy of ``slampp_tpu/core/partition.py`` (which imports
no JAX itself, but lives in a package that does).

Splits the fine block graph into K parts + one global separator such that no
edge couples interiors of two different parts.  Part interiors are then
eliminated as independent dense frames (batched on the MXU) and the separator
solves as one dense Schur-complement core — the "Schur-eliminate everything
sparse into a dense core" design SURVEY.md §7 sanctions for TPU, generalizing
the reference's Schur solver (include/slam/LinearSolver_Schur.h:1424) from
{cameras, landmarks} to {separator, part interiors}.

Two strategies:

* :func:`interval_partition` — contiguous index chunks of the (trajectory-
  ordered) block sequence; the separator is chunk boundaries plus a greedy
  vertex cover of the remaining crossing edges.  Ideal for SLAM trajectories
  (odometry chains + sparse loop closures), deterministic and O(E).
* fallback inside :func:`partition_graph`: if the interval separator exceeds
  ``max_sep_frac`` the graph is not chain-like; callers should use the level-
  scheduled (v2) engine instead.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Partition:
    """Host-side partition description (fine block indices)."""

    parts: List[np.ndarray]  # interior block ids per part
    separator: np.ndarray  # separator block ids (sorted)
    boundary: List[np.ndarray]  # per part: separator ids adjacent to interior
    n: int

    @property
    def K(self) -> int:
        return len(self.parts)

    @property
    def max_interior(self) -> int:
        return max((len(p) for p in self.parts), default=0)

    @property
    def max_boundary(self) -> int:
        return max((len(b) for b in self.boundary), default=0)


def interval_partition(
    n: int, pairs: Sequence[Tuple[int, int]], target: int = 64
) -> Partition:
    """Partition blocks 0..n-1 into contiguous chunks of ~``target`` and a
    separator that covers every chunk-crossing edge.

    Cover construction: a chunk's LAST block joins the separator (severing
    the odometry chain), then remaining crossing edges (loop closures) are
    covered greedily by the endpoint that covers the most uncovered crossers.
    """
    n_parts = max(1, (n + target - 1) // target)
    bounds = np.linspace(0, n, n_parts + 1).astype(np.int64)
    chunk_of = np.zeros(n, np.int64)
    for k in range(n_parts):
        chunk_of[bounds[k] : bounds[k + 1]] = k

    sep = set()
    # chain-severing: last element of each chunk except the final one
    for k in range(n_parts - 1):
        sep.add(int(bounds[k + 1] - 1))

    return _finish_partition(n, pairs, chunk_of, sep)


def bfs_partition(
    n: int, pairs: Sequence[Tuple[int, int]], target: int = 64
) -> Partition:
    """Region-growing partition for NON-chain graphs (landmark-induced pose
    coupling, loop-dense graphs): BFS from successive seeds collects parts of
    ~``target`` blocks each, then remaining part-crossing edges are covered
    greedily by a vertex separator."""
    from collections import deque

    adj: List[List[int]] = [[] for _ in range(n)]
    for i, j in pairs:
        adj[int(i)].append(int(j))
        adj[int(j)].append(int(i))

    chunk_of = np.full(n, -1, np.int64)
    k = 0
    for seed in range(n):
        if chunk_of[seed] >= 0:
            continue
        size = 0
        frontier = deque([seed])
        while frontier and size < target:
            v = frontier.popleft()
            if chunk_of[v] >= 0:
                continue
            chunk_of[v] = k
            size += 1
            for w in adj[v]:
                if chunk_of[w] < 0:
                    frontier.append(w)
        k += 1
    return _finish_partition(n, pairs, chunk_of, set())


def _finish_partition(n, pairs, chunk_of, sep: set) -> Partition:
    """Shared tail: cover remaining part-crossing edges with a greedy
    max-degree vertex separator, then build part/boundary lists."""
    crossing = [
        (int(i), int(j))
        for i, j in pairs
        if chunk_of[int(i)] != chunk_of[int(j)]
        and int(i) not in sep
        and int(j) not in sep
    ]
    # greedy max-degree vertex cover of the remaining crossers
    from collections import defaultdict

    inc = defaultdict(list)
    for idx, (i, j) in enumerate(crossing):
        inc[i].append(idx)
        inc[j].append(idx)
    covered = np.zeros(len(crossing), bool)
    order = sorted(inc, key=lambda v: -len(inc[v]))
    for v in order:
        if all(covered[e] for e in inc[v]):
            continue
        sep.add(v)
        for e in inc[v]:
            covered[e] = True

    separator = np.array(sorted(sep), np.int64)
    in_sep = np.zeros(n, bool)
    in_sep[separator] = True

    n_parts = int(chunk_of.max()) + 1 if n else 0
    parts = []
    for k in range(n_parts):
        members = np.flatnonzero(chunk_of == k)
        parts.append(members[~in_sep[members]])
    parts = [p for p in parts if len(p)]

    # adjacency: per part, separator blocks touching its interior
    part_of = np.full(n, -1, np.int64)
    for k, p in enumerate(parts):
        part_of[p] = k
    bnd_sets: List[set] = [set() for _ in parts]
    for i, j in pairs:
        i, j = int(i), int(j)
        if in_sep[i] and not in_sep[j] and part_of[j] >= 0:
            bnd_sets[part_of[j]].add(i)
        elif in_sep[j] and not in_sep[i] and part_of[i] >= 0:
            bnd_sets[part_of[i]].add(j)
        elif not in_sep[i] and not in_sep[j]:
            assert part_of[i] == part_of[j], (
                f"crossing interior edge ({i},{j}) — separator cover is broken"
            )
    boundary = [np.array(sorted(b), np.int64) for b in bnd_sets]
    return Partition(parts=parts, separator=separator, boundary=boundary, n=n)


def partition_graph(
    n: int,
    pairs: Sequence[Tuple[int, int]],
    target: int = 64,
    max_sep_frac: float = 0.45,
    strict: bool = True,
) -> Partition:
    """Best-available partition with a quality gate: interval (optimal for
    trajectory-ordered chains), then BFS region growing (general graphs);
    raises ValueError when even the BFS separator exceeds ``max_sep_frac``
    of the blocks (use the v2 level-scheduled engine instead).  With
    ``strict=False`` it returns that partition instead of raising (a caller
    whose dense separator core takes any size)."""
    part = interval_partition(n, pairs, target=target)
    if n and len(part.separator) > max_sep_frac * n:
        part_b = bfs_partition(n, pairs, target=target)
        if len(part_b.separator) < len(part.separator):
            part = part_b
    if strict and n and len(part.separator) > max_sep_frac * n:
        raise ValueError(
            f"separator has {len(part.separator)}/{n} blocks; "
            "graph is not chain-like — use engine='v2'"
        )
    return part


def partition_graph_forced(
    n: int,
    pairs: Sequence[Tuple[int, int]],
    forced_separator: Sequence[int],
    target: int = 64,
    max_sep_frac: float = 0.45,
) -> Partition:
    """Partition with a FORCED separator subset: the given blocks always land
    in the separator; the remainder is partitioned normally (the quality
    gate applies to the remainder only).

    This is the geometry the windowed incremental solver needs: frozen-chunk
    Schur priors attach to designated separator vertices, so those vertices
    must live in the dense separator core where the prior can be added
    (reference analog: CLinearSolver_Schur's guided ordering pins the
    eliminated set, LinearSolver_Schur.h:725)."""
    forced = np.asarray(sorted({int(f) for f in forced_separator}), np.int64)
    if len(forced) == 0:
        return partition_graph(n, pairs, target=target,
                               max_sep_frac=max_sep_frac)
    if len(forced) and (forced[0] < 0 or forced[-1] >= n):
        raise ValueError("forced separator ids out of range")
    keep = np.setdiff1d(np.arange(n, dtype=np.int64), forced)
    rel = -np.ones(n, np.int64)
    rel[keep] = np.arange(len(keep))
    sub_pairs = sorted({
        (max(int(rel[i]), int(rel[j])), min(int(rel[i]), int(rel[j])))
        for i, j in pairs
        if rel[i] >= 0 and rel[j] >= 0 and rel[i] != rel[j]
    })
    sub = partition_graph(len(keep), sub_pairs, target=target,
                          max_sep_frac=max_sep_frac)
    parts = [keep[p] for p in sub.parts]
    separator = np.asarray(
        sorted(set(keep[sub.separator].tolist()) | set(forced.tolist())),
        np.int64,
    )
    sep_set = set(separator.tolist())
    owner = {}
    for k, p in enumerate(parts):
        for b in p.tolist():
            owner[b] = k
    bnd = [set() for _ in parts]
    for i, j in pairs:
        i, j = int(i), int(j)
        if i in sep_set and j in owner:
            bnd[owner[j]].add(i)
        elif j in sep_set and i in owner:
            bnd[owner[i]].add(j)
    boundary = [np.asarray(sorted(s), np.int64) for s in bnd]
    return Partition(parts=parts, separator=separator, boundary=boundary, n=n)
