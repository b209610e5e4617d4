"""Fill-reducing block orderings, host side (counterpart of
``slampp_tpu/core/ordering.py``; reference CMatrixOrdering,
include/slam/OrderingMagic.h:201).

A NumPy / pure-Python copy.  The JAX package's ``min_degree_ordering``
calls its C++ implementation (``native/libslampp_native.so`` through
``core/native_host.py``) when that library is built; the port runs the
pure-Python branch only, so its orderings can differ from the JAX
package's where ties are broken otherwise (ROADMAP.md queue 1 item 4).
"""

from __future__ import annotations

import heapq
import sys
from typing import Optional, Sequence

import numpy as np
from scipy import sparse as sp


def block_adjacency(n: int, pairs: Sequence) -> sp.csr_matrix:
    """Symmetric block adjacency (no diagonal) from (i, j) block pairs."""
    if len(pairs) == 0:
        return sp.csr_matrix((n, n))
    a = np.asarray(pairs, dtype=np.int64)
    i, j = a[:, 0], a[:, 1]
    m = i != j
    i, j = i[m], j[m]
    data = np.ones(len(i) * 2, dtype=np.int8)
    adj = sp.csr_matrix((data, (np.concatenate([i, j]), np.concatenate([j, i]))), shape=(n, n))
    adj.data[:] = 1
    return adj


def identity_ordering(n: int) -> np.ndarray:
    return np.arange(n, dtype=np.int64)


def rcm_ordering(adj: sp.csr_matrix) -> np.ndarray:
    """Reverse Cuthill-McKee (bandwidth-minimizing; suits chain-like graphs)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    return np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True), dtype=np.int64)


def min_degree_ordering(adj: sp.csr_matrix,
                        constrained_last: Optional[Sequence[int]] = None) -> np.ndarray:
    """Minimum-degree ordering on the block graph with elimination-graph
    updates.  ``constrained_last`` pins the given blocks to the end, in
    their natural order (reference CLastElementOrderingConstraint,
    OrderingMagic.h:138)."""
    n = adj.shape[0]
    last = set(int(x) for x in (constrained_last or ()))
    nbrs = [set(adj.indices[adj.indptr[i] : adj.indptr[i + 1]].tolist()) for i in range(n)]
    for i in range(n):
        nbrs[i].discard(i)
    eliminated = np.zeros(n, bool)
    heap = [(len(nbrs[i]), i) for i in range(n) if i not in last]
    heapq.heapify(heap)
    order = []
    while heap:
        d, v = heapq.heappop(heap)
        if eliminated[v] or v in last:
            continue
        if d != len(nbrs[v]):
            heapq.heappush(heap, (len(nbrs[v]), v))
            continue
        eliminated[v] = True
        order.append(v)
        live = [u for u in nbrs[v] if not eliminated[u]]
        # connect the clique of v's live neighbors (elimination-graph update)
        for a in live:
            s = nbrs[a]
            s.discard(v)
            before = len(s)
            s.update(live)
            s.discard(a)
            if len(s) != before:
                heapq.heappush(heap, (len(s), a))
    order.extend(sorted(last))
    assert len(order) == n
    return np.asarray(order, dtype=np.int64)


def inverse_ordering(order: np.ndarray) -> np.ndarray:
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order), dtype=order.dtype)
    return inv


def nested_dissection_ordering(adj: sp.csr_matrix, leaf_size: int = 32,
                               constrained_last: Optional[Sequence[int]] = None) -> np.ndarray:
    """Nested-dissection ordering by recursive BFS bisection (median BFS
    layer from a pseudo-peripheral start as the separator); leaves below
    ``leaf_size`` are ordered by local minimum degree."""
    n = adj.shape[0]
    indptr, indices = adj.indptr, adj.indices
    last = set(int(x) for x in (constrained_last or ()))
    order: list = []

    def nbrs(v):
        return indices[indptr[v] : indptr[v + 1]]

    def order_leaf(nodes):
        if len(nodes) <= 1:
            return list(nodes)
        sub = adj[np.ix_(nodes, nodes)].tocsr()
        return [nodes[i] for i in min_degree_ordering(sub)]

    def bfs_layers(nodes_set, start):
        dist = {start: 0}
        frontier = [start]
        layers = [[start]]
        while frontier:
            nxt = []
            for v in frontier:
                for u in nbrs(v):
                    u = int(u)
                    if u in nodes_set and u not in dist:
                        dist[u] = dist[v] + 1
                        nxt.append(u)
            if nxt:
                layers.append(nxt)
            frontier = nxt
        return layers

    def dissect(nodes):
        if len(nodes) <= leaf_size:
            order.extend(order_leaf(list(nodes)))
            return
        nodes_set = set(nodes)
        layers = bfs_layers(nodes_set, next(iter(nodes)))
        layers = bfs_layers(nodes_set, layers[-1][0])  # pseudo-peripheral restart
        covered = {v for layer in layers for v in layer}
        rest = [v for v in nodes if v not in covered]  # disconnected pieces
        if len(layers) < 3:
            order.extend(order_leaf(list(nodes)))
            return
        sizes = np.cumsum([len(layer) for layer in layers])
        cut = int(np.searchsorted(sizes, sizes[-1] // 2))
        cut = max(1, min(cut, len(layers) - 2))
        A = [v for layer in layers[:cut] for v in layer] + rest
        B = [v for layer in layers[cut + 1 :] for v in layer]
        if not A or not B:
            order.extend(order_leaf(list(nodes)))
            return
        dissect(A)
        dissect(B)
        order.extend(order_leaf(layers[cut]))

    free = [v for v in range(n) if v not in last]
    rec = sys.getrecursionlimit()
    sys.setrecursionlimit(max(rec, 10000))
    seen = set()
    try:
        for v in free:  # one connected component at a time
            if v in seen:
                continue
            comp = []
            stack = [v]
            seen.add(v)
            while stack:
                u = stack.pop()
                comp.append(u)
                for w in nbrs(u):
                    w = int(w)
                    if w not in seen and w not in last:
                        seen.add(w)
                        stack.append(w)
            dissect(comp)
    finally:
        sys.setrecursionlimit(rec)
    order.extend(sorted(last))
    assert len(order) == n, (len(order), n)
    return np.asarray(order, dtype=np.int64)
