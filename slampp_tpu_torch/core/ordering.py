"""Fill-reducing block orderings, host side (counterpart of
``slampp_tpu/core/ordering.py``; reference CMatrixOrdering,
include/slam/OrderingMagic.h:201).

A NumPy / pure-Python copy, except that :func:`min_degree_ordering` runs
the port's own C++ implementation (``csrc/slampp_native.cpp``), built at
first use with the host C++ compiler into ``slampp_tpu_torch/_build/`` and
bound through ``ctypes``; a failed build raises.  The pure-Python
:func:`min_degree_ordering_py` is its plain reference, with the same
tie-breaking.
"""

from __future__ import annotations

import ctypes
import heapq
import os
import shutil
import sys
import threading
from pathlib import Path
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


_NATIVE_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "slampp_native.cpp"
_NATIVE_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")  # native/Makefile's
_native_lock = threading.Lock()
_native_lib = None


def _native() -> ctypes.CDLL:
    """The C++ ordering library, built on first call."""
    global _native_lib
    from slampp_tpu_torch.ops._cuda import compile_shared

    with _native_lock:
        if _native_lib is None:
            cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
            if cxx is None:
                raise RuntimeError("no host C++ compiler (g++ / c++ / $CXX) for the ordering")
            lib = ctypes.CDLL(str(compile_shared(_NATIVE_SOURCE, cxx, _NATIVE_FLAGS, {})))
            p64 = ctypes.POINTER(ctypes.c_int64)
            lib.slampp_min_degree_order.argtypes = [ctypes.c_int64, p64, p64, p64,
                                                    ctypes.c_int64, p64]
            lib.slampp_min_degree_order.restype = ctypes.c_int64
            _native_lib = lib
        return _native_lib


def min_degree_ordering(adj: sp.csr_matrix,
                        constrained_last: Optional[Sequence[int]] = None) -> np.ndarray:
    """Minimum-degree ordering on the block graph with elimination-graph
    updates, by the C++ implementation.  ``constrained_last`` pins the given
    blocks to the end, in their natural order (reference
    CLastElementOrderingConstraint, OrderingMagic.h:138)."""
    n = adj.shape[0]
    rowptr = np.ascontiguousarray(adj.indptr, np.int64)
    colidx = np.ascontiguousarray(adj.indices, np.int64)
    last = np.ascontiguousarray(list(constrained_last or ()), np.int64)
    perm = np.empty(n, np.int64)

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    rc = _native().slampp_min_degree_order(n, ptr(rowptr), ptr(colidx), ptr(last), len(last),
                                           ptr(perm))
    if rc != 0:
        raise ValueError(f"min_degree_ordering: the C++ ordering failed ({rc}); "
                         "constrained_last must hold block ids in [0, n)")
    return perm


def min_degree_ordering_py(adj: sp.csr_matrix,
                           constrained_last: Optional[Sequence[int]] = None) -> np.ndarray:
    """The pure-Python minimum-degree ordering, :func:`min_degree_ordering`'s
    plain reference (the same lazy heap and tie-breaking: smallest
    (degree, block) first)."""
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


def mis_first_fit(adj: sp.csr_matrix, order: Optional[np.ndarray] = None) -> np.ndarray:
    """Greedy maximal independent set, first fit (CSchurOrdering::
    t_MIS_FirstFit, include/slam/LinearSolver_Schur.h:332): visit the
    vertices in ``order`` (default ascending degree) and take one when no
    neighbour is taken yet.  Sorted member indices; the Schur elimination
    set of a graph with no landmark-like type (linear/schur.py)."""
    n = adj.shape[0]
    indptr, indices = adj.indptr, adj.indices
    if order is None:
        order = np.argsort(np.diff(indptr), kind="stable")
    in_set = np.zeros(n, bool)
    blocked = np.zeros(n, bool)
    for v in order:
        if blocked[v] or in_set[v]:
            continue
        in_set[v] = True
        blocked[indices[indptr[v]:indptr[v + 1]]] = True
    return np.flatnonzero(in_set)
