"""Sparse system-matrix assembly for dumps (``-dsm``) without a dense
Hessian (counterpart of ``slampp_tpu/core/sparse_dump.py``).

Reference: the CLI's ``-dsm`` writes ``system.mtx`` from the sparse lambda
block matrix (``src/slam_app/Main.h:1449-1493``).  The Gauss-Newton Hessian
is assembled as a SciPy CSR from per-edge-type block triplets: each edge
type's Jacobians (its ``jacobian_fn``, analytic or
``graph/types.autodiff_jacobian``) and blocks J_a^T W J_b are evaluated on
the snapshot's device in float64, one bounded chunk of edges at a time,
pulled to the host and summed as sparse matrices; peak memory is
O(chunk * block^2 + nnz).
"""

from __future__ import annotations

import numpy as np
import torch

from slampp_tpu_torch.core.assembly import robust_information
from slampp_tpu_torch.graph.system import GraphArrays
from slampp_tpu_torch.graph.types import get_edge_type, get_vertex_type


def _hessian_blocks(et, states, meas, sigma_inv):
    """Per-edge blocks habs[a][b] = J_a^T W J_b, (e, d_a, d_b), on the
    device of the inputs, W with the edge type's IRLS weight."""
    r, jacs = et.jacobian_fn(states, meas)
    W = robust_information(et, r, sigma_inv)
    WJ = [torch.einsum("eij,ejk->eik", W, J) for J in jacs]
    return [[torch.einsum("eij,eik->ejk", jacs[a], WJ[b]) for b in range(et.arity)]
            for a in range(et.arity)]


def assemble_sparse_csr(graph: GraphArrays, chunk: int = 65536):
    """The GN Hessian H (N x N, SciPy CSR, float64) without a dense
    intermediate.  Contributions of const vertices (offsets at the dummy
    row >= N) are dropped; the unary gauge factor is included, as in
    ``core/assembly.assemble_dense``."""
    import scipy.sparse as sp

    N = graph.state_dim
    acc = sp.csr_matrix((N, N))
    for name, ea in graph.edges.items():
        et = get_edge_type(name)
        vts = tuple(get_vertex_type(t) for t in et.vertex_types)
        E = ea.meas.shape[0]
        for lo in range(0, E, chunk):
            hi = min(E, lo + chunk)
            states = tuple(graph.states[et.vertex_types[s]][ea.local_idx[lo:hi, s]]
                           for s in range(et.arity))
            habs = _hessian_blocks(et, states, ea.meas[lo:hi], ea.sigma_inv[lo:hi])
            valid = ea.valid[lo:hi].cpu().numpy()
            offs = ea.offsets[lo:hi].cpu().numpy()  # (e, arity)
            rows_l, cols_l, vals_l = [], [], []
            for a in range(et.arity):
                ra = offs[:, a, None] + np.arange(vts[a].dim)[None, :]  # (e, da)
                for b in range(et.arity):
                    cb = offs[:, b, None] + np.arange(vts[b].dim)[None, :]
                    ok = valid & (offs[:, a] < N) & (offs[:, b] < N)
                    if not ok.any():
                        continue
                    hab = habs[a][b].cpu().numpy()[ok]  # (e', da, db)
                    rows_l.append(np.broadcast_to(ra[ok][:, :, None], hab.shape).ravel())
                    cols_l.append(np.broadcast_to(cb[ok][:, None, :], hab.shape).ravel())
                    vals_l.append(hab.ravel())
            if vals_l:
                acc = acc + sp.coo_matrix(
                    (np.concatenate(vals_l), (np.concatenate(rows_l), np.concatenate(cols_l))),
                    shape=(N, N)).tocsr()
    if graph.unary_dim > 0 and graph.unary_offset < N:
        idx = graph.unary_offset + np.arange(graph.unary_dim)
        acc = acc + sp.coo_matrix(
            (np.full(graph.unary_dim, graph.unary_information), (idx, idx)), shape=(N, N)
        ).tocsr()
    return acc
