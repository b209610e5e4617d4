"""Schur-complement linear solver on the dense Hessian (counterpart of
``slampp_tpu/linear/schur.py``; reference CLinearSolver_Schur,
include/slam/LinearSolver_Schur.h:1424).

Partition the system into landmark-like variables (eliminated) and the
rest (the reduced "camera" system), invert the block-diagonal landmark part
in one batched call, form SC = A - B D^-1 B^T with batched products, factor
the dense SC (``linear/dense.solve_spd``: ``cholesky_ex``, as the JAX
package's ``lax.linalg`` calls, outside any kernel) and back-substitute the
landmarks.  The guided ordering by vertex type
(schur_detail::CGuidedOrdering_Helper, LinearSolver_Schur.h:725) maps to
the ``is_landmark`` flag of the registered vertex types; a graph without
one falls back to a greedy maximum independent set, as the reference's
CSchurOrdering does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slampp_tpu_torch.core import assembly
from slampp_tpu_torch.graph.system import GraphArrays, GraphSystem
from slampp_tpu_torch.graph.types import get_vertex_type
from slampp_tpu_torch.linear.dense import solve_spd


class SchurPlan(NamedTuple):
    """Host-made elimination plan (reference SymbolicDecomposition_Blocky,
    LinearSolver_Schur.h:1553)."""

    cam_idx: torch.Tensor  # (n_c,) int64 scalar indices of the reduced system
    lm_offsets: torch.Tensor  # (n_l,) int64 scalar offsets of the landmark blocks
    lm_dim: int  # uniform landmark block size

    def to(self, device) -> "SchurPlan":
        return SchurPlan(self.cam_idx.to(device), self.lm_offsets.to(device), self.lm_dim)


def build_schur_plan(system: GraphSystem, allow_mis_fallback: bool = True) -> SchurPlan:
    """The landmark / camera partition from the vertex types (guided
    ordering), on the CPU.  All landmark types present must share one block
    size.  A graph with no landmark-like type falls back to a greedy
    maximum-independent-set elimination set (CSchurOrdering::
    n_Calculate_Ordering, LinearSolver_Schur.h:275,332): an independent set
    has a block-diagonal Hessian block, so it is eliminated as landmarks
    are."""
    offsets, total = system._layout()
    lm_offs, lm_dims = [], set()
    for vid, (t, _) in system.vertex_index.items():
        vt = get_vertex_type(t)
        if vt.is_landmark and vid in offsets:
            lm_offs.append(offsets[vid])
            lm_dims.add(vt.dim)
    if not lm_offs:
        if not allow_mis_fallback:
            raise ValueError("no landmark-like vertices to eliminate")
        lm_offs, lm_dims = _mis_elimination_set(system, offsets)
    if len(lm_dims) > 1:
        raise ValueError(f"mixed landmark dims not yet supported: {lm_dims}")
    d = lm_dims.pop()
    lm_offs = np.sort(np.array(lm_offs, dtype=np.int64))
    lm_scalar = (lm_offs[:, None] + np.arange(d)[None, :]).reshape(-1)
    cam_idx = np.setdiff1d(np.arange(total, dtype=np.int64), lm_scalar)
    return SchurPlan(torch.from_numpy(cam_idx), torch.from_numpy(lm_offs), d)


def _mis_elimination_set(system: GraphSystem, offsets):
    """Greedy MIS over the vertex graph (host), restricted to the most
    common block size so the eliminated diagonal stays uniform."""
    from slampp_tpu_torch.core.ordering import block_adjacency, mis_first_fit

    vids = sorted(v for v in system.vertex_index if v in offsets)
    pos = {v: i for i, v in enumerate(vids)}
    dims = np.array([get_vertex_type(system.vertex_index[v][0]).dim for v in vids])
    modal_dim = np.bincount(dims).argmax()
    pairs = []
    for t in system.edge_type_names:
        for evids in system._edges[t]["vids"]:
            ev = [v for v in evids if v in pos]
            for a in range(len(ev)):
                for b in range(a + 1, len(ev)):
                    pairs.append((pos[ev[a]], pos[ev[b]]))
    adj = block_adjacency(len(vids), pairs)
    deg = np.diff(adj.indptr)
    candidates = np.flatnonzero(dims == modal_dim)
    order = candidates[np.argsort(deg[candidates], kind="stable")]
    mis = mis_first_fit(adj, order=order)
    if len(mis) == 0:
        raise ValueError("MIS fallback produced an empty elimination set")
    return [offsets[vids[i]] for i in mis], {int(modal_dim)}


def _eliminate(H: torch.Tensor, plan: SchurPlan, alpha):
    """(rows (n_l, d), D^-1 (n_l, d, d), B (n_c, n_l, d), B D^-1, SC) of
    (H + alpha I)."""
    d = plan.lm_dim
    cam = plan.cam_idx
    rows = plan.lm_offsets[:, None] + torch.arange(d, device=H.device)[None, :]
    D = H[rows[:, :, None], rows[:, None, :]] + alpha * torch.eye(d, dtype=H.dtype, device=H.device)
    B = H[cam[:, None, None], rows[None, :, :]]
    A = H[cam[:, None], cam[None, :]] + alpha * torch.eye(cam.shape[0], dtype=H.dtype,
                                                          device=H.device)
    Dinv = torch.linalg.inv(D)  # batched small inverses
    BDinv = torch.einsum("cld,lde->cle", B, Dinv)
    SC = A - torch.einsum("cld,kld->ck", BDinv, B)
    return rows, Dinv, B, BDinv, SC


def schur_solve(H: torch.Tensor, g: torch.Tensor, plan: SchurPlan, alpha=0.0) -> torch.Tensor:
    """dx of (H + alpha I) dx = -g by landmark elimination (the reference's
    pipeline, LinearSolver_Schur.h:1623-1770: C^-1 -> B C^-1 -> SC = A -
    B C^-1 B^T -> Cholesky of SC -> landmark back-substitution)."""
    rows, Dinv, B, BDinv, SC = _eliminate(H, plan, alpha)
    cam = plan.cam_idx
    g_c = g[cam]
    g_l = g[rows]  # (n_l, d)
    rhs = -(g_c - torch.einsum("cld,ld->c", BDinv, g_l))
    x_c = solve_spd(SC, rhs)
    # landmarks: x_l = D^-1 (-g_l - B^T x_c)
    BTxc = torch.einsum("cld,c->ld", B, x_c)
    x_l = torch.einsum("lde,le->ld", Dinv, -g_l - BTxc)
    dx = torch.zeros_like(g)
    dx[cam] = x_c
    dx[rows.reshape(-1)] = x_l.reshape(-1)
    return dx


def schur_solve_dense(graph: GraphArrays, H, g, plan: SchurPlan = None) -> torch.Tensor:
    if plan is None:
        raise ValueError("schur path requires a SchurPlan")
    return schur_solve(H, g, plan)


def schur_solve_dense_damped(graph: GraphArrays, H, g, alpha, plan: SchurPlan = None):
    """(new_states, dx, denom, dx_norm) of the damped Schur step, denom the
    LM gain ratio's dx . (alpha dx - g)."""
    if plan is None:
        raise ValueError("schur path requires a SchurPlan")
    dx = schur_solve(H, g, plan, alpha=alpha)
    denom = torch.dot(dx, alpha * dx - g)
    return assembly.apply_update(graph, dx), dx, denom, torch.linalg.norm(dx)
