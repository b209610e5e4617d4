"""Batched residuals, chi2, the dense Gauss-Newton system and the state
update (counterpart of ``slampp_tpu/core/assembly.py``).

Sign convention as in the JAX package: the error ``r(x)`` itself is
differentiated, so the system is ``H dx = -g`` with ``H = J^T W J``,
``g = J^T W r``, ``W = Sigma^-1`` (times the IRLS weight of an edge type
that has a robust loss; chi2 stays unweighted).  ``assemble_dense`` is the
tests' dense oracle; the solver path assembles blocks
(core/block_assembly.py).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from slampp_tpu_torch.graph.system import EdgeArrays, GraphArrays
from slampp_tpu_torch.graph.types import get_edge_type, get_vertex_type


def slot_states(et, ea: EdgeArrays, states: Dict[str, torch.Tensor]):
    """Per-slot (E, state_dim) vertex states of every edge of one type."""
    return tuple(states[et.vertex_types[s]][ea.local_idx[:, s]] for s in range(et.arity))


def takes_fused(et, ea: EdgeArrays) -> bool:
    """Whether edges ``ea`` of type ``et`` take the type's fused forms
    (``EdgeType.fused_terms`` / ``fused_chi2``, a hand-written kernel):
    where the type has them and its operands are on a CUDA card.  One
    attribute read, no host sync; CPU operands keep the generic path."""
    return et.fused_terms is not None and ea.meas.is_cuda


def edge_chi2(et_name: str, ea: EdgeArrays, states: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Unweighted chi2 of one edge type (denormalized); the type's fused
    chi2 where it takes it (``takes_fused``)."""
    et = get_edge_type(et_name)
    if takes_fused(et, ea):
        return et.fused_chi2(ea, states)
    r = et.error_fn(slot_states(et, ea, states), ea.meas)
    v = torch.einsum("ei,eij,ej->e", r, ea.sigma_inv, r)
    return torch.where(ea.valid, v, torch.zeros_like(v)).sum()


def graph_chi2(graph: GraphArrays) -> torch.Tensor:
    """Total denormalized chi2 (reference f_Chi_Squared_Error summed,
    Main.h:1474-1478)."""
    total = torch.zeros((), dtype=torch.float64, device=graph.device)
    for name, ea in graph.edges.items():
        total = total + edge_chi2(name, ea, graph.states)
    return total


def robust_information(et, r: torch.Tensor, sigma_inv: torch.Tensor) -> torch.Tensor:
    """The information matrices assembly weighs with: ``sigma_inv`` times
    the edge type's IRLS weight of the residuals, where it has one
    (reference BaseTypes_Binary.h:772).  chi2 stays on the bare
    ``sigma_inv``."""
    if et.robust_weight_fn is None:
        return sigma_inv
    return sigma_inv * et.robust_weight_fn(r, sigma_inv)[:, None, None]


def _dmax(graph: GraphArrays) -> int:
    return max((get_vertex_type(t).dim for t in graph.states), default=1)


def assemble_dense(graph: GraphArrays) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense (H (N, N), g (N,), chi2), N = graph.state_dim.  Const-vertex
    contributions land in dummy rows past N and are sliced off."""
    N = graph.state_dim
    pad = _dmax(graph)
    dev = graph.device
    H = torch.zeros((N + pad, N + pad), dtype=torch.float64, device=dev)
    g = torch.zeros(N + pad, dtype=torch.float64, device=dev)
    chi2 = torch.zeros((), dtype=torch.float64, device=dev)
    for name, ea in graph.edges.items():
        et = get_edge_type(name)
        vts = [get_vertex_type(t) for t in et.vertex_types]
        r, jacs = et.jacobian_fn(slot_states(et, ea, graph.states), ea.meas)
        valid = ea.valid.to(r.dtype)
        chi2 = chi2 + (torch.einsum("ei,eij,ej->e", r, ea.sigma_inv, r) * valid).sum()
        W = robust_information(et, r, ea.sigma_inv)
        WJ = [torch.einsum("eij,ejk->eik", W, J) for J in jacs]
        for a in range(et.arity):
            rows = ea.offsets[:, a, None] + torch.arange(vts[a].dim, device=dev)
            ga = torch.einsum("eij,ei->ej", WJ[a], r) * valid[:, None]
            g.index_put_((rows,), ga, accumulate=True)
            for b in range(et.arity):
                cols = ea.offsets[:, b, None] + torch.arange(vts[b].dim, device=dev)
                Hab = torch.einsum("eij,eik->ejk", jacs[a], WJ[b]) * valid[:, None, None]
                H.index_put_((rows[:, :, None], cols[:, None, :]), Hab, accumulate=True)
    # automatic unary gauge factor: information * I on the anchor vertex
    if graph.unary_dim > 0:
        idx = graph.unary_offset + torch.arange(graph.unary_dim, device=dev)
        H[idx, idx] += graph.unary_information
    return H[:N, :N], g[:N], chi2


def _fused_slot_hessians(et, terms):
    """J_a^T W J_a of each slot a from an edge type's fused terms, whose
    tuple follows the edge's kind (``EdgeType.fused_terms``): Hii, Hjj and
    D_lm of a ternary type, D_lm of a unary one, H_pose and D_lm of a
    pose-landmark one."""
    if et.arity == 3:
        return terms[0], terms[1], terms[5]
    if et.arity == 1:
        return terms[:1]
    return terms[0], terms[2]


def max_edge_hessian_diag(graph: GraphArrays) -> torch.Tensor:
    """max over edges and slots of max diag(J_a^T W J_a), the LM initial
    damping's scale (JAX ``solvers/lm._max_edge_hessian_diag``; reference
    f_Max_VertexHessianDiagValue, NonlinearSolver_Lambda_LM.h:152-199); a
    type that takes its fused terms (``takes_fused``) reads J_a^T W J_a of
    its slots from them."""
    best = torch.zeros((), dtype=torch.float64, device=graph.device)
    for name, ea in graph.edges.items():
        et = get_edge_type(name)
        if takes_fused(et, ea):
            blocks = _fused_slot_hessians(et, et.fused_terms(ea, graph.states, None))
        else:
            _, jacs = et.jacobian_fn(slot_states(et, ea, graph.states), ea.meas)
            blocks = (torch.einsum("eji,ejk,ekl->eil", J, ea.sigma_inv, J) for J in jacs)
        for Haa in blocks:
            d = torch.diagonal(Haa, dim1=1, dim2=2).amax(1)
            best = torch.maximum(best, torch.where(ea.valid, d, 0.0).amax())
    return best


def apply_update(graph: GraphArrays, dx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """states <- retract(states, dx) per vertex type."""
    return _retract(graph, dx, None)


def apply_update_gated(graph: GraphArrays, dx: torch.Tensor, threshold) -> Dict[str, torch.Tensor]:
    """Threshold-gated vertex updates (fluid relinearization): a vertex moves
    only when the norm of its tangent update exceeds ``threshold`` (reference
    f_UpdateThreshold, NonlinearSolver_Lambda_DL.h:399).  ``threshold=0``
    behaves as :func:`apply_update`."""
    return _retract(graph, dx, threshold)


def _retract(graph: GraphArrays, dx: torch.Tensor, threshold) -> Dict[str, torch.Tensor]:
    dxp = torch.cat([dx, dx.new_zeros(_dmax(graph))])
    out = {}
    for t, st in graph.states.items():
        vt = get_vertex_type(t)
        idx = graph.vertex_offsets[t][:, None] + torch.arange(vt.dim, device=dx.device)
        delta = dxp[idx]
        if threshold is not None:
            keep = torch.linalg.vector_norm(delta, dim=1) > threshold
            delta = torch.where(keep[:, None], delta, 0.0)
        out[t] = vt.retract(st, delta)
    return out
