"""Block-level lambda assembly (counterpart of
``slampp_tpu/core/block_assembly.py``).

Host half: :func:`build_block_plan` routes every edge's per-slot Hessian
block and rhs vector to its fine destination, sorts the contribution terms
by destination and builds grouped segment-sum plans over them (the
reference's matrix reduction plan, CMatrixReductionPlan,
NonlinearSolver_Lambda_Base.h:524).  Device half:
:func:`assemble_blocks_sorted` evaluates the terms per edge type, reduces
them with gather + sum (no scatter, no atomics) and places the reduced
blocks with one gather.

Panel (supernodal) mode: ``panel`` consecutive permuted fine blocks are
amalgamated into one P x P panel (P = panel * bs), so the native engines
factor a much shallower elimination tree of larger blocks.  Fine permuted
position q lands in panel ``q // panel`` at scalar offset
``(q % panel) * bs``; pairs within one panel sit in its diagonal block's
lower triangle.  ``panel=1`` is plain fine-block granularity (the
partitioned solver's).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from slampp_tpu_torch.core.assembly import robust_information, slot_states
from slampp_tpu_torch.graph.system import GraphArrays, GraphSystem
from slampp_tpu_torch.graph.types import get_edge_type, get_vertex_type
from slampp_tpu_torch.ops.segments import (
    GroupedSegments,
    grouped_segsum_last,
    plan_grouped_segments,
)


@dataclasses.dataclass
class EdgeRouting:
    """Per-edge-type routing the sorted assembly reads on the device."""

    pair_transpose: torch.Tensor  # (E, n_pairs) bool: store the pair block transposed
    pairs: Tuple  # ((a, b), ...) slot-index pairs, a < b


@dataclasses.dataclass
class BlockPlan:
    """Routing for one (graph structure, ordering, panel size)."""

    n: int  # panel columns (fine blocks at panel 1)
    bs: int  # fine block size
    P: int  # panel scalar size, panel * bs
    nnzb: int  # panel lower-triangle slots
    routing: Dict[str, EdgeRouting]
    anchor_diag_slot: int  # panel diag slot of the unary anchor (or nnzb)
    anchor_off: int  # its scalar offset in the panel
    anchor_dim: int
    unary_information: float
    dx_offsets: torch.Tensor  # (n, P) global scalar offset per panel scalar (state_dim = unused)
    state_dim: int
    panel_diag_slots: torch.Tensor  # (n,) diag slot of each panel
    panel_diag_reg: torch.Tensor  # (n, P) float64 1.0 where the panel scalar is unused
    type_order: Tuple
    asm_grp: GroupedSegments  # over T Hessian terms -> F fine blocks
    asm_inv_map: torch.Tensor  # (nnzb * pn * pn,) fine cell -> reduced block (F = zero)
    rhs_grp: GroupedSegments  # over Tr rhs terms -> Fr fine rows
    rhs_inv_map: torch.Tensor  # (n * pn,) fine row -> reduced row (Fr = zero)

    def to(self, device) -> "BlockPlan":
        return dataclasses.replace(
            self,
            routing={k: EdgeRouting(r.pair_transpose.to(device), r.pairs)
                     for k, r in self.routing.items()},
            dx_offsets=self.dx_offsets.to(device),
            panel_diag_slots=self.panel_diag_slots.to(device),
            panel_diag_reg=self.panel_diag_reg.to(device),
            asm_grp=self.asm_grp.to(device), asm_inv_map=self.asm_inv_map.to(device),
            rhs_grp=self.rhs_grp.to(device), rhs_inv_map=self.rhs_inv_map.to(device),
        )


def _cat(chunks) -> np.ndarray:
    return np.concatenate(chunks) if chunks else np.zeros(0, np.int64)


def sorted_segments(dests: np.ndarray, sentinel: int):
    """Host: stable-sort contribution terms by destination and plan their
    segment sums.  Returns (the sorted unique destinations below
    ``sentinel`` — terms at ``sentinel`` or above are dropped — and the
    GroupedSegments plan over the UNSORTED term array, one segment each)."""
    order = np.argsort(dests, kind="stable")
    sd = dests[order]
    kept = int(np.searchsorted(sd, sentinel))
    uniq, starts = np.unique(sd[:kept], return_index=True)
    ends = np.append(starts[1:], kept).astype(np.int64) if len(uniq) else starts
    return uniq, _remapped_group_plan(starts, ends, order)


def inverse_map(uniq: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Position of each id in the sorted unique array, or len(uniq)."""
    F = len(uniq)
    if not F:
        return np.full(ids.shape, F, np.int64)
    pos = np.minimum(np.searchsorted(uniq, ids), F - 1)
    return np.where(uniq[pos] == ids, pos, F)


def build_block_plan(
    system: GraphSystem,
    slot_of: Dict[Tuple[int, int], int],
    diag_slot: np.ndarray,
    nnzb: int,
    inv_order: np.ndarray,
    block_of_vid: Dict[int, int],
    panel: int = 1,
    edge_mask: Optional[Dict[str, np.ndarray]] = None,
) -> BlockPlan:
    """Host: the sorted-assembly plan for a panel slot table.

    ``slot_of`` maps PERMUTED panel pairs (i, j), i > j, to the off-diagonal
    slot; ``diag_slot[p]`` is the diagonal slot of permuted panel p;
    ``block_of_vid`` maps a vertex id to its original fine block and
    ``inv_order`` an original fine block to its permuted fine position.
    ``edge_mask`` (per edge type, a bool per edge) drops the masked-out
    edges' contributions, as the JAX package routes them to its dummy slot:
    a subgraph's system (the SPCG spanning tree, linear/spcg.py) assembles
    from the same GraphArrays."""
    offsets, total = system._layout()
    dims = {get_vertex_type(t).dim for t, _ in system.vertex_index.values()}
    if len(dims) != 1:
        raise ValueError(f"uniform block size required, got dims {dims}")
    bs = dims.pop()
    P = panel * bs
    n_fine = len(block_of_vid)
    n_panels = (n_fine + panel - 1) // panel

    # one destination per contribution term, fi * NF + fj (fi >= fj, fine
    # permuted positions), in the order the device concatenates terms (type,
    # then diag a, then pair k); SENT marks terms of const vertices, which
    # are dropped
    NF = n_panels * panel
    SENT = NF * NF + 1
    fine_dests: list = []
    rhs_dests: list = []
    routing: Dict[str, EdgeRouting] = {}
    for tname in system.edge_type_names:
        et = get_edge_type(tname)
        vids = system._edges[tname]["vids"]
        E, arity = len(vids), et.arity
        pairs = tuple((a, b) for a in range(arity) for b in range(a + 1, arity))
        ptrans = np.zeros((E, len(pairs)), bool)
        fd_diag = np.full((E, arity), SENT, np.int64)
        fd_pair = np.full((E, len(pairs)), SENT, np.int64)
        fd_rhs = np.full((E, arity), NF, np.int64)
        mask_t = edge_mask.get(tname) if edge_mask is not None else None
        for e, ev in enumerate(vids):
            if mask_t is not None and not mask_t[e]:
                continue  # every destination of a dropped edge stays dummy
            locs = [int(inv_order[block_of_vid[v]]) if v in block_of_vid else None
                    for v in ev]
            for s, p in enumerate(locs):
                if p is not None:
                    fd_diag[e, s] = p * NF + p
                    fd_rhs[e, s] = p
            for k, (a, b) in enumerate(pairs):
                pa, pb = locs[a], locs[b]
                if pa is None or pb is None:
                    continue
                fd_pair[e, k] = max(pa, pb) * NF + min(pa, pb)
                # the lower-triangle cell holds H[max, min]: transpose when
                # slot a is the column (within one panel as across panels)
                ptrans[e, k] = pa < pb
        routing[tname] = EdgeRouting(torch.from_numpy(ptrans), pairs)
        fine_dests += [fd_diag[:, a] for a in range(arity)]
        fine_dests += [fd_pair[:, k] for k in range(len(pairs))]
        rhs_dests += [fd_rhs[:, a] for a in range(arity)]

    anchor = system._unary_anchor
    if anchor is not None and anchor in block_of_vid:
        q = int(inv_order[block_of_vid[anchor]])
        anchor_slot, anchor_off = int(diag_slot[q // panel]), (q % panel) * bs
    else:
        anchor_slot, anchor_off = nnzb, 0

    # un-permutation of the solution, and the unit regularization of the
    # unused scalars of a partial last panel
    order = np.empty_like(inv_order)
    order[inv_order] = np.arange(len(inv_order))
    vid_of_block = {b: v for v, b in block_of_vid.items()}
    dx_off = np.full((n_panels, P), total, np.int64)
    reg = np.ones((n_panels, P))
    for q in range(n_fine):
        pan, w = q // panel, (q % panel) * bs
        dx_off[pan, w : w + bs] = offsets[vid_of_block[int(order[q])]] + np.arange(bs)
        reg[pan, w : w + bs] = 0.0

    # sorted reduction of the Hessian terms, placed into the panel cells by
    # one gather through asm_inv_map
    uniq, asm_grp = sorted_segments(_cat(fine_dests), SENT)
    ij_of = {int(s_): (int(i_), int(j_)) for (i_, j_), s_ in slot_of.items()}
    for pan in range(n_panels):
        ij_of.setdefault(int(diag_slot[pan]), (pan, pan))
    slot_ij = np.array([ij_of[s_] for s_ in range(nnzb)], np.int64).reshape(nnzb, 2)
    br = np.arange(panel, dtype=np.int64)
    fi = slot_ij[:, 0, None, None] * panel + br[None, :, None]
    fj = slot_ij[:, 1, None, None] * panel + br[None, None, :]
    fid = (fi * NF + fj).ravel()

    # the same over the rhs vectors, keyed by fine row
    uniq_r, rhs_grp = sorted_segments(_cat(rhs_dests), NF)

    return BlockPlan(
        n=n_panels, bs=bs, P=P, nnzb=nnzb, routing=routing,
        anchor_diag_slot=anchor_slot, anchor_off=anchor_off, anchor_dim=bs,
        unary_information=system.unary_information,
        dx_offsets=torch.from_numpy(dx_off),
        state_dim=total,
        panel_diag_slots=torch.as_tensor(np.asarray(diag_slot, np.int64)),
        panel_diag_reg=torch.from_numpy(reg),
        type_order=tuple(system.edge_type_names),
        asm_grp=asm_grp,
        asm_inv_map=torch.from_numpy(inverse_map(uniq, fid)),
        rhs_grp=rhs_grp,
        rhs_inv_map=torch.from_numpy(inverse_map(uniq_r, np.arange(NF, dtype=np.int64))),
    )


def _remapped_group_plan(starts, ends, order) -> GroupedSegments:
    """Grouped-segment plan whose index rows point directly at the
    unpermuted term array (sorted positions remapped through ``order``,
    the dummy to T)."""
    T = len(order)
    order_pad = np.concatenate([np.asarray(order, np.int64), [T]])
    return plan_grouped_segments(starts, ends, T, remap=order_pad)


def _edge_type_terms(graph: GraphArrays, bp: BlockPlan, name: str,
                     hessian_f32: bool = False):
    """Per-edge Hessian blocks in the canonical term order (diag a, then
    pair k), the rhs vectors (one per slot) and the chi2 of one edge type.

    ``hessian_f32``: Jacobians and Hessian blocks in float32, residual, rhs
    and chi2 in float64.  The Gauss-Newton fixed point is set by the f64 rhs,
    so the converged chi2 does not change."""
    ea = graph.edges[name]
    et = get_edge_type(name)
    rt = bp.routing[name]
    xs = slot_states(et, ea, graph.states)
    r, jacs = et.jacobian_fn(xs, ea.meas)
    # chi2 on the bare information; the Hessian and rhs with the robust weight
    chi2 = torch.where(ea.valid, torch.einsum("ei,eij,ej->e", r, ea.sigma_inv, r), 0.0).sum()
    W = robust_information(et, r, ea.sigma_inv)
    if hessian_f32:
        _, jacs = et.jacobian_fn(tuple(x.float() for x in xs), ea.meas.float())
        W = W.float()
    WJ = [torch.einsum("eij,ejk->eik", W, J) for J in jacs]
    mask3 = ea.valid[:, None, None]
    mask2 = ea.valid[:, None]
    hblocks = [torch.where(mask3, torch.einsum("eij,eik->ejk", J, WJa), 0.0)
               for J, WJa in zip(jacs, WJ)]
    # rhs stays f64: an f32 WJ is widened exactly before the contraction
    gvecs = [torch.where(mask2, torch.einsum("eij,ei->ej", WJa.to(r.dtype), r), 0.0)
             for WJa in WJ]
    for k, (a, b) in enumerate(rt.pairs):
        Hab = torch.einsum("eij,eik->ejk", jacs[a], WJ[b])
        Hab = torch.where(rt.pair_transpose[:, k, None, None], Hab.transpose(1, 2), Hab)
        hblocks.append(torch.where(mask3, Hab, 0.0))
    return hblocks, gvecs, chi2


def assemble_blocks_sorted(graph: GraphArrays, bp: BlockPlan, hessian_f32: bool = False):
    """Device: (vals (nnzb+1, P, P), rhs (n+1, P), chi2) — the packed
    lower-triangular lambda in permuted panel-slot order, g, and chi2.  The
    +1 rows are zero dummies that plan gathers point at.  With
    ``hessian_f32`` the blocks come back float32; rhs and chi2 are float64."""
    bs, P = bp.bs, bp.P
    pn = P // bs
    chi2 = torch.zeros((), dtype=torch.float64, device=graph.device)
    hchunks, rchunks = [], []
    for name in bp.type_order:
        hb, gv, c2 = _edge_type_terms(graph, bp, name, hessian_f32)
        hchunks += hb
        rchunks += gv
        chi2 = chi2 + c2

    G = torch.cat(hchunks, 0)  # (T, bs, bs) in term order
    red = grouped_segsum_last(G.reshape(-1, bs * bs).T, bp.asm_grp)  # (bs*bs, F)
    redp = torch.cat([red, red.new_zeros(bs * bs, 1)], -1)
    vals = (redp[:, bp.asm_inv_map].reshape(bs, bs, bp.nnzb, pn, pn)
            .permute(2, 3, 0, 4, 1).reshape(bp.nnzb, P, P))
    vals = torch.cat([vals, vals.new_zeros(1, P, P)], 0)

    Gr = torch.cat(rchunks, 0).T  # (bs, Tr)
    red_r = grouped_segsum_last(Gr, bp.rhs_grp)  # (bs, Fr)
    red_rp = torch.cat([red_r, red_r.new_zeros(bs, 1)], -1)
    rhs = red_rp[:, bp.rhs_inv_map].T.reshape(bp.n, P)
    rhs = torch.cat([rhs, rhs.new_zeros(1, P)], 0)

    if bp.anchor_diag_slot < bp.nnzb:
        idx = bp.anchor_off + torch.arange(bp.anchor_dim, device=vals.device)
        vals[bp.anchor_diag_slot, idx, idx] += bp.unary_information
    if pn > 1:
        # unit diagonal on the unused scalars of a partial panel, so that its
        # Cholesky stays positive definite (their dx solves to 0, dropped)
        dd = torch.arange(P, device=vals.device)
        vals[bp.panel_diag_slots[:, None], dd[None, :], dd[None, :]] += (
            bp.panel_diag_reg.to(vals.dtype))
    return vals, rhs, chi2


def assemble_blocks(graph: GraphArrays, bp: BlockPlan):
    """Device: the same (vals, rhs, chi2) in float64 (counterpart of the
    scatter form ``assemble_blocks``, ``slampp_tpu/core/block_assembly.py:370``).
    The grouped sums of :func:`assemble_blocks_sorted` already add repeated
    destinations without a scatter, so this is that form."""
    return assemble_blocks_sorted(graph, bp)


def scatter_dx(bp: BlockPlan, x: torch.Tensor) -> torch.Tensor:
    """Un-permute the panel solution (n, P) into the global dx vector;
    unused panel scalars land in a dropped tail."""
    dx = x.new_zeros(bp.state_dim + bp.P)
    dx[bp.dx_offsets.reshape(-1)] = x.reshape(-1)
    return dx[: bp.state_dim]
