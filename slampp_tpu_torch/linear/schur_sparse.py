"""Sparse Schur complement for general landmark graphs, with no dense
Hessian (counterpart of ``slampp_tpu/linear/schur_sparse.py``).

The landmarks are eliminated observation-wise (as ``linear/ba_schur.py``
does for BA), and the reduced pose system is assembled directly in the
partitioned (v3) fine-block format, so the pose solve is the v3 engine:
its part frames and its separator go through the three kernels
(``chol_batched``, ``trsm_lower_batched``, ``trsm_lower_t_batched``).

Pipeline (reference CLinearSolver_Schur::Solve_PosDef_Blocky,
include/slam/LinearSolver_Schur.h:1623-1770: permute -> slice to A / U / C
-> inverse of the block diagonal -> SC = A - U C^-1 V -> inner solve ->
back-substitute):

  host symbolic:  the landmark set from the guided ordering (vertex types
      flagged is_landmark, LinearSolver_Schur.h:725); the SC fill pattern =
      pose-pose edges and landmark-induced pose pairs; the v3 geometry over
      the pose blocks (``build_v3_geometry``); sorted contribution -> slot
      routing tables, and from them a slot-major table of each fine slot's
      contributions (``ops/schur_kernels.SlotTable``).
  device numeric: per-type batched Jacobians -> landmark blocks D_l, g_l by
      sorted segment sums -> couplings B_e -> each fine slot's head blocks
      and pair corrections -B_e D^-1 B_f^T summed into it
      (``ops/schur_kernels.slot_sums``: on the card one kernel that forms
      the pair corrections inside the sums) -> the partitioned solve ->
      landmark back-substitution.

Edge kinds: unary (pose or landmark), binary pose-pose and pose-landmark,
and ternary with one landmark and two poses (the local-landmark LO edges
of models/sim3.py: landmark, owner camera, observing camera).  A ternary
edge adds its two poses' blocks H_aa, H_bb, H_ab as a pose-pose edge does,
its landmark block to D_l, and a coupling to the landmark for each pose.
With ternary edges a landmark's couplings to one pose repeat (the owner's,
on every LO edge of its landmark), so they are first summed per (landmark,
pose) into one row (span ``ss.rows``); the pairs are those of the rows, as
many as the same scene's binary edges would give.  Without ternary edges
the rows are the pose-landmark edges themselves and no row is summed.

The JAX package jit-compiles each step; the port runs it eagerly, with the
plan's tables as tensors on the solver's device.  Its segment sums (and
the slot sums' plain version) are the grouped padded-gather sums of
``ops/segments.py`` (each segment summed on its own, in a fixed order),
where the JAX module took differences of prefix sums: those round at the
magnitude of the running total, and at cityTrees300's GN step (condition
~1.3e10) they put dx 2.2e-4 from the dense f64 solution (the grouped sums
5.9e-7, the JAX package's own run 4.7e-6).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from slampp_tpu_torch.core import assembly
from slampp_tpu_torch.graph.system import GraphArrays, GraphSystem
from slampp_tpu_torch.graph.types import get_edge_type, get_vertex_type
from slampp_tpu_torch.linear import partitioned as v3
from slampp_tpu_torch.ops import schur_kernels
from slampp_tpu_torch.ops.schur_kernels import SlotTable, plan_slot_segments
from slampp_tpu_torch.ops.segments import (GroupedSegments, grouped_segsum_first,
                                           plan_grouped_segments)
from slampp_tpu_torch.ops.small_blocks import inverse_spd_small
from slampp_tpu_torch.utils.device import require_device
from slampp_tpu_torch.utils.spans import span


class SparseSchurPlan(NamedTuple):
    # statics
    n_p: int  # pose blocks
    n_l: int  # landmarks
    bs: int  # pose block dim
    dl: int  # landmark dim
    anchor_kind: str  # "pose" | "landmark" | "none"
    anchor_idx: int
    anchor_dim: int
    anchor_info: float
    anchor_orig: int  # original pose-block id of a pose anchor (-1 otherwise)
    # routing: the slot-major table of the Hessian block contributions (one
    # slot per fine slot hit; its pairs are the kept pairs of pose-landmark
    # edges sharing a landmark, those whose correction lands in the lower
    # triangle), the sorted segments of the rhs contributions (one per pose
    # block) and of the landmark-sorted pose-landmark edges (one per
    # landmark); each grouped plan's rows hold the contributions' own indices
    slots: SlotTable
    slot_inv: torch.Tensor  # (nnzb,) -> hit index, or n_hit (zero)
    rsrc_grp: GroupedSegments
    lm_grp: GroupedSegments
    pl_lm: torch.Tensor  # (n_pl,) landmark of each (sorted) pose-landmark edge
    pl_pose: torch.Tensor  # (n_pl,) pose block of each (sorted) edge (0 for none)
    # the coupling rows the pairs are formed of, sorted by landmark: the
    # sorted pose-landmark edges themselves where no edge is ternary (the
    # same tensors as pl_lm, pl_pose and lm_grp); with ternary edges one row
    # per (landmark, pose), each the sum of that pose's couplings to the
    # landmark (``rows``: coupling -> row segments), and the rows of each
    # landmark (``row_lm_grp``)
    row_lm: torch.Tensor  # (n_rows,)
    row_pose: torch.Tensor  # (n_rows,) (0 for none)
    row_lm_grp: GroupedSegments
    rows: Optional[GroupedSegments]
    # the pose of each head block of the pose-landmark terms, and the pose
    # and landmark of each coupling: pl_pose, pl_pose and pl_lm where no edge
    # is ternary; with ternary edges the binary pose-landmark edges' poses
    # (in their type and pool order), and the couplings' (binary edges', then
    # each ternary type's first pose slot's, then its second's)
    hp_pose: torch.Tensor
    cpl_pose: torch.Tensor
    cpl_lm: torch.Tensor
    # solution scatter
    pose_dx_offsets: torch.Tensor  # (n_p, bs) global scalar offsets (dummy = state_dim)
    lm_dx_offsets: torch.Tensor  # (n_l, dl)
    # pose ids of the pose-pose edges (the dogleg's matvec)
    pp_ei: torch.Tensor  # (n_pp,)
    pp_ej: torch.Tensor
    inv_map: torch.Tensor  # (n_p,) original pose block -> permuted
    lm_sort: torch.Tensor  # (n_pl,) the landmark sort of the pose-landmark edges
    # counts: ternary edges, coupling rows, kept pairs, head blocks
    n_ternary: int
    n_rows: int
    n_pairs: int
    n_heads: int

    @property
    def pair_e(self) -> torch.Tensor:  # (n_kept,) the kept pairs, in table order
        return self.slots.pair_e

    @property
    def pair_f(self) -> torch.Tensor:
        return self.slots.pair_f

    def to(self, device) -> "SparseSchurPlan":
        return self._replace(**{k: v.to(device) for k, v in self._asdict().items()
                                if isinstance(v, (torch.Tensor, GroupedSegments, SlotTable))})


def generic_terms(et, kind: str, sl, ea, states: Dict[str, torch.Tensor]):
    """An edge type's generic terms in its edge order, on its
    ``jacobian_fn``, by the kind ``symbolic`` gives it (landmark in slot
    ``sl``), with W = ``ea.sigma_inv``, H_ab = J_a^T W J_b and g_a =
    (W J_a)^T r: pose-landmark (Hpp, gp, D, gl, B = Jp^T W Jl, chi2) of its
    pose slot p; ternary (Haa, Hbb, Hab, ga, gb, D, gl, B_a, B_b, chi2) of
    its poses a, b in slot order; pose-pose (H00, H11, H01, g0, g1, chi2), a
    unary pose's with zero blocks for its second slot; unary landmark (D,
    gl, chi2); chi2 = sum of r^T W r over the valid edges (the terms are not
    masked)."""
    r, jacs = et.jacobian_fn(assembly.slot_states(et, ea, states), ea.meas)
    W = ea.sigma_inv
    Wr = torch.einsum("eij,ej->ei", W, r)
    chi2 = torch.where(ea.valid, torch.einsum("ei,ei->e", r, Wr), 0.0).sum()
    WJ = [torch.einsum("eij,ejk->eik", W, J) for J in jacs]

    def H(a, b):
        return torch.einsum("eri,erj->eij", jacs[a], WJ[b])

    def g(a):
        return torch.einsum("eri,er->ei", WJ[a], r)

    if kind == "pl":
        sp = 1 - sl
        return H(sp, sp), g(sp), H(sl, sl), g(sl), H(sp, sl), chi2
    if kind == "ter":
        a, b = (k for k in range(3) if k != sl)
        return H(a, a), H(b, b), H(a, b), g(a), g(b), H(sl, sl), g(sl), H(a, sl), H(b, sl), chi2
    if kind == "pp":
        return H(0, 0), H(1, 1), H(0, 1), g(0), g(1), chi2
    if kind == "u_pose":
        Hii, gi = H(0, 0), g(0)
        return (Hii, torch.zeros_like(Hii), torch.zeros_like(Hii), gi, torch.zeros_like(gi),
                chi2)
    return H(0, 0), g(0), chi2


def pl_terms(et, sl: int, ea, states: Dict[str, torch.Tensor]):
    """A pose-landmark edge type's generic terms, landmark in slot ``sl``:
    (Hpp, gp, Dl, gl, B, chi2), :func:`generic_terms` of kind ``pl``."""
    return generic_terms(et, "pl", sl, ea, states)


def _slot_table(csrc, starts, ends, slot_i, slot_j, pair_off, tflag, pair_e, pair_f,
                plain: bool) -> SlotTable:
    """The slot-major table of ``ops/schur_kernels.py`` (host arrays) from
    the routing: ``csrc`` the kept contributions sorted by slot (stably, so
    each slot's in the routing order: head blocks, then pairs), hit slot k's
    at [starts[k], ends[k]) and at permuted pose blocks (slot_i[k],
    slot_j[k]); contribution c < ``pair_off`` the head block c of
    [Hii | Hjj | Hij | Hpp] (transposed where ``tflag``), else the pair
    (pair_e, pair_f)[c - pair_off].  The kernel walks the diagonal slots
    first (they hold the most terms: every observation of the camera), then
    the rest by (larger, smaller) pose index, so that the warps working at
    once read one row camera's BD rows and share them in L2.  ``plain``
    adds the plain version's grouped segments."""
    if max(len(csrc), pair_off) > np.iinfo(np.int32).max:
        raise ValueError(f"sparse Schur slot table: {len(csrc)} terms over {pair_off} head "
                         f"blocks exceed int32")
    n_hit = len(starts)
    order = np.lexsort((slot_j, slot_i, slot_i != slot_j))
    lens = (ends - starts)[order]
    # each kept contribution's place in the table
    rank = np.empty(n_hit, np.int64)
    rank[order] = np.arange(n_hit)
    hit = np.repeat(np.arange(n_hit), ends - starts)
    first = np.cumsum(lens) - lens
    c = np.empty_like(csrc)
    c[first[rank[hit]] + np.arange(len(csrc)) - starts[hit]] = csrc
    head = c < pair_off
    nh = np.bincount(np.repeat(np.arange(n_hit), lens)[head], minlength=n_hit)
    hc = c[head]
    pairs = c[~head] - pair_off
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))  # noqa: E731
    hptr = np.concatenate([[0], np.cumsum(nh)])
    pptr = np.concatenate([[0], np.cumsum(lens - nh)])
    return SlotTable(out=i32(order), hptr=i32(hptr), heads=i32(np.where(tflag[hc] > 0, ~hc, hc)),
                     pptr=i32(pptr), pair_e=i32(pair_e[pairs]), pair_f=i32(pair_f[pairs]),
                     grp=plan_slot_segments(hptr, pptr) if plain else None)


class SparseSchurSolver:
    """General-graph Schur solver: landmark elimination + v3 pose solve.

    The step interface of ``PartitionedSolver`` (``gn_step``,
    ``damped_step``, ``dogleg_step``), so the GN / LM / dogleg solvers route
    landmark graphs through it."""

    def __init__(self, system: GraphSystem, target: int = 64, mixed_precision: bool = True,
                 refine_iters: int = 1, damping_rel: float = 1e-6, device="cuda"):
        self.system = system
        self.target = target
        self.mixed_precision = mixed_precision
        self.refine_iters = refine_iters
        self.damping_rel = damping_rel
        self.device = torch.device(device)
        self.plan: SparseSchurPlan | None = None
        self.v3_plan = None
        self._symbolic_key = None
        self._type_meta = None  # per edge type: (name, kind, landmark slot)
        # the landmark rows come from one type with fused terms, which on
        # the card write them in the landmark order themselves
        self._lm_rows_fused = False
        self.tables = None  # the JAX package's routing tables (host)

    # ------------------------------------------------------------------ host
    def symbolic(self) -> None:
        require_device(self.device, "SparseSchurSolver")
        system = self.system
        pose_block: Dict[int, int] = {}
        lm_pos: Dict[int, int] = {}
        bs_set, dl_set = set(), set()
        for vid in system._vorder:
            t, _ = system.vertex_index[vid]
            vt = get_vertex_type(t)
            if vt.is_landmark:
                lm_pos[vid] = len(lm_pos)
                dl_set.add(vt.dim)
            else:
                pose_block[vid] = len(pose_block)
                bs_set.add(vt.dim)
        if not lm_pos:
            raise ValueError("no landmark-like vertices to eliminate")
        if len(bs_set) != 1 or len(dl_set) != 1:
            raise ValueError(f"uniform pose/landmark dims required, got {bs_set}/{dl_set}")
        bs, dl = bs_set.pop(), dl_set.pop()
        n_p, n_l = len(pose_block), len(lm_pos)

        # edge types by kind; pose-pose pairs and pose-landmark edge lists in
        # the order the device concatenates them (type name, then pool order).
        # A ternary edge (one landmark, two poses) adds its pose-pose blocks
        # as a pose-pose edge does, its landmark block as a unary landmark
        # edge, and one coupling per pose slot
        type_meta = []
        pp_i, pp_j = [], []
        pl_pose, pl_lm = [], []
        hp_pose, cpl_pose, cpl_lm = [], [], []
        n_ter = 0
        for tname in system.edge_type_names:
            et = get_edge_type(tname)
            if et.arity == 1:
                vt0 = get_vertex_type(et.vertex_types[0])
                kind = "u_lm" if vt0.is_landmark else "u_pose"
                type_meta.append((tname, kind, None))
                for (v0,) in system._edges[tname]["vids"]:
                    if kind == "u_pose":
                        pp_i.append(pose_block[v0])
                        pp_j.append(pose_block[v0])
                    else:
                        pl_lm.append(lm_pos[v0])
                        pl_pose.append(-1)
                continue
            lm_slots = [get_vertex_type(v).is_landmark for v in et.vertex_types]
            if et.arity == 3 and sum(lm_slots) == 1:
                sl = int(lm_slots.index(True))
                pa, pb = (k for k in range(3) if k != sl)
                type_meta.append((tname, "ter", sl))
                vids = np.asarray(system._edges[tname]["vids"], np.int64).reshape(-1, 3)
                a = np.fromiter((pose_block[v] for v in vids[:, pa]), np.int64, len(vids))
                b = np.fromiter((pose_block[v] for v in vids[:, pb]), np.int64, len(vids))
                lm = np.fromiter((lm_pos[v] for v in vids[:, sl]), np.int64, len(vids))
                if (a == b).any():
                    raise ValueError(f"ternary edge type {tname}: an edge holds one pose in both "
                                     f"pose slots")
                pp_i.extend(a.tolist())
                pp_j.extend(b.tolist())
                pl_lm.extend(lm.tolist())
                pl_pose.extend([-1] * len(vids))
                cpl_pose.extend(a.tolist() + b.tolist())
                cpl_lm.extend(lm.tolist() * 2)
                n_ter += len(vids)
                continue
            if et.arity != 2:
                raise NotImplementedError(f"sparse Schur supports unary and binary edges and "
                                          f"ternary ones with one landmark, got {tname}")
            if not any(lm_slots):
                type_meta.append((tname, "pp", None))
                for vids in system._edges[tname]["vids"]:
                    pp_i.append(pose_block[vids[0]])
                    pp_j.append(pose_block[vids[1]])
            elif all(lm_slots):
                raise ValueError(f"landmark-landmark edge type {tname}: C not block-diagonal")
            else:
                sl = int(lm_slots.index(True))
                type_meta.append((tname, "pl", sl))
                for vids in system._edges[tname]["vids"]:
                    pl_pose.append(pose_block[vids[1 - sl]])
                    pl_lm.append(lm_pos[vids[sl]])
                    hp_pose.append(pl_pose[-1])
                    cpl_pose.append(pl_pose[-1])
                    cpl_lm.append(pl_lm[-1])
        self._type_meta = type_meta
        lm_types = [(t, k) for t, k, _ in type_meta if k in ("pl", "u_lm")]
        self._lm_rows_fused = (not n_ter and len(lm_types) == 1 and lm_types[0][1] == "pl"
                               and get_edge_type(lm_types[0][0]).fused_terms is not None)
        n_pp, n_pl = len(pp_i), len(pl_pose)
        pp_i = np.asarray(pp_i, np.int64).reshape(-1)
        pp_j = np.asarray(pp_j, np.int64).reshape(-1)
        pl_pose = np.asarray(pl_pose, np.int64).reshape(-1)
        pl_lm = np.asarray(pl_lm, np.int64).reshape(-1)

        # pose-landmark edges sorted by landmark
        lm_sort = np.argsort(pl_lm, kind="stable")
        pl_lm_s = pl_lm[lm_sort]
        pl_pose_s = pl_pose[lm_sort]
        lm_starts = np.searchsorted(pl_lm_s, np.arange(n_l))
        lm_ends = np.searchsorted(pl_lm_s, np.arange(n_l) + 1)

        # the coupling rows: the sorted edges themselves, or with ternary
        # edges the couplings summed per (landmark, pose) (a pose's repeated
        # couplings to one landmark would otherwise each pair with every
        # other row of the landmark)
        rows = None
        if n_ter:
            cpl_pose = np.asarray(cpl_pose, np.int64)
            cpl_lm = np.asarray(cpl_lm, np.int64)
            hp_pose = np.asarray(hp_pose, np.int64)
            cord = np.lexsort((cpl_pose, cpl_lm))
            ckey = cpl_lm[cord] * n_p + cpl_pose[cord]
            _, r_starts = np.unique(ckey, return_index=True)
            r_ends = np.append(r_starts[1:], len(ckey))
            rows = plan_grouped_segments(r_starts, r_ends, len(ckey),
                                         remap=np.append(cord, len(ckey)))
            row_lm_s, row_pose_s = cpl_lm[cord][r_starts], cpl_pose[cord][r_starts]
            row_starts = np.searchsorted(row_lm_s, np.arange(n_l))
            row_ends = np.searchsorted(row_lm_s, np.arange(n_l) + 1)
        else:
            hp_pose = row_pose_s = pl_pose_s
            row_lm_s, row_starts, row_ends = pl_lm_s, lm_starts, lm_ends
        n_hp, n_rows = len(hp_pose), len(row_lm_s)

        # ordered pairs of rows sharing a landmark (both directions)
        deg = (row_ends - row_starts).astype(np.int64)
        d2 = deg * deg
        M2 = int(d2.sum())
        block_start = np.cumsum(d2) - d2
        t_idx = np.arange(M2, dtype=np.int64)
        within = t_idx - np.repeat(block_start, d2)
        deg_r = np.repeat(deg, d2)
        base = np.repeat(row_starts.astype(np.int64), d2)
        pair_e = base + within // deg_r
        pair_f = base + within % deg_r

        # SC fill pattern in original pose-block ids, as sorted (hi, lo) keys
        pe_pose = row_pose_s[pair_e]
        pf_pose = row_pose_s[pair_f]
        valid_pair = (pe_pose >= 0) & (pf_pose >= 0)
        hi = np.maximum(pe_pose, pf_pose)
        lo = np.minimum(pe_pose, pf_pose)
        offd = valid_pair & (hi != lo)
        pp_hi, pp_lo = np.maximum(pp_i, pp_j), np.minimum(pp_i, pp_j)
        pp_off = pp_hi != pp_lo
        keys = np.unique(np.concatenate([pp_hi[pp_off] * n_p + pp_lo[pp_off],
                                         hi[offd] * n_p + lo[offd]]))
        pattern = list(zip((keys // n_p).tolist(), (keys % n_p).tolist()))

        # a generous separator gate: landmark coupling makes pose graphs
        # less chain-like than pure odometry, and the dense SC core takes
        # any size.  Beyond the gate the JAX package raises (the venice871
        # class reduced camera system: 763 of 871 blocks); the port takes
        # the partition as it is
        plan_v3, slot_of, inv = v3.build_v3_geometry(n_p, pattern, bs, self.target,
                                                     max_sep_frac=0.85, strict=False)
        self.v3_plan = plan_v3.to(self.device)
        nnzb = plan_v3.nnzb
        inv = np.asarray(inv, np.int64)

        # fine slot of permuted blocks (i, j), i >= j, by sorted-key lookup
        skey = np.fromiter((i * n_p + j for i, j in slot_of), np.int64, len(slot_of))
        sval = np.fromiter(slot_of.values(), np.int64, len(slot_of))
        sord = np.argsort(skey)
        skey, sval = skey[sord], sval[sord]

        def slots(i, j):
            return sval[np.searchsorted(skey, i * n_p + j)]

        # contribution -> slot routing, in the device's concatenation order:
        #   [pp Hii | pp Hjj | pp Hij | pl Hpp | pair corrections]; a unary
        # pose edge drops its duplicate and its off-diagonal; an H_ij whose
        # row block comes first in the permuted order lands transposed (tflag)
        ip, jp = inv[pp_i], inv[pp_j]
        unary = pp_i == pp_j
        dest = np.empty(3 * n_pp + n_hp + M2, np.int64)
        tflag = np.zeros(3 * n_pp + n_hp + M2)
        dest[:n_pp] = slots(ip, ip)
        dest[n_pp:2 * n_pp] = np.where(unary, nnzb + 1, slots(jp, jp))
        dest[2 * n_pp:3 * n_pp] = np.where(unary, nnzb + 1,
                                           slots(np.maximum(ip, jp), np.minimum(ip, jp)))
        tflag[2 * n_pp:3 * n_pp] = (~unary & (ip < jp)).astype(np.float64)
        ipl = inv[np.maximum(hp_pose, 0)]
        dest[3 * n_pp:3 * n_pp + n_hp] = np.where(hp_pose >= 0, slots(ipl, ipl), nnzb + 1)
        # pair corrections: the ordered pairs that map to the lower triangle
        pair_off = 3 * n_pp + n_hp
        rk_e = np.where(pe_pose >= 0, inv[np.maximum(pe_pose, 0)], -1)
        rk_f = np.where(pf_pose >= 0, inv[np.maximum(pf_pose, 0)], -1)
        keep = valid_pair & (rk_e >= rk_f)
        pdest = np.full(M2, nnzb + 1, np.int64)
        pdest[keep] = slots(rk_e[keep], rk_f[keep])
        dest[pair_off:] = pdest

        src_perm = np.argsort(dest, kind="stable")
        sdest = dest[src_perm]
        kept = int(np.searchsorted(sdest, nnzb + 1))
        uniq, starts = np.unique(sdest[:kept], return_index=True)
        ends = (np.concatenate([starts[1:], [kept]]).astype(np.int64) if len(uniq)
                else np.zeros(0, np.int64))
        n_hit = len(uniq)
        grid = np.arange(nnzb, dtype=np.int64)
        if n_hit:
            pos = np.minimum(np.searchsorted(uniq, grid), n_hit - 1)
            slot_inv = np.where(uniq[pos] == grid, pos, n_hit)
        else:
            slot_inv = np.full(nnzb, n_hit, np.int64)

        # rhs routing: [pp g_i | pp g_j | pl g_p | pair-correction g per row],
        # in the permuted fine layout of the v3 solve
        rdest = np.concatenate([
            pp_i, np.where(pp_i == pp_j, n_p + 1, pp_j),
            np.where(hp_pose >= 0, hp_pose, n_p + 1),
            np.where(row_pose_s >= 0, row_pose_s, n_p + 1),
        ])
        rdest = np.where(rdest < n_p, inv[np.minimum(rdest, n_p - 1)], n_p + 1)
        rsrc_perm = np.argsort(rdest, kind="stable")
        srd = rdest[rsrc_perm]
        keptr = int(np.searchsorted(srd, n_p + 1))
        uniq_r, starts_r = np.unique(srd[:keptr], return_index=True)
        if len(uniq_r) != n_p:
            raise ValueError("every pose block needs a rhs contribution")
        ends_r = np.concatenate([starts_r[1:], [keptr]]).astype(np.int64)

        # the gauge anchor
        av = system._unary_anchor
        anchor_kind, anchor_idx, anchor_dim, anchor_orig = "none", 0, 0, -1
        if av is not None and not system._vconst.get(av, False):
            vt = get_vertex_type(system.vertex_index[av][0])
            if av in pose_block:
                anchor_kind, anchor_idx = "pose", int(inv[pose_block[av]])
                anchor_orig = int(pose_block[av])
            else:
                anchor_kind, anchor_idx = "landmark", lm_pos[av]
                anchor_orig = lm_pos[av]
            anchor_dim = vt.dim

        # dx scatter offsets
        offsets, total = system._layout()
        pose_off = np.full((n_p, bs), total, np.int64)
        for vid, b in pose_block.items():
            if vid in offsets:
                pose_off[b] = np.arange(offsets[vid], offsets[vid] + bs)
        lm_off = np.full((n_l, dl), total, np.int64)
        for vid, b in lm_pos.items():
            if vid in offsets:
                lm_off[b] = np.arange(offsets[vid], offsets[vid] + dl)

        # the JAX package's routing tables, kept on the host (the tests hold
        # them to JAX's); the device sums through grouped plans made of them
        self.tables = {"src_perm": src_perm, "src_starts": starts, "src_ends": ends,
                       "rsrc_perm": rsrc_perm, "rsrc_starts": starts_r, "rsrc_ends": ends_r,
                       "lm_starts": lm_starts, "lm_ends": lm_ends, "src_tflag": tflag,
                       "pair_e": pair_e, "pair_f": pair_f}
        # the device sums the same terms in the same order into each slot,
        # through a slot-major table of them (the JAX package forms all M2
        # pair corrections and routes the rest to its dummy slot)
        slot_key = np.full(nnzb, -1, np.int64)
        slot_key[sval] = skey
        slot_table = _slot_table(src_perm[:kept], starts, ends, slot_key[uniq] // n_p,
                                 slot_key[uniq] % n_p, pair_off, tflag, pair_e, pair_f,
                                 plain=self.device.type != "cuda")
        n_rsrc = len(rdest)
        t = torch.from_numpy
        lm_grp = plan_grouped_segments(lm_starts, lm_ends, n_pl)
        pl_lm_t, pl_pose_t = t(pl_lm_s), t(np.maximum(pl_pose_s, 0))
        if rows is None:
            row_lm, row_pose, row_lm_grp = pl_lm_t, pl_pose_t, lm_grp
            hp_pose_t, cpl_pose_t, cpl_lm_t = pl_pose_t, pl_pose_t, pl_lm_t
        else:
            row_lm, row_pose = t(row_lm_s), t(row_pose_s)
            row_lm_grp = plan_grouped_segments(row_starts, row_ends, n_rows)
            hp_pose_t, cpl_pose_t, cpl_lm_t = t(hp_pose), t(cpl_pose), t(cpl_lm)
        self.plan = SparseSchurPlan(
            n_p=n_p, n_l=n_l, bs=bs, dl=dl, anchor_kind=anchor_kind, anchor_idx=anchor_idx,
            anchor_dim=anchor_dim, anchor_info=float(system.unary_information),
            anchor_orig=anchor_orig,
            slots=slot_table, slot_inv=t(slot_inv.astype(np.int64)),
            rsrc_grp=plan_grouped_segments(starts_r, ends_r, n_rsrc,
                                           remap=np.append(rsrc_perm, n_rsrc)),
            lm_grp=lm_grp, pl_lm=pl_lm_t, pl_pose=pl_pose_t,
            row_lm=row_lm, row_pose=row_pose, row_lm_grp=row_lm_grp, rows=rows,
            hp_pose=hp_pose_t, cpl_pose=cpl_pose_t, cpl_lm=cpl_lm_t,
            pose_dx_offsets=t(pose_off), lm_dx_offsets=t(lm_off),
            pp_ei=t(pp_i), pp_ej=t(pp_j),
            inv_map=t(np.asarray(inv, np.int64)), lm_sort=t(lm_sort),
            n_ternary=n_ter, n_rows=n_rows, n_pairs=len(slot_table.pair_e),
            n_heads=len(slot_table.heads),
        ).to(self.device)
        self._symbolic_key = (system.n_vertices, system.n_edges)

    def ensure_symbolic(self):
        if self._symbolic_key != (self.system.n_vertices, self.system.n_edges):
            self.symbolic()

    # ---------------------------------------------------------------- device
    def _edge_terms(self, graph: GraphArrays):
        """Per-edge contributions in the host's routing order: (pp_Hii,
        pp_Hjj, pp_Hij, pp_gi, pp_gj, pl_Hpp, pl_gp, pl_D, pl_gl, pl_B, chi2),
        the pl_* arrays in landmark-sorted order.  A type that takes its
        fused terms (``assembly.takes_fused``: ops/sim3_kernels.py and
        ops/invdist_kernels.py on the card) takes them in place of
        :func:`generic_terms`; where a pose-landmark type is the only type
        with landmark rows, they come in the landmark order already.  A
        ternary edge's two poses give its pp_* terms, as a pose-pose edge's
        do; where some edges are ternary, pl_Hpp and pl_gp are the binary
        pose-landmark edges' alone (in their type and pool order), pl_D and
        pl_gl those of every edge with a landmark, and pl_B the couplings in
        the plan's coupling order (``cpl_pose``), which ``ss.rows`` sums per
        (landmark, pose).  A list of one contribution is passed on as it
        is, not copied."""
        p = self.plan
        rows = p.rows is not None
        bs, dl = p.bs, p.dl
        dt, dev = torch.float64, graph.device
        Hii, Hjj, Hij, gi, gj = [], [], [], [], []
        Hpp, gp, Dl, gl, Bc = [], [], [], [], []
        chi2 = torch.zeros((), dtype=dt, device=dev)
        lm_sorted = False
        # the lists each kind's terms go to, in its terms' order; a generic
        # ternary type's two couplings both go to Bc, a fused one's as one
        # (2E, bs, dl) block
        accs = {"pl": (Hpp, gp, Dl, gl, Bc), "ter": (Hii, Hjj, Hij, gi, gj, Dl, gl, Bc, Bc),
                "pp": (Hii, Hjj, Hij, gi, gj), "u_pose": (Hii, Hjj, Hij, gi, gj),
                "u_lm": (Dl, gl)}
        for tname, kind, sl in self._type_meta:
            et = get_edge_type(tname)
            ea = graph.edges[tname]
            fused = assembly.takes_fused(et, ea)
            if kind == "u_lm" and not rows:
                n = ea.meas.shape[0]
                Hpp.append(torch.zeros((n, bs, bs), dtype=dt, device=dev))
                gp.append(torch.zeros((n, bs), dtype=dt, device=dev))
                Bc.append(torch.zeros((n, bs, dl), dtype=dt, device=dev))
            if fused and kind == "pl":
                lm_sorted = self._lm_rows_fused
                terms = et.fused_terms(ea, graph.states, p.lm_sort if lm_sorted else None)
            elif fused:  # ternary or unary landmark: the edge order
                terms = et.fused_terms(ea, graph.states, None)
            else:
                terms = generic_terms(et, kind, sl, ea, graph.states)
            for acc, t in zip(accs[kind], terms[:-1]):
                acc.append(t)
            chi2 = chi2 + terms[-1]

        def cat(xs, shp):
            if len(xs) == 1:
                return xs[0]
            return torch.cat(xs, 0) if xs else torch.zeros((0,) + shp, dtype=dt, device=dev)

        s = p.lm_sort
        lm_rows = [cat(Hpp, (bs, bs)), cat(gp, (bs,)), cat(Dl, (dl, dl)), cat(gl, (dl,)),
                   cat(Bc, (bs, dl))]
        if rows:
            lm_rows[2:4] = lm_rows[2][s], lm_rows[3][s]
        elif not lm_sorted:
            lm_rows = [t[s] for t in lm_rows]
        return (cat(Hii, (bs, bs)), cat(Hjj, (bs, bs)), cat(Hij, (bs, bs)),
                cat(gi, (bs,)), cat(gj, (bs,)), *lm_rows, chi2)

    def _solve_from_terms(self, graph: GraphArrays, terms, alpha: float):
        """Landmark elimination + sparse pose solve from the per-edge terms:
        (dx (state_dim,), gvec (state_dim,), chi2, D_undamped), shared by
        the damped (LM / GN) step and the dogleg step."""
        p, v3p = self.plan, self.v3_plan
        bs, dl, n_p = p.bs, p.dl, p.n_p
        (Hii, Hjj, Hij, gi, gj, Hpp, gp, Dle, gle, B, chi2) = terms
        if p.rows is not None:
            with span("ss.rows"):
                # each (landmark, pose)'s couplings summed into its row
                B = grouped_segsum_first(B, p.rows)  # (n_rows, bs, dl)

        with span("ss.landmarks"):
            D0 = grouped_segsum_first(Dle, p.lm_grp)  # (n_l, dl, dl) undamped
            g_l = grouped_segsum_first(gle, p.lm_grp)  # (n_l, dl)
            D = D0 + alpha * torch.eye(dl, dtype=D0.dtype, device=D0.device)
            if p.anchor_kind == "landmark":
                da = torch.arange(p.anchor_dim, device=D.device)
                D[p.anchor_idx, da, da] += p.anchor_info
            Dinv = inverse_spd_small(D)
            BD = torch.einsum("eij,ejk->eik", B, Dinv[p.row_lm])  # (n_rows, bs, dl)

        with span("ss.pairs"):
            # each hit fine slot's Hessian contributions summed into it: the
            # head blocks (the pose-pose H_ij transposed where it lands so)
            # and the pair corrections -B_e Dinv_lm B_f^T (ops/schur_kernels)
            red = schur_kernels.slot_sums(Hii, Hjj, Hij, Hpp, BD, B, p.slots)  # (n_hit, bs, bs)

        with span("ss.assemble"):
            redp = torch.cat([red, red.new_zeros(1, bs, bs)], 0)
            vals = redp[p.slot_inv]  # (nnzb, bs, bs)
            d = torch.arange(bs, device=vals.device)
            vals[:n_p, d, d] += alpha
            if p.anchor_kind == "pose":
                da = torch.arange(p.anchor_dim, device=vals.device)
                vals[p.anchor_idx, da, da] += p.anchor_info

            # rhs: g_p - BD g_l per row, in the permuted fine layout
            r2 = torch.einsum("eik,ek->ei", BD, g_l[p.row_lm])
            rcontrib = torch.cat([gi, gj, gp, -r2], 0)
            rhs = grouped_segsum_first(rcontrib, p.rsrc_grp)  # (n_p, bs)

        vals_p = torch.cat([vals, vals.new_zeros(1, bs, bs)], 0)
        rhs_p = torch.cat([rhs, rhs.new_zeros(1, bs)], 0)
        x_perm = v3._v3_solve_refined(v3p, vals_p, -rhs_p, self.refine_iters, self.damping_rel,
                                      self.mixed_precision)  # (n_p, bs) permuted

        with span("ss.backsub"):
            # landmark back-substitution: dx_l = Dinv (-g_l - B^T dx_pose)
            x_pose = x_perm[p.inv_map]  # (n_p, bs) original order
            bt = torch.einsum("eik,ei->ek", B, x_pose[p.row_pose])  # (n_rows, dl)
            BT = grouped_segsum_first(bt, p.row_lm_grp)
            dx_l = torch.einsum("lij,lj->li", Dinv, -g_l - BT)

        total = graph.state_dim
        dx = x_pose.new_zeros(total + 1)
        dx[p.pose_dx_offsets.reshape(-1)] = x_pose.reshape(-1)
        dx[p.lm_dx_offsets.reshape(-1)] = dx_l.reshape(-1)
        # gvec: the pose rows carry -(g_p - BD g_l), the landmark rows raw
        # g_l (the LM gain denominator's layout, as the dense oracle's)
        gvec = x_pose.new_zeros(total + 1)
        gvec[p.pose_dx_offsets.reshape(-1)] = rhs[p.inv_map].reshape(-1)
        gvec[p.lm_dx_offsets.reshape(-1)] = g_l.reshape(-1)
        return dx[:total], gvec[:total], chi2, D0

    def _gradient(self, graph: GraphArrays, terms) -> torch.Tensor:
        """The true gradient g (J^T W r layout): pose rows g_p, landmark
        rows g_l, in global state coordinates."""
        p = self.plan
        (Hii, Hjj, Hij, gi, gj, Hpp, gp, Dle, gle, B, chi2) = terms
        g = gle.new_zeros(graph.state_dim + 1)
        po = p.pose_dx_offsets
        if gi.shape[0]:
            g.index_put_((po[p.pp_ei].reshape(-1),), gi.reshape(-1), accumulate=True)
            g.index_put_((po[p.pp_ej].reshape(-1),), gj.reshape(-1), accumulate=True)
        # unary landmark rows have gp == 0 and their head pose clamped to 0
        g.index_put_((po[p.hp_pose].reshape(-1),), gp.reshape(-1), accumulate=True)
        g.index_put_((p.lm_dx_offsets[p.pl_lm].reshape(-1),), gle.reshape(-1), accumulate=True)
        return g[: graph.state_dim]

    def _hessian_matvec(self, graph: GraphArrays, terms, v: torch.Tensor) -> torch.Tensor:
        """H v without forming H: per-edge block products + the anchor
        term (the edge list is the block matrix)."""
        p = self.plan
        (Hii, Hjj, Hij, gi, gj, Hpp, gp, Dle, gle, B, chi2) = terms
        total = graph.state_dim
        vp = torch.cat([v, v.new_zeros(1)])
        po, lo = p.pose_dx_offsets, p.lm_dx_offsets
        out = v.new_zeros(total + 1)
        if Hii.shape[0]:
            vi, vj = vp[po[p.pp_ei]], vp[po[p.pp_ej]]
            oi = torch.einsum("eij,ej->ei", Hii, vi) + torch.einsum("eij,ej->ei", Hij, vj)
            oj = torch.einsum("eji,ej->ei", Hij, vi) + torch.einsum("eij,ej->ei", Hjj, vj)
            out.index_put_((po[p.pp_ei].reshape(-1),), oi.reshape(-1), accumulate=True)
            out.index_put_((po[p.pp_ej].reshape(-1),), oj.reshape(-1), accumulate=True)
        # head blocks, landmark blocks and couplings apart: B == 0 on unary
        # landmark rows masks their clamped head pose
        vh, vl = vp[po[p.hp_pose]], vp[lo[p.pl_lm]]
        vcp, vcl = vp[po[p.cpl_pose]], vp[lo[p.cpl_lm]]
        out.index_put_((po[p.hp_pose].reshape(-1),),
                       torch.einsum("eij,ej->ei", Hpp, vh).reshape(-1), accumulate=True)
        out.index_put_((lo[p.pl_lm].reshape(-1),),
                       torch.einsum("eij,ej->ei", Dle, vl).reshape(-1), accumulate=True)
        out.index_put_((po[p.cpl_pose].reshape(-1),),
                       torch.einsum("eij,ej->ei", B, vcl).reshape(-1), accumulate=True)
        out.index_put_((lo[p.cpl_lm].reshape(-1),),
                       torch.einsum("eji,ej->ei", B, vcp).reshape(-1), accumulate=True)
        if p.anchor_kind != "none" and p.anchor_orig >= 0:
            offs = (po if p.anchor_kind == "pose" else lo)[p.anchor_orig][: p.anchor_dim]
            out.index_put_((offs,), p.anchor_info * vp[offs], accumulate=True)
        return out[:total]

    def damped_step(self, graph: GraphArrays, alpha: float):
        """(new_states, denom, dx_norm, chi2): the PartitionedSolver
        contract, denom the LM gain ratio's dx . (alpha dx - g)."""
        self.ensure_symbolic()
        with span("ss.edge_terms"):
            terms = self._edge_terms(graph)
        dx, gvec, chi2, _ = self._solve_from_terms(graph, terms, alpha)
        denom = torch.dot(dx, alpha * dx - gvec)
        return assembly.apply_update(graph, dx), denom, torch.linalg.norm(dx), chi2

    def gn_step(self, graph: GraphArrays):
        """(new_states, dx_norm, chi2): the GN step (alpha = 0)."""
        new_states, _, dxn, chi2 = self.damped_step(graph, 0.0)
        return new_states, dxn, chi2

    def dogleg_step(self, graph: GraphArrays, delta: float, relin_threshold: float = 0.0):
        """Powell dogleg with the Schur GN step and observation-wise H
        matvecs (reference NonlinearSolver_Lambda_DL.h:242 over the Schur
        slot): (new_states, pred, dx_norm, chi2), the PartitionedSolver
        dogleg_step contract, with no H formed."""
        self.ensure_symbolic()
        terms = self._edge_terms(graph)
        dx_gn, _, chi2, _ = self._solve_from_terms(graph, terms, 0.0)
        g = self._gradient(graph, terms)
        gTg = torch.dot(g, g)
        gHg = torch.dot(g, self._hessian_matvec(graph, terms, g))
        dx_sd = -(gTg / torch.clamp_min(gHg, 1e-300)) * g
        n_gn = torch.linalg.norm(dx_gn)
        n_sd = torch.linalg.norm(dx_sd)
        d = dx_gn - dx_sd
        a = torch.dot(d, d)
        b = 2.0 * torch.dot(dx_sd, d)
        c = torch.dot(dx_sd, dx_sd) - delta * delta
        disc = torch.sqrt(torch.clamp_min(b * b - 4 * a * c, 0.0))
        t = torch.clamp((-b + disc) / torch.clamp_min(2 * a, 1e-300), 0.0, 1.0)
        dx = torch.where(
            n_gn <= delta, dx_gn,
            torch.where(n_sd >= delta, dx_sd * (delta / torch.clamp_min(n_sd, 1e-300)),
                        dx_sd + t * d),
        )
        pred = -(torch.dot(g, dx) + 0.5 * torch.dot(dx, self._hessian_matvec(graph, terms, dx)))
        new_states = assembly.apply_update_gated(graph, dx, relin_threshold)
        return new_states, pred, torch.linalg.norm(dx), chi2
