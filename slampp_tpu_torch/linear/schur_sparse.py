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
      routing tables.
  device numeric: per-type batched Jacobians -> landmark blocks D_l, g_l by
      sorted segment sums -> couplings B_e -> pair corrections -B_e D^-1
      B_f^T -> one sorted segment sum into the fine slots -> the partitioned
      solve -> landmark back-substitution.

The JAX package jit-compiles each step; the port runs it eagerly, with the
plan's tables as tensors on the solver's device.  Its segment sums are the
grouped padded-gather sums of ``ops/segments.py`` (each segment summed on
its own, in a fixed order), where the JAX module took differences of
prefix sums: those round at the magnitude of the running total, and at
cityTrees300's GN step (condition ~1.3e10) they put dx 2.2e-4 from the
dense f64 solution (the grouped sums 5.9e-7, the JAX package's own run
4.7e-6).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from slampp_tpu_torch.core import assembly
from slampp_tpu_torch.graph.system import GraphArrays, GraphSystem
from slampp_tpu_torch.graph.types import get_edge_type, get_vertex_type
from slampp_tpu_torch.linear import partitioned as v3
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
    # routing: the sorted segments of the Hessian block contributions (one
    # per fine slot hit), of the rhs contributions (one per pose block) and
    # of the landmark-sorted pose-landmark edges (one per landmark); each
    # grouped plan's rows hold the contributions' own indices
    src_grp: GroupedSegments  # rows index [head contributions | kept pairs]
    slot_inv: torch.Tensor  # (nnzb,) -> hit index, or n_hit (zero)
    hij_tflag: torch.Tensor  # (n_pp,) bool: the pose-pose H_ij block lands transposed
    rsrc_grp: GroupedSegments
    lm_grp: GroupedSegments
    pl_lm: torch.Tensor  # (n_pl,) landmark of each (sorted) pose-landmark edge
    pl_pose: torch.Tensor  # (n_pl,) pose block of each (sorted) edge (0 for none)
    # the kept pairs of pose-landmark edges sharing a landmark: those whose
    # correction lands in the lower triangle
    pair_e: torch.Tensor  # (n_kept,)
    pair_f: torch.Tensor
    # solution scatter
    pose_dx_offsets: torch.Tensor  # (n_p, bs) global scalar offsets (dummy = state_dim)
    lm_dx_offsets: torch.Tensor  # (n_l, dl)
    # pose ids of the pose-pose edges (the dogleg's matvec)
    pp_ei: torch.Tensor  # (n_pp,)
    pp_ej: torch.Tensor
    inv_map: torch.Tensor  # (n_p,) original pose block -> permuted
    lm_sort: torch.Tensor  # (n_pl,) the landmark sort of the pose-landmark edges

    def to(self, device) -> "SparseSchurPlan":
        return self._replace(**{k: v.to(device) for k, v in self._asdict().items()
                                if isinstance(v, (torch.Tensor, GroupedSegments))})


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
        # the order the device concatenates them (type name, then pool order)
        type_meta = []
        pp_i, pp_j = [], []
        pl_pose, pl_lm = [], []
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
            if et.arity != 2:
                raise NotImplementedError(f"sparse Schur supports unary/binary edges, got {tname}")
            lm_slots = [get_vertex_type(v).is_landmark for v in et.vertex_types]
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
        self._type_meta = type_meta
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

        # ordered pairs of edges sharing a landmark (both directions)
        deg = (lm_ends - lm_starts).astype(np.int64)
        d2 = deg * deg
        M2 = int(d2.sum())
        block_start = np.cumsum(d2) - d2
        t_idx = np.arange(M2, dtype=np.int64)
        within = t_idx - np.repeat(block_start, d2)
        deg_r = np.repeat(deg, d2)
        base = np.repeat(lm_starts.astype(np.int64), d2)
        pair_e = base + within // deg_r
        pair_f = base + within % deg_r

        # SC fill pattern in original pose-block ids, as sorted (hi, lo) keys
        pe_pose = pl_pose_s[pair_e]
        pf_pose = pl_pose_s[pair_f]
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
        dest = np.empty(3 * n_pp + n_pl + M2, np.int64)
        tflag = np.zeros(3 * n_pp + n_pl + M2)
        dest[:n_pp] = slots(ip, ip)
        dest[n_pp:2 * n_pp] = np.where(unary, nnzb + 1, slots(jp, jp))
        dest[2 * n_pp:3 * n_pp] = np.where(unary, nnzb + 1,
                                           slots(np.maximum(ip, jp), np.minimum(ip, jp)))
        tflag[2 * n_pp:3 * n_pp] = (~unary & (ip < jp)).astype(np.float64)
        ipl = inv[np.maximum(pl_pose_s, 0)]
        dest[3 * n_pp:3 * n_pp + n_pl] = np.where(pl_pose_s >= 0, slots(ipl, ipl), nnzb + 1)
        # pair corrections: the ordered pairs that map to the lower triangle
        pair_off = 3 * n_pp + n_pl
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

        # rhs routing: [pp g_i | pp g_j | pl g_p | pair-correction g per pl edge],
        # in the permuted fine layout of the v3 solve
        rdest = np.concatenate([
            pp_i, np.where(pp_i == pp_j, n_p + 1, pp_j),
            np.where(pl_pose_s >= 0, pl_pose_s, n_p + 1),
            np.where(pl_pose_s >= 0, pl_pose_s, n_p + 1),
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
        # the device forms only the kept pair corrections (the JAX package
        # forms all M2 and routes the rest to its dummy slot): the same terms
        # in the same order in every segment, at about half the memory; its
        # contributions are indexed [head | kept pairs]
        pair_keep = np.flatnonzero(keep)
        n_src, n_used = len(dest), pair_off + len(pair_keep)
        cidx = np.concatenate([np.arange(pair_off, dtype=np.int64),
                               pair_off + np.cumsum(keep, dtype=np.int64) - 1, [n_used]])
        src_grp = plan_grouped_segments(starts, ends, n_src,
                                        remap=cidx[np.append(src_perm, n_src)])._replace(m=n_used)
        n_rsrc = len(rdest)
        t = torch.from_numpy
        self.plan = SparseSchurPlan(
            n_p=n_p, n_l=n_l, bs=bs, dl=dl, anchor_kind=anchor_kind, anchor_idx=anchor_idx,
            anchor_dim=anchor_dim, anchor_info=float(system.unary_information),
            anchor_orig=anchor_orig,
            src_grp=src_grp, slot_inv=t(slot_inv.astype(np.int64)),
            hij_tflag=t(tflag[2 * n_pp:3 * n_pp] > 0),
            rsrc_grp=plan_grouped_segments(starts_r, ends_r, n_rsrc,
                                           remap=np.append(rsrc_perm, n_rsrc)),
            lm_grp=plan_grouped_segments(lm_starts, lm_ends, n_pl),
            pl_lm=t(pl_lm_s), pl_pose=t(np.maximum(pl_pose_s, 0)),
            pair_e=t(pair_e[pair_keep]), pair_f=t(pair_f[pair_keep]),
            pose_dx_offsets=t(pose_off), lm_dx_offsets=t(lm_off),
            pp_ei=t(pp_i), pp_ej=t(pp_j),
            inv_map=t(np.asarray(inv, np.int64)), lm_sort=t(lm_sort),
        ).to(self.device)
        self._symbolic_key = (system.n_vertices, system.n_edges)

    def ensure_symbolic(self):
        if self._symbolic_key != (self.system.n_vertices, self.system.n_edges):
            self.symbolic()

    # ---------------------------------------------------------------- device
    def _edge_terms(self, graph: GraphArrays):
        """Per-edge contributions in the host's routing order: (pp_Hii,
        pp_Hjj, pp_Hij, pp_gi, pp_gj, pl_Hpp, pl_gp, pl_D, pl_gl, pl_B, chi2),
        the pl_* arrays in landmark-sorted order."""
        p = self.plan
        bs, dl = p.bs, p.dl
        dt, dev = torch.float64, graph.device
        Hii, Hjj, Hij, gi, gj = [], [], [], [], []
        Hpp, gp, Dl, gl, Bc = [], [], [], [], []
        chi2 = torch.zeros((), dtype=dt, device=dev)
        for tname, kind, sl in self._type_meta:
            et = get_edge_type(tname)
            ea = graph.edges[tname]
            r, jacs = et.jacobian_fn(assembly.slot_states(et, ea, graph.states), ea.meas)
            W = ea.sigma_inv
            Wr = torch.einsum("eij,ej->ei", W, r)
            chi2 = chi2 + torch.where(ea.valid, torch.einsum("ei,ei->e", r, Wr), 0.0).sum()
            WJ = [torch.einsum("eij,ejk->eik", W, J) for J in jacs]
            if kind == "pp":
                Hii.append(torch.einsum("eri,erj->eij", jacs[0], WJ[0]))
                Hjj.append(torch.einsum("eri,erj->eij", jacs[1], WJ[1]))
                Hij.append(torch.einsum("eri,erj->eij", jacs[0], WJ[1]))
                gi.append(torch.einsum("eri,er->ei", WJ[0], r))
                gj.append(torch.einsum("eri,er->ei", WJ[1], r))
            elif kind == "u_pose":
                Hii.append(torch.einsum("eri,erj->eij", jacs[0], WJ[0]))
                Hjj.append(torch.zeros_like(Hii[-1]))
                Hij.append(torch.zeros_like(Hii[-1]))
                gi.append(torch.einsum("eri,er->ei", WJ[0], r))
                gj.append(torch.zeros_like(gi[-1]))
            elif kind == "u_lm":
                Dl.append(torch.einsum("eri,erj->eij", jacs[0], WJ[0]))
                gl.append(torch.einsum("eri,er->ei", WJ[0], r))
                Hpp.append(r.new_zeros((r.shape[0], bs, bs)))
                gp.append(r.new_zeros((r.shape[0], bs)))
                Bc.append(r.new_zeros((r.shape[0], bs, dl)))
            else:  # pl
                sp = 1 - sl
                Hpp.append(torch.einsum("eri,erj->eij", jacs[sp], WJ[sp]))
                gp.append(torch.einsum("eri,er->ei", WJ[sp], r))
                Dl.append(torch.einsum("eri,erj->eij", jacs[sl], WJ[sl]))
                gl.append(torch.einsum("eri,er->ei", WJ[sl], r))
                Bc.append(torch.einsum("eri,erj->eij", jacs[sp], WJ[sl]))

        def cat(xs, shp):
            return torch.cat(xs, 0) if xs else torch.zeros((0,) + shp, dtype=dt, device=dev)

        s = p.lm_sort
        return (cat(Hii, (bs, bs)), cat(Hjj, (bs, bs)), cat(Hij, (bs, bs)),
                cat(gi, (bs,)), cat(gj, (bs,)),
                cat(Hpp, (bs, bs))[s], cat(gp, (bs,))[s], cat(Dl, (dl, dl))[s],
                cat(gl, (dl,))[s], cat(Bc, (bs, dl))[s], chi2)

    def _solve_from_terms(self, graph: GraphArrays, terms, alpha: float):
        """Landmark elimination + sparse pose solve from the per-edge terms:
        (dx (state_dim,), gvec (state_dim,), chi2, D_undamped), shared by
        the damped (LM / GN) step and the dogleg step."""
        p, v3p = self.plan, self.v3_plan
        bs, dl, n_p = p.bs, p.dl, p.n_p
        (Hii, Hjj, Hij, gi, gj, Hpp, gp, Dle, gle, B, chi2) = terms

        with span("ss.landmarks"):
            D0 = grouped_segsum_first(Dle, p.lm_grp)  # (n_l, dl, dl) undamped
            g_l = grouped_segsum_first(gle, p.lm_grp)  # (n_l, dl)
            D = D0 + alpha * torch.eye(dl, dtype=D0.dtype, device=D0.device)
            if p.anchor_kind == "landmark":
                da = torch.arange(p.anchor_dim, device=D.device)
                D[p.anchor_idx, da, da] += p.anchor_info
            Dinv = inverse_spd_small(D)
            BD = torch.einsum("eij,ejk->eik", B, Dinv[p.pl_lm])  # (n_pl, bs, dl)

        with span("ss.pairs"):  # pair corrections -B_e Dinv_lm B_f^T
            pair_c = -torch.einsum("tik,tjk->tij", BD[p.pair_e], B[p.pair_f])

        with span("ss.assemble"):
            # fine-slot assembly: concatenated in routing order, the pose-pose
            # H_ij blocks transposed where flagged (no other term ever is)
            Hij = torch.where(p.hij_tflag[:, None, None], Hij.transpose(1, 2), Hij)
            contribs = torch.cat([Hii, Hjj, Hij, Hpp, pair_c], 0)
            del pair_c
            red = grouped_segsum_first(contribs, p.src_grp)  # (n_hit, bs, bs)
            del contribs
            redp = torch.cat([red, red.new_zeros(1, bs, bs)], 0)
            vals = redp[p.slot_inv]  # (nnzb, bs, bs)
            d = torch.arange(bs, device=vals.device)
            vals[:n_p, d, d] += alpha
            if p.anchor_kind == "pose":
                da = torch.arange(p.anchor_dim, device=vals.device)
                vals[p.anchor_idx, da, da] += p.anchor_info

            # rhs: g_p - BD g_l per pose-landmark edge, in the permuted fine layout
            r2 = torch.einsum("eik,ek->ei", BD, g_l[p.pl_lm])
            rcontrib = torch.cat([gi, gj, gp, -r2], 0)
            rhs = grouped_segsum_first(rcontrib, p.rsrc_grp)  # (n_p, bs)

        vals_p = torch.cat([vals, vals.new_zeros(1, bs, bs)], 0)
        rhs_p = torch.cat([rhs, rhs.new_zeros(1, bs)], 0)
        x_perm = v3._v3_solve_refined(v3p, vals_p, -rhs_p, self.refine_iters, self.damping_rel,
                                      self.mixed_precision)  # (n_p, bs) permuted

        with span("ss.backsub"):
            # landmark back-substitution: dx_l = Dinv (-g_l - B^T dx_pose)
            x_pose = x_perm[p.inv_map]  # (n_p, bs) original order
            bt = torch.einsum("eik,ei->ek", B, x_pose[p.pl_pose])  # (n_pl, dl)
            BT = grouped_segsum_first(bt, p.lm_grp)
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
        if gp.shape[0]:
            # unary landmark rows have gp == 0 and pl_pose clamped to 0
            g.index_put_((po[p.pl_pose].reshape(-1),), gp.reshape(-1), accumulate=True)
            g.index_put_((p.lm_dx_offsets[p.pl_lm].reshape(-1),), gle.reshape(-1),
                         accumulate=True)
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
        if Hpp.shape[0]:
            vpp, vll = vp[po[p.pl_pose]], vp[lo[p.pl_lm]]
            # B == 0 on unary landmark rows masks the clamped pl_pose gather
            op = torch.einsum("eij,ej->ei", Hpp, vpp) + torch.einsum("eij,ej->ei", B, vll)
            ol = torch.einsum("eji,ej->ei", B, vpp) + torch.einsum("eij,ej->ei", Dle, vll)
            out.index_put_((po[p.pl_pose].reshape(-1),), op.reshape(-1), accumulate=True)
            out.index_put_((lo[p.pl_lm].reshape(-1),), ol.reshape(-1), accumulate=True)
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
