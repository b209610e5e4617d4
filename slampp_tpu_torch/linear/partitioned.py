"""Partitioned dense-core linear solver, the v3 engine (counterpart of
``slampp_tpu/linear/partitioned.py``).

The block graph is split into K parts plus a separator
(core/partition.py).  On the device each Gauss-Newton step then

  1. assembles the fine block lambda scatter-free (core/block_assembly.py),
  2. eliminates every part interior — by batched block cyclic reduction when
     all interiors are chains (chain mode, ``_chain_factor32``), else by the
     batched dense Cholesky + TRSM kernels on (K, M, M) part frames (dense
     frames, ``_factor32``),
  3. forms the separator Schur complement SC = A_ss - sum_k U_k^T A_k^-1 U_k
     with a batched GEMM and a sorted segment reduction,
  4. factors SC with the dense Cholesky kernel and back-substitutes with the
     two triangular-solve kernels (ops/dense_kernels.py).

Numerics as in the JAX package: mixed mode solves equilibrated float32
frames with pivot clamping, plus optional float64 refinement on the fine
blocks; exact mode (``mixed_precision=False``) is float64 end to end.

The chain-mode separator always goes through the port's ``chol_batched`` /
``trsm_lower_batched`` / ``trsm_lower_t_batched`` — the JAX package's
``SLAMPP_CHAIN_SEP_XLA=0`` configuration.  The JAX default (XLA's
cholesky/triangular_solve there) was chosen from a TPU measurement, which
says nothing about the H100.  The cyclic-reduction base case stays a
library call (``torch.linalg.cholesky_ex``, which neither syncs nor raises
inside the loop), as it was an XLA call outside any Pallas kernel in JAX.

``optimize_fused`` runs the iterations as a Python loop that never reads a
value back to the host; the caller's first read of a result is its one sync.
Each step marks its layers as profiler ranges (v3.assemble, v3.factor,
v3.backsolve, v3.update; apps/manhattan.py ``profile`` reads them).

The other steps the JAX package offers go through the same factorization:
``gn_step_prior`` (a dense prior on a forced separator, the windowed
incremental solver's live solve), ``damped_step`` (Levenberg-Marquardt) and
``dogleg_step`` (Powell dogleg), each a sequence of device ops whose outputs
stay on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from slampp_tpu_torch.core import block_assembly, partition as part_mod
from slampp_tpu_torch.core.assembly import apply_update, apply_update_gated, graph_chi2
from slampp_tpu_torch.graph.system import GraphArrays, GraphSystem
from slampp_tpu_torch.graph.types import get_vertex_type
from slampp_tpu_torch.ops import dense_kernels as dk
from slampp_tpu_torch.ops.segments import GroupedSegments, grouped_segsum_last
from slampp_tpu_torch.utils.device import require_device

_CR_BASE = 8  # chain length at which cyclic reduction hands off to a dense factorization


def _small_inv(A: torch.Tensor) -> torch.Tensor:
    """Batched inverse of tiny SPD blocks (..., bs, bs): closed forms for
    bs <= 3, as in the JAX package (numerical parity), else a library
    inverse."""
    bs = A.shape[-1]
    if bs == 1:
        return 1.0 / A
    if bs == 2:
        a, b = A[..., 0, 0], A[..., 0, 1]
        c, d = A[..., 1, 0], A[..., 1, 1]
        inv_det = 1.0 / (a * d - b * c)
        return torch.stack(
            [torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2
        ) * inv_det[..., None, None]
    if bs == 3:
        a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
        d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
        g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
        A11 = e * i - f * h
        A12 = -(d * i - f * g)
        A13 = d * h - e * g
        inv_det = 1.0 / (a * A11 + b * A12 + c * A13)
        adj = torch.stack(
            [
                torch.stack([A11, -(b * i - c * h), b * f - c * e], -1),
                torch.stack([A12, a * i - c * g, -(a * f - c * d)], -1),
                torch.stack([A13, -(a * h - b * g), a * e - b * d], -1),
            ],
            -2,
        )
        return adj * inv_det[..., None, None]
    return torch.linalg.inv(A)


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class V3Plan(NamedTuple):
    # statics
    n: int  # fine blocks
    bs: int
    nnzb: int  # fine slots (n diag + n_off offd)
    K: int
    mB: int  # interior blocks per part (padded)
    sB: int  # boundary blocks per part (padded)
    SB: int  # total separator blocks
    M: int  # part frame scalars (mult of PB)
    S: int  # boundary scalars (sB*bs)
    Ms: int  # separator frame scalars (mult of PB)
    # device index tensors (int64) and padding masks (float32)
    rows: torch.Tensor  # (nnzb,) permuted block row per slot
    cols: torch.Tensor  # (nnzb,)
    a_idx: torch.Tensor  # (K, mB, mB) -> Gv row
    u_idx: torch.Tensor  # (K, mB, sB) -> Gv row
    ss_idx: torch.Tensor  # (SB, SB) -> Gv row
    gk_idx: torch.Tensor  # (K, mB) -> rhs row (n = dummy)
    gs_idx: torch.Tensor  # (max(SB, 1),)
    a_pad_eye: torch.Tensor  # (K, M) 1.0 where the frame diagonal is padding
    ss_pad_eye: torch.Tensor  # (Ms,)
    sc_grp: GroupedSegments  # over SC block contributions
    sc_inv_map: torch.Tensor  # (SB*SB,) -> F2 = zero
    scr_grp: GroupedSegments  # over SC rhs contributions
    scr_inv_map: torch.Tensor  # (SB,)
    xs_idx: torch.Tensor  # (K, sB) -> separator block rank (SB = dummy)
    sol_gather: torch.Tensor  # (n,) -> row in [x_int (K*mB) | xs (SB)]
    mv_grp: GroupedSegments  # matvec terms -> n rows (f64 refinement)
    # chain mode: every part interior is a pure chain, so the part frames
    # are block tridiagonal and factor by batched block cyclic reduction
    ch_ok: int = 0
    ch_m: int = 1  # pow2-padded chain length
    ch_d_idx: torch.Tensor = None  # (K, ch_m) Gv rows of interior diagonal blocks
    ch_e_idx: torch.Tensor = None  # (K, ch_m) Gv rows of A[a+1, a] blocks
    ch_pad: torch.Tensor = None  # (K, ch_m) 1.0 where the chain is padding

    def to(self, device) -> "V3Plan":
        return self._replace(**{
            k: v.to(device) for k, v in self._asdict().items()
            if isinstance(v, (torch.Tensor, GroupedSegments))
        })


class PartitionedSolver:
    """v3 engine over a GraphSystem whose vertices share one block size."""

    def __init__(
        self,
        system: GraphSystem,
        target: int = 64,
        mixed_precision: bool = True,
        refine_iters: int = 1,
        damping_rel: float = 1e-6,
        forced_separator=None,
        device="cuda",
    ):
        """``forced_separator``: vertex ids that must land in the dense
        separator core, where ``gn_step_prior`` adds its prior."""
        self.system = system
        self.target = target
        self.mixed_precision = mixed_precision
        self.refine_iters = refine_iters
        self.damping_rel = damping_rel
        self.forced_separator = forced_separator
        self.separator_blocks = None  # sorted block ids, set by symbolic()
        self.device = torch.device(device)
        self._symbolic_key = None
        self.block_plan = None
        self.plan: V3Plan | None = None

    # ------------------------------------------------------------------ host
    def symbolic(self) -> None:
        require_device(self.device, "PartitionedSolver")
        system = self.system
        block_of_vid = {vid: b for b, vid in enumerate(system._vorder)}
        n = len(block_of_vid)

        pairs = set()
        for tname in system.edge_type_names:
            for vids in system._edges[tname]["vids"]:
                bs_ = [block_of_vid.get(v, -1) for v in vids]
                for x in range(len(bs_)):
                    for y in range(x + 1, len(bs_)):
                        if bs_[x] >= 0 and bs_[y] >= 0 and bs_[x] != bs_[y]:
                            a, b = sorted((bs_[x], bs_[y]))
                            pairs.add((b, a))
        pairs = sorted(pairs)

        vt_dims = {get_vertex_type(t).dim for t, _ in system.vertex_index.values()}
        if len(vt_dims) != 1:
            raise ValueError(f"uniform block size required, got dims {vt_dims}")
        bs = vt_dims.pop()

        forced = None
        if self.forced_separator is not None:
            forced = [block_of_vid[v] for v in self.forced_separator if v in block_of_vid]
        extras = {}
        plan, slot_of, inv = build_v3_geometry(n, pairs, bs, self.target,
                                               forced_separator=forced, extras=extras)
        self.separator_blocks = extras["separator"]
        bp = block_assembly.build_block_plan(
            system, slot_of, np.arange(n, dtype=np.int64), plan.nnzb, inv, block_of_vid
        )
        self.block_plan = bp.to(self.device)
        self.plan = plan.to(self.device)
        self._symbolic_key = (system.n_vertices, system.n_edges)

    def ensure_symbolic(self):
        if self._symbolic_key != (self.system.n_vertices, self.system.n_edges):
            self.symbolic()

    # ---------------------------------------------------------------- device
    def gn_step(self, graph: GraphArrays):
        """One Gauss-Newton step: (new_states, dx_norm, chi2 before)."""
        self.ensure_symbolic()
        return _v3_gn_step_impl(
            graph, self.block_plan, self.plan, self.refine_iters, self.damping_rel,
            self.mixed_precision,
        )

    def optimize_fused(self, graph: GraphArrays, n_iters: int = 5):
        """``n_iters`` GN steps with no host sync in between: (states,
        dx_norm of the last step, chi2 before the first, chi2 after the
        last)."""
        self.ensure_symbolic()
        states = graph.states
        for it in range(n_iters):
            states, dxn, chi2 = self.gn_step(graph.replace_states(states))
            if it == 0:
                chi2_0 = chi2
        return states, dxn, chi2_0, graph_chi2(graph.replace_states(states))

    def _assemble(self, graph: GraphArrays):
        self.ensure_symbolic()
        with record_function("v3.assemble"):
            return block_assembly.assemble_blocks_sorted(
                graph, self.block_plan, hessian_f32=self.mixed_precision)

    def gn_step_prior(self, graph: GraphArrays, sc_prior, rhs_prior, update_threshold=0.0):
        """One GN step on H + prior: H[sep, sep] += sc_prior, g[sep] +=
        rhs_prior, dx = -(H + P)^-1 (g + p).

        sc_prior: (Ms, Ms) in separator-frame scalar coordinates (rank order
        of ``separator_blocks`` x block size, zero-padded to Ms); rhs_prior:
        (Ms,) in the same frame, g-sign convention.  Returns (new_states,
        dx_norm, chi2)."""
        vals, rhs, chi2 = self._assemble(graph)
        sc = torch.as_tensor(sc_prior, dtype=torch.float64, device=self.device)
        rp = torch.as_tensor(rhs_prior, dtype=torch.float64, device=self.device)
        # b64 = -g on the fine rows, so the separator rhs adds -rhs_prior
        x = _v3_solve_refined(self.plan, vals, -rhs, self.refine_iters, self.damping_rel,
                              self.mixed_precision, sc_prior=sc, gs_prior=-rp)
        with record_function("v3.update"):
            dx = block_assembly.scatter_dx(self.block_plan, x)
            return apply_update_gated(graph, dx, update_threshold), torch.linalg.norm(dx), chi2

    def damped_step(self, graph: GraphArrays, alpha: float):
        """One LM-damped step (lambda + alpha I) through the partitioned
        engine (reference ApplyDamping, NonlinearSolver_Lambda_LM.h:235-243).
        alpha is added to the diagonal before equilibration, rounded to the
        dtype of the Hessian blocks (float32 in mixed mode), as in the JAX
        package.  Returns (new_states, denom, dx_norm, chi2), denom the gain
        ratio's dx . (alpha dx - g)."""
        vals, rhs, chi2 = self._assemble(graph)
        p, bp = self.plan, self.block_plan
        d = torch.arange(p.bs, device=vals.device)
        vals[: p.n, d, d] += float(alpha)
        x = _v3_solve_refined(p, vals, -rhs, self.refine_iters, self.damping_rel,
                              self.mixed_precision)
        with record_function("v3.update"):
            dx = block_assembly.scatter_dx(bp, x)
            gvec = block_assembly.scatter_dx(bp, rhs[: p.n])
            denom = torch.dot(dx, alpha * dx - gvec)
            return apply_update(graph, dx), denom, torch.linalg.norm(dx), chi2

    def dogleg_step(self, graph: GraphArrays, delta: float, relin_threshold: float = 0.0):
        """One Powell-dogleg step through the partitioned engine (reference
        CNonlinearSolver_Lambda_DL batch semantics).  Returns (new_states,
        pred_reduction, dx_norm, chi2)."""
        vals, rhs, chi2 = self._assemble(graph)
        p = self.plan
        grad = rhs[: p.n]  # permuted fine-layout gradient (n, bs)
        x_gn = _v3_solve_refined(p, vals, -rhs, self.refine_iters, self.damping_rel,
                                 self.mixed_precision)
        with record_function("v3.update"):
            vals64 = vals.to(grad.dtype)
            gTg = torch.sum(grad * grad)
            gHg = torch.sum(grad * _spmv_fine(p, vals64, grad))
            x_sd = -(gTg / torch.clamp_min(gHg, 1e-300)) * grad
            n_gn = torch.linalg.vector_norm(x_gn)
            n_sd = torch.linalg.vector_norm(x_sd)
            d_ = x_gn - x_sd
            aa = torch.sum(d_ * d_)
            bb = 2.0 * torch.sum(x_sd * d_)
            cc = torch.sum(x_sd * x_sd) - delta * delta
            disc = torch.sqrt(torch.clamp_min(bb * bb - 4 * aa * cc, 0.0))
            t = torch.clamp((-bb + disc) / torch.clamp_min(2 * aa, 1e-300), 0.0, 1.0)
            x = torch.where(
                n_gn <= delta, x_gn,
                torch.where(n_sd >= delta, x_sd * (delta / torch.clamp_min(n_sd, 1e-300)),
                            x_sd + t * d_),
            )
            pred = -(torch.sum(grad * x) + 0.5 * torch.sum(x * _spmv_fine(p, vals64, x)))
            dx = block_assembly.scatter_dx(self.block_plan, x)
            new_states = apply_update_gated(graph, dx, relin_threshold)
            return new_states, pred, torch.linalg.vector_norm(x), chi2


def build_v3_geometry(n, pairs, bs: int, target: int = 64, max_sep_frac: float = 0.45,
                      forced_separator=None, extras: dict = None):
    """Host: the partitioned-solver geometry for ``n`` blocks of size ``bs``
    with off-diagonal pattern ``pairs`` (original block indices).

    Returns ``(V3Plan, slot_of, inv)``: ``inv`` maps an original block to its
    permuted position, ``slot_of`` a PERMUTED ``(i, j)``, ``i >= j``, to its
    fine value slot (diagonal slot j at index j, off-diagonals from ``n``).
    The plan's tensors are on the CPU (``V3Plan.to`` moves them).

    ``forced_separator``: block ids that must land in the separator;
    ``extras``, when given, receives {"separator": sorted block ids}."""
    def _do_partition(forced):
        if forced:
            return part_mod.partition_graph_forced(
                n, sorted(pairs), sorted(forced), target=target,
                max_sep_frac=max_sep_frac)
        return part_mod.partition_graph(n, sorted(pairs), target=target,
                                        max_sep_frac=max_sep_frac)

    forced0 = set(forced_separator or [])
    forced_set = set(forced0)
    part = _do_partition(forced_set)
    # chain-ification: promote one endpoint of every interior-interior
    # coupling that skips a chain position, so part interiors become pure
    # block tridiagonals; give up (dense frames) rather than blow up the
    # separator on graphs that are not chain-like.  The budget counts the
    # promoted blocks only, not the forced ones
    budget = max(16, n // 8)
    for _ in range(4):
        offenders = set()
        for pk in part.parts:
            pos = {int(b): i for i, b in enumerate(pk)}
            for i, j in pairs:
                pi, pj = pos.get(int(i)), pos.get(int(j))
                if pi is not None and pj is not None and abs(pi - pj) >= 2:
                    offenders.add(int(max(i, j)))
        if not offenders:
            break
        if len(forced_set | offenders) - len(forced0) > budget:
            part = _do_partition(forced0)
            break
        forced_set |= offenders
        part = _do_partition(forced_set)
    if extras is not None:
        extras["separator"] = np.asarray(part.separator, np.int64)
    # permuted order: part interiors (contiguous), then separator
    order = np.concatenate([*(part.parts or [np.zeros(0, np.int64)]), part.separator]).astype(np.int64)
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    n_int = n - len(part.separator)

    # permuted off-diagonal pairs -> fine slot table
    ppairs = sorted({(max(int(inv[i]), int(inv[j])), min(int(inv[i]), int(inv[j]))) for i, j in pairs})
    slot_of = {(j, j): j for j in range(n)}
    rows_l, cols_l = [], []
    for k, (i, j) in enumerate(ppairs):
        slot_of[(i, j)] = n + k
        rows_l.append(i)
        cols_l.append(j)
    nnzb = n + len(ppairs)

    K = part.K
    mB = part.max_interior
    sB = max(1, part.max_boundary)
    SB = len(part.separator)
    M = _pad_to(mB * bs, dk.PB)
    S = sB * bs
    Ms = _pad_to(max(SB, 1) * bs, dk.PB)

    ZERO = 2 * nnzb  # Gv rows: [vals | vals^T | zero]

    def look(i, j):
        """Gv row for block H_{ij} in permuted coords."""
        if i == j:
            return i
        if i > j:
            s = slot_of.get((i, j))
            return s if s is not None else ZERO
        s = slot_of.get((j, i))
        return (nnzb + s) if s is not None else ZERO

    # part frames
    p0 = np.zeros(K, np.int64)
    off = 0
    for k, p in enumerate(part.parts):
        p0[k] = off
        off += len(p)

    a_idx = np.full((K, mB, mB), ZERO, np.int64)
    u_idx = np.full((K, mB, sB), ZERO, np.int64)
    gk_idx = np.full((K, mB), n, np.int64)
    xs_idx = np.full((K, sB), SB, np.int64)
    a_pad_eye = np.zeros((K, M))
    sep_rank = {int(b): r for r, b in enumerate(part.separator)}
    for k, p in enumerate(part.parts):
        m = len(p)
        for a in range(m):
            ia = int(p0[k] + a)
            gk_idx[k, a] = ia
            for b in range(m):
                a_idx[k, a, b] = look(ia, int(p0[k] + b))
        a_pad_eye[k, m * bs :] = 1.0
        for c, sb_orig in enumerate(part.boundary[k]):
            r = sep_rank[int(sb_orig)]
            xs_idx[k, c] = r
            for a in range(m):
                u_idx[k, a, c] = look(int(p0[k] + a), n_int + r)

    ss_idx = np.full((SB, SB), ZERO, np.int64)
    gs_idx = np.zeros(max(SB, 1), np.int64)
    for r in range(SB):
        gs_idx[r] = n_int + r
        for c in range(SB):
            ss_idx[r, c] = look(n_int + r, n_int + c)
    ss_pad_eye = np.zeros(Ms)
    ss_pad_eye[SB * bs :] = 1.0

    # SC contributions: term (k, c, d) -> (xs_idx[k, c], xs_idx[k, d])
    kk, cc, dd = np.meshgrid(np.arange(K), np.arange(sB), np.arange(sB), indexing="ij")
    dr, dc = xs_idx[kk, cc], xs_idx[kk, dd]
    dest = np.where((dr < SB) & (dc < SB), dr * max(SB, 1) + dc, SB * SB + 1).ravel()
    uniq, sc_grp = block_assembly.sorted_segments(dest, SB * SB + 1)
    sc_inv_map = block_assembly.inverse_map(uniq, np.arange(max(SB, 1) ** 2, dtype=np.int64))

    # SC rhs contributions: term (k, c) -> xs_idx[k, c]
    destr = np.where(xs_idx < SB, xs_idx, SB + 1).ravel()
    uniq_r, scr_grp = block_assembly.sorted_segments(destr, SB + 1)
    scr_inv_map = block_assembly.inverse_map(uniq_r, np.arange(max(SB, 1), dtype=np.int64))

    # solution gather: permuted fine p -> row in [x_int (K*mB) | xs (SB)]
    sol = np.zeros(n, np.int64)
    for k, p in enumerate(part.parts):
        sol[p0[k] : p0[k] + len(p)] = k * mB + np.arange(len(p))
    sol[n_int:] = K * mB + np.arange(SB)

    # spmv plan: terms = [all slots -> rows] + [off-diagonal slots -> cols]
    rows_arr = np.concatenate([np.arange(n), np.asarray(rows_l, np.int64)])
    cols_arr = np.concatenate([np.arange(n), np.asarray(cols_l, np.int64)])
    _, mv_grp = block_assembly.sorted_segments(np.concatenate([rows_arr, cols_arr[n:]]), n)

    # chain detection + tables: interiors are chains iff no interior
    # off-diagonal skips a position
    offd = a_idx != ZERO
    ai = np.arange(mB)
    skip = np.abs(ai[:, None] - ai[None, :]) >= 2
    ch_ok = int(not (offd & skip[None, :, :]).any())
    ch_m = 1
    while ch_m < max(mB, 1):
        ch_m *= 2
    ch_d_idx = np.full((K, ch_m), ZERO, np.int64)
    ch_e_idx = np.full((K, ch_m), ZERO, np.int64)
    ch_pad = np.zeros((K, ch_m))
    ch_d_idx[:, :mB] = a_idx[np.arange(K)[:, None], ai[None, :], ai[None, :]]
    if mB > 1:
        ch_e_idx[:, : mB - 1] = a_idx[np.arange(K)[:, None], ai[None, 1:], ai[None, :-1]]
    ch_pad[ch_d_idx == ZERO] = 1.0

    t = torch.from_numpy
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    plan = V3Plan(
        n=n, bs=bs, nnzb=nnzb, K=K, mB=mB, sB=sB, SB=SB, M=M, S=S, Ms=Ms,
        rows=t(rows_arr), cols=t(cols_arr),
        a_idx=t(a_idx), u_idx=t(u_idx), ss_idx=t(ss_idx),
        gk_idx=t(gk_idx), gs_idx=t(gs_idx),
        a_pad_eye=f32(a_pad_eye), ss_pad_eye=f32(ss_pad_eye),
        sc_grp=sc_grp, sc_inv_map=t(sc_inv_map),
        scr_grp=scr_grp, scr_inv_map=t(scr_inv_map),
        xs_idx=t(xs_idx), sol_gather=t(sol),
        mv_grp=mv_grp,
        ch_ok=ch_ok, ch_m=ch_m, ch_d_idx=t(ch_d_idx), ch_e_idx=t(ch_e_idx),
        ch_pad=f32(ch_pad),
    )
    return plan, slot_of, inv


# --------------------------------------------------------------------- device


def _pad_rows(x: torch.Tensor, to: int) -> torch.Tensor:
    """Zero-pad dim 1 of a (K, m, ...) tensor to ``to`` rows."""
    pad = [0, 0] * (x.dim() - 2) + [0, to - x.shape[1]]
    return F.pad(x, pad)


def _pad_sq(x: torch.Tensor, to: int) -> torch.Tensor:
    """Zero-pad the last two (square) dims to ``to``."""
    d = to - x.shape[-1]
    return F.pad(x, (0, d, 0, d))


def _packed(vals, rhs):
    """Gv = [vals | vals^T | zero] and rhsf = [rhs | zero]."""
    bs = vals.shape[-1]
    Gv = torch.cat([vals, vals.transpose(1, 2), vals.new_zeros(1, bs, bs)], 0)
    return Gv, torch.cat([rhs, rhs.new_zeros(1, bs)], 0)


def _frames(p: V3Plan, Gv, rhsf, dtype):
    """Part frames A (K, M, M), couplings U (K, M, S), separator system
    Ass (Ms, Ms), rhs frames gk (K, M) and gs (Ms,)."""
    bs = p.bs
    A = Gv[p.a_idx].permute(0, 1, 3, 2, 4).reshape(p.K, p.mB * bs, p.mB * bs)
    A = _pad_sq(A, p.M) + torch.diag_embed(p.a_pad_eye.to(dtype))
    U = Gv[p.u_idx].permute(0, 1, 3, 2, 4).reshape(p.K, p.mB * bs, p.S)
    U = _pad_rows(U, p.M)
    gk = _pad_rows(rhsf[p.gk_idx].reshape(p.K, p.mB * bs), p.M)
    Ass, gs = _chain_sep_frames(p, Gv, rhsf, dtype)
    return A, U, Ass, gk, gs


def _cr_build(D, Lw):
    """Batched block cyclic reduction hierarchy for SPD block-tridiagonal
    systems.  D (K, m, bs, bs) diagonal blocks, Lw (K, m, bs, bs) with
    Lw[:, i] = A[i+1, i] (Lw[:, m-1] = 0); m a power of two.  log2(m / base)
    levels of batched tiny-block products, then one batched dense Cholesky
    of the remaining (K, base*bs, base*bs) tridiagonal."""
    levels = []
    m = D.shape[1]
    while m > _CR_BASE:
        DO = D[:, 1::2]
        DE = D[:, 0::2]
        P = Lw[:, 0::2]  # even -> odd coupling A[2t+1, 2t]
        Q = Lw[:, 1::2]  # odd -> even coupling A[2t+2, 2t+1]
        DOinv = _small_inv(DO)
        DiP = torch.einsum("kmij,kmjl->kmil", DOinv, P)
        PtDiP = torch.einsum("kmji,kmjl->kmil", P, DiP)
        QDi = torch.einsum("kmij,kmjl->kmil", Q, DOinv)
        QDiQt = torch.einsum("kmil,kmjl->kmij", QDi, Q)
        Dn = DE - PtDiP - _shift_down(QDiQt)
        Ln = -torch.einsum("kmil,kmlj->kmij", QDi, P)
        levels.append((DOinv, P, Q))
        D, Lw = Dn, Ln
        m //= 2
    # dense base case: the remaining (K, m*bs, m*bs) tridiagonal
    K_, _, bs, _ = D.shape
    T = D.new_zeros(K_, m, m, bs, bs)
    ar = torch.arange(m, device=D.device)
    T[:, ar, ar] = D
    if m > 1:
        T[:, ar[1:], ar[:-1]] = Lw[:, :-1]
        T[:, ar[:-1], ar[1:]] = Lw[:, :-1].transpose(-1, -2)
    T = T.permute(0, 1, 3, 2, 4).reshape(K_, m * bs, m * bs)
    Lbase = torch.linalg.cholesky_ex(T).L
    return levels, (Lbase, m, bs)


def _shift_down(X):
    """X[:, :-1] moved one position down the chain axis, zero at the top."""
    return torch.cat([torch.zeros_like(X[:, :1]), X[:, :-1]], 1)


def _cr_solve(levels, root, B):
    """Solve A X = B through a _cr_build hierarchy; B (K, m, bs, R)."""
    stack = []
    for DOinv, P, Q in levels:
        BO = B[:, 1::2]
        BE = B[:, 0::2]
        DiB = torch.einsum("kmij,kmjr->kmir", DOinv, BO)
        PtDiB = torch.einsum("kmji,kmjr->kmir", P, DiB)
        QDiB = torch.einsum("kmij,kmjr->kmir", Q, DiB)
        B = BE - PtDiB - _shift_down(QDiB)
        stack.append((DOinv, P, Q, BO))
    Lbase, mb, bs = root
    K_ = B.shape[0]
    Bb = B.reshape(K_, mb * bs, -1)
    yb = torch.linalg.solve_triangular(Lbase, Bb, upper=False)
    xb = torch.linalg.solve_triangular(Lbase.transpose(1, 2), yb, upper=True)
    x = xb.reshape(K_, mb, bs, -1)
    for DOinv, P, Q, BO in reversed(stack):
        xE = x
        xE_next = torch.cat([xE[:, 1:], torch.zeros_like(xE[:, :1])], 1)
        t = (
            BO
            - torch.einsum("kmij,kmjr->kmir", P, xE)
            - torch.einsum("kmji,kmjr->kmir", Q, xE_next)
        )
        xO = torch.einsum("kmij,kmjr->kmir", DOinv, t)
        x = torch.stack([xE, xO], 2).reshape((K_, 2 * xE.shape[1]) + xE.shape[2:])
    return x


def _chain_sep_frames(p: V3Plan, Gv, rhsf, dtype):
    """Separator system Ass (Ms, Ms) and rhs gs (Ms,)."""
    bs = p.bs
    Ass = Gv[p.ss_idx].permute(0, 2, 1, 3).reshape(p.SB * bs, p.SB * bs)
    Ass = _pad_sq(Ass, p.Ms) + torch.diag(p.ss_pad_eye.to(dtype))
    gs = F.pad(rhsf[p.gs_idx].reshape(-1)[: p.SB * bs], (0, p.Ms - p.SB * bs))
    return Ass, gs


def _chain_gather_U(p: V3Plan, Gv, rhsf):
    bs = p.bs
    Ub = Gv[p.u_idx].permute(0, 1, 3, 2, 4).reshape(p.K, p.mB, bs, p.S)
    gk = rhsf[p.gk_idx]  # (K, mB, bs)
    return _pad_rows(Ub, p.ch_m), _pad_rows(gk, p.ch_m)


def _chain_flat(p: V3Plan, X):
    """(K, ch_m, bs, ...) node rows -> (K, M, ...) flat frame rows."""
    flat = X.reshape((p.K, p.ch_m * p.bs) + X.shape[3:])[:, : p.mB * p.bs]
    return _pad_rows(flat, p.M)


def _chain_sc_reduce(p: V3Plan, C):
    """(K, S, S) boundary-pair contributions -> SC subtraction (SB*bs, SB*bs)."""
    bs = p.bs
    Cb = C.reshape(p.K, p.sB, bs, p.sB, bs).permute(0, 1, 3, 2, 4).reshape(-1, bs * bs)
    red = grouped_segsum_last(Cb.T, p.sc_grp)
    redp = torch.cat([red, red.new_zeros(bs * bs, 1)], -1)
    SBp = max(p.SB, 1)
    return (
        redp[:, p.sc_inv_map]
        .reshape(bs, bs, SBp, SBp)
        .permute(2, 0, 3, 1)
        .reshape(SBp * bs, SBp * bs)[: p.SB * bs, : p.SB * bs]
    )


def _chain_rhs_reduce(p: V3Plan, v):
    """(K, S) boundary rhs contributions -> separator subtraction (SB*bs,)."""
    bs = p.bs
    vb = v.reshape(p.K * p.sB, bs)
    redv = grouped_segsum_last(vb.T, p.scr_grp)
    redvp = torch.cat([redv, redv.new_zeros(bs, 1)], -1)
    return redvp[:, p.scr_inv_map].T.reshape(-1)[: p.SB * bs]


def _separator(p: V3Plan, Ass, gs, C, v):
    """Factor SC = Ass - place(C) with the Cholesky kernel; rhs_s = gs - place(v)."""
    SC = Ass - _pad_sq(_chain_sc_reduce(p, C), p.Ms)
    Ls = dk.chol_batched(SC[None].contiguous())  # (1, Ms, Ms)
    rhs_s = gs - F.pad(_chain_rhs_reduce(p, v), (0, p.Ms - p.SB * p.bs))
    return Ls, rhs_s


def _add_prior(Ass, gs, sc_prior, gs_prior):
    """The separator prior (already in the frames' scaling) on the separator
    system and rhs."""
    if sc_prior is not None:
        Ass = Ass + sc_prior.to(Ass.dtype)
    if gs_prior is not None:
        gs = gs + gs_prior.to(gs.dtype)
    return Ass, gs


def _chain_factor32(p: V3Plan, vals32, rhs32, sc_prior=None, gs_prior=None):
    """Chain-mode factorization: batched cyclic reduction over the part
    tridiagonals + the dense separator core.  Returns
    (levels, root, Uflat, Xu, Xg, Ls, rhs_s).  ``sc_prior`` (Ms, Ms) /
    ``gs_prior`` (Ms,) add to the separator system / rhs."""
    bs = p.bs
    Gv, rhsf = _packed(vals32, rhs32)
    dt = vals32.dtype
    D = Gv[p.ch_d_idx] + p.ch_pad.to(dt)[..., None, None] * torch.eye(bs, dtype=dt, device=Gv.device)
    E = Gv[p.ch_e_idx]
    Ub, gk = _chain_gather_U(p, Gv, rhsf)
    Ass, gs = _add_prior(*_chain_sep_frames(p, Gv, rhsf, dt), sc_prior, gs_prior)

    levels, root = _cr_build(D, E)
    X = _cr_solve(levels, root, torch.cat([Ub, gk[..., None]], -1))  # (K, ch_m, bs, S+1)
    Xu = _chain_flat(p, X[..., : p.S])  # (K, M, S) = A^-1 U
    Xg = _chain_flat(p, X[..., p.S])  # (K, M)    = A^-1 b
    Uflat = _chain_flat(p, Ub)
    C = torch.einsum("kms,kmt->kst", Uflat, Xu)
    v = torch.einsum("kms,km->ks", Uflat, Xg)
    Ls, rhs_s = _separator(p, Ass, gs, C, v)
    return levels, root, Uflat, Xu, Xg, Ls, rhs_s


def _separator_solve(p: V3Plan, Ls, rhs_s):
    """xs = SC^-1 rhs_s through the two triangular-solve kernels, the rhs
    padded to 8 columns as on the TPU."""
    rs = F.pad(rhs_s[None, :, None], (0, 7))
    zs = dk.trsm_lower_batched(Ls, rs)
    xs = dk.trsm_lower_t_batched(Ls, zs)[0, :, 0]  # (Ms,)
    xs_blocks = torch.cat([xs[: p.SB * p.bs].reshape(-1, p.bs), xs.new_zeros(1, p.bs)], 0)
    return xs, xs_blocks[p.xs_idx].reshape(p.K, p.S)


def _gather_solution(p: V3Plan, xk, xs):
    """Interior (K, M) and separator (Ms,) solutions -> (n, bs) permuted fine."""
    x_int = xk[:, : p.mB * p.bs].reshape(p.K * p.mB, p.bs)
    x_rows = torch.cat([x_int, xs[: p.SB * p.bs].reshape(-1, p.bs)], 0)
    return x_rows[p.sol_gather]


def _chain_backsolve(p: V3Plan, Xu, Xg, Ls, rhs_s):
    """x_int = A^-1 b - (A^-1 U) x_s; no triangular solves on the parts."""
    xs, xsb = _separator_solve(p, Ls, rhs_s)
    xk = Xg - torch.einsum("kms,ks->km", Xu, xsb)
    return _gather_solution(p, xk, xs)


def _chain_solve_with(p: V3Plan, levels, root, Uflat, Xu, Ls, gk_fine):
    """Repeated solve for a new fine rhs (n+1, bs) through the cached chain
    factorization (refinement path)."""
    bs = p.bs
    gk = _pad_rows(gk_fine[p.gk_idx], p.ch_m)  # (K, ch_m, bs)
    gs = F.pad(gk_fine[p.gs_idx].reshape(-1)[: p.SB * bs], (0, p.Ms - p.SB * bs))
    Yg = _chain_flat(p, _cr_solve(levels, root, gk[..., None])[..., 0])
    v = torch.einsum("kms,km->ks", Uflat, Yg)
    rhs_s = gs - F.pad(_chain_rhs_reduce(p, v), (0, p.Ms - p.SB * bs))
    return _chain_backsolve(p, Xu, Yg, Ls, rhs_s)


def _factor32(p: V3Plan, vals32, rhs32, sc_prior=None, gs_prior=None):
    """Dense-frame factorization: (L, WU, y, Ls, rhs_s) for the solves;
    the prior as in :func:`_chain_factor32`."""
    Gv, rhsf = _packed(vals32, rhs32)
    A, U, Ass, gk, gs = _frames(p, Gv, rhsf, vals32.dtype)
    Ass, gs = _add_prior(Ass, gs, sc_prior, gs_prior)
    L = dk.chol_batched(A)  # (K, M, M)
    B = torch.cat([U, gk[..., None]], -1)
    B = F.pad(B, (0, (-B.shape[-1]) % 8))
    W = dk.trsm_lower_batched(L, B)  # (K, M, S+pad)
    WU = W[:, :, : p.S]
    y = W[:, :, p.S]
    C = torch.einsum("kms,kmt->kst", WU, WU)
    v = torch.einsum("kms,km->ks", WU, y)
    Ls, rhs_s = _separator(p, Ass, gs, C, v)
    return L, WU, y, Ls, rhs_s


def _solve_with(p: V3Plan, L, WU, Ls, gk_fine):
    """Solve for a new fine rhs (n+1, bs) given the cached factorization."""
    bs = p.bs
    gk = _pad_rows(gk_fine[p.gk_idx].reshape(p.K, p.mB * bs), p.M)
    gs = F.pad(gk_fine[p.gs_idx].reshape(-1)[: p.SB * bs], (0, p.Ms - p.SB * bs))
    y = dk.trsm_lower_batched(L, F.pad(gk[..., None], (0, 7)))[:, :, 0]  # (K, M)
    v = torch.einsum("kms,km->ks", WU, y)
    rhs_s = gs - F.pad(_chain_rhs_reduce(p, v), (0, p.Ms - p.SB * bs))
    return _backsolve(p, L, WU, Ls, y, rhs_s)


def _backsolve(p: V3Plan, L, WU, Ls, y, rhs_s):
    xs, xsb = _separator_solve(p, Ls, rhs_s)
    t = y - torch.einsum("kms,ks->km", WU, xsb)
    xk = dk.trsm_lower_t_batched(L, F.pad(t[..., None], (0, 7)))[:, :, 0]  # (K, M)
    return _gather_solution(p, xk, xs)


def _spmv_fine(p: V3Plan, vals, x):
    """y = A x on fine blocks (lower + diag stored); x: (n, bs)."""
    n = p.n
    t1 = torch.einsum("sij,sj->si", vals[: p.nnzb], x[p.cols])
    t2 = torch.einsum("sji,sj->si", vals[n : p.nnzb], x[p.rows[n:]])
    return grouped_segsum_last(torch.cat([t1, t2], 0).T, p.mv_grp).T


def _v3_solve_refined(p: V3Plan, vals64, b64, refine: int, damping_rel: float,
                      mixed: bool = True, sc_prior=None, gs_prior=None):
    """Partitioned solve of vals x = b: equilibrated float32 + float64
    refinement (``mixed``), or float64 end to end (``mixed=False``, which
    matches the dense oracle to ~1e-8 including the near-singular gauge
    mode).  vals64: (nnzb+1, bs, bs) fine lambda blocks (float32 accepted
    in mixed mode); b64: (n+1, bs) float64.

    ``sc_prior`` (Ms, Ms) / ``gs_prior`` (Ms,), float64, add to the
    separator system / rhs in the b64 sign convention, unscaled: mixed mode
    equilibrates them with the separator rows' scale factors, and the f64
    refinement residual includes the prior's term at the separator rows."""
    bs, n = p.bs, p.n
    if gs_prior is not None and sc_prior is None:
        raise ValueError("gs_prior requires sc_prior")
    if not mixed:
        b_f = torch.cat([b64[:n], b64.new_zeros(1, bs)], 0)
        with record_function("v3.factor"):
            L, WU, y, Ls, rhs_s = _factor32(p, vals64[: p.nnzb], b_f, sc_prior, gs_prior)
        with record_function("v3.backsolve"):
            return _backsolve(p, L, WU, Ls, y, rhs_s)
    d = torch.arange(bs, device=vals64.device)
    s = 1.0 / torch.sqrt(torch.clamp_min(vals64[:n, d, d], 1e-30))  # (n, bs)
    vs = vals64[: p.nnzb] * s[p.rows][:, :, None] * s[p.cols][:, None, :]
    vs[:n] += damping_rel * torch.eye(bs, dtype=vs.dtype, device=vs.device)
    vals32 = vs.float()
    b32 = torch.cat([(s * b64[:n]).float(), vals32.new_zeros(1, bs)], 0)

    scp = gsp = None
    if sc_prior is not None:
        # the separator frame's scale factors; padding rows keep scale 1
        sp = F.pad(s[p.gs_idx].reshape(-1)[: p.SB * bs], (0, p.Ms - p.SB * bs), value=1.0)
        scp = (sp[:, None] * sc_prior * sp[None, :]).float()
        if gs_prior is not None:
            gsp = (sp * gs_prior).float()

    if p.ch_ok:
        with record_function("v3.factor"):
            levels, root, Uflat, Xu, Xg, Ls, rhs_s = _chain_factor32(p, vals32, b32, scp, gsp)
        with record_function("v3.backsolve"):
            z = _chain_backsolve(p, Xu, Xg, Ls, rhs_s)
    else:
        with record_function("v3.factor"):
            L, WU, y, Ls, rhs_s = _factor32(p, vals32, b32, scp, gsp)
        with record_function("v3.backsolve"):
            z = _backsolve(p, L, WU, Ls, y, rhs_s)
    x = s * z.double()

    for _ in range(refine):
        r = b64[:n] - _spmv_fine(p, vals64.to(x.dtype), x)
        if sc_prior is not None:
            # the full system is (A + S sc S^T) x = b + S gs: the prior's
            # term at the separator rows, in f64 and unscaled
            sep = p.gs_idx[: p.SB]
            xs = F.pad(x[sep].reshape(-1), (0, p.Ms - p.SB * bs))
            pr = sc_prior @ xs
            if gs_prior is not None:
                pr = pr - gs_prior
            r = r.index_add(0, sep, -pr[: p.SB * bs].reshape(p.SB, bs))
        rs1 = torch.cat([(s * r).float(), vals32.new_zeros(1, bs)], 0)
        if p.ch_ok:
            z = _chain_solve_with(p, levels, root, Uflat, Xu, Ls, rs1)
        else:
            z = _solve_with(p, L, WU, Ls, rs1)
        x = x + s * z.double()
    return x


def _v3_gn_step_impl(graph: GraphArrays, bp, p: V3Plan, refine: int,
                     damping_rel: float, mixed: bool = True):
    # mixed mode assembles the Hessian blocks in float32; rhs and chi2 stay
    # float64, so the GN fixed point is unchanged
    with record_function("v3.assemble"):
        vals, rhs, chi2 = block_assembly.assemble_blocks_sorted(graph, bp, hessian_f32=mixed)
    x = _v3_solve_refined(p, vals, -rhs, refine, damping_rel, mixed)
    with record_function("v3.update"):
        dx = block_assembly.scatter_dx(bp, x)
        return apply_update(graph, dx), torch.linalg.norm(dx), chi2
