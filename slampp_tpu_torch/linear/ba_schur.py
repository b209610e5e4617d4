"""Large-scale bundle-adjustment Schur solver, observation-driven
(counterpart of ``slampp_tpu/linear/ba_schur.py``).

The reduced camera system is built directly from the observations, never
from a dense Hessian:

  * the residuals, the Jacobians and their products with the information,
    and each chi2 of the LM loop, come from ``ops/ba_kernels.py``: one
    float64 kernel launch on the card, the models' chain on the CPU;
  * observations sorted by landmark: the landmark blocks D_l, g_l and the
    back-substitution are grouped padded-gather sums (ops/segments.py),
    whose order is fixed by the plan;
  * a camera-grouped index map gives the block diagonal of H_cc and the
    camera rhs the same way (pure BA has no camera-camera edges);
  * the Schur complement's off-diagonal mass, SC -= sum_l U_l D_l^-1 U_l^T,
    expands into one 6 x 6 product per pair of observations that share a
    landmark, the pairs sorted by (cam_i, cam_j) and summed bucket by
    bucket in chunks of at most ``max_chunk`` pairs (bounded memory);
  * the dense SC (6 n_c)^2 is factored by ``torch.linalg.cholesky_ex``
    (the JAX package's ``lax.linalg.cholesky``, outside any kernel): in
    float64 (``sc_f64``), or equilibrated in float32 with a 1e-6 shift and
    one float64 refinement.  A failed factorization gives NaN, and the LM
    loop aborts as ``linear/dense.solve_spd``'s callers do.

The JAX module kept every per-observation array batch-last for the TPU's
tiling; the port keeps them batch-first, as torch's batched products take
them.  Its profiler spans (``utils/spans.py``: ``record_function`` ranges
while a profiler runs, one shared null context otherwise) form one tree:

  ba.solve             BigBASolver.optimize, one request
    ba.chi2            the chi2 at the start
    ba.iteration       each pass of the LM loop: step, host reads, gain test
      ba.jacobians, ba.landmarks, ba.pairs, ba.sc_build, ba.sc_factor,
      ba.backsub       the step's layers
      ba.chi2          the test's chi2 (every ``ba_chi2_only``)
      ba.lm_accept or ba.lm_reject   the branch the gain test takes

``apps/ba.py --profile`` and the benchmark's readers read them.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from slampp_tpu_torch.models import ba as ba_models
from slampp_tpu_torch.ops import ba_kernels
from slampp_tpu_torch.ops.segments import (
    GroupedSegments,
    grouped_segsum_first,
    plan_grouped_segments,
)
from slampp_tpu_torch.solvers.lm import lm_loop
from slampp_tpu_torch.utils.device import require_device
from slampp_tpu_torch.utils.spans import span, spanned


class PairBucket(NamedTuple):
    """A size class of the pair segments: segment ``seg_ids[g]`` is the pair
    range [starts[g], starts[g] + sizes[g]), padded to ``cap`` with the
    dummy pair (the JAX package's ``RangeBucket``): the padded index rows
    are made on the device, chunk by chunk."""

    seg_ids: torch.Tensor  # (G,)
    starts: torch.Tensor  # (G,)
    sizes: torch.Tensor  # (G,)
    cap: int


class BASchurPlan(NamedTuple):
    n_c: int
    n_l: int
    n_obs: int
    n_distinct: int  # distinct SC blocks the pair products touch
    # observation arrays sorted by landmark
    obs_cam: torch.Tensor  # (m,) int64
    obs_lm: torch.Tensor  # (m,) int64, ascending
    obs_uv: torch.Tensor  # (m, 2)
    obs_info: torch.Tensor  # (m, 2, 2)
    # grouped sums; the camera plan's rows are observation indices
    lm_grp: GroupedSegments
    cam_grp: GroupedSegments
    # observation pairs sharing a landmark, sorted by cam_i * n_c + cam_j,
    # with one dummy pair at M2 pointing at the dummy observation m
    pair_e: torch.Tensor  # (M2 + 1,) row side
    pair_f: torch.Tensor  # (M2 + 1,) column side
    pair_buckets: Tuple[PairBucket, ...]  # segments = distinct SC blocks
    sc_inv_map: torch.Tensor  # (n_c * n_c,) -> distinct id, or n_distinct (zero)
    anchor_cam: int  # -1 when the gauge anchor is a landmark
    anchor_lm: int  # -1 when the gauge anchor is a camera


def ba_system_arrays(system):
    """(cam ids, landmark ids, cam states, landmark states, obs_cam, obs_lm,
    uv, info, anchor_cam, anchor_lm) of a BA GraphSystem (cam / xyz
    vertices, edge_p2c): cameras and landmarks in vertex-id order, the
    gauge anchor as the system's unary anchor (a camera, a landmark, else
    camera 0)."""
    cam_ids = sorted(v for v, (t, _) in system.vertex_index.items() if t == "cam")
    lm_ids = sorted(v for v, (t, _) in system.vertex_index.items() if t == "xyz")
    cam_pos = {v: i for i, v in enumerate(cam_ids)}
    lm_pos = {v: i for i, v in enumerate(lm_ids)}
    rec = system._edges["edge_p2c"]
    oc = np.array([cam_pos[c] for _, c in rec["vids"]], np.int64)
    ol = np.array([lm_pos[p] for p, _ in rec["vids"]], np.int64)
    uv = np.asarray(rec["meas"], np.float64).reshape(-1, 2)
    info = np.asarray(rec["sigma_inv"], np.float64).reshape(-1, 2, 2)
    av = system._unary_anchor
    if av in cam_pos:
        anchor_cam, anchor_lm = cam_pos[av], -1
    elif av in lm_pos:
        anchor_cam, anchor_lm = -1, lm_pos[av]
    else:
        anchor_cam, anchor_lm = 0, -1
    cams = np.stack([system.vertex_state(v) for v in cam_ids])
    lms = np.stack([system.vertex_state(v) for v in lm_ids])
    return cam_ids, lm_ids, cams, lms, oc, ol, uv, info, anchor_cam, anchor_lm


def set_ba_states(system, cam_ids, lm_ids, cams: torch.Tensor, lms: torch.Tensor) -> None:
    """Writes camera and landmark states back to a BA GraphSystem, row i to
    vertex ``cam_ids[i]`` / ``lm_ids[i]``."""
    for ids, states in ((cam_ids, cams), (lm_ids, lms)):
        for v, x in zip(ids, states.cpu().numpy()):
            system.set_vertex_state(v, x)


def build_ba_schur_plan(system, device="cuda") -> BASchurPlan:
    """The host symbolic phase of a BA GraphSystem (cam / xyz vertices,
    edge_p2c)."""
    _, _, cams, lms, *obs = ba_system_arrays(system)
    return build_ba_schur_plan_arrays(len(cams), len(lms), *obs, device=device)


def segment_buckets(starts, ends, device, bucket_base: int = 2, min_cap: int = 8):
    """``plan_grouped_segments``' size classes of the segments [starts[g],
    ends[g]) (host arrays), as :class:`PairBucket` s on ``device``."""
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    sizes = ends - starts
    out, cap = [], min_cap
    remaining = np.flatnonzero(sizes > 0)
    while len(remaining):
        in_b = remaining[sizes[remaining] <= cap]
        remaining = remaining[sizes[remaining] > cap]
        if len(in_b):
            out.append(PairBucket(t(in_b), t(starts[in_b]), t(sizes[in_b]), cap))
        cap *= bucket_base
    return tuple(out)


def padded_chunks(buckets, dummy: int, max_chunk: int):
    """The segments of each :class:`PairBucket` in chunks of at most
    ``max_chunk`` padded rows: yields (the chunk's segment ids, its (rows,
    cap) row indices, ``dummy`` past each segment's end)."""
    for seg_ids, starts, sizes, cap in buckets:
        iota = torch.arange(cap, device=starts.device)
        rows = max(1, max_chunk // cap)
        for r0 in range(0, seg_ids.shape[0], rows):
            st, sz = starts[r0:r0 + rows], sizes[r0:r0 + rows]
            yield seg_ids[r0:r0 + rows], torch.where(iota[None, :] < sz[:, None],
                                                     st[:, None] + iota[None, :], dummy)


def _device_pairs(oc, ol, lm_starts, deg, M2: int, n_c: int):
    """The within-landmark unordered observation pairs (e <= f by
    observation index), their camera order made canonical, stably sorted by
    the flat key min(ci, cj) * n_c + max(ci, cj), on the device (the JAX
    package's ``_device_pairs``).  Returns (pair_e, pair_f)."""
    m = oc.shape[0]
    idx = torch.arange(m, dtype=torch.int64, device=oc.device)
    loc = idx - lm_starts[ol]
    reps = deg[ol] - loc  # pairs whose e is this observation
    pair_e = torch.repeat_interleave(idx, reps, output_size=M2)
    run_start = torch.cumsum(reps, 0) - reps
    offset = torch.arange(M2, dtype=torch.int64, device=oc.device) - torch.repeat_interleave(
        run_start, reps, output_size=M2)
    pair_f = pair_e + offset
    ci, cj = oc[pair_e], oc[pair_f]
    swap = ci > cj
    pe = torch.where(swap, pair_f, pair_e)
    pf = torch.where(swap, pair_e, pair_f)
    flat = torch.minimum(ci, cj) * n_c + torch.maximum(ci, cj)
    order = torch.sort(flat, stable=True).indices
    return pe[order], pf[order]


def build_ba_schur_plan_arrays(n_c: int, n_l: int, oc, ol, uv, info, anchor_cam: int = 0,
                               anchor_lm: int = -1, device="cuda") -> BASchurPlan:
    """The vectorized host symbolic phase from raw observation arrays (the
    venice-scale entry point: no Python loop over observations or
    landmarks).  The O(sum deg^2) pair table is generated and sorted on the
    device; the host derives only the pair counts per SC block from the
    sparse incidence product P^T P."""
    device = torch.device(device)
    oc, ol = np.asarray(oc, np.int64), np.asarray(ol, np.int64)
    m = len(oc)
    order = np.argsort(ol, kind="stable")
    oc, ol, uv, info = oc[order], ol[order], np.asarray(uv)[order], np.asarray(info)[order]

    lm_starts = np.searchsorted(ol, np.arange(n_l))
    lm_ends = np.searchsorted(ol, np.arange(n_l) + 1)
    lm_grp = plan_grouped_segments(lm_starts, lm_ends, m)

    cam_perm = np.argsort(oc, kind="stable")
    oc_sorted = oc[cam_perm]
    cam_starts = np.searchsorted(oc_sorted, np.arange(n_c))
    cam_ends = np.searchsorted(oc_sorted, np.arange(n_c) + 1)
    perm_pad = np.concatenate([cam_perm, [m]]).astype(np.int64)
    cam_grp = plan_grouped_segments(cam_starts, cam_ends, m, remap=perm_pad)

    # unordered pairs sharing a landmark (e <= f), keyed by the canonical
    # (min(ci, cj), max(ci, cj)): SC's symmetry lets the device form each
    # pair once and mirror the reduced grid
    deg = (lm_ends - lm_starts).astype(np.int64)
    M2 = int((deg * (deg + 1) // 2).sum())
    P = sp.csr_matrix((np.ones(m, np.int64), (ol, oc)), shape=(n_l, n_c))
    G = (P.T @ P).tocsr()
    G.sort_indices()
    Gc = sp.triu(G, k=0).tocsr()
    rows_nz, cols_nz = Gc.nonzero()
    counts = np.asarray(Gc[rows_nz, cols_nz]).ravel().astype(np.int64)
    # off-diagonal keys count each unordered cross pair once; diagonal keys
    # count ordered pairs (m_i^2 per landmark): (m_i^2 + m_i) / 2 unordered
    diag_mask = rows_nz == cols_nz
    cam_obs = np.bincount(oc, minlength=n_c)
    counts[diag_mask] = (counts[diag_mask] + cam_obs[rows_nz[diag_mask]]) // 2
    distinct = rows_nz.astype(np.int64) * n_c + cols_nz.astype(np.int64)
    ends = np.cumsum(counts)
    starts = ends - counts
    n_distinct = len(distinct)
    if M2 != int(counts.sum()):
        raise ValueError(f"pair count mismatch: {M2} != {int(counts.sum())}")
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    pair_e, pair_f = _device_pairs(t(oc), t(ol), t(lm_starts.astype(np.int64)), t(deg), M2, n_c)
    dummy = torch.full((1,), m, dtype=torch.int64, device=device)

    grid = np.arange(n_c * n_c, dtype=np.int64)
    if n_distinct:
        pos = np.minimum(np.searchsorted(distinct, grid), n_distinct - 1)
        sc_inv_map = np.where(distinct[pos] == grid, pos, n_distinct)
    else:
        sc_inv_map = np.full(grid.shape, n_distinct, np.int64)

    return BASchurPlan(
        n_c=n_c, n_l=n_l, n_obs=m, n_distinct=n_distinct,
        obs_cam=t(oc), obs_lm=t(ol),
        obs_uv=torch.as_tensor(uv, dtype=torch.float64, device=device),
        obs_info=torch.as_tensor(info, dtype=torch.float64, device=device),
        lm_grp=lm_grp.to(device), cam_grp=cam_grp.to(device),
        pair_e=torch.cat([pair_e, dummy]), pair_f=torch.cat([pair_f, dummy]),
        pair_buckets=segment_buckets(starts, ends, device), sc_inv_map=t(sc_inv_map),
        anchor_cam=int(anchor_cam), anchor_lm=int(anchor_lm),
    )


def inv3(D: torch.Tensor) -> torch.Tensor:
    """Closed-form (n, 3, 3) inverses by the adjugate, as the JAX package's
    ``_inv3_last``."""
    a, b, c = D[:, 0, 0], D[:, 0, 1], D[:, 0, 2]
    d, e, f = D[:, 1, 0], D[:, 1, 1], D[:, 1, 2]
    g, h, i = D[:, 2, 0], D[:, 2, 1], D[:, 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    Dd = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d  # noqa: E741
    inv_det = 1.0 / (a * A + b * Dd + c * G)
    adj = torch.stack([torch.stack([A, B, C], -1), torch.stack([Dd, E, F], -1),
                       torch.stack([G, H, I], -1)], -2)
    return adj * inv_det[:, None, None]


def observation_sums(plan: BASchurPlan, r, Jp, Jc, WJp, WJc):
    """The landmark and camera sums of ``ba_kernels.p2c_linearize``'s
    per-observation terms: (D (n_l, 3, 3), g_l (n_l, 3), H_cc's diagonal
    blocks (n_c, 6, 6), g_c (n_c, 6), B (m, 6, 3)), D and H_cc undamped,
    B_e = J_c^T W J_p."""
    D = grouped_segsum_first(Jp.transpose(1, 2) @ WJp, plan.lm_grp)
    g_l = grouped_segsum_first(torch.einsum("mri,mr->mi", WJp, r), plan.lm_grp)
    Hcc_diag = grouped_segsum_first(Jc.transpose(1, 2) @ WJc, plan.cam_grp)
    g_c = grouped_segsum_first(torch.einsum("mri,mr->mi", WJc, r), plan.cam_grp)
    return D, g_l, Hcc_diag, g_c, Jc.transpose(1, 2) @ WJp


def pair_sc_mass(plan: BASchurPlan, BD: torch.Tensor, B: torch.Tensor,
                 max_chunk: int = 1_000_000, pair_f32: bool = True) -> torch.Tensor:
    """The half-triangle SC mass: for every distinct (cam_i, cam_j) block,
    the sum over the unordered landmark-sharing observation pairs of BD_e
    B_f^T (e == f pairs scaled by 0.5, so that the mirror G + G^T in
    :func:`reduced_camera_system` restores the full ordered sum).  BD = B
    D^-1 per observation, B: (m, 6, 3).  Returns (n_distinct + 1, 6, 6)
    with a zero block at n_distinct.  Each bucket is reduced in chunks of
    at most ``max_chunk`` padded pairs; ``pair_f32`` forms the products in
    float32 (the SC is equilibrated in float32 downstream anyway)."""
    dt = torch.float32 if pair_f32 else BD.dtype
    BDp = torch.cat([BD.to(dt), BD.new_zeros((1, 6, 3), dtype=dt)], 0)  # (m + 1, 6, 3)
    Bp = torch.cat([B.to(dt), B.new_zeros((1, 6, 3), dtype=dt)], 0)
    out = BD.new_zeros((plan.n_distinct + 1, 6, 6), dtype=dt)
    for seg, ix in padded_chunks(plan.pair_buckets, plan.pair_e.shape[0] - 1, max_chunk):
        pe, pf = plan.pair_e[ix], plan.pair_f[ix]  # (rows, cap)
        scale = torch.where(pe == pf, 0.5, 1.0).to(dt)
        prod = torch.einsum("rcik,rcjk->rcij", BDp[pe], Bp[pf]) * scale[:, :, None, None]
        out[seg] = prod.sum(1)
    return out


def reduced_camera_system(plan: BASchurPlan, mass: torch.Tensor, diag: torch.Tensor,
                          out: torch.Tensor = None) -> torch.Tensor:
    """The reduced camera system (6 n_c, 6 n_c) in ``diag``'s dtype: the
    diagonal blocks ``diag`` (n_c, 6, 6), as the caller damped them, minus
    the pair mass mirrored, block (ci, cj) -= G_ij + G_ji^T; written into
    ``out`` when given."""
    n_c = plan.n_c
    Gg = mass[plan.sc_inv_map].to(diag.dtype).reshape(n_c, n_c, 6, 6)
    SCb = -(Gg + Gg.permute(1, 0, 3, 2))
    ids = torch.arange(n_c, device=SCb.device)
    SCb[ids, ids] += diag
    if out is None:
        out = SCb.new_empty((6 * n_c, 6 * n_c))
    out.view(n_c, 6, n_c, 6).copy_(SCb.permute(0, 2, 1, 3))
    return out


def reduced_rhs(plan: BASchurPlan, BD: torch.Tensor, g_l: torch.Tensor,
                g_c: torch.Tensor) -> torch.Tensor:
    """The reduced right-hand side (6 n_c,): -(g_c - sum_l U_l D_l^-1 g_l),
    per observation BD_e g_l."""
    r2 = grouped_segsum_first(torch.einsum("mik,mk->mi", BD, g_l[plan.obs_lm]), plan.cam_grp)
    return -(g_c - r2).reshape(-1)


def sc_cholesky(SC: torch.Tensor) -> torch.Tensor:
    """The lower Cholesky factor of the symmetrized SC, NaN where it fails."""
    L, info = torch.linalg.cholesky_ex(0.5 * (SC + SC.T))
    return torch.where(info == 0, L, torch.nan)


def back_substitute(plan: BASchurPlan, B: torch.Tensor, Dinv: torch.Tensor, g_l: torch.Tensor,
                    dx_c: torch.Tensor):
    """(dx_c as (n_c, 6) blocks, dx_l (n_l, 3)): dx_l = D^-1 (-g_l - sum_e
    B_e^T dx_c[cam_e])."""
    dxc_blocks = dx_c.reshape(plan.n_c, 6)
    bt = torch.einsum("mik,mi->mk", B, dxc_blocks[plan.obs_cam])  # (m, 3)
    BT = grouped_segsum_first(bt, plan.lm_grp)
    return dxc_blocks, torch.einsum("lij,lj->li", Dinv, -g_l - BT)


def ba_schur_lm_step(plan: BASchurPlan, cam_states: torch.Tensor, lm_states: torch.Tensor,
                     alpha: float, sc_f64: bool = True, pair_f32: bool = True):
    """One damped (LM) BA iteration with no dense Hessian.  cam_states
    (n_c, 11), lm_states (n_l, 3).  Returns (new_cams, new_lms, dx_norm,
    chi2, denom); ``sc_f64`` factors SC in float64, else equilibrated
    float32 with one float64 refinement."""
    with span("ba.jacobians"):
        # r (m, 2), Jp (m, 2, 3), Jc (m, 2, 6), W Jp, W Jc and chi2: one
        # kernel launch on the card (ops/ba_kernels.py)
        r, Jp, Jc, WJp, WJc, chi2 = ba_kernels.p2c_linearize(
            cam_states, lm_states, plan.obs_cam, plan.obs_lm, plan.obs_uv, plan.obs_info)

    with span("ba.landmarks"):
        D, g_l, Hcc_diag, g_c, B = observation_sums(plan, r, Jp, Jc, WJp, WJc)
        eye3 = torch.eye(3, dtype=D.dtype, device=D.device)
        D = D + alpha * eye3
        if plan.anchor_lm >= 0:
            D[plan.anchor_lm] += eye3
        Dinv = inv3(D)
        BD = B @ Dinv[plan.obs_lm]  # (m, 6, 3)

    with span("ba.pairs"):
        mass = pair_sc_mass(plan, BD, B, pair_f32=pair_f32)

    with span("ba.sc_build"):
        eye6 = torch.eye(6, dtype=Hcc_diag.dtype, device=Hcc_diag.device)
        diag = Hcc_diag + alpha * eye6
        if plan.anchor_cam >= 0:
            diag[plan.anchor_cam] += eye6
        SC = reduced_camera_system(plan, mass, diag)
        rhs = reduced_rhs(plan, BD, g_l, g_c)

    with span("ba.sc_factor"):
        if sc_f64:
            dx_c = torch.cholesky_solve(rhs[:, None], sc_cholesky(SC))[:, 0]
        else:
            s = 1.0 / torch.sqrt(torch.clamp_min(torch.diagonal(SC), 1e-30))
            SCs = (SC * s[:, None] * s[None, :]).float()
            SCs = SCs + 1e-6 * torch.eye(SC.shape[0], dtype=torch.float32, device=SC.device)
            L = sc_cholesky(SCs)

            def solve32(rr):
                return s * torch.cholesky_solve((s * rr).float()[:, None], L)[:, 0].to(SC.dtype)

            dx_c = solve32(rhs)
            dx_c = dx_c + solve32(rhs - SC @ dx_c)

    with span("ba.backsub"):
        dxc_blocks, dx_l = back_substitute(plan, B, Dinv, g_l, dx_c)
        new_cams = ba_models._cam_retract(cam_states, dxc_blocks)
        new_lms = lm_states + dx_l
        sq = torch.dot(dx_c, dx_c) + (dx_l * dx_l).sum()
        # the LM gain denominator dx . (alpha dx - g) with the full gradient
        denom = alpha * sq - ((dxc_blocks * g_c).sum() + (dx_l * g_l).sum())
    return new_cams, new_lms, torch.sqrt(sq), chi2, denom


@spanned("ba.chi2")
def ba_chi2_only(plan: BASchurPlan, cam_states: torch.Tensor, lm_states: torch.Tensor):
    """Residual-only chi2 (no Jacobians, no SC): the LM loop's accept /
    reject test, so that a rejected step costs O(m) (reference
    NonlinearSolver_Lambda_LM.h:205-230); one kernel launch on the card."""
    return ba_kernels.p2c_chi2(cam_states, lm_states, plan.obs_cam, plan.obs_lm, plan.obs_uv,
                               plan.obs_info)


class BigBASolver:
    """LM over the observation-driven Schur step (the venice-class solver)."""

    def __init__(self, system, verbose: bool = False, tau: float = 1e-3, sc_f64: bool = True,
                 pair_f32: bool = True, device="cuda"):
        self.system = system
        self.verbose = verbose
        self.tau = tau
        self.sc_f64 = sc_f64
        self.pair_f32 = pair_f32
        self.device = torch.device(device)
        self.plan = None
        self._cams = None
        self._lms = None

    @classmethod
    def from_arrays(cls, cam_states, lm_states, obs_cam, obs_lm, uv, info, verbose: bool = False,
                    tau: float = 1e-3, sc_f64: bool = False, pair_f32: bool = True,
                    device="cuda"):
        """The venice-scale constructor from raw observation arrays (no
        GraphSystem or parser in the loop)."""
        self = cls(system=None, verbose=verbose, tau=tau, sc_f64=sc_f64, pair_f32=pair_f32,
                   device=device)
        require_device(self.device, "BigBASolver")
        self.plan = build_ba_schur_plan_arrays(len(cam_states), len(lm_states), obs_cam, obs_lm,
                                               uv, info, device=self.device)
        self._cams = torch.as_tensor(cam_states, dtype=torch.float64, device=self.device)
        self._lms = torch.as_tensor(lm_states, dtype=torch.float64, device=self.device)
        return self

    def step(self, cams, lms, alpha):
        """One ``ba_schur_lm_step`` with this solver's precision options."""
        return ba_schur_lm_step(self.plan, cams, lms, alpha, sc_f64=self.sc_f64,
                                pair_f32=self.pair_f32)

    def _prepare(self):
        require_device(self.device, "BigBASolver")
        if self.system is None:
            return None, None, self._cams, self._lms
        cam_ids, lm_ids, cams, lms, *obs = ba_system_arrays(self.system)
        if self.plan is None:
            self.plan = build_ba_schur_plan_arrays(len(cams), len(lms), *obs, device=self.device)
        t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=self.device)  # noqa: E731
        return cam_ids, lm_ids, t(cams), t(lms)

    @spanned("ba.solve")
    def optimize(self, max_iterations: int = 5, min_dx_norm: float = 0.01) -> int:
        cam_ids, lm_ids, cams, lms = self._prepare()

        def step(state, alpha):
            nc, nl, dxn, _, denom = self.step(*state, alpha)
            return (nc, nl), denom, dxn

        # alpha starts scale-free and is adapted by the gain ratio
        (self._cams, self._lms), applied, _, _ = lm_loop(
            (cams, lms), step, lambda s: float(ba_chi2_only(self.plan, *s)), self.tau * 1e3,
            max_iterations, min_dx_norm, ("ba.iteration", "ba.lm_accept", "ba.lm_reject"),
            self.verbose and "BigBA iter {it}: {verdict} chi2={chi2:.2f} alpha={alpha:.2e}")
        if self.system is not None:
            set_ba_states(self.system, cam_ids, lm_ids, self._cams, self._lms)
        return applied

    def chi2(self) -> float:
        _, _, cams, lms = self._prepare()
        return float(ba_chi2_only(self.plan, cams, lms))
