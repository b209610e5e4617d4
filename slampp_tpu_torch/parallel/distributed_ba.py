"""Distributed bundle adjustment by landmark-sharded Schur reduction
(counterpart of ``slampp_tpu/parallel/distributed_ba.py``).

Landmarks and their observations are partitioned over the ranks; each rank
assembles its local contributions, the reduced camera system is summed over
the ranks (one ``all_reduce`` per step), factored replicated, and the
landmarks back-substitute rank-locally:

  per rank:   H_cc += sum_obs J_c^T W J_c        (partial, all-reduced)
              D_l   = sum_obs J_l^T W J_l        (local landmarks)
              U_l   = stacked J_c^T W J_l        (local couplings)
              SC_part = H_cc_part - sum_l U_l D_l^-1 U_l^T
  all-reduce: SC, rhs_c, g_c, chi2
  replicated: dense Cholesky of SC -> dx_c
  local:      dx_l = D_l^-1 (g_l - U_l^T dx_c)

Rank r owns landmarks [r per, (r + 1) per) with per = ceil(n_l / world); the
last rank's padding slots get an identity D and stay put.  The venice-class
path (:class:`BigBAShards`, :func:`distributed_big_ba_step`,
:class:`DistributedBigBASolver`, :func:`distributed_big_ba_marginals`)
builds each rank's plan on its own landmarks and runs the single-card step's
pieces (``linear/ba_schur.py``: the hand-written reprojection kernel on the
card, the pair-reduced SC mass in float64 products as the JAX module does)
around its collectives; :func:`distributed_ba_lm_step` is the JAX module's
dense form, a (per, 6 n_c, 3) accumulator per rank, for small problems.  The
replicated SC factor is ``torch.linalg.cholesky_ex``
(``lax.linalg.cholesky`` in the JAX module, outside any kernel); a failed
factorization gives NaN and the LM loop stops on a non-finite step.  Each
step marks its layers as profiler ranges (``dist.jacobians``,
``dist.pairs``, ``dist.allreduce``, ``dist.sc_factor``, ``dist.backsub``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slampp_tpu_torch.linear.ba_schur import (
    BASchurPlan,
    back_substitute,
    ba_chi2_only,
    ba_system_arrays,
    build_ba_schur_plan_arrays,
    inv3,
    observation_sums,
    padded_chunks,
    pair_sc_mass,
    reduced_camera_system,
    reduced_rhs,
    sc_cholesky,
    segment_buckets,
    set_ba_states,
)
from slampp_tpu_torch.linear.dense import solve_spd
from slampp_tpu_torch.models import ba as ba_models
from slampp_tpu_torch.ops import ba_kernels
from slampp_tpu_torch.parallel.distributed import Mesh
from slampp_tpu_torch.solvers.lm import lm_loop
from slampp_tpu_torch.utils.spans import span

F64 = torch.float64


def _local_landmarks(lm_states, mesh: Mesh):
    """This rank's landmark states (per, 3) with padding zeros, their valid
    mask, and (lo, hi)."""
    lo, hi, per = mesh.share(len(lm_states))
    lms = torch.zeros((per, 3), dtype=F64, device=mesh.device)
    lms[: hi - lo] = torch.as_tensor(np.asarray(lm_states)[lo:hi], dtype=F64, device=mesh.device)
    return lms, torch.arange(per, device=mesh.device) < hi - lo, lo, hi


def _damped_landmarks(D, alpha, lm_valid, lo: int, anchor_lm: int):
    """D + alpha I, +I on the gauge anchor's block on the rank that owns it,
    identity on padding slots; returns D^-1."""
    eye3 = torch.eye(3, dtype=D.dtype, device=D.device)
    D = D + alpha * eye3
    loc = anchor_lm - lo
    if anchor_lm >= 0 and 0 <= loc < D.shape[0]:
        D[loc] += eye3
    return inv3(torch.where(lm_valid[:, None, None], D, eye3))


def _damp_cameras(SC, alpha, anchor_cam: int):
    """SC + alpha I, +I on the anchor camera's block (after the reduction,
    so once)."""
    SC.diagonal().add_(alpha)
    if anchor_cam >= 0:
        SC.diagonal()[6 * anchor_cam: 6 * anchor_cam + 6] += 1.0


def _gain_terms(mesh: Mesh, dx_c, dx_l, g_c_tot, g_l, alpha):
    """(|dx|, the LM gain denominator alpha |dx|^2 - dx . g): the camera
    parts replicated, the landmark parts summed over the ranks."""
    loc = mesh.all_reduce(torch.stack([(dx_l * dx_l).sum(), (dx_l * g_l).sum()]))
    sq = torch.dot(dx_c, dx_c) + loc[0]
    return torch.sqrt(sq), alpha * sq - (torch.dot(dx_c, g_c_tot) + loc[1])


# ------------------------------------------------- venice-class, pair-reduced


class BigBAShards(NamedTuple):
    """One rank's share of a venice-scale BA problem.  Nothing is dense in
    the landmark x camera product: the rank's plan reduces the Schur
    off-diagonal mass per observation pair (``linear/ba_schur.py``), so a
    rank holds O(local observations + local pairs + (6 n_c)^2)."""

    cam_states: torch.Tensor  # (n_c, 11) replicated
    lm_states: torch.Tensor  # (per, 3) landmarks [lo, lo + per), zero padding
    lm_valid: torch.Tensor  # (per,) bool
    plan: BASchurPlan  # this rank's observations; n_l = per, landmark ids local
    n_l: int  # landmarks over all ranks
    lo: int  # global index of local landmark 0
    anchor_cam: int  # gauge anchor camera, or -1
    anchor_lm: int  # gauge anchor landmark (global index), or -1


def build_big_ba_shards_arrays(cam_states, lm_states, obs_cam, obs_lm, uv, info, mesh: Mesh,
                               anchor_cam: int = 0, anchor_lm: int = -1) -> BigBAShards:
    """This rank's :class:`BigBAShards` from raw observation arrays (the
    venice-scale entry point: no GraphSystem, no Python loop over
    observations or landmarks)."""
    lms, valid, lo, hi = _local_landmarks(lm_states, mesh)
    ol = np.asarray(obs_lm, np.int64)
    mine = (ol >= lo) & (ol < hi)
    plan = build_ba_schur_plan_arrays(len(cam_states), lms.shape[0],
                                      np.asarray(obs_cam, np.int64)[mine], ol[mine] - lo,
                                      np.asarray(uv)[mine], np.asarray(info)[mine],
                                      anchor_cam=-1, anchor_lm=-1, device=mesh.device)
    cams = torch.as_tensor(np.asarray(cam_states), dtype=F64, device=mesh.device)
    return BigBAShards(cams, lms, valid, plan, len(lm_states), lo, int(anchor_cam),
                       int(anchor_lm))


def build_big_ba_shards(system, mesh: Mesh) -> BigBAShards:
    """This rank's :class:`BigBAShards` of a BA GraphSystem."""
    _, _, cams, lms, oc, ol, uv, info, anchor_cam, anchor_lm = ba_system_arrays(system)
    return build_big_ba_shards_arrays(cams, lms, oc, ol, uv, info, mesh, anchor_cam, anchor_lm)


def _rank_system(sh: BigBAShards, alpha, out):
    """The rank's observation terms, damped landmark blocks and undamped SC
    part (float64 pair products, written into ``out`` (6 n_c, 6 n_c)), from
    ``linear/ba_schur.py``'s pieces: (chi2, B, BD, D^-1, g_l, g_c)."""
    p = sh.plan
    with span("dist.jacobians"):
        r, Jp, Jc, WJp, WJc, chi2 = ba_kernels.p2c_linearize(
            sh.cam_states, sh.lm_states, p.obs_cam, p.obs_lm, p.obs_uv, p.obs_info)
        D, g_l, Hcc, g_c, B = observation_sums(p, r, Jp, Jc, WJp, WJc)
        Dinv = _damped_landmarks(D, alpha, sh.lm_valid, sh.lo, sh.anchor_lm)
        BD = B @ Dinv[p.obs_lm]
    with span("dist.pairs"):
        reduced_camera_system(p, pair_sc_mass(p, BD, B, pair_f32=False), Hcc, out)
    return chi2, B, BD, Dinv, g_l, g_c


def distributed_big_ba_step(shards: BigBAShards, mesh: Mesh, alpha):
    """One damped (LM) BA iteration, observation-driven, landmark-sharded:
    the rank's landmark blocks and pair-reduced SC part, ONE all-reduce of
    (SC, rhs, g_c, chi2), the replicated SC Cholesky, the rank-local
    landmark back-substitution, and one all-reduce of the two landmark
    scalars of the gain.  ``linear/ba_schur.ba_schur_lm_step``'s pieces
    (float64 pair products) around the collectives.  Returns (new_cams
    (replicated), new_lms (this rank's, (per, 3)), dx_norm, chi2, denom)."""
    p = shards.plan
    N = 6 * p.n_c
    # one buffer, one collective: SC (N^2), rhs (N), g_c (N), chi2
    buf = torch.empty(N * N + 2 * N + 1, dtype=F64, device=mesh.device)
    SC = buf[: N * N].view(N, N)
    chi2, B, BD, Dinv, g_l, g_c = _rank_system(shards, alpha, SC)
    with span("dist.pairs"):
        buf[N * N: N * N + N] = reduced_rhs(p, BD, g_l, g_c)
        buf[N * N + N: -1] = g_c.reshape(-1)
        buf[-1] = chi2
    mesh.all_reduce(buf)
    rhs, g_c_tot, chi2 = buf[N * N: N * N + N], buf[N * N + N: -1], buf[-1]

    with span("dist.sc_factor"):
        _damp_cameras(SC, alpha, shards.anchor_cam)
        dx_c = torch.cholesky_solve(rhs[:, None], sc_cholesky(SC))[:, 0]

    with span("dist.backsub"):
        dxc_blocks, dx_l = back_substitute(p, B, Dinv, g_l, dx_c)
        new_cams = ba_models._cam_retract(shards.cam_states, dxc_blocks)
        dx_norm, denom = _gain_terms(mesh, dx_c, dx_l, g_c_tot, g_l, alpha)
    return new_cams, shards.lm_states + dx_l, dx_norm, chi2, denom


def distributed_chi2(shards: BigBAShards, mesh: Mesh) -> float:
    """chi2 over every rank's observations (residuals only)."""
    return float(mesh.all_reduce(ba_chi2_only(shards.plan, shards.cam_states,
                                              shards.lm_states)[None])[0])


class DistributedBigBASolver:
    """LM over the landmark-sharded observation-driven Schur step, the
    multi-rank venice-class solver.  Every rank runs it on its own share;
    the LM decisions read only all-reduced values, so the ranks agree."""

    def __init__(self, system, mesh: Mesh, verbose: bool = False, tau: float = 1e-3):
        self.system = system
        self.mesh = mesh
        self.verbose = verbose
        self.tau = tau
        self.shards = None
        self.landmarks = None  # (n_l, 3) on every rank after optimize

    @classmethod
    def from_arrays(cls, cam_states, lm_states, obs_cam, obs_lm, uv, info, mesh: Mesh,
                    verbose: bool = False, tau: float = 1e-3, anchor_cam: int = 0,
                    anchor_lm: int = -1):
        """The venice-scale constructor from raw observation arrays."""
        self = cls(None, mesh, verbose, tau)
        self.shards = build_big_ba_shards_arrays(cam_states, lm_states, obs_cam, obs_lm, uv,
                                                 info, mesh, anchor_cam, anchor_lm)
        return self

    def _prepare(self) -> BigBAShards:
        if self.shards is None:
            self.shards = build_big_ba_shards(self.system, self.mesh)
        return self.shards

    def optimize(self, max_iterations: int = 5, min_dx_norm: float = 0.01) -> int:
        """``solvers/lm.lm_loop`` from alpha = tau * 1e3, each candidate's chi2
        from a full step at the candidate, as in the JAX module.  Ends with an
        all-gather of the landmarks, and writes every state back to the
        GraphSystem (on every rank)."""
        mesh = self.mesh

        def step(sh, alpha):
            nc, nl, dxn, _, denom = distributed_big_ba_step(sh, mesh, alpha)
            return sh._replace(cam_states=nc, lm_states=nl), denom, dxn

        sh, applied, _, _ = lm_loop(
            self._prepare(), step, lambda sh: float(distributed_big_ba_step(sh, mesh, 0.0)[3]),
            self.tau * 1e3, max_iterations, min_dx_norm, verbose=self.verbose and mesh.rank == 0
            and "DistBigBA: {verdict} chi2={chi2:.2f} alpha={alpha:.2e}")
        self.shards = sh
        self.landmarks = mesh.all_gather(sh.lm_states)[: sh.n_l]
        if self.system is not None:
            set_ba_states(self.system, *ba_system_arrays(self.system)[:2], sh.cam_states,
                          self.landmarks)
        return applied

    def chi2(self) -> float:
        return distributed_chi2(self._prepare(), self.mesh)


# --------------------------------------------------------- dense, per landmark


class BAShards(NamedTuple):
    """One rank's share of a small BA problem for the dense step: its
    landmarks' observations in edge order, landmark ids local."""

    cam_states: torch.Tensor  # (n_c, 11) replicated
    lm_states: torch.Tensor  # (per, 3)
    lm_valid: torch.Tensor  # (per,)
    obs_cam: torch.Tensor  # (m,) int64
    obs_lm: torch.Tensor  # (m,) int64 local landmark slot
    obs_uv: torch.Tensor  # (m, 2)
    obs_info: torch.Tensor  # (m, 2, 2)
    lo: int
    anchor_cam: int
    anchor_lm: int  # global index, or -1


def build_ba_shards(system, mesh: Mesh) -> BAShards:
    """This rank's :class:`BAShards` of a BA GraphSystem (cam / xyz
    vertices, edge_p2c)."""
    _, _, cams, lm_states, oc, ol, uv, info, anchor_cam, anchor_lm = ba_system_arrays(system)
    lms, valid, lo, hi = _local_landmarks(lm_states, mesh)
    mine = (ol >= lo) & (ol < hi)
    t = lambda a, dt=F64: torch.as_tensor(a, dtype=dt, device=mesh.device)  # noqa: E731
    return BAShards(t(cams), lms, valid, t(oc[mine], torch.int64), t(ol[mine] - lo, torch.int64),
                    t(uv[mine]), t(info[mine]), lo, anchor_cam, anchor_lm)


def distributed_ba_lm_step(shards: BAShards, mesh: Mesh, alpha):
    """One damped (LM) BA iteration with the sharded Schur reduction in the
    JAX module's dense form: the camera blocks scattered into a dense H_cc
    and each local landmark's couplings into (per, 6 n_c, 3) accumulators.
    Returns (new_cams (replicated), new_lms (this rank's), dx_norm, chi2,
    denom); denom is the gain denominator dx . (alpha dx - g) with the
    reduced camera right-hand side, as in the JAX module."""
    sh = shards
    n_c, per = sh.cam_states.shape[0], sh.lm_states.shape[0]
    N = 6 * n_c
    dev = mesh.device
    r, (Jp, Jc) = ba_models._edge_p2c_jacobians(
        (sh.lm_states[sh.obs_lm], sh.cam_states[sh.obs_cam]), sh.obs_uv)
    W = sh.obs_info
    WJc, WJp = W @ Jc, W @ Jp
    rows = sh.obs_cam[:, None] * 6 + torch.arange(6, device=dev)[None, :]

    # one buffer, one collective: SC part (N^2), rhs part (N), chi2
    buf = torch.zeros(N * N + N + 1, dtype=F64, device=dev)
    SC = buf[: N * N].view(N, N)
    SC.index_put_((rows[:, :, None], rows[:, None, :]), Jc.transpose(1, 2) @ WJc, accumulate=True)
    g_c = torch.zeros(N, dtype=F64, device=dev).index_put_(
        (rows,), torch.einsum("eij,ei->ej", WJc, r), accumulate=True)
    D = torch.zeros((per, 3, 3), dtype=F64, device=dev).index_add_(
        0, sh.obs_lm, Jp.transpose(1, 2) @ WJp)
    g_l = torch.zeros((per, 3), dtype=F64, device=dev).index_add_(
        0, sh.obs_lm, torch.einsum("eij,ei->ej", WJp, r))
    Dinv = _damped_landmarks(D, alpha, sh.lm_valid, sh.lo, sh.anchor_lm)
    # SC[a, b] -= B_e Dinv_l B_f^T over observation pairs sharing landmark l,
    # through per-landmark camera-stacked accumulators of B D^-1 and B
    B = Jc.transpose(1, 2) @ WJp  # (m, 6, 3)
    BD = B @ Dinv[sh.obs_lm]
    T_BD = torch.zeros((per, N, 3), dtype=F64, device=dev)
    T_B = torch.zeros((per, N, 3), dtype=F64, device=dev)
    T_BD.index_put_((sh.obs_lm[:, None], rows), BD, accumulate=True)
    T_B.index_put_((sh.obs_lm[:, None], rows), B, accumulate=True)
    SC -= torch.einsum("lad,lbd->ab", T_BD, T_B)
    buf[N * N: -1] = g_c - torch.einsum("lad,ld->a", T_BD, g_l)
    buf[-1] = (r * torch.einsum("eij,ej->ei", W, r)).sum()
    mesh.all_reduce(buf)
    rhs, chi2 = buf[N * N: -1], buf[-1]

    _damp_cameras(SC, alpha, sh.anchor_cam)
    dx_c = solve_spd(SC, -rhs)
    dx_l = torch.einsum("lde,le->ld", Dinv, -g_l - torch.einsum("lad,a->ld", T_B, dx_c))
    new_cams = ba_models._cam_retract(sh.cam_states, dx_c.view(n_c, 6))
    dx_norm, denom = _gain_terms(mesh, dx_c, dx_l, rhs, g_l, alpha)
    return new_cams, sh.lm_states + dx_l, dx_norm, chi2, denom


# ---------------------------------------------------------------- marginals


def build_lm_pair_plan(shards: BigBAShards):
    """The rank's within-landmark ORDERED observation pairs (e, f), local
    observation indices, landmark slot l owning pair rows [qs[l], qe[l])
    in (e, f) row-major order: (QE, QF, QS, QS + QN).  Made on the device
    with ``repeat_interleave``; the rank's tables have no padding rows, so
    the JAX module's validity mask has nothing to mark."""
    p = shards.plan
    dev = p.obs_lm.device
    per = shards.lm_states.shape[0]
    deg = torch.bincount(p.obs_lm, minlength=per)
    starts = torch.cumsum(deg, 0) - deg
    qn = deg * deg
    qs = torch.cumsum(qn, 0) - qn
    Q = int(qn.sum())
    reps = deg[p.obs_lm]  # pairs whose e is this observation
    qe = torch.repeat_interleave(torch.arange(p.n_obs, device=dev), reps, output_size=Q)
    run_start = torch.cumsum(reps, 0) - reps
    off = torch.arange(Q, device=dev) - torch.repeat_interleave(run_start, reps, output_size=Q)
    qf = starts[p.obs_lm[qe]] + off
    return qe, qf, qs, qs + qn


def distributed_big_ba_marginals(shards: BigBAShards, mesh: Mesh, alpha=0.0,
                                 max_chunk: int = 1_000_000):
    """Block-diagonal marginal covariances over the ranks:

      camera blocks   - the diagonal blocks of SC^-1, SC all-reduced and
                        factored replicated (one collective);
      landmark blocks - Sigma_ll = D^-1 + D^-1 U^T Sigma_cc U D^-1, formed
                        rank-locally from the local observation pairs, the
                        Sigma_cc gathers and products in chunks of at most
                        ``max_chunk`` padded pairs.

    Returns (cam_cov (n_c, 6, 6) replicated, lm_cov (per, 3, 3) this
    rank's landmarks, zero on padding)."""
    p = shards.plan
    n_c = p.n_c
    N = 6 * n_c
    SC = torch.empty((N, N), dtype=F64, device=mesh.device)
    _, B, _, Dinv, _, _ = _rank_system(shards, alpha, SC)
    mesh.all_reduce(SC)
    with span("dist.sc_factor"):
        _damp_cameras(SC, alpha, shards.anchor_cam)
        Scc = torch.cholesky_inverse(sc_cholesky(SC))
        Scc_b = Scc.view(n_c, 6, n_c, 6).permute(0, 2, 1, 3).contiguous()
        del Scc, SC
        ids = torch.arange(n_c, device=mesh.device)
        cam_cov = Scc_b[ids, ids]

    with span("dist.backsub"):
        qe, qf, qs, qend = build_lm_pair_plan(shards)
        dummy = qe.shape[0]  # a pair row of the zero observation p.n_obs
        pad = torch.full((1,), p.n_obs, dtype=qe.dtype, device=qe.device)
        qe, qf = torch.cat([qe, pad]), torch.cat([qf, pad])
        Bp = torch.cat([B, B.new_zeros((1, 6, 3))], 0)
        camp = torch.cat([p.obs_cam, p.obs_cam.new_zeros(1)])
        M = torch.zeros_like(Dinv)
        buckets = segment_buckets(qs.cpu().numpy(), qend.cpu().numpy(), qe.device)
        for seg, ix in padded_chunks(buckets, dummy, max_chunk):
            pe, pf = qe[ix], qf[ix]  # (rows, cap)
            G = Scc_b[camp[pe], camp[pf]]  # (rows, cap, 6, 6)
            M[seg] = torch.einsum("rcia,rcij,rcjb->rcab", Bp[pe], G, Bp[pf]).sum(1)
        lm_cov = Dinv + Dinv @ M @ Dinv
        lm_cov = torch.where(shards.lm_valid[:, None, None], lm_cov, 0.0)
    return cam_cov, lm_cov
