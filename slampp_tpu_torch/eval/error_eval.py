"""Trajectory error evaluation: ATE / RPE with pose-set alignment
(counterpart of ``slampp_tpu/eval/error_eval.py``, the port's own copy).

Capability parity with ``CErrorEvaluation`` (include/slam/ErrorEval.h:40,
161, 208-231): absolute trajectory error and relative pose error against a
ground-truth pose set, after rigid (Umeyama/Kabsch) alignment of the
estimated trajectory — host-side NumPy (evaluation is not a hot path).
"""

from __future__ import annotations

import numpy as np


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Rigid (optionally similarity) alignment est -> gt for (n, d) point sets.

    Returns (R, t, s) minimizing ||gt - (s R est + t)||^2 (Umeyama 1991; the
    reference uses the equivalent Kabsch alignment, geometry/Kabsch.h).
    """
    est = np.asarray(est, float)
    gt = np.asarray(gt, float)
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    C = G.T @ E / len(est)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(C.shape[0])
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[-1, -1] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_e = (E**2).sum() / len(est)
        s = float(np.trace(np.diag(D) @ S) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(est_xy: np.ndarray, gt_xy: np.ndarray, align: bool = True, with_scale: bool = False) -> float:
    """Absolute trajectory RMSE over positions (reference ErrorEval.h:161)."""
    est_xy = np.asarray(est_xy, float)
    gt_xy = np.asarray(gt_xy, float)
    if align:
        R, t, s = align_umeyama(est_xy, gt_xy, with_scale)
        est_xy = (s * (R @ est_xy.T)).T + t
    d2 = np.sum((est_xy - gt_xy) ** 2, axis=1)
    return float(np.sqrt(np.mean(d2)))


def rpe_rmse(est_xy: np.ndarray, gt_xy: np.ndarray, delta: int = 1) -> float:
    """Relative pose error RMSE over position increments
    (reference ErrorEval.h:208-231, the RPE family)."""
    est_xy = np.asarray(est_xy, float)
    gt_xy = np.asarray(gt_xy, float)
    de = est_xy[delta:] - est_xy[:-delta]
    dg = gt_xy[delta:] - gt_xy[:-delta]
    # compare increment magnitudes (rotation-invariant position RPE)
    d2 = (np.linalg.norm(de, axis=1) - np.linalg.norm(dg, axis=1)) ** 2
    return float(np.sqrt(np.mean(d2)))


def rpe_aa_rmse(est_aa: np.ndarray, gt_aa: np.ndarray, delta: int = 1) -> float:
    """RPE over ROTATIONS (the reference's RPE-AA mode, ErrorEval.h:231):
    RMSE of the relative-rotation error angle between consecutive poses,
    with axis-angle inputs (n, 3)."""
    from scipy.spatial.transform import Rotation

    Re = Rotation.from_rotvec(np.asarray(est_aa, float))
    Rg = Rotation.from_rotvec(np.asarray(gt_aa, float))
    n = len(est_aa)
    errs = []
    for i in range(n - delta):
        de = Re[i].inv() * Re[i + delta]
        dg = Rg[i].inv() * Rg[i + delta]
        err = (dg.inv() * de).magnitude()
        errs.append(err)
    return float(np.sqrt(np.mean(np.square(errs))))
