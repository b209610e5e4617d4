"""Synthetic dataset generators (counterpart of ``slampp_tpu/io/datasets.py``).

``make_manhattan`` (SE(2) pose graph), ``make_city_trees`` (SE(2) poses
and landmarks), ``make_sphere`` (SE(3) pose graph) and
``make_sphere_landmarks`` (SE(3) poses and XYZ landmarks) are NumPy copies
of the JAX package's generators: for the same arguments they emit
byte-identical g2o text, so both packages optimize the same graph.
``sphere_text`` is the sphere graph the port's apps run, at one ring per
50 poses unless told otherwise.
"""

from __future__ import annotations

import numpy as np

from slampp_tpu_torch.models.se2 import _np_rel_to_abs
from slampp_tpu_torch.models.se3 import (
    _np_aa_to_quat,
    _np_quat_conj,
    _np_quat_mul,
    _np_quat_rotate,
    _np_quat_to_aa,
)


def _np_abs_to_rel_se2(p1, p2):
    de, dn = p2[0] - p1[0], p2[1] - p1[1]
    c, s = np.cos(p1[2]), np.sin(p1[2])
    return np.array(
        [c * de + s * dn, -s * de + c * dn, np.fmod(p2[2] - p1[2], 2 * np.pi)]
    )


def make_manhattan(
    n_poses: int = 3500,
    step: float = 1.0,
    loop_prob: float = 0.1,
    loop_radius: float = 2.0,
    loop_separation: int = 50,
    trans_noise: float = 0.05,
    rot_noise: float = 0.02,
    seed: int = 0,
):
    """Manhattan-world 2D pose graph: grid walk with 90-degree turns and
    proximity loop closures.  Returns (g2o_text, ground_truth (n,3))."""
    rng = np.random.default_rng(seed)
    gt = np.zeros((n_poses, 3))
    pose = np.zeros(3)
    for i in range(1, n_poses):
        turn = rng.choice([0, 0, 0, 1, -1])  # mostly straight
        d = np.array([step, 0.0, turn * np.pi / 2])
        pose = _np_rel_to_abs(pose, d)
        gt[i] = pose

    lines = []
    info_t = 1.0 / (trans_noise**2)
    info_r = 1.0 / (rot_noise**2)
    info6 = (info_t, 0.0, 0.0, info_t, 0.0, info_r)

    def noisy_rel(a, b):
        rel = _np_abs_to_rel_se2(gt[a], gt[b])
        rel[0] += rng.normal(0, trans_noise)
        rel[1] += rng.normal(0, trans_noise)
        rel[2] += rng.normal(0, rot_noise)
        return rel

    for i in range(1, n_poses):
        rel = noisy_rel(i - 1, i)
        lines.append(
            "EDGE2 %d %d %.9f %.9f %.9f %.6f %.6f %.6f %.6f %.6f %.6f"
            % (i - 1, i, *rel, *info6)
        )
        # proximity loop closures back to earlier poses
        if i > loop_separation and rng.random() < loop_prob:
            d2 = np.sum((gt[: i - loop_separation, :2] - gt[i, :2]) ** 2, axis=1)
            j = int(np.argmin(d2))
            if d2[j] < loop_radius**2:
                rel = noisy_rel(j, i)
                lines.append(
                    "EDGE2 %d %d %.9f %.9f %.9f %.6f %.6f %.6f %.6f %.6f %.6f"
                    % (j, i, *rel, *info6)
                )
    return "\n".join(lines) + "\n", gt


def make_city_trees(
    n_poses: int = 500,
    n_landmarks: int = 120,
    obs_radius: float = 4.0,
    max_obs_per_pose: int = 3,
    trans_noise: float = 0.05,
    rot_noise: float = 0.02,
    lm_noise: float = 0.05,
    seed: int = 0,
    loop_prob: float = 0.05,
    obs_kind: str = "xy",
):
    """cityTrees10k-class SE(2) pose+landmark graph: a Manhattan-style
    trajectory observing scattered XY landmarks (EDGE2 odometry +
    LANDMARK2:XY observations).  Returns (g2o_text, (gt_poses, gt_lms))."""
    rng = np.random.default_rng(seed)
    gt = np.zeros((n_poses, 3))
    pose = np.zeros(3)
    for i in range(1, n_poses):
        turn = rng.choice([0, 0, 0, 1, -1])
        pose = _np_rel_to_abs(pose, np.array([1.0, 0.0, turn * np.pi / 2]))
        gt[i] = pose

    lo = gt[:, :2].min(0) - 2.0
    hi = gt[:, :2].max(0) + 2.0
    lms = rng.uniform(lo, hi, (n_landmarks, 2))

    info_t = 1.0 / (trans_noise**2)
    info_r = 1.0 / (rot_noise**2)
    info6 = (info_t, 0.0, 0.0, info_t, 0.0, info_r)
    info_lm = 1.0 / (lm_noise**2)
    lines = []
    for i in range(1, n_poses):
        rel = _np_abs_to_rel_se2(gt[i - 1], gt[i])
        rel[0] += rng.normal(0, trans_noise)
        rel[1] += rng.normal(0, trans_noise)
        rel[2] += rng.normal(0, rot_noise)
        lines.append(
            "EDGE2 %d %d %.9f %.9f %.9f %.6f %.6f %.6f %.6f %.6f %.6f"
            % (i - 1, i, *rel, *info6)
        )
        if i > 50 and rng.random() < loop_prob:
            d2 = np.sum((gt[: i - 50, :2] - gt[i, :2]) ** 2, axis=1)
            j = int(np.argmin(d2))
            if d2[j] < 4.0:
                rel = _np_abs_to_rel_se2(gt[j], gt[i])
                rel[0] += rng.normal(0, trans_noise)
                rel[1] += rng.normal(0, trans_noise)
                rel[2] += rng.normal(0, rot_noise)
                lines.append(
                    "EDGE2 %d %d %.9f %.9f %.9f %.6f %.6f %.6f %.6f %.6f %.6f"
                    % (j, i, *rel, *info6)
                )
    # landmark dataset ids are assigned in FIRST-APPEARANCE order (the
    # reference parser requires vertices to appear in incremental id order,
    # FlatSystem "vertices must be accessed in incremental manner")
    lm_id = {}
    for i in range(n_poses):
        d2 = np.sum((lms - gt[i, :2]) ** 2, axis=1)
        near = np.flatnonzero(d2 < obs_radius**2)
        rng.shuffle(near)
        for l in near[:max_obs_per_pose]:
            if l not in lm_id:
                lm_id[l] = n_poses + len(lm_id)
            de, dn = lms[l, 0] - gt[i, 0], lms[l, 1] - gt[i, 1]
            c, s = np.cos(gt[i, 2]), np.sin(gt[i, 2])
            if obs_kind == "xy":
                z = np.array([c * de + s * dn, -s * de + c * dn])
                z += rng.normal(0, lm_noise, 2)
                lines.append(
                    "LANDMARK2:XY %d %d %.9f %.9f %.6f 0.0 %.6f"
                    % (i, lm_id[l], z[0], z[1], info_lm, info_lm)
                )
            else:  # range-bearing (the reference-native 2D landmark edge)
                rb = np.array([np.hypot(de, dn), np.arctan2(dn, de) - gt[i, 2]])
                rb[0] += rng.normal(0, lm_noise)
                rb[1] += rng.normal(0, lm_noise * 0.2)
                rb[1] = (rb[1] + np.pi) % (2 * np.pi) - np.pi
                lines.append(
                    "LANDMARK2:RB %d %d %.9f %.9f %.6f 0.0 %.6f"
                    % (i, lm_id[l], rb[0], rb[1], 1.0 / lm_noise**2,
                       1.0 / (lm_noise * 0.2) ** 2)
                )
    # landmarks with zero observations simply never appear in the file
    return "\n".join(lines) + "\n", (gt, lms)


def _np_abs_to_rel_se3(p1, p2):
    q1 = _np_aa_to_quat(p1[3:6])
    q2 = _np_aa_to_quat(p2[3:6])
    q1i = _np_quat_conj(q1)
    t = _np_quat_rotate(q1i, p2[0:3] - p1[0:3])
    return np.concatenate([t, _np_quat_to_aa(_np_quat_mul(q1i, q2))])


def make_sphere(
    n_poses: int = 2500,
    n_rings: int = 50,
    radius: float = 20.0,
    trans_noise: float = 0.05,
    rot_noise: float = 0.02,
    seed: int = 0,
):
    """SE(3) sphere pose graph (sphere2500-like): a spiral on a sphere with
    ring-to-ring loop closures, as EDGE_SE3:AXISANGLE lines.  Returns
    (g2o_text, ground_truth (n, 6))."""
    rng = np.random.default_rng(seed)
    per_ring = n_poses // n_rings
    gt = np.zeros((n_poses, 6))
    for i in range(n_poses):
        ring = i // per_ring
        a = 2 * np.pi * (i % per_ring) / per_ring
        ele = np.pi * (ring + 1) / (n_rings + 1) - np.pi / 2
        p = radius * np.array(
            [np.cos(ele) * np.cos(a), np.cos(ele) * np.sin(a), np.sin(ele)]
        )
        # heading tangent to the ring
        yaw_aa = np.array([0.0, 0.0, a + np.pi / 2])
        gt[i] = np.concatenate([p, yaw_aa])

    info = np.zeros(21)
    it, ir = 1.0 / trans_noise**2, 1.0 / rot_noise**2
    # row-major upper triangle of diag(it, it, it, ir, ir, ir)
    for k, v in zip([0, 6, 11, 15, 18, 20], [it, it, it, ir, ir, ir]):
        info[k] = v

    def noisy_rel(a, b):
        rel = _np_abs_to_rel_se3(gt[a], gt[b])
        rel[0:3] += rng.normal(0, trans_noise, 3)
        rel[3:6] += rng.normal(0, rot_noise, 3)
        return rel

    def line(a, b):
        return ("EDGE_SE3:AXISANGLE %d %d " % (a, b)
                + " ".join("%.9f" % x for x in noisy_rel(a, b))
                + " " + " ".join("%.6f" % x for x in info))

    lines = []
    for i in range(1, n_poses):
        lines.append(line(i - 1, i))
        if i >= per_ring:  # loop closure to the pose below on the previous ring
            lines.append(line(i - per_ring, i))
    return "\n".join(lines) + "\n", gt


def make_sphere_landmarks(
    n_poses: int = 300,
    n_rings: int = 10,
    n_landmarks: int = 80,
    radius: float = 20.0,
    trans_noise: float = 0.05,
    rot_noise: float = 0.02,
    lm_noise: float = 0.05,
    obs_radius: float = 12.0,
    max_obs_per_pose: int = 3,
    seed: int = 0,
):
    """SE(3) pose graph with XYZ landmarks (victoria-park-in-3D class): the
    sphere trajectory observing scattered points through LANDMARK3:XYZ
    edges.  Returns (g2o_text, (gt_poses, gt_landmarks))."""
    text, gt = make_sphere(
        n_poses=n_poses, n_rings=n_rings, radius=radius,
        trans_noise=trans_noise, rot_noise=rot_noise, seed=seed,
    )
    rng = np.random.default_rng(seed + 1)
    lms = rng.normal(0, radius * 0.6, (n_landmarks, 3))
    info_lm = 1.0 / lm_noise**2
    info6 = (info_lm, 0.0, 0.0, info_lm, 0.0, info_lm)
    lines = [text.rstrip("\n")]
    lm_id = {}  # first-appearance ids (the parser's incremental-order contract)
    for i in range(n_poses):
        d2 = np.sum((lms - gt[i, :3]) ** 2, axis=1)
        near = np.flatnonzero(d2 < obs_radius**2)
        rng.shuffle(near)
        for l in near[:max_obs_per_pose]:
            if l not in lm_id:
                lm_id[l] = n_poses + len(lm_id)
            q = _np_aa_to_quat(gt[i, 3:6])
            h = _np_quat_rotate(_np_quat_conj(q), lms[l] - gt[i, 0:3])
            h = h + rng.normal(0, lm_noise, 3)
            lines.append(
                "LANDMARK3:XYZ %d %d %.9f %.9f %.9f %.6f %.6f %.6f %.6f %.6f %.6f"
                % (i, lm_id[l], *h, *info6)
            )
    return "\n".join(lines) + "\n", (gt, lms)


def default_rings(n_poses: int) -> int:
    """One ring per 50 poses (sphere2500: 50 rings, ``make_sphere``'s default)."""
    return max(1, n_poses // 50)


def sphere_text(n_poses: int, n_rings=None, seed: int = 0, landmarks: bool = False) -> str:
    """The g2o text of the seed-``seed`` sphere graph (``default_rings``
    unless ``n_rings``), with ``make_sphere_landmarks``' XYZ landmarks when
    ``landmarks``."""
    rings = default_rings(n_poses) if n_rings is None else n_rings
    make = make_sphere_landmarks if landmarks else make_sphere
    return make(n_poses=n_poses, n_rings=rings, seed=seed)[0]
