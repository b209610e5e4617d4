"""Synthetic dataset generators (counterpart of ``slampp_tpu/io/datasets.py``).

``make_manhattan`` (SE(2) pose graph) and ``make_city_trees`` (SE(2) poses
and landmarks) are NumPy copies of the JAX package's generators: for the
same arguments they emit byte-identical g2o text, so both packages optimize
the same graph.
"""

from __future__ import annotations

import numpy as np

from slampp_tpu_torch.models.se2 import _np_rel_to_abs


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
