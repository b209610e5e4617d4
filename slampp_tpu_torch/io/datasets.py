"""Synthetic dataset generators (counterpart of ``slampp_tpu/io/datasets.py``).

``make_manhattan`` is a NumPy copy of the JAX package's generator: for the
same arguments it emits byte-identical g2o text, so both packages optimize
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
