"""Frozen copy of the SE(3) sphere pose-graph generator
(``slampp_tpu_torch/io/datasets.py``: ``make_sphere``, ``sphere_text`` and
the NumPy quaternion helpers they use, from ``models/se3.py``).

It is a copy so that a change to the port's generator never moves the
benchmark's inputs; ``portbench/tests/test_portbench_traffic.py`` holds it
equal to the port's, byte for byte, while the two agree.

The graph: ``n_poses`` poses on ``n_rings`` rings of a sphere of radius
``radius``, odometry between consecutive poses and a loop closure from each
pose to the one below it on the previous ring, every measurement perturbed
by Gaussian noise from ``np.random.default_rng(seed)``, as
``EDGE_SE3:AXISANGLE`` lines (no VERTEX lines: the solver initializes the
poses by composing the odometry).  The structure does not depend on the
seed; only the noise does.
"""

from __future__ import annotations

import numpy as np


def _np_aa_to_quat(aa):
    angle = np.linalg.norm(aa)
    if angle < 1e-12:
        q = np.array([np.cos(angle * 0.5), *(aa * 0.5)])
    else:
        c = np.cos(angle * 0.5)
        f = np.sin(angle * 0.5) / angle
        if c < 0:
            c, f = -c, -f
        q = np.array([c, *(aa * f)])
    return q / np.linalg.norm(q)


def _np_quat_mul(q1, q2):
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def _np_quat_conj(q):
    return np.array([q[0], -q[1], -q[2], -q[3]])


def _np_quat_rotate(q, v):
    uv = 2.0 * np.cross(q[1:], v)
    return v + q[0] * uv + np.cross(q[1:], uv)


def _np_quat_to_aa(q):
    w, v = q[0], q[1:]
    vn = np.linalg.norm(v)
    if vn < 1e-12:
        return v * 2.0
    half = np.copysign(np.arctan2(vn, abs(w)), w if w != 0 else 1.0)
    return v * (2.0 * half / vn)


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


def default_rings(n_poses: int) -> int:
    """One ring per 50 poses (sphere2500: 50 rings, ``make_sphere``'s default)."""
    return max(1, n_poses // 50)


def sphere_text(n_poses: int, n_rings=None, seed: int = 0) -> str:
    """The g2o text of the seed-``seed`` sphere graph (``default_rings``
    unless ``n_rings``)."""
    rings = default_rings(n_poses) if n_rings is None else n_rings
    return make_sphere(n_poses=n_poses, n_rings=rings, seed=seed)[0]


def generate(seed: int, n_poses: int, n_rings: int) -> str:
    """The benchmark's entry: the g2o text of the seed's sphere graph."""
    return sphere_text(n_poses, n_rings, seed=seed)
