"""Synthetic dataset generators (counterpart of ``slampp_tpu/io/datasets.py``).

``make_manhattan`` (SE(2) pose graph), ``make_city_trees`` (SE(2) poses
and landmarks), ``make_sphere`` (SE(3) pose graph),
``make_sphere_landmarks`` (SE(3) poses and XYZ landmarks), ``make_ba_scene``
and ``make_ba_scene_incremental`` (bundle adjustment: cameras on a ring, a
point cloud), ``make_rocv`` (range-only constant velocity) and
``make_spheron`` (spherical cameras observing XYZ landmarks) are NumPy
copies of the JAX package's generators: for the same arguments they emit
byte-identical g2o text, so both packages optimize the same graph.  ``make_venice_ba_arrays`` (venice871-class BA) returns the
same arrays as the JAX package's.
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


def make_ba_scene(
    n_cams: int = 20,
    n_points: int = 500,
    obs_per_point: int = 6,
    pix_noise: float = 1.0,
    point_init_noise: float = 0.1,
    cam_init_rot_noise: float = 0.0,
    seed: int = 0,
    fx: float = 500.0,
):
    """Synthetic BA (venice-like structure): cameras on a ring looking at the
    origin, Gaussian point cloud; emits VERTEX_CAM / VERTEX_XYZ /
    EDGE_PROJECT_P2MC.  Ground-truth projections get pixel noise; initial
    vertex states get perturbation so GN has work to do.

    Returns (g2o_text, (gt_cam_states, gt_points)).
    """
    rng = np.random.default_rng(seed)
    intr = np.array([fx, fx, 320.0, 240.0, 0.0])

    cams_w2c = []  # internal-convention states (world-to-camera, (t, aa))
    cam_lines = []
    R_all = []
    for c in range(n_cams):
        a = 2 * np.pi * c / n_cams
        center = np.array([8.0 * np.cos(a), 8.0 * np.sin(a), 2.0])
        # camera looks at origin: z axis toward -center
        z = -center / np.linalg.norm(center)
        x = np.cross(np.array([0.0, 0.0, 1.0]), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R_c2w = np.stack([x, y, z], axis=1)  # columns are camera axes in world
        R_w2c = R_c2w.T
        t_w2c = -R_w2c @ center
        aa = _np_quat_to_aa(_np_rot_to_quat_np(R_w2c))
        cams_w2c.append(np.concatenate([t_w2c, aa, intr]))
        R_all.append(R_w2c)
        # dataset line carries camera-to-world quaternion + position
        q_c2w = _np_rot_to_quat_np(R_c2w)
        cam_lines.append(
            "VERTEX_CAM %d %.9f %.9f %.9f %.9f %.9f %.9f %.9f %.3f %.3f %.3f %.3f %.6f"
            % (c, *center, q_c2w[1], q_c2w[2], q_c2w[3], q_c2w[0], *intr)
        )
    cams_w2c = np.stack(cams_w2c)

    pts = rng.normal(0, 2.0, (n_points, 3))
    pt_lines = []
    obs_lines = []
    info = 1.0 / pix_noise**2
    for p in range(n_points):
        noisy_pt = pts[p] + rng.normal(0, point_init_noise, 3)
        pt_lines.append(
            "VERTEX_XYZ %d %.9f %.9f %.9f" % (n_cams + p, *noisy_pt)
        )
        cams = rng.choice(n_cams, size=min(obs_per_point, n_cams), replace=False)
        for c in cams:
            st = cams_w2c[c]
            x = R_all[c] @ pts[p] + st[0:3]
            if x[2] < 0.5:
                continue
            u = intr[0] * x[0] / x[2] + intr[2]
            v = intr[1] * x[1] / x[2] + intr[3]
            u += rng.normal(0, pix_noise)
            v += rng.normal(0, pix_noise)
            obs_lines.append(
                "EDGE_PROJECT_P2MC %d %d %.6f %.6f %.6f 0.0 %.6f"
                % (n_cams + p, c, u, v, info, info)
            )
    text = "\n".join(cam_lines + pt_lines + obs_lines) + "\n"
    return text, (cams_w2c, pts)


def make_ba_scene_incremental(n_cams: int = 10, n_points: int = 120, seed: int = 0, **kw):
    """Incremental-BA ordering of :func:`make_ba_scene`: cameras appear one
    at a time followed by the newly-visible points and observations, with
    CONSISTENCY_MARKER records at each consistent state (the reference's
    incremental BA format, data/Readme.txt and scripts/incremental_BA/)."""
    text, gt = make_ba_scene(n_cams=n_cams, n_points=n_points, seed=seed, **kw)
    cam_lines, pt_lines, obs_lines = [], [], []
    for line in text.strip().splitlines():
        if line.startswith("VERTEX_CAM"):
            cam_lines.append(line)
        elif line.startswith("VERTEX_XYZ"):
            pt_lines.append(line)
        else:
            obs_lines.append(line)
    # group observations by camera
    by_cam = {}
    for line in obs_lines:
        cam = int(line.split()[2])
        by_cam.setdefault(cam, []).append(line)
    emitted_pts = set()
    out = []
    for c in range(n_cams):
        out.append(cam_lines[c])
        for line in by_cam.get(c, []):
            pid = int(line.split()[1])
            if pid not in emitted_pts:
                emitted_pts.add(pid)
                out.append(pt_lines[pid - n_cams])
        out.extend(by_cam.get(c, []))
        if c >= 1:  # first consistent state needs two cameras
            out.append("CONSISTENCY_MARKER")
    return "\n".join(out) + "\n", gt


def _np_rot_to_quat_np(R):
    t = np.trace(R)
    qw = np.sqrt(max(0.0, 1.0 + t)) / 2.0
    qx = np.sqrt(max(0.0, 1.0 + R[0, 0] - R[1, 1] - R[2, 2])) / 2.0
    qy = np.sqrt(max(0.0, 1.0 - R[0, 0] + R[1, 1] - R[2, 2])) / 2.0
    qz = np.sqrt(max(0.0, 1.0 - R[0, 0] - R[1, 1] + R[2, 2])) / 2.0
    qx = np.copysign(qx, R[2, 1] - R[1, 2])
    qy = np.copysign(qy, R[0, 2] - R[2, 0])
    qz = np.copysign(qz, R[1, 0] - R[0, 1])
    q = np.array([qw, qx, qy, qz])
    return q / np.linalg.norm(q)


def make_venice_ba_arrays(
    n_cams: int = 871,
    n_points: int = 110_000,
    mean_track: int = 10,
    pix_noise: float = 1.0,
    point_init_noise: float = 0.05,
    seed: int = 0,
    fx: float = 500.0,
):
    """Venice-871-class synthetic BA as ARRAYS (no g2o text: at >=1e6
    observations a line-based file would dominate setup time).  Matches the
    reference's venice871.g2o shape class (unit_tests.sh:182-188): 871
    cameras, ~1e5 landmarks, ~1e6+ observations, long-tailed track lengths.

    Returns (cam_states (n_c, 11) [t_w2c, axis-angle, intrinsics],
             lm_states (n_l, 3) noisy init, obs_cam, obs_lm, uv (m, 2),
             info (m, 2, 2), gt_points).
    """
    rng = np.random.default_rng(seed)
    intr = np.array([fx, fx, 320.0, 240.0, 0.0])

    # cameras on two concentric rings over a "canal city" disc
    cam_states = np.zeros((n_cams, 11))
    R_all = np.zeros((n_cams, 3, 3))
    centers = np.zeros((n_cams, 3))
    for c in range(n_cams):
        ring = c % 2
        a = 2 * np.pi * (c // 2) / max(1, (n_cams + 1) // 2) + ring * 0.03
        radius = 14.0 + 4.0 * ring
        center = np.array([radius * np.cos(a), radius * np.sin(a), 3.0 + ring])
        z = -center / np.linalg.norm(center)
        x = np.cross(np.array([0.0, 0.0, 1.0]), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R_w2c = np.stack([x, y, z], axis=1).T
        t_w2c = -R_w2c @ center
        aa = _np_quat_to_aa(_np_rot_to_quat_np(R_w2c))
        cam_states[c] = np.concatenate([t_w2c, aa, intr])
        R_all[c] = R_w2c
        centers[c] = center

    # landmark cloud inside the rings; long-tailed track lengths
    pts = rng.normal(0, 4.0, (n_points, 3)) * np.array([1.0, 1.0, 0.4])
    tracks = np.clip(rng.geometric(1.0 / mean_track, n_points), 2, 60)

    # visibility: landmarks are seen from an arc of consecutive cameras
    # (Venice-style coverage), vectorized construction
    m = int(tracks.sum())
    obs_lm = np.repeat(np.arange(n_points), tracks)
    base_cam = rng.integers(0, n_cams, n_points)
    within = np.arange(m) - np.repeat(np.cumsum(tracks) - tracks, tracks)
    obs_cam = (np.repeat(base_cam, tracks) + within * 2) % n_cams

    # project (vectorized); keep only physically valid observations (point
    # in front of the camera and inside a generous sensor window)
    Xc = np.einsum("mij,mj->mi", R_all[obs_cam], pts[obs_lm]) + cam_states[obs_cam, 0:3]
    z = Xc[:, 2]
    u = fx * Xc[:, 0] / np.where(z > 0.5, z, 1.0) + intr[2]
    v = fx * Xc[:, 1] / np.where(z > 0.5, z, 1.0) + intr[3]
    keep = (z > 0.5) & (np.abs(u - intr[2]) < 4000) & (np.abs(v - intr[3]) < 4000)
    # landmarks need >= 2 surviving observations to be constrained
    deg_keep = np.bincount(obs_lm[keep], minlength=n_points)
    keep &= deg_keep[obs_lm] >= 2
    obs_cam, obs_lm = obs_cam[keep], obs_lm[keep]
    m = len(obs_cam)
    u = u[keep] + rng.normal(0, pix_noise, m)
    v = v[keep] + rng.normal(0, pix_noise, m)
    uv = np.stack([u, v], 1)
    w = 1.0 / pix_noise**2
    info = np.broadcast_to(np.eye(2) * w, (m, 2, 2)).copy()

    # drop now-unconstrained landmarks (renumber contiguously)
    used = np.flatnonzero(np.bincount(obs_lm, minlength=n_points) >= 2)
    remap = np.full(n_points, -1, np.int64)
    remap[used] = np.arange(len(used))
    sel = remap[obs_lm] >= 0
    obs_cam, obs_lm, uv, info = obs_cam[sel], remap[obs_lm[sel]], uv[sel], info[sel]
    pts = pts[used]

    lm_init = pts + rng.normal(0, point_init_noise, (len(pts), 3))
    return cam_states, lm_init, obs_cam.astype(np.int64), obs_lm.astype(np.int64), uv, info, pts


def make_rocv(n_steps: int = 30, n_transmitters: int = 4, seed: int = 0):
    """Synthetic range-only constant-velocity dataset (ROCV problem,
    reference ROCV_Types.h / ParsePrimitives.h:1425-1700): a receiver on a
    constant-velocity track ranging against fixed transmitters with absolute
    position priors."""
    rng = np.random.default_rng(seed)
    tx = rng.normal(0, 10, (n_transmitters, 3))
    lines = []
    # incremental vertex ids (the reference parser contract): transmitters
    # 0..T-1, receivers T+k
    for t_ in range(n_transmitters):
        lines.append(
            "ROCV:TRANSMITTER %d %.6f %.6f %.6f"
            % (t_, *(tx[t_] + rng.normal(0, 0.1, 3)))
        )
        lines.append("ROCV:TRANSMITTER_UF %d 1 0 0 1 0 1" % (t_,))
    pos = np.zeros(3)
    vel = np.array([1.0, 0.5, 0.0])
    info21 = [100, 0, 0, 0, 0, 0, 100, 0, 0, 0, 0, 100, 0, 0, 0, 100, 0, 0, 100, 0, 100]
    T = n_transmitters
    for k in range(n_steps):
        p = pos + vel * k
        lines.append(
            "ROCV:RECEIVER %d %.6f %.6f %.6f %.6f %.6f %.6f"
            % (T + k, *(p + rng.normal(0, 0.05, 3)), *vel)
        )
        if k > 0:
            lines.append(
                "ROCV:DELTA_TIME %d %d 1.0 %s"
                % (T + k - 1, T + k, " ".join(map(str, info21)))
            )
        for t_ in range(n_transmitters):
            r = np.linalg.norm(p - tx[t_]) + rng.normal(0, 0.02)
            lines.append("ROCV:RANGE %d %d %.6f 2500" % (T + k, t_, r))
    return "\n".join(lines) + "\n", tx


def make_spheron(n_poses: int = 8, n_points: int = 40, seed: int = 0):
    """Synthetic spherical-camera (Spheron) dataset: poses on a circle
    observing XYZ landmarks in their local frame
    (CEdgeSpheronXYZ, BA_Types.h:996)."""
    rng = np.random.default_rng(seed)

    def aa_to_R(aa):
        th = np.linalg.norm(aa)
        if th < 1e-12:
            return np.eye(3)
        k = aa / th
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)

    lines = []
    poses = []
    for k in range(n_poses):
        a = 2 * np.pi * k / n_poses
        t = np.array([3 * np.cos(a), 3 * np.sin(a), 0.0])
        aa = np.array([0.0, 0.0, a])
        poses.append((t, aa))
        lines.append(
            "VERTEX_SPHERON:QUAT %d %.6f %.6f %.6f 0 0 %.9f %.9f"
            % (k, *t, np.sin(a / 2), np.cos(a / 2))
        )
    pts = rng.normal(0, 2.0, (n_points, 3))
    for pi, p in enumerate(pts):
        for k in range(n_poses):
            t, aa = poses[k]
            local = aa_to_R(aa).T @ (p - t) + rng.normal(0, 0.01, 3)
            lines.append(
                "EDGE_SPHERON_XYZ %d %d %.6f %.6f %.6f 100 0 0 100 0 100"
                % (k, n_poses + pi, *local)
            )
    return "\n".join(lines) + "\n", pts


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
