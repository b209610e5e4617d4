"""Frozen copy of the venice871-class bundle-adjustment generator
(``slampp_tpu_torch/io/datasets.py``: ``make_venice_ba_arrays`` and the
NumPy rotation helpers it uses).

It is a copy so that a change to the port's generator never moves the
benchmark's inputs; ``portbench/tests/test_portbench_traffic.py`` holds it
equal to the port's, array for array, while the two agree.

The scene: ``n_cams`` cameras on two concentric rings looking inwards, with
exact poses and intrinsics (fx = fy, no distortion); ``n_points`` points of
a flattened Gaussian cloud, each seen from an arc of consecutive cameras
(track lengths geometric with mean ``mean_track``, clipped to 2..60), the
observations that fall behind a camera or far off the sensor dropped, the
pixels perturbed by ``pix_noise`` and the points' start states by
``point_init_noise``, all from ``np.random.default_rng(seed)``.

``generate`` (the benchmark's entry, not part of the copy) then moves each
camera's start off its true pose, from a second stream of the same seed, so
that the solve starts as bundle adjustment does after incremental
reconstruction rather than at the cameras' true poses.
"""

from __future__ import annotations

import numpy as np

from portbench.traffic.sphere import _np_aa_to_quat, _np_quat_mul, _np_quat_to_aa


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
    """Venice-871-class synthetic BA as arrays.

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
    m = int(tracks.sum())
    obs_lm = np.repeat(np.arange(n_points), tracks)
    base_cam = rng.integers(0, n_cams, n_points)
    within = np.arange(m) - np.repeat(np.cumsum(tracks) - tracks, tracks)
    obs_cam = (np.repeat(base_cam, tracks) + within * 2) % n_cams

    # project; keep only physically valid observations (point in front of
    # the camera and inside a generous sensor window)
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


def generate(seed: int, n_cams: int, n_points: int, mean_track: float,
             cam_rot_sigma: float = 0.0, cam_t_sigma: float = 0.0) -> dict:
    """The benchmark's entry: ``make_venice_ba_arrays``' scene, with each
    camera's start rotated by a Gaussian axis-angle of ``cam_rot_sigma``
    rad per axis (left-multiplied onto the world-to-camera rotation) and
    its translation moved by ``cam_t_sigma`` m per axis, drawn from
    ``np.random.default_rng([seed, 1])``."""
    cams, points, oc, op, uv, info, _ = make_venice_ba_arrays(
        n_cams=n_cams, n_points=n_points, mean_track=mean_track, seed=seed)
    if cam_rot_sigma or cam_t_sigma:
        rng = np.random.default_rng([seed, 1])
        drot = rng.normal(0.0, cam_rot_sigma, (len(cams), 3))
        dt = rng.normal(0.0, cam_t_sigma, (len(cams), 3))
        cams = cams.copy()
        for c in range(len(cams)):
            q = _np_quat_mul(_np_aa_to_quat(drot[c]), _np_aa_to_quat(cams[c, 3:6]))
            cams[c, 3:6] = _np_quat_to_aa(q)
        cams[:, 0:3] += dt
    return {"cams": cams, "points": points, "obs_cam": oc, "obs_pt": op, "uv": uv,
            "info": info}
