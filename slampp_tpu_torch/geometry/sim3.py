"""Sim(3) math, batched over leading axes (counterpart of
``slampp_tpu/geometry/sim3.py``, whose functions are written per item and
vmapped; reference CSim3Jacobians, include/slam/Sim3SolverBase.h).

exp / log between sim(3) vectors (u(3), omega(3), sigma) and the tRs
representation (translation, axis-angle rotation, linear scale), in the
TooN-style convention of slam_app/Main.h:731-809; composition, inversion,
point transforms, the inverse-depth maps and the Sim(3) camera projections
(Project_P2C_XYZ, Sim3SolverBase.h:630).  Vertex states are log
coordinates, retracted post-multiplicatively: log(exp(x) exp(d))
(Sim3_Types.h:2106).

Every function is dtype-generic and takes ``(..., k)`` tensors.  The
small-angle and small-sigma branches keep the JAX package's double-select
form: the branch not taken sees a safe denominator, so forward-mode
derivatives (``torch.func.jacfwd``, which differentiates both branches of
``torch.where``) stay finite.  The distortion normalization is the
reference's Sim3SolverBase one, k / (0.5 fx fy), not the BA camera's
k / (0.5 (fx + fy)).
"""

from __future__ import annotations

import torch

from slampp_tpu_torch.geometry import se3


def _sinc_coeffs(sq: torch.Tensor):
    """(sin t)/t and (1 - cos t)/t^2 of t = sqrt(sq), Taylor-guarded."""
    small = sq < 1e-16
    t = torch.where(small, torch.ones_like(sq), sq)
    ang = torch.sqrt(t)
    sinc = torch.where(small, 1.0 - sq / 6.0, torch.sin(ang) / ang)
    cosc = torch.where(small, 0.5 - sq / 24.0, (1.0 - torch.cos(ang)) / t)
    return sinc, cosc


def _W_matrix(omega: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) sim(3) 'V' matrix, t = W u in exp: W = C I + A K + B K^2,
    K = [omega]x, with the limits for small sigma and / or small theta of
    the JAX package's four-way select (its docstring gives the formulas)."""
    sq = (omega * omega).sum(-1)
    small_th = sq < 1e-16
    one = torch.ones_like(sq)
    tsafe = torch.sqrt(torch.where(small_th, one, sq))
    s = torch.exp(sigma)
    K = se3._skew(omega)

    small_sig = sigma.abs() < 1e-8
    ssafe = torch.where(small_sig, torch.ones_like(sigma), sigma)

    C = torch.where(small_sig, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (s - 1.0) / ssafe)

    sinth, costh = torch.sin(tsafe), torch.cos(tsafe)
    denom = ssafe * ssafe + torch.where(small_th, torch.zeros_like(sq), sq)
    sq_safe = torch.where(small_th, one, sq)

    A_gen = (ssafe * s * sinth + (1.0 - s * costh) * tsafe) / (tsafe * denom)
    A_sig0 = (1.0 - costh) / sq_safe
    A_th0 = (ssafe * s + 1.0 - s) / (ssafe * ssafe)
    half = torch.full_like(sq, 0.5)
    A = torch.where(small_th, torch.where(small_sig, half, A_th0),
                    torch.where(small_sig, A_sig0, A_gen))

    B_gen = (C - ((s * costh - 1.0) * ssafe + s * tsafe * sinth) / denom) / sq_safe
    B_sig0 = (tsafe - sinth) / (sq_safe * tsafe)
    B_th0 = (2.0 * (s - 1.0) - ssafe * s * (2.0 - ssafe)) / (2.0 * ssafe ** 3)
    sixth = torch.full_like(sq, 1.0 / 6.0)
    B = torch.where(small_th, torch.where(small_sig, sixth, B_th0),
                    torch.where(small_sig, B_sig0, B_gen))
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return (C[..., None, None] * eye + A[..., None, None] * K
            + B[..., None, None] * (K @ K))


def sim3_exp(v: torch.Tensor) -> torch.Tensor:
    """exp: sim(3) vector (u, omega, sigma) -> tRs (t, aa, s)."""
    u, omega, sigma = v[..., 0:3], v[..., 3:6], v[..., 6]
    t = (_W_matrix(omega, sigma) @ u[..., None])[..., 0]
    return torch.cat([t, omega, torch.exp(sigma)[..., None]], -1)


def _solve3(W: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """W^-1 t for (..., 3, 3) W by Cramer's rule.  (``torch.linalg.solve``
    gives wrong forward-mode derivatives under ``torch.func.vmap``.)"""
    c0, c1, c2 = W[..., :, 0], W[..., :, 1], W[..., :, 2]
    cross = torch.linalg.cross
    r0, r1, r2 = cross(c1, c2, dim=-1), cross(c2, c0, dim=-1), cross(c0, c1, dim=-1)
    det = (c0 * r0).sum(-1, keepdim=True)
    return torch.stack([(t * r0).sum(-1), (t * r1).sum(-1), (t * r2).sum(-1)], -1) / det


def sim3_log(tRs: torch.Tensor) -> torch.Tensor:
    """log: tRs -> sim(3) vector; the inverse of :func:`sim3_exp`."""
    t, omega, s = tRs[..., 0:3], tRs[..., 3:6], tRs[..., 6]
    sigma = torch.log(s)
    u = _solve3(_W_matrix(omega, sigma), t)
    return torch.cat([u, omega, sigma[..., None]], -1)


def compose_tRs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """tRs composition a * b: (t, R, s)(x) = s R x + t."""
    Ra = se3.axis_angle_to_rot(a[..., 3:6])
    t = a[..., 0:3] + a[..., 6:7] * (Ra @ b[..., 0:3, None])[..., 0]
    qa = se3.axis_angle_to_quat(a[..., 3:6])
    qb = se3.axis_angle_to_quat(b[..., 3:6])
    aa = se3.quat_to_axis_angle(se3.quat_mul(qa, qb))
    return torch.cat([t, aa, a[..., 6:7] * b[..., 6:7]], -1)


def inverse_tRs(a: torch.Tensor) -> torch.Tensor:
    q = se3.quat_conj(se3.axis_angle_to_quat(a[..., 3:6]))
    s_inv = 1.0 / a[..., 6:7]
    t = -s_inv * se3.quat_rotate(q, a[..., 0:3])
    return torch.cat([t, se3.quat_to_axis_angle(q), s_inv], -1)


def transform_tRs(a: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Apply the similarity: s R X + t."""
    q = se3.axis_angle_to_quat(a[..., 3:6])
    return a[..., 6:7] * se3.quat_rotate(q, X) + a[..., 0:3]


def inv_transform_tRs(a: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Apply the inverse similarity (v_InvTransform): R^T (X - t) / s."""
    q = se3.quat_conj(se3.axis_angle_to_quat(a[..., 3:6]))
    return se3.quat_rotate(q, X - a[..., 0:3]) / a[..., 6:7]


def plus(state: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Post-multiplicative retraction of log-coordinate states
    (CVertexSim3::Operator_Plus, Sim3_Types.h:2106)."""
    return sim3_log(compose_tRs(sim3_exp(state), sim3_exp(delta)))


def absolute_to_relative(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """log(exp(x1)^-1 exp(x2)) (Sim3SolverBase.h:345)."""
    return sim3_log(compose_tRs(inverse_tRs(sim3_exp(x1)), sim3_exp(x2)))


def relative_to_absolute(x1: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """log(exp(x1) exp(d)) (Sim3SolverBase.h:435)."""
    return sim3_log(compose_tRs(sim3_exp(x1), sim3_exp(d)))


# ------------------------------------------------------------------ inv depth
def invdepth_to_xyz(v: torch.Tensor) -> torch.Tensor:
    """(x/z, y/z, 1/z) -> XYZ (v_InvDepth_to_XYZ, Sim3SolverBase.h:529)."""
    depth = 1.0 / v[..., 2]
    return torch.stack([v[..., 0] * depth, v[..., 1] * depth, depth], -1)


def xyz_to_invdepth(X: torch.Tensor) -> torch.Tensor:
    q = 1.0 / X[..., 2]
    return torch.stack([X[..., 0] * q, X[..., 1] * q, q], -1)


def invdepth_plus(state: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Inverse-depth retraction with the delta in XYZ space
    (Relative_to_Absolute_InvDepth_Epsilon, used by CVertexInvDepth)."""
    return xyz_to_invdepth(invdepth_to_xyz(state) + delta)


# ----------------------------------------------------------------- projection
def _distort(x: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """(..., 2) pixel of camera-frame points: pinhole with one radial term,
    k normalized by 0.5 fx fy (Sim3SolverBase convention)."""
    fx, fy, cx, cy = (intrinsics[..., i] for i in range(4))
    k = intrinsics[..., 4] / (0.5 * (fx * fy))
    iz = 1.0 / x[..., 2]
    u = fx * x[..., 0] * iz + cx
    v = fy * x[..., 1] * iz + cy
    r2 = (u - cx) ** 2 + (v - cy) ** 2
    d = 1.0 + r2 * k
    return torch.stack([cx + d * (u - cx), cy + d * (v - cy)], -1)


def project_p2c_xyz(cam_log: torch.Tensor, intrinsics: torch.Tensor, X: torch.Tensor):
    """Project GLOBAL XYZ points into Sim(3) cameras (Project_P2C_XYZ,
    Sim3SolverBase.h:630); the camera pose is camera-to-world."""
    return _distort(inv_transform_tRs(sim3_exp(cam_log), X), intrinsics)


def project_p2c_local_xyz(x_local: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Project CAMERA-LOCAL XYZ points (Project_P2C_LocalXYZ_Self, :702)."""
    return _distort(x_local, intrinsics)


def local_to_other(x_local_owner, owner_cam_log, obs_cam_log):
    """A point from its owner camera's local frame to the observing
    camera's (the LocalXYZ_Other family)."""
    Xw = transform_tRs(sim3_exp(owner_cam_log), x_local_owner)
    return inv_transform_tRs(sim3_exp(obs_cam_log), Xw)


def world_to_local(cam_log: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """World points -> camera-local frame (first half of project_p2c_xyz)."""
    return inv_transform_tRs(sim3_exp(cam_log), X)


def backproject_ray(uv: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Unit observation rays in the camera frame from pixels: the radial
    distortion inverted with one fixed-point step (r2 at the pixel), as in
    the JAX package."""
    fx, fy, cx, cy = (intrinsics[..., i] for i in range(4))
    k = intrinsics[..., 4] / (0.5 * (fx * fy))
    du = uv[..., 0] - cx
    dv = uv[..., 1] - cy
    d = 1.0 + k * (du * du + dv * dv)
    x = (du / d) / fx
    y = (dv / d) / fy
    ray = torch.stack([x, y, torch.ones_like(x)], -1)
    return ray / torch.linalg.vector_norm(ray, dim=-1, keepdim=True)


def tangent_angle_error(ray_obs: torch.Tensor, x_local: torch.Tensor) -> torch.Tensor:
    """(..., 2) angular residual between observed unit rays and the
    directions to camera-local points (the AngleErr family of
    Sim3_Types.h): the direction's projections onto a tangent basis at the
    ray, whose helper axis is y where |ray_x| > 0.9, else x."""
    d = x_local / torch.clamp_min(torch.linalg.vector_norm(x_local, dim=-1, keepdim=True),
                                  1e-300)
    pick_y = (ray_obs[..., 0].abs() > 0.9)[..., None]
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=ray_obs.dtype, device=ray_obs.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=ray_obs.dtype, device=ray_obs.device)
    a = torch.where(pick_y, ey, ex)
    e1 = torch.linalg.cross(ray_obs, a.expand_as(ray_obs), dim=-1)
    e1 = e1 / torch.clamp_min(torch.linalg.vector_norm(e1, dim=-1, keepdim=True), 1e-300)
    e2 = torch.linalg.cross(ray_obs, e1, dim=-1)
    return torch.stack([(d * e1).sum(-1), (d * e2).sum(-1)], -1)
