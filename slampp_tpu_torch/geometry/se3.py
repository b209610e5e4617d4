"""SE(3) pose math, batched over leading axes (counterpart of
``slampp_tpu/geometry/se3.py``, whose functions are written per pose and
vmapped).

Poses are (..., 6) tensors (translation, axis-angle rotation); quaternions
are (..., 4) tensors (w, x, y, z).  Composition goes through quaternions,
and the quaternion <-> axis-angle conversions keep the JAX package's
numerics exactly: the squared-norm Taylor branches (thresholds 1e-16 and
1e-24), the ``w >= 0`` flip of ``axis_angle_to_quat``, the ``copysign``
short rotation and the ``maximum(|w|, 1e-12)`` guard of
``quat_to_axis_angle`` (reference C3DJacobians, 3DSolverBase.h:477-651).
The converged chi2 depends on them.

Every function is dtype-generic: the mixed-precision engines evaluate
Jacobians in float32.
"""

from __future__ import annotations

import torch


# ------------------------------------------------------------------ quaternion
def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        -1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v by unit quaternions q (Eigen's _transformVector)."""
    qv = q[..., 1:]
    uv = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + q[..., :1] * uv + torch.linalg.cross(qv, uv, dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def _sign_of(w: torch.Tensor) -> torch.Tensor:
    """-1 where w < 0, else 1 (``jnp.where(w < 0, -1.0, 1.0)``), in w's dtype."""
    return 1.0 - 2.0 * (w < 0).to(w.dtype)


def axis_angle_to_quat(aa: torch.Tensor) -> torch.Tensor:
    """Reference C3DJacobians::f_AxisAngle_to_Quat (3DSolverBase.h:477):
    sin(a/2)/a with its a -> 0 limit 0.5 on the squared norm, the sign
    flipped so that w >= 0."""
    sq = (aa * aa).sum(-1)
    small = sq < 1e-16
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    c = torch.where(small, 1.0 - sq / 8.0, torch.cos(angle * 0.5))
    f = torch.where(small, 0.5 - sq / 48.0, torch.sin(angle * 0.5) / angle)
    f = torch.where(c < 0, -f, f)
    q = torch.cat([c.abs()[..., None], aa * f[..., None]], -1)
    return quat_normalize(q)


def _q2aa_scale(q: torch.Tensor):
    """(v, sq, small, sgn, aw, vn, a) of ``quat_to_axis_angle``'s two
    branches, shared with its derivative."""
    w, v = q[..., 0], q[..., 1:]
    sq = (v * v).sum(-1)
    small = sq < 1e-24
    vn = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    aw = w.abs()
    return v, sq, small, _sign_of(w), aw, vn, torch.clamp_min(aw, 1e-12)


def quat_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """Reference C3DJacobians::f_Quat_to_AxisAngle (3DSolverBase.h:557-651):
    half angle copysign(atan2(|v|, |w|), w), the short rotation; below
    |v|^2 = 1e-24 the Taylor form 2 v (1/|w| - |v|^2 / (3 |w|^3))."""
    v, sq, small, sgn, aw, vn, a = _q2aa_scale(q)
    scale_big = sgn * 2.0 * torch.atan2(vn, aw) / vn
    scale_small = sgn * 2.0 * (1.0 / a - sq / (3.0 * a ** 3))
    return v * torch.where(small, scale_small, scale_big)[..., None]


def quat_to_axis_angle_jacobian(q: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) derivative of :func:`quat_to_axis_angle` at q (not
    renormalized), on the branch that q takes, as ``jax.jacfwd`` of it
    gives: aa = v s(w, v), so d aa / dw = v ds/dw and
    d aa / dv = s I + v (ds/dv)^T."""
    v, sq, small, sgn, aw, vn, a = _q2aa_scale(q)
    r2 = vn * vn + aw * aw
    at = torch.atan2(vn, aw)
    s_big = sgn * 2.0 * at / vn
    s_small = sgn * 2.0 * (1.0 / a - sq / (3.0 * a ** 3))
    # d|w|/dw = sign(w) (0 at w = 0, as jnp.abs); the 1e-12 guard passes no
    # derivative below it
    dabs = torch.sign(q[..., 0])
    da = torch.where(aw > 1e-12, dabs, torch.zeros_like(dabs))
    dsdw_big = sgn * 2.0 * (-vn / r2) / vn * dabs
    dsdw_small = sgn * 2.0 * (-1.0 / a ** 2 + sq / a ** 4) * da
    # ds/dv = c v: big branch c = (ds/dvn) / vn, small c = -4 sgn / (3 a^3)
    c_big = sgn * 2.0 * (aw / r2 / vn - at / (vn * vn)) / vn
    c_small = sgn * 2.0 * (-2.0 / (3.0 * a ** 3))
    s = torch.where(small, s_small, s_big)
    dsdw = torch.where(small, dsdw_small, dsdw_big)
    c = torch.where(small, c_small, c_big)
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    dv = s[..., None, None] * eye + c[..., None, None] * v[..., :, None] * v[..., None, :]
    return torch.cat([(v * dsdw[..., None])[..., None], dv], -1)


def quat_left(q: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) L(q) with q (x) p = L(q) p."""
    w, x, y, z = q.unbind(-1)
    return torch.stack(
        [
            torch.stack([w, -x, -y, -z], -1),
            torch.stack([x, w, -z, y], -1),
            torch.stack([y, z, w, -x], -1),
            torch.stack([z, -y, x, w], -1),
        ],
        -2,
    )


def quat_right(p: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) R(p) with q (x) p = R(p) q."""
    w, x, y, z = p.unbind(-1)
    return torch.stack(
        [
            torch.stack([w, -x, -y, -z], -1),
            torch.stack([x, w, z, -y], -1),
            torch.stack([y, -z, w, x], -1),
            torch.stack([z, y, -x, w], -1),
        ],
        -2,
    )


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix of unit quaternions q (the matrix form
    of :func:`quat_rotate`)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )


# ------------------------------------------------------------------ rotations
def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) cross-product matrix [v]x."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack(
        [torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1), torch.stack([-y, x, o], -1)],
        -2,
    )


def axis_angle_to_rot(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues in the smooth sinc form R = I + sinc(a) K + ((1 - cos a) / a^2) K^2,
    K = [aa]x, Taylor-guarded at a = 0 (reference t_AxisAngle_to_RotMatrix,
    3DSolverBase.h:292)."""
    sq = (aa * aa).sum(-1)
    small = sq < 1e-16
    t = torch.where(small, torch.ones_like(sq), sq)
    angle = torch.sqrt(t)
    sinc = torch.where(small, 1.0 - sq / 6.0, torch.sin(angle) / angle)
    cosc = torch.where(small, 0.5 - sq / 24.0, (1.0 - torch.cos(angle)) / t)
    K = _skew(aa)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return eye + sinc[..., None, None] * K + cosc[..., None, None] * (K @ K)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Shepperd's construction, branch-free: each component from its own
    diagonal combination, the vector part signed by the skew part."""
    r00, r11, r22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    t = r00 + r11 + r22
    zero = torch.zeros_like(t)

    def root(x):
        return torch.sqrt(torch.maximum(zero, x)) / 2.0

    def signed(mag, d):
        return mag * torch.sign(torch.where(d == 0, torch.ones_like(d), d))

    qw = root(1.0 + t)
    qx = signed(root(1.0 + r00 - r11 - r22), R[..., 2, 1] - R[..., 1, 2])
    qy = signed(root(1.0 - r00 + r11 - r22), R[..., 0, 2] - R[..., 2, 0])
    qz = signed(root(1.0 - r00 - r11 + r22), R[..., 1, 0] - R[..., 0, 1])
    return quat_normalize(torch.stack([qw, qx, qy, qz], -1))


def rot_to_axis_angle(R: torch.Tensor) -> torch.Tensor:
    """Via the quaternion (reference v_RotMatrix_to_AxisAngle)."""
    return quat_to_axis_angle(rot_to_quat(R))


# ------------------------------------------------------------------- SE(3) ops
def relative_to_absolute(p1: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Compose poses: t = t1 + R1 d_t, rotation aa(q1 (x) q_d)
    (C3DJacobians::Relative_to_Absolute, 3DSolverBase.h:807)."""
    q1 = axis_angle_to_quat(p1[..., 3:6])
    qd = axis_angle_to_quat(d[..., 3:6])
    t = p1[..., 0:3] + quat_rotate(q1, d[..., 0:3])
    return torch.cat([t, quat_to_axis_angle(quat_mul(q1, qd))], -1)


def absolute_to_relative(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Pose of p2 in the frame of p1 (3DSolverBase.h:893)."""
    q1i = quat_conj(axis_angle_to_quat(p1[..., 3:6]))
    q2 = axis_angle_to_quat(p2[..., 3:6])
    t = quat_rotate(q1i, p2[..., 0:3] - p1[..., 0:3])
    return torch.cat([t, quat_to_axis_angle(quat_mul(q1i, q2))], -1)


def pose_inverse(p: torch.Tensor) -> torch.Tensor:
    """3DSolverBase.h Pose_Inverse."""
    q = quat_conj(axis_angle_to_quat(p[..., 3:6]))
    return torch.cat([-quat_rotate(q, p[..., 0:3]), quat_to_axis_angle(q)], -1)


def plus(state: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """SE(3) vertex retraction: right composition with the delta pose
    (CVertexPose3D::Operator_Plus, SE3_Types.h:45)."""
    return relative_to_absolute(state, delta)


def pose_pose_error(x0: torch.Tensor, x1: torch.Tensor, meas: torch.Tensor) -> torch.Tensor:
    """SE(3) odometry / loop edge residual (CEdgePose3D, SE3_Types.h:265-286):
    translation z_t - h_t, rotation aa(q_z (x) q_h^-1)."""
    h = absolute_to_relative(x0, x1)
    qz = axis_angle_to_quat(meas[..., 3:6])
    qh = axis_angle_to_quat(h[..., 3:6])
    daa = quat_to_axis_angle(quat_mul(qz, quat_conj(qh)))
    return torch.cat([meas[..., 0:3] - h[..., 0:3], daa], -1)


def pose_landmark_error(x0: torch.Tensor, lm: torch.Tensor, meas: torch.Tensor) -> torch.Tensor:
    """SE(3) pose -> landmark XYZ residual (CEdgePoseLandmark3D,
    SE3_Types.h:443): z minus the landmark in the pose's frame."""
    q = axis_angle_to_quat(x0[..., 3:6])
    return meas - quat_rotate(quat_conj(q), lm - x0[..., 0:3])


def rpy_to_rot(r: torch.Tensor) -> torch.Tensor:
    """The parser's RPY -> rotation convention (ParsePrimitives.h:520-531):
    fields (r0, r1, r2) with cos_x = cos(r2), cos_y = cos(r1), cos_z = cos(r0)."""
    cx, sx = torch.cos(r[..., 2]), torch.sin(r[..., 2])
    cy, sy = torch.cos(r[..., 1]), torch.sin(r[..., 1])
    cz, sz = torch.cos(r[..., 0]), torch.sin(r[..., 0])
    return torch.stack(
        [
            torch.stack([cy * cx, -cz * sx + sz * sy * cx, sz * sx + cz * sy * cx], -1),
            torch.stack([cy * sx, cz * cx + sz * sy * sx, -sz * cx + cz * sy * sx], -1),
            torch.stack([-sy, sz * cy, cz * cy], -1),
        ],
        -2,
    )
