"""SE(3) problem types (counterpart of ``slampp_tpu/models/se3.py``;
reference include/slam/SE3_Types.h).

Vertex types pose3d (translation, axis-angle; retraction by right
composition) and landmark3d (x, y, z; additive), edge types edge_pose3d and
edge_pose_landmark3d.  The JAX package differentiated each ``error_fn``
through the retraction with ``jax.jacfwd``; the port brings the analytic
batched Jacobians J_k = d error(retract(x_k, d_k)) / d d_k at d_k = 0.  At
d = 0 a rotation delta enters as the quaternion [1; d / 2] (the Taylor
branch of ``axis_angle_to_quat``), so dq / dd = [0; I / 2].
"""

from __future__ import annotations

import numpy as np
import torch

from slampp_tpu_torch.geometry import se3
from slampp_tpu_torch.graph.types import (
    EdgeType,
    VertexType,
    register_edge_type,
    register_vertex_type,
)


def _pose3d_local_diff(cur: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """The inverse of ``plus``: plus(ref, local_diff(cur, ref)) == cur."""
    return se3.absolute_to_relative(ref, cur)


def _blocks(tl, tr, bl, br):
    """(E, 6, 6) from four (E, 3, 3) blocks."""
    return torch.cat([torch.cat([tl, tr], -1), torch.cat([bl, br], -1)], -2)


def _edge_pose3d_jacobians(xs, z):
    """With h = absolute_to_relative(x0, x1), q_h its rotation and
    q_e = q_z (x) conj(q_h) (the residual's rotation is aa(q_e)):
    x0 moves q_e to q_e (x) q_d, x1 moves it to q_z (x) conj(q_d) (x) conj(q_h),
    and the translation rows are [I, -[h_t]x] and [-R_h, 0]."""
    x0, x1 = xs
    h = se3.absolute_to_relative(x0, x1)
    qz = se3.axis_angle_to_quat(z[..., 3:6])
    qh = se3.axis_angle_to_quat(h[..., 3:6])
    qe = se3.quat_mul(qz, se3.quat_conj(qh))
    r = torch.cat([z[..., 0:3] - h[..., 0:3], se3.quat_to_axis_angle(qe)], -1)
    jq = se3.quat_to_axis_angle_jacobian(qe)  # (E, 3, 4)
    rot0 = 0.5 * (jq @ se3.quat_left(qe)[..., :, 1:])
    rot1 = -0.5 * (jq @ (se3.quat_left(qz) @ se3.quat_right(se3.quat_conj(qh)))[..., :, 1:])
    eye = torch.eye(3, dtype=x0.dtype, device=x0.device).expand_as(rot0)
    zero = torch.zeros_like(rot0)
    j0 = _blocks(eye, -se3._skew(h[..., 0:3]), zero, rot0)
    j1 = _blocks(-se3.quat_to_rot(qh), zero, zero, rot1)
    return r, (j0, j1)


def _edge_pose_landmark3d_jacobians(xs, z):
    """With h = R0^T (lm - t0): [I, -[h]x] for the pose, -R0^T for the
    landmark."""
    x0, lm = xs
    q0i = se3.quat_conj(se3.axis_angle_to_quat(x0[..., 3:6]))
    h = se3.quat_rotate(q0i, lm - x0[..., 0:3])
    eye = torch.eye(3, dtype=x0.dtype, device=x0.device).expand(h.shape[:-1] + (3, 3))
    j0 = torch.cat([eye, -se3._skew(h)], -1)
    return z - h, (j0, -se3.quat_to_rot(q0i))


POSE3D = register_vertex_type(
    VertexType(name="pose3d", dim=6, retract=se3.plus, local_diff=_pose3d_local_diff)
)

LANDMARK3D = register_vertex_type(
    VertexType(name="landmark3d", dim=3, retract=lambda x, d: x + d, is_landmark=True)
)

EDGE_POSE3D = register_edge_type(
    EdgeType(
        name="edge_pose3d",
        vertex_types=("pose3d", "pose3d"),
        res_dim=6,
        meas_dim=6,
        error_fn=lambda xs, z: se3.pose_pose_error(xs[0], xs[1], z),
        jacobian_fn=_edge_pose3d_jacobians,
    )
)

EDGE_POSE_LANDMARK3D = register_edge_type(
    EdgeType(
        name="edge_pose_landmark3d",
        vertex_types=("pose3d", "landmark3d"),
        res_dim=3,
        meas_dim=3,
        error_fn=lambda xs, z: se3.pose_landmark_error(xs[0], xs[1], z),
        jacobian_fn=_edge_pose_landmark3d_jacobians,
    )
)


# ---------------------------------------------------------------- initializers
# NumPy mirrors of the composition math for host-side vertex initialization
# (reference CRelative_to_Absolute_XYZ_Initializer, SE3_Types.h:130).
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


def np_relative_to_absolute(p1, d):
    q1 = _np_aa_to_quat(p1[3:6])
    qd = _np_aa_to_quat(d[3:6])
    t = p1[0:3] + _np_quat_rotate(q1, d[0:3])
    return np.concatenate([t, _np_quat_to_aa(_np_quat_mul(q1, qd))])


def init_pose3d_from_pose(known, meas):
    p1 = np.asarray(known.get(0, np.zeros(6)))
    return np_relative_to_absolute(p1, np.asarray(meas)[:6])


def init_landmark3d(known, meas):
    p1 = np.asarray(known.get(0, np.zeros(6)))
    q1 = _np_aa_to_quat(p1[3:6])
    return p1[0:3] + _np_quat_rotate(q1, np.asarray(meas)[:3])


POSE_POSE3D_INITIALIZERS = (None, init_pose3d_from_pose)
POSE_LANDMARK3D_INITIALIZERS = (None, init_landmark3d)
