"""Bundle-adjustment problem types (counterpart of ``slampp_tpu/models/ba.py``;
reference include/slam/BA_Types.h).

Vertex types:
  * ``xyz``        — 3D point landmark (CVertexXYZ, BA_Types.h:355)
  * ``cam``        — monocular camera: 6-DoF world-to-camera pose + 5 stored
                     intrinsics (fx fy cx cy k) (CVertexCam, BA_Types.h:54)
  * ``intrinsics`` — optimizable 5-DoF intrinsics (CVertexIntrinsics, :141)
  * ``scam``       — stereo camera: 6-DoF pose + (fx fy cx cy baseline)
                     (CVertexSCam, :211)

Edge slot order follows the dataset tokens: EDGE_PROJECT_P2MC is (point,
camera) (ParsePrimitives.h:1134+).  The JAX package differentiated each
``error_fn`` through the retractions with ``jax.jacfwd``; the port brings
the analytic batched Jacobians (the chain of the JAX package's own
``ba_schur._p2c_jacs_analytic``): with x = R X + t, a pose delta composed
on the right (``se3.plus``) moves x by R d_t - R [X]x d_r, a point delta by
R d_X, and the projection layer differentiates elementwise.
"""

from __future__ import annotations

import torch

from slampp_tpu_torch.geometry import camera as cam_geo
from slampp_tpu_torch.geometry import se3
from slampp_tpu_torch.graph.types import (
    EdgeType,
    VertexType,
    register_edge_type,
    register_vertex_type,
)


def _cam_retract(state, delta):
    """The pose part composes like SE(3); the intrinsics stay
    (CVertexCam::Operator_Plus, BA_Types.h:54-140)."""
    return torch.cat([se3.plus(state[..., 0:6], delta), state[..., 6:11]], -1)


def _point_and_pose_jacobians(Jh, R, X):
    """d error / d (point, pose) of error = z - h(x), x = R X + t, given Jh =
    dh / dx (E, r, 3): (-Jh R, [-Jh R, Jh R [X]x])."""
    JhR = Jh @ R
    return -JhR, torch.cat([-JhR, JhR @ se3._skew(X)], -1)


def _p2c_projection_jacobian(x, intr):
    """dh / dx (E, 2, 3) of the radial pinhole projection at camera-frame
    points x, with a, b = u - cx, v - cy and d = 1 + k r^2; also returns
    (a, b, d, iz, k, r2) for the intrinsics' derivatives."""
    fx, fy = intr[..., 0], intr[..., 1]
    k = intr[..., 4] / (0.5 * (fx + fy))
    iz = 1.0 / x[..., 2]
    a = fx * x[..., 0] * iz
    b = fy * x[..., 1] * iz
    r2 = a * a + b * b
    d = 1.0 + k * r2
    zero = torch.zeros_like(iz)
    da = torch.stack([fx * iz, zero, -a * iz], -1)  # d a / d x
    db = torch.stack([zero, fy * iz, -b * iz], -1)
    m11 = (d + 2.0 * k * a * a)[..., None]
    m12 = (2.0 * k * a * b)[..., None]
    m22 = (d + 2.0 * k * b * b)[..., None]
    Jh = torch.stack([m11 * da + m12 * db, m12 * da + m22 * db], -2)
    return Jh, (a, b, d, iz, k, r2)


def _edge_p2c_jacobians(xs, z):
    X, cam = xs
    R = se3.axis_angle_to_rot(cam[..., 3:6])
    x = (R @ X[..., None])[..., 0] + cam[..., 0:3]
    Jh, _ = _p2c_projection_jacobian(x, cam[..., 6:11])
    return cam_geo.p2c_error(X, cam, z), _point_and_pose_jacobians(Jh, R, X)


def _edge_p2ci_jacobians(xs, z):
    """As p2c, plus d error / d (fx, fy, cx, cy, k) of the intrinsics
    vertex (additive): k = k_s / (0.5 (fx + fy)) moves with both focal
    lengths, the principal point enters h once, a and b do not move with
    it."""
    X, cam, intr = xs
    R = se3.axis_angle_to_rot(cam[..., 3:6])
    x = (R @ X[..., None])[..., 0] + cam[..., 0:3]
    Jh, (a, b, d, iz, k, r2) = _p2c_projection_jacobian(x, intr)
    jp, jc = _point_and_pose_jacobians(Jh, R, X)
    fsum = intr[..., 0] + intr[..., 1]
    dk_df = -k / fsum  # d k / d fx = d k / d fy
    dd_fx = dk_df * r2 + 2.0 * k * a * x[..., 0] * iz
    dd_fy = dk_df * r2 + 2.0 * k * b * x[..., 1] * iz
    dd_k = r2 / (0.5 * fsum)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    dh = torch.stack([
        torch.stack([dd_fx * a + d * x[..., 0] * iz, dd_fy * a, one, zero, dd_k * a], -1),
        torch.stack([dd_fx * b, dd_fy * b + d * x[..., 1] * iz, zero, one, dd_k * b], -1),
    ], -2)
    return cam_geo.p2ci_error(X, cam, intr, z), (jp, jc, -dh)


def _edge_p2sc_jacobians(xs, z):
    X, cam = xs
    R = se3.axis_angle_to_rot(cam[..., 3:6])
    x = (R @ X[..., None])[..., 0] + cam[..., 0:3]
    fx, fy, base = cam[..., 6], cam[..., 7], cam[..., 10]
    iz = 1.0 / x[..., 2]
    zero = torch.zeros_like(iz)
    Jh = torch.stack([
        torch.stack([fx * iz, zero, -fx * x[..., 0] * iz * iz], -1),
        torch.stack([zero, fy * iz, -fy * x[..., 1] * iz * iz], -1),
        torch.stack([fx * iz, zero, -fx * (x[..., 0] - base) * iz * iz], -1),
    ], -2)
    return cam_geo.p2sc_error(X, cam, z), _point_and_pose_jacobians(Jh, R, X)


XYZ = register_vertex_type(
    VertexType(name="xyz", dim=3, retract=lambda x, d: x + d, is_landmark=True)
)

CAM = register_vertex_type(
    VertexType(name="cam", dim=6, retract=_cam_retract, _state_dim=11)
)

INTRINSICS = register_vertex_type(
    VertexType(name="intrinsics", dim=5, retract=lambda x, d: x + d)
)

SCAM = register_vertex_type(
    VertexType(name="scam", dim=6, retract=_cam_retract, _state_dim=11)
)

EDGE_P2C = register_edge_type(
    EdgeType(
        name="edge_p2c",
        vertex_types=("xyz", "cam"),
        res_dim=2,
        meas_dim=2,
        error_fn=lambda xs, z: cam_geo.p2c_error(xs[0], xs[1], z),
        jacobian_fn=_edge_p2c_jacobians,
    )
)

EDGE_P2CI = register_edge_type(
    EdgeType(
        name="edge_p2ci",
        vertex_types=("xyz", "cam", "intrinsics"),
        res_dim=2,
        meas_dim=2,
        error_fn=lambda xs, z: cam_geo.p2ci_error(xs[0], xs[1], xs[2], z),
        jacobian_fn=_edge_p2ci_jacobians,
    )
)

EDGE_P2SC = register_edge_type(
    EdgeType(
        name="edge_p2sc",
        vertex_types=("xyz", "scam"),
        res_dim=3,
        meas_dim=3,
        error_fn=lambda xs, z: cam_geo.p2sc_error(xs[0], xs[1], z),
        jacobian_fn=_edge_p2sc_jacobians,
    )
)
