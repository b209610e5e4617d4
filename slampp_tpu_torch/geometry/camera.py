"""Camera projection models for bundle adjustment (counterpart of
``slampp_tpu/geometry/camera.py``; reference CBAJacobians,
include/slam/BASolverBase.h:57).

Batched over a leading axis, as the port's other geometry: monocular
pinhole with one radial-distortion parameter scaled by the mean focal
length (Project_P2C, BASolverBase.h:260), stereo (Project_P2SC, :462), and
the intrinsics-optimizing variant (Project_P2CI, :690).

The camera pose state is the world-to-camera transform (t, axis-angle) —
the parser inverts the dataset's camera-to-world quaternion
(ParsePrimitives.h:902-915) — so projection is ``x_cam = R X + t``.
Intrinsics are (fx, fy, cx, cy, k) with k stored pre-scaled in the dataset
convention and rescaled by 2 / (fx + fy) at projection time.
"""

from __future__ import annotations

import torch

from slampp_tpu_torch.geometry import se3


def camera_point(cam_pose: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """(B, 3) camera-frame points x = R X + t of (B, 6) poses."""
    R = se3.axis_angle_to_rot(cam_pose[..., 3:6])
    return (R @ point[..., None])[..., 0] + cam_pose[..., 0:3]


def project_p2c(cam_pose: torch.Tensor, intrinsics: torch.Tensor, point: torch.Tensor):
    """(B, 2) projections (u, v) of world points into cameras
    (CBAJacobians::Project_P2C, BASolverBase.h:260)."""
    fx, fy, cx, cy = (intrinsics[..., i] for i in range(4))
    k = intrinsics[..., 4] / (0.5 * (fx + fy))
    x = camera_point(cam_pose, point)
    iz = 1.0 / x[..., 2]
    u = fx * x[..., 0] * iz + cx
    v = fy * x[..., 1] * iz + cy
    r2 = (u - cx) ** 2 + (v - cy) ** 2
    d = 1.0 + r2 * k
    return torch.stack([cx + d * (u - cx), cy + d * (v - cy)], -1)


def project_p2sc(cam_pose: torch.Tensor, intrinsics_baseline: torch.Tensor, point: torch.Tensor):
    """(B, 3) stereo projections (u_left, v, u_right); the intrinsics carry
    (fx, fy, cx, cy, baseline) (CBAJacobians::Project_P2SC,
    BASolverBase.h:462)."""
    fx, fy, cx, cy, b = (intrinsics_baseline[..., i] for i in range(5))
    x = camera_point(cam_pose, point)
    iz = 1.0 / x[..., 2]
    u = fx * x[..., 0] * iz + cx
    v = fy * x[..., 1] * iz + cy
    u_right = fx * (x[..., 0] - b) * iz + cx
    return torch.stack([u, v, u_right], -1)


def p2c_error(point, cam_state, meas):
    """Monocular reprojection residual z - h (CEdgeP2C3D, BA_Types.h:403).
    ``cam_state`` is the 11-wide camera vertex (pose 6 + intrinsics 5); the
    edge's slot order is (point, camera), as EDGE_PROJECT_P2MC."""
    return meas - project_p2c(cam_state[..., 0:6], cam_state[..., 6:11], point)


def p2ci_error(point, cam_state, intrinsics, meas):
    """Intrinsics-optimizing residual (CEdgeP2CI3D, BA_Types.h:562):
    ternary (point, camera pose, intrinsics)."""
    return meas - project_p2c(cam_state[..., 0:6], intrinsics, point)


def p2sc_error(point, cam_state, meas):
    """Stereo residual (CEdgeP2SC3D, BA_Types.h:705)."""
    return meas - project_p2sc(cam_state[..., 0:6], cam_state[..., 6:11], point)
