"""Range-only constant-velocity (ROCV) navigation types and the Spheron
spherical-camera types (counterpart of ``slampp_tpu/models/rocv.py``).

Reference: include/slam/ROCV_Types.h (CVertexPositionVelocity3D :31, the
range edge CEdgePosVel_Landmark3D :78, the landmark prior :228, the
constant-velocity process edge :326) and the Spheron problem
(CVertexSpheron BA_Types.h:297, CEdgeSpheronXYZ :996: a 6-DoF pose
observing XYZ landmarks in its local frame).  All four Jacobians are
closed forms.
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
from slampp_tpu_torch.models import se3 as se3_model

POSVEL3D = register_vertex_type(
    VertexType(name="posvel3d", dim=6, retract=lambda x, d: x + d)
)

SPHERON = register_vertex_type(
    VertexType(name="spheron", dim=6, retract=se3.plus)
)


def _range_error(xs, z):
    """1-D range residual z - ||p - l|| (CEdgePosVel_Landmark3D)."""
    pv, lm = xs
    return z - torch.linalg.vector_norm(pv[..., 0:3] - lm, dim=-1, keepdim=True)


def _range_jacobians(xs, z):
    """With n = (p - l) / ||p - l||: [-n^T, 0] for the pos-vel vertex, n^T
    for the landmark."""
    pv, lm = xs
    d = pv[..., 0:3] - lm
    nrm = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    n = (d / nrm)[..., None, :]
    return z - nrm, (torch.cat([-n, torch.zeros_like(n)], -1), n)


def _const_velocity_error(xs, z):
    """Constant-velocity process edge, 6-D residual
    (p_cur - (p_prev + v_prev dt), v_cur - v_prev); measurement dt
    (CEdgeConstVelocity3D, 6D-residual variant)."""
    prev, cur = xs
    dt = z[..., 0:1]
    pos_res = cur[..., 0:3] - (prev[..., 0:3] + prev[..., 3:6] * dt)
    return torch.cat([pos_res, cur[..., 3:6] - prev[..., 3:6]], -1)


def _const_velocity_jacobians(xs, z):
    """[[-I, -dt I], [0, -I]] for the previous state, I for the current."""
    prev, cur = xs
    eye = torch.eye(3, dtype=prev.dtype, device=prev.device).expand(prev.shape[:-1] + (3, 3))
    dt = z[..., 0, None, None]
    zero = torch.zeros_like(eye)
    j_prev = torch.cat([torch.cat([-eye, -dt * eye], -1), torch.cat([zero, -eye], -1)], -2)
    j_cur = torch.eye(6, dtype=prev.dtype, device=prev.device).expand(prev.shape[:-1] + (6, 6))
    return _const_velocity_error(xs, z), (j_prev, j_cur)


def _landmark_prior_error(xs, z):
    """Landmark anchor (CEdgeLandmark3DPrior, ROCV_Types.h:240-320): the
    error is identically zero, so is its chi2; only its information enters
    the Hessian, through the identity Jacobian, pinning the gauge."""
    (lm,) = xs
    return torch.zeros_like(lm)


def _landmark_prior_jacobians(xs, z):
    (lm,) = xs
    eye = torch.eye(3, dtype=lm.dtype, device=lm.device).expand(lm.shape[:-1] + (3, 3))
    return torch.zeros_like(lm), (eye,)


EDGE_ROCV_RANGE = register_edge_type(
    EdgeType(name="edge_rocv_range", vertex_types=("posvel3d", "landmark3d"), res_dim=1,
             meas_dim=1, error_fn=_range_error, jacobian_fn=_range_jacobians)
)

EDGE_ROCV_CONST_VEL = register_edge_type(
    EdgeType(name="edge_rocv_const_vel", vertex_types=("posvel3d", "posvel3d"), res_dim=6,
             meas_dim=1, error_fn=_const_velocity_error,
             jacobian_fn=_const_velocity_jacobians)
)

EDGE_LANDMARK3D_PRIOR = register_edge_type(
    EdgeType(name="edge_landmark3d_prior", vertex_types=("landmark3d",), res_dim=3,
             meas_dim=3, error_fn=_landmark_prior_error,
             jacobian_fn=_landmark_prior_jacobians)
)

# CEdgeSpheronXYZ (BA_Types.h:1127-1150): the landmark in the spheron
# pose's local frame, plain z - h; the spheron retracts as pose3d does, so
# the Jacobians are edge_pose_landmark3d's
EDGE_SPHERON_XYZ = register_edge_type(
    EdgeType(name="edge_spheron_xyz", vertex_types=("spheron", "landmark3d"), res_dim=3,
             meas_dim=3, error_fn=lambda xs, z: se3.pose_landmark_error(xs[0], xs[1], z),
             jacobian_fn=se3_model._edge_pose_landmark3d_jacobians)
)


# --- parse-time vertex initializers (reference CInitialize* policies) ---
def init_posvel_from_prev(known, meas):
    """A receiver from the previous pos-vel state propagated by dt
    (constant-velocity motion model)."""
    prev = np.asarray(known.get(0, np.zeros(6)))
    dt = float(np.asarray(meas).reshape(-1)[0])
    return np.concatenate([prev[0:3] + prev[3:6] * dt, prev[3:6]])


def init_landmark_null(known, meas):
    return np.zeros(3)


ROCV_CONST_VEL_INITIALIZERS = (None, init_posvel_from_prev)
ROCV_RANGE_INITIALIZERS = (None, init_landmark_null)
# a spheron landmark starts at pose (+) (meas translation, identity
# rotation), reference CRelative_to_Absolute_XYZ_Initializer
# (BA_Types.h:1010-1037)
SPHERON_XYZ_INITIALIZERS = (None, se3_model.init_landmark3d)
