"""SE(2) pose-graph types (counterpart of ``slampp_tpu/models/se2.py``;
reference include/slam/SE2_Types.h).

Vertex types pose2d (x, y, theta) and landmark2d (x, y); edge types
edge_pose2d, edge_pose_landmark2d_xy and edge_pose_landmark2d_rb, each with
an analytic batched Jacobian (the JAX package differentiated ``error_fn``
with ``jax.jacfwd``; the formulas follow ``models/np_kernels``).
"""

from __future__ import annotations

import numpy as np
import torch

from slampp_tpu_torch.geometry import se2
from slampp_tpu_torch.graph.types import (
    EdgeType,
    VertexType,
    register_edge_type,
    register_vertex_type,
)


def _pose2d_local_diff(cur: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    d = cur - ref
    return torch.cat([d[..., :2], se2.clamp_angular_error_2pi(d[..., 2:3])], -1)


def _edge_pose2d_error(xs, z):
    return se2.pose_pose_error(xs[0], xs[1], z)


def _edge_pose2d_jacobians(xs, z):
    """r = z - h(x0, x1) and J_k = -dh/dx_k (the retraction is additive, so
    manifold and state Jacobians coincide)."""
    _, j1, j2 = se2.absolute_to_relative_jacobians(xs[0], xs[1])
    return se2.pose_pose_error(xs[0], xs[1], z), (-j1, -j2)


def _stack_rows(*rows):
    """(E, len(rows), len(rows[0])) from rows of (E,) tensors."""
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _edge_pose_landmark2d_xy_jacobians(xs, z):
    """J = d r / d x of r = z - R(theta)^T (lm - t)."""
    x0, lm = xs
    de, dn = lm[..., 0] - x0[..., 0], lm[..., 1] - x0[..., 1]
    c, s = torch.cos(x0[..., 2]), torch.sin(x0[..., 2])
    hx, hy = c * de + s * dn, -s * de + c * dn
    j0 = _stack_rows((c, s, -hy), (-s, c, hx))
    j1 = _stack_rows((-c, -s), (s, -c))
    return se2.pose_landmark_xy_error(x0, lm, z), (j0, j1)


def _edge_pose_landmark2d_rb_jacobians(xs, z):
    """J = d r / d x of r = z - (range, bearing); a zero range or squared
    range divides by 1 instead, as the NumPy kernel does."""
    x0, lm = xs
    de, dn = lm[..., 0] - x0[..., 0], lm[..., 1] - x0[..., 1]
    q = de * de + dn * dn
    rng = torch.sqrt(q)
    rs = torch.where(rng > 0, rng, torch.ones_like(rng))
    qs = torch.where(q > 0, q, torch.ones_like(q))
    zero, one = torch.zeros_like(q), torch.ones_like(q)
    j0 = _stack_rows((de / rs, dn / rs, zero), (-dn / qs, de / qs, one))
    j1 = _stack_rows((-de / rs, -dn / rs), (dn / qs, -de / qs))
    return se2.pose_landmark_rb_error(x0, lm, z), (j0, j1)


POSE2D = register_vertex_type(
    VertexType(name="pose2d", dim=3, retract=se2.plus, local_diff=_pose2d_local_diff)
)

LANDMARK2D = register_vertex_type(
    VertexType(
        name="landmark2d",
        dim=2,
        retract=lambda x, d: x + d,  # CVertexLandmark2D::Operator_Plus (plain add)
        is_landmark=True,
    )
)

EDGE_POSE2D = register_edge_type(
    EdgeType(
        name="edge_pose2d",
        vertex_types=("pose2d", "pose2d"),
        res_dim=3,
        meas_dim=3,
        error_fn=_edge_pose2d_error,
        jacobian_fn=_edge_pose2d_jacobians,
    )
)

EDGE_POSE_LANDMARK2D_XY = register_edge_type(
    EdgeType(
        name="edge_pose_landmark2d_xy",
        vertex_types=("pose2d", "landmark2d"),
        res_dim=2,
        meas_dim=2,
        error_fn=lambda xs, z: se2.pose_landmark_xy_error(xs[0], xs[1], z),
        jacobian_fn=_edge_pose_landmark2d_xy_jacobians,
    )
)

EDGE_POSE_LANDMARK2D_RB = register_edge_type(
    EdgeType(
        name="edge_pose_landmark2d_rb",
        vertex_types=("pose2d", "landmark2d"),
        res_dim=2,
        meas_dim=2,
        error_fn=lambda xs, z: se2.pose_landmark_rb_error(xs[0], xs[1], z),
        jacobian_fn=_edge_pose_landmark2d_rb_jacobians,
    )
)


# ---------------------------------------------------------------- initializers
# CRelative_to_Absolute_XYT_Initializer (SE2_Types.h:184): the endpoint of an
# odometry edge starts at the origin pose composed with the measurement, a
# landmark at the observing pose composed with its observation; a missing
# origin pose counts as zero.


def _np_rel_to_abs(p1, d):
    c, s = np.cos(p1[2]), np.sin(p1[2])
    a = np.fmod(p1[2] + d[2], 2 * np.pi)
    return np.array([p1[0] + c * d[0] - s * d[1], p1[1] + s * d[0] + c * d[1], a])


def init_pose_from_pose(known, meas):
    p1 = known.get(0, np.zeros(3))
    return _np_rel_to_abs(np.asarray(p1), np.asarray(meas)[:3])


def init_landmark_xy(known, meas):
    p1 = np.asarray(known.get(0, np.zeros(3)))
    c, s = np.cos(p1[2]), np.sin(p1[2])
    mx, my = meas[0], meas[1]
    return np.array([p1[0] + c * mx - s * my, p1[1] + s * mx + c * my])


def init_landmark_rb(known, meas):
    p1 = np.asarray(known.get(0, np.zeros(3)))
    rng, brg = meas[0], meas[1]
    a = p1[2] + brg
    return np.array([p1[0] + rng * np.cos(a), p1[1] + rng * np.sin(a)])


POSE_POSE_INITIALIZERS = (None, init_pose_from_pose)
POSE_LANDMARK_XY_INITIALIZERS = (None, init_landmark_xy)
POSE_LANDMARK_RB_INITIALIZERS = (None, init_landmark_rb)
