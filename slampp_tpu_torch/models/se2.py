"""SE(2) pose-graph types (counterpart of ``slampp_tpu/models/se2.py``;
reference include/slam/SE2_Types.h).

Vertex type pose2d (x, y, theta); edge type edge_pose2d with an analytic
batched Jacobian (the JAX package differentiated ``error_fn`` with
``jax.jacfwd``; the formulas follow ``models/np_kernels._edge_pose2d_lin``).
The landmark types wait for a later port.
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


POSE2D = register_vertex_type(
    VertexType(name="pose2d", dim=3, retract=se2.plus, local_diff=_pose2d_local_diff)
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


# ---------------------------------------------------------------- initializers
# CRelative_to_Absolute_XYT_Initializer (SE2_Types.h:184): the endpoint of an
# odometry edge starts at the origin pose composed with the measurement;
# a missing origin pose counts as zero.


def _np_rel_to_abs(p1, d):
    c, s = np.cos(p1[2]), np.sin(p1[2])
    a = np.fmod(p1[2] + d[2], 2 * np.pi)
    return np.array([p1[0] + c * d[0] - s * d[1], p1[1] + s * d[0] + c * d[1], a])


def init_pose_from_pose(known, meas):
    p1 = known.get(0, np.zeros(3))
    return _np_rel_to_abs(np.asarray(p1), np.asarray(meas)[:3])


POSE_POSE_INITIALIZERS = (None, init_pose_from_pose)
