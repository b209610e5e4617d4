"""SE(2) pose math, batched over a leading edge axis (counterpart of
``slampp_tpu/geometry/se2.py``, whose functions are written per pose and
vmapped).

Poses are (..., 3) tensors (x, y, theta).  The conventions are the
reference's (C2DJacobians, 2DSolverBase.h:37): fmod-style angle clamping
into (-2pi, 2pi) and the minimum-absolute angular-error fixup, so chi2
matches the JAX package at f64.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def clamp_angle_2pi(a: torch.Tensor) -> torch.Tensor:
    """Angle modulo into (-2pi, 2pi), preserving sign (C fmod semantics)."""
    return torch.where(torch.isfinite(a), torch.fmod(a, TWO_PI), torch.zeros_like(a))


def clamp_angular_error_2pi(e: torch.Tensor) -> torch.Tensor:
    """Minimum-absolute 2pi-congruent angular error; on a tie the first of
    (e, e - 2pi, e + 2pi) wins, as with ``jnp.argmin``."""
    e = clamp_angle_2pi(e)
    cand = torch.stack([e, e - TWO_PI, e + TWO_PI], -1)
    pick = torch.argmin(cand.abs(), -1, keepdim=True)
    return torch.gather(cand, -1, pick)[..., 0]


def relative_to_absolute(p1: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Compose: pose of ``d`` (relative to ``p1``) in the global frame
    (C2DJacobians::Relative_to_Absolute, 2DSolverBase.h:108)."""
    c, s = torch.cos(p1[..., 2]), torch.sin(p1[..., 2])
    return torch.stack(
        [p1[..., 0] + c * d[..., 0] - s * d[..., 1],
         p1[..., 1] + s * d[..., 0] + c * d[..., 1],
         clamp_angle_2pi(p1[..., 2] + d[..., 2])], -1
    )


def absolute_to_relative(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Pose of ``p2`` in the frame of ``p1`` (the edge expectation h(x))."""
    de, dn = p2[..., 0] - p1[..., 0], p2[..., 1] - p1[..., 1]
    c, s = torch.cos(p1[..., 2]), torch.sin(p1[..., 2])
    return torch.stack(
        [c * de + s * dn, -s * de + c * dn, clamp_angle_2pi(p2[..., 2] - p1[..., 2])], -1
    )


def absolute_to_relative_jacobians(p1: torch.Tensor, p2: torch.Tensor):
    """h = absolute_to_relative(p1, p2) and its Jacobians (..., 3, 3) with
    respect to p1 and p2 (2DSolverBase.h:330-345)."""
    de, dn = p2[..., 0] - p1[..., 0], p2[..., 1] - p1[..., 1]
    c, s = torch.cos(p1[..., 2]), torch.sin(p1[..., 2])
    hx = c * de + s * dn
    hy = -s * de + c * dn
    h = torch.stack([hx, hy, clamp_angle_2pi(p2[..., 2] - p1[..., 2])], -1)
    z = torch.zeros_like(c)
    one = torch.ones_like(c)
    j1 = torch.stack(
        [
            torch.stack([-c, -s, hy], -1),
            torch.stack([s, -c, -hx], -1),
            torch.stack([z, z, -one], -1),
        ],
        -2,
    )
    j2 = torch.stack(
        [
            torch.stack([c, s, z], -1),
            torch.stack([-s, c, z], -1),
            torch.stack([z, z, one], -1),
        ],
        -2,
    )
    return h, j1, j2


def pose_pose_error(x0: torch.Tensor, x1: torch.Tensor, meas: torch.Tensor) -> torch.Tensor:
    """Residual of an SE(2) odometry/loop edge: ``z - h(x0, x1)`` with the
    angular fixup (CEdgePose2D, SE2_Types.h:305-318)."""
    err = meas - absolute_to_relative(x0, x1)
    return torch.cat([err[..., :2], clamp_angular_error_2pi(err[..., 2:3])], -1)


def pose_landmark_xy_error(x0: torch.Tensor, lm: torch.Tensor, meas: torch.Tensor) -> torch.Tensor:
    """Residual of an SE(2) pose->landmark XY observation: ``z - h`` with h
    the landmark in the observing pose's frame (CEdgePoseLandmark2D,
    SE2_Types.h:340+)."""
    de, dn = lm[..., 0] - x0[..., 0], lm[..., 1] - x0[..., 1]
    c, s = torch.cos(x0[..., 2]), torch.sin(x0[..., 2])
    return meas - torch.stack([c * de + s * dn, -s * de + c * dn], -1)


def pose_landmark_rb_error(x0: torch.Tensor, lm: torch.Tensor, meas: torch.Tensor) -> torch.Tensor:
    """Residual of an SE(2) pose->landmark range-bearing edge (LANDMARK2:RB),
    with the angular fixup on the bearing."""
    de, dn = lm[..., 0] - x0[..., 0], lm[..., 1] - x0[..., 1]
    rng = torch.sqrt(de * de + dn * dn)
    brg = torch.atan2(dn, de) - x0[..., 2]
    err = meas - torch.stack([rng, brg], -1)
    return torch.stack([err[..., 0], clamp_angular_error_2pi(err[..., 1])], -1)


def plus(state: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Vertex retraction for SE(2) poses: addition + angle clamp."""
    out = state + delta
    return torch.cat([out[..., :2], clamp_angle_2pi(out[..., 2:3])], -1)
