"""Vectorized NumPy model kernels for the host-side incremental hot path
(a copy of ``slampp_tpu/models/np_kernels.py``).

The FastL-role solver (solvers/fastl.py) keeps the live window's linear
system resident on the host and updates it per incremental step with no
device dispatch — the reference runs the same economics on the CPU
(``include/slam/NonlinearSolver_FastL.h``).  That takes batched *NumPy*
residual/Jacobian kernels that follow the model math at f64.

Registry contract (all functions are batched over a leading E/B axis):

  ``NP_EDGE_LIN[edge_type]     (slot_states tuple of (E, sd_k), meas (E, m))
                                -> (r (E, res), jacs tuple of (E, res, d_k))``
  ``NP_RETRACT[vertex_type]    (states (B, sd), delta (B, d)) -> (B, sd)``
  ``NP_LOCAL_DIFF[vertex_type] (cur (B, sd), ref (B, sd)) -> (B, d)``

Types without NumPy kernels do not get the fast path (FastLSolver raises
for them).  tests/test_torch_incremental.py holds these kernels against the
JAX package's (random states, r and J at 1e-12).

Reference math: ``C2DJacobians`` (include/slam/2DSolverBase.h:37-345),
``CVertexPose2D::Operator_Plus`` (SE2_Types.h:70), ``CEdgePose2D``
(SE2_Types.h:305).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

TWO_PI = 2.0 * np.pi

NP_EDGE_LIN: Dict[str, Callable] = {}
NP_RETRACT: Dict[str, Callable] = {}
NP_LOCAL_DIFF: Dict[str, Callable] = {}


def register_np_edge_lin(name: str, fn: Callable) -> None:
    NP_EDGE_LIN[name] = fn


def register_np_vertex(name: str, retract: Callable, local_diff: Callable) -> None:
    NP_RETRACT[name] = retract
    NP_LOCAL_DIFF[name] = local_diff


def has_np_kernels(edge_types, vertex_types) -> bool:
    return all(t in NP_EDGE_LIN for t in edge_types) and all(
        t in NP_RETRACT for t in vertex_types
    )


# ------------------------------------------------------------------ SE(2) math


def _clamp_angle_2pi(a):
    """fmod into (-2pi, 2pi), sign preserved (2DSolverBase.h:45)."""
    return np.where(np.isfinite(a), np.fmod(a, TWO_PI), 0.0)


def _clamp_angular_error_2pi(e):
    """Minimum-absolute 2pi-congruent error (2DSolverBase.h:91); batched."""
    e = _clamp_angle_2pi(e)
    cand = np.stack([e, e - TWO_PI, e + TWO_PI])       # (3, ...)
    pick = np.argmin(np.abs(cand), axis=0)
    return np.take_along_axis(cand, pick[None], axis=0)[0]


def _pose2d_retract(states, delta):
    out = states + delta
    out[..., 2] = _clamp_angle_2pi(out[..., 2])
    return out


def _pose2d_local_diff(cur, ref):
    d = cur - ref
    d[..., 2] = _clamp_angular_error_2pi(d[..., 2])
    return d


def _vec_retract(states, delta):
    return states + delta


def _vec_local_diff(cur, ref):
    return cur - ref


def _edge_pose2d_lin(slot_states, meas):
    """Batched residual + error-Jacobians of the SE(2) pose-pose edge.

    r = z - abs_to_rel(x0, x1) with angular fixup; J_k = -d h/d x_k (the
    retraction is additive so manifold and state Jacobians coincide).
    Mirrors geometry/se2.absolute_to_relative_jacobians (2DSolverBase.h:330).
    """
    p1, p2 = slot_states
    de = p2[:, 0] - p1[:, 0]
    dn = p2[:, 1] - p1[:, 1]
    c, s = np.cos(p1[:, 2]), np.sin(p1[:, 2])
    hx = c * de + s * dn
    hy = -s * de + c * dn
    ht = _clamp_angle_2pi(p2[:, 2] - p1[:, 2])
    E = p1.shape[0]
    r = np.empty((E, 3))
    r[:, 0] = meas[:, 0] - hx
    r[:, 1] = meas[:, 1] - hy
    r[:, 2] = _clamp_angular_error_2pi(meas[:, 2] - ht)
    z = np.zeros(E)
    one = np.ones(E)
    # J1 = -dh/dp1, J2 = -dh/dp2  (r = z - h)
    j1 = np.empty((E, 3, 3))
    j1[:, 0, 0] = c
    j1[:, 0, 1] = s
    j1[:, 0, 2] = -hy
    j1[:, 1, 0] = -s
    j1[:, 1, 1] = c
    j1[:, 1, 2] = hx
    j1[:, 2, 0] = z
    j1[:, 2, 1] = z
    j1[:, 2, 2] = one
    j2 = np.empty((E, 3, 3))
    j2[:, 0, 0] = -c
    j2[:, 0, 1] = -s
    j2[:, 0, 2] = z
    j2[:, 1, 0] = s
    j2[:, 1, 1] = -c
    j2[:, 1, 2] = z
    j2[:, 2, 0] = z
    j2[:, 2, 1] = z
    j2[:, 2, 2] = -one
    return r, (j1, j2)


def _edge_pose_landmark2d_xy_lin(slot_states, meas):
    """SE(2) pose->landmark XY observation (SE2_Types.h:340+)."""
    x0, lm = slot_states
    de = lm[:, 0] - x0[:, 0]
    dn = lm[:, 1] - x0[:, 1]
    c, s = np.cos(x0[:, 2]), np.sin(x0[:, 2])
    hx = c * de + s * dn
    hy = -s * de + c * dn
    E = x0.shape[0]
    r = np.empty((E, 2))
    r[:, 0] = meas[:, 0] - hx
    r[:, 1] = meas[:, 1] - hy
    # h w.r.t. pose (x, y, theta) and landmark (x, y); J = -dh/dx
    j0 = np.empty((E, 2, 3))
    j0[:, 0, 0] = c
    j0[:, 0, 1] = s
    j0[:, 0, 2] = -hy
    j0[:, 1, 0] = -s
    j0[:, 1, 1] = c
    j0[:, 1, 2] = hx
    j1 = np.empty((E, 2, 2))
    j1[:, 0, 0] = -c
    j1[:, 0, 1] = -s
    j1[:, 1, 0] = s
    j1[:, 1, 1] = -c
    return r, (j0, j1)


def _edge_pose_landmark2d_rb_lin(slot_states, meas):
    """SE(2) pose->landmark range-bearing observation."""
    x0, lm = slot_states
    de = lm[:, 0] - x0[:, 0]
    dn = lm[:, 1] - x0[:, 1]
    q = de * de + dn * dn
    rng = np.sqrt(q)
    E = x0.shape[0]
    r = np.empty((E, 2))
    r[:, 0] = meas[:, 0] - rng
    r[:, 1] = _clamp_angular_error_2pi(
        meas[:, 1] - (np.arctan2(dn, de) - x0[:, 2])
    )
    # d rng/d(de,dn) = (de,dn)/rng ; d brg/d(de,dn) = (-dn,de)/q ; J = d r/d x
    rs = np.where(rng > 0, rng, 1.0)
    qs = np.where(q > 0, q, 1.0)
    j0 = np.empty((E, 2, 3))
    j0[:, 0, 0] = de / rs
    j0[:, 0, 1] = dn / rs
    j0[:, 0, 2] = 0.0
    j0[:, 1, 0] = -dn / qs
    j0[:, 1, 1] = de / qs
    j0[:, 1, 2] = 1.0
    j1 = np.empty((E, 2, 2))
    j1[:, 0, 0] = -de / rs
    j1[:, 0, 1] = -dn / rs
    j1[:, 1, 0] = dn / qs
    j1[:, 1, 1] = -de / qs
    return r, (j0, j1)


register_np_vertex("pose2d", _pose2d_retract, _pose2d_local_diff)
register_np_vertex("landmark2d", _vec_retract, _vec_local_diff)
register_np_edge_lin("edge_pose2d", _edge_pose2d_lin)
register_np_edge_lin("edge_pose_landmark2d_xy", _edge_pose_landmark2d_xy_lin)
register_np_edge_lin("edge_pose_landmark2d_rb", _edge_pose_landmark2d_rb_lin)
