"""Sim(3) problem types (counterpart of ``slampp_tpu/models/sim3.py``;
reference include/slam/Sim3_Types.h, the ACRA'15 parameterization study).

Vertex types: ``sim3`` (7 log coordinates), ``camsim3`` (7 log + 5 stored
intrinsics), ``invdepth`` (3: (x/z, y/z, 1/z) with XYZ-space deltas),
``invdist`` (state (q, ray), one degree of freedom), plus the shared
``xyz`` landmark of models/ba.

Edges over the reference's {XYZ, InvDepth, InvDist} x {global, local-self,
local-other} grid (Sim3_Types.h:247-3598): _G (world landmark, camera),
_LS (landmark in its owner's frame, unary: the measurement carries
(u, v, fx, fy, cx, cy, k)), _LO (ternary: landmark, owner camera,
observing camera); the Sim(3) relative pose edge, the SE(3)-pose <->
Sim(3)-camera edge, and the angle-error variant of each reprojection edge.

Jacobians: the G edges on xyz and invdepth (the Sim(3) bundle adjustment
path) are analytic.  With the post-multiplied retraction
log(exp(x) exp(d)), a camera delta d = (u, w, sigma) moves the local point
x = R^T (X - t) / s by -(u + w x x + sigma x), and a landmark delta (XYZ
space for both parameterizations) by R^T d / s; the projection layer is
differentiated elementwise.  The other edge types take
``graph.types.autodiff_jacobian`` (jacfwd through the retractions, as the
JAX package did for every type).

The xyz G edge (``edge_p2c_xyz_sim3_g``, the Sim(3) bundle adjustment of
world points) also has fused forms (``ops/sim3_kernels.py``: one
hand-written float64 kernel) for its sparse Schur terms, its chi2 and the
LM damping scale, which CUDA operands take; on the CPU it keeps the plain
path.  ``edge_p2c_invdepth_sim3_g``, which shares ``_g_jacobians``, and
every other type stay on the plain path.
"""

from __future__ import annotations

import numpy as np
import torch

from slampp_tpu_torch.geometry import se3, sim3
from slampp_tpu_torch.graph.types import (
    EdgeType,
    VertexType,
    autodiff_jacobian,
    register_edge_type,
    register_vertex_type,
)
from slampp_tpu_torch.models import ba  # noqa: F401  (registers xyz)
from slampp_tpu_torch.models import se3 as _se3_model  # noqa: F401  (registers pose3d)
from slampp_tpu_torch.ops import sim3_kernels


def _camsim3_retract(state, delta):
    return torch.cat([sim3.plus(state[..., 0:7], delta), state[..., 7:12]], -1)


def _invdist_retract(state, delta):
    """CVertexInvDist (Sim3_Types.h:102): the delta moves the inverse
    distance q only (Operator_Plus, :161-171)."""
    return torch.cat([state[..., 0:1] + delta[..., 0:1], state[..., 1:4]], -1)


SIM3 = register_vertex_type(VertexType(name="sim3", dim=7, retract=sim3.plus))

CAMSIM3 = register_vertex_type(
    VertexType(name="camsim3", dim=7, retract=_camsim3_retract, _state_dim=12)
)

INVDEPTH = register_vertex_type(
    VertexType(name="invdepth", dim=3, retract=sim3.invdepth_plus, is_landmark=True)
)

INVDIST = register_vertex_type(
    VertexType(name="invdist", dim=1, retract=_invdist_retract, is_landmark=True,
               _state_dim=4)
)


def invdist_to_xyz(state: torch.Tensor) -> torch.Tensor:
    """Position (owner frame) of inverse-distance landmarks: ray / q."""
    return state[..., 1:4] / state[..., 0:1]


# ------------------------------------------------------------ error functions
def _p2c_xyz_g(xs, z):
    """CEdgeP2C_XYZ_Sim3_G: (xyz world landmark, camsim3) reprojection."""
    X, cam = xs
    return z - sim3.project_p2c_xyz(cam[..., 0:7], cam[..., 7:12], X)


def _p2c_invdepth_g(xs, z):
    """CEdgeP2C_InvDepth_Sim3_G: inverse-depth world landmark."""
    v, cam = xs
    return z - sim3.project_p2c_xyz(cam[..., 0:7], cam[..., 7:12], sim3.invdepth_to_xyz(v))


def _p2c_xyz_ls(xs, z):
    """CEdgeLandmark_XYZ_Sim3_LS: landmark in the observing camera's own
    frame (unary); z = (u, v, fx, fy, cx, cy, k)."""
    (x_local,) = xs
    return z[..., 0:2] - sim3.project_p2c_local_xyz(x_local, z[..., 2:7])


def _p2c_invdepth_ls(xs, z):
    (v,) = xs
    return z[..., 0:2] - sim3.project_p2c_local_xyz(sim3.invdepth_to_xyz(v), z[..., 2:7])


def _p2c_xyz_lo(xs, z):
    """CEdgeP2C_XYZ_Sim3_LO: landmark local to its owner camera, observed
    by another (ternary: landmark, owner cam, observing cam)."""
    x_local, owner, obs = xs
    x_obs = sim3.local_to_other(x_local, owner[..., 0:7], obs[..., 0:7])
    return z - sim3.project_p2c_local_xyz(x_obs, obs[..., 7:12])


def _p2c_invdepth_lo(xs, z):
    v, owner, obs = xs
    x_obs = sim3.local_to_other(sim3.invdepth_to_xyz(v), owner[..., 0:7], obs[..., 0:7])
    return z - sim3.project_p2c_local_xyz(x_obs, obs[..., 7:12])


def _p2c_invdist_ls(xs, z):
    """CEdgeP2C_InvDist_Sim3_LS (unary; z = (u, v, intrinsics))."""
    (v,) = xs
    return z[..., 0:2] - sim3.project_p2c_local_xyz(invdist_to_xyz(v), z[..., 2:7])


def _p2c_invdist_lo(xs, z):
    """CEdgeP2C_InvDist_Sim3_LO: observed from another camera (ternary)."""
    v, owner, obs = xs
    x_obs = sim3.local_to_other(invdist_to_xyz(v), owner[..., 0:7], obs[..., 0:7])
    return z - sim3.project_p2c_local_xyz(x_obs, obs[..., 7:12])


def _log_difference(h, z):
    """log(exp(h)^-1 exp(z)): the 7-dof residual of the pose edges."""
    return sim3.sim3_log(sim3.compose_tRs(sim3.inverse_tRs(sim3.sim3_exp(h)), sim3.sim3_exp(z)))


def _sim3_pose_pose(xs, z):
    """Relative Sim(3) constraint: r = z (-) log(exp(x0)^-1 exp(x1))."""
    return _log_difference(sim3.absolute_to_relative(xs[0], xs[1]), z)


def _pose_cam_sim3(xs, z):
    """CEdgePoseCamSim3: an SE(3) pose vertex (as sim(3) with sigma = 0)
    tied to a Sim(3) camera; the 7-dof log difference."""
    pose_se3, cam = xs
    x0 = torch.cat([pose_se3, pose_se3.new_zeros(pose_se3.shape[:-1] + (1,))], -1)
    return _log_difference(sim3.absolute_to_relative(x0, cam[..., 0:7]), z)


# angle-error variants: the 2-DoF tangent-plane deviation between the
# observed ray (back-projected pixel) and the predicted landmark direction
def _angle_err_local(x_local, uv, intrinsics):
    return sim3.tangent_angle_error(sim3.backproject_ray(uv, intrinsics), x_local)


def _p2c_xyz_sim3_g_angle(xs, z):
    X, cam = xs
    return _angle_err_local(sim3.world_to_local(cam[..., 0:7], X), z, cam[..., 7:12])


def _p2c_invdepth_sim3_g_angle(xs, z):
    v, cam = xs
    return _angle_err_local(sim3.world_to_local(cam[..., 0:7], sim3.invdepth_to_xyz(v)), z,
                            cam[..., 7:12])


def _p2c_xyz_sim3_ls_angle(xs, z):
    (x_local,) = xs
    return _angle_err_local(x_local, z[..., 0:2], z[..., 2:7])


def _p2c_invdepth_sim3_ls_angle(xs, z):
    (v,) = xs
    return _angle_err_local(sim3.invdepth_to_xyz(v), z[..., 0:2], z[..., 2:7])


def _p2c_invdist_sim3_ls_angle(xs, z):
    (v,) = xs
    return _angle_err_local(invdist_to_xyz(v), z[..., 0:2], z[..., 2:7])


def _p2c_xyz_sim3_lo_angle(xs, z):
    x_local, owner, obs = xs
    x_obs = sim3.local_to_other(x_local, owner[..., 0:7], obs[..., 0:7])
    return _angle_err_local(x_obs, z, obs[..., 7:12])


def _p2c_invdepth_sim3_lo_angle(xs, z):
    v, owner, obs = xs
    x_obs = sim3.local_to_other(sim3.invdepth_to_xyz(v), owner[..., 0:7], obs[..., 0:7])
    return _angle_err_local(x_obs, z, obs[..., 7:12])


def _p2c_invdist_sim3_lo_angle(xs, z):
    v, owner, obs = xs
    x_obs = sim3.local_to_other(invdist_to_xyz(v), owner[..., 0:7], obs[..., 0:7])
    return _angle_err_local(x_obs, z, obs[..., 7:12])


# ------------------------------------------------- analytic G-edge Jacobians
def _g_jacobians(X, cam, z):
    """(r, (J_point (E, 2, 3), J_cam (E, 2, 7))) of z - h(x), x the world
    point X in the camera's local frame; J_point is per XYZ-space delta."""
    tRs = sim3.sim3_exp(cam[..., 0:7])
    x = sim3.inv_transform_tRs(tRs, X)
    intr = cam[..., 7:12]
    fx, fy = intr[..., 0], intr[..., 1]
    k = intr[..., 4] / (0.5 * (fx * fy))
    iz = 1.0 / x[..., 2]
    a = fx * x[..., 0] * iz
    b = fy * x[..., 1] * iz
    d = 1.0 + k * (a * a + b * b)
    zero = torch.zeros_like(iz)
    da = torch.stack([fx * iz, zero, -a * iz], -1)  # d a / d x
    db = torch.stack([zero, fy * iz, -b * iz], -1)
    m11 = (d + 2.0 * k * a * a)[..., None]
    m12 = (2.0 * k * a * b)[..., None]
    m22 = (d + 2.0 * k * b * b)[..., None]
    Jh = torch.stack([m11 * da + m12 * db, m12 * da + m22 * db], -2)  # dh / dx
    Rt = se3.axis_angle_to_rot(tRs[..., 3:6]).transpose(-1, -2)
    j_point = -(Jh @ Rt) / tRs[..., 6, None, None]
    eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(x.shape[:-1] + (3, 3))
    j_cam = Jh @ torch.cat([eye, -se3._skew(x), x[..., None]], -1)
    return z - sim3._distort(x, intr), (j_point, j_cam)


def _p2c_xyz_g_jacobians(xs, z):
    return _g_jacobians(xs[0], xs[1], z)


def _p2c_invdepth_g_jacobians(xs, z):
    """The invdepth retraction adds its delta in XYZ space, so the point
    Jacobian is the xyz edge's."""
    v, cam = xs
    return _g_jacobians(sim3.invdepth_to_xyz(v), cam, z)


def _xyz_g_operands(ea, states):
    """The fused forms' operands of the xyz G edges (slots xyz, camsim3)."""
    return (states["xyz"], states["camsim3"], ea.local_idx, ea.meas, ea.sigma_inv, ea.valid)


def _edge(name, vertex_types, res_dim, meas_dim, error_fn, jacobian_fn=None, **fused):
    return register_edge_type(EdgeType(
        name=name, vertex_types=vertex_types, res_dim=res_dim, meas_dim=meas_dim,
        error_fn=error_fn,
        jacobian_fn=jacobian_fn or autodiff_jacobian(error_fn, vertex_types), **fused))


_G = ("xyz", "camsim3")
_LO = ("camsim3", "camsim3")
EDGE_P2C_XYZ_SIM3_G = _edge(
    "edge_p2c_xyz_sim3_g", _G, 2, 2, _p2c_xyz_g, _p2c_xyz_g_jacobians,
    fused_terms=lambda ea, st, order: sim3_kernels.sim3_g_terms(*_xyz_g_operands(ea, st), order),
    fused_chi2=lambda ea, st: sim3_kernels.sim3_g_chi2(*_xyz_g_operands(ea, st)))
EDGE_P2C_INVDEPTH_SIM3_G = _edge("edge_p2c_invdepth_sim3_g", ("invdepth", "camsim3"), 2, 2,
                                 _p2c_invdepth_g, _p2c_invdepth_g_jacobians)
EDGE_P2C_XYZ_SIM3_LS = _edge("edge_p2c_xyz_sim3_ls", ("xyz",), 2, 7, _p2c_xyz_ls)
EDGE_P2C_INVDEPTH_SIM3_LS = _edge("edge_p2c_invdepth_sim3_ls", ("invdepth",), 2, 7,
                                  _p2c_invdepth_ls)
EDGE_P2C_XYZ_SIM3_LO = _edge("edge_p2c_xyz_sim3_lo", ("xyz",) + _LO, 2, 2, _p2c_xyz_lo)
EDGE_P2C_INVDEPTH_SIM3_LO = _edge("edge_p2c_invdepth_sim3_lo", ("invdepth",) + _LO, 2, 2,
                                  _p2c_invdepth_lo)
EDGE_P2C_INVDIST_SIM3_LS = _edge("edge_p2c_invdist_sim3_ls", ("invdist",), 2, 7,
                                 _p2c_invdist_ls)
EDGE_P2C_INVDIST_SIM3_LO = _edge("edge_p2c_invdist_sim3_lo", ("invdist",) + _LO, 2, 2,
                                 _p2c_invdist_lo)
EDGE_POSE_SIM3 = _edge("edge_pose_sim3", ("sim3", "sim3"), 7, 7, _sim3_pose_pose)
EDGE_POSE_CAM_SIM3 = _edge("edge_pose_cam_sim3", ("pose3d", "camsim3"), 7, 7, _pose_cam_sim3)

EDGE_P2C_XYZ_SIM3_G_ANGLE = _edge("edge_p2c_xyz_sim3_g_angle", _G, 2, 2, _p2c_xyz_sim3_g_angle)
EDGE_P2C_INVDEPTH_SIM3_G_ANGLE = _edge("edge_p2c_invdepth_sim3_g_angle",
                                       ("invdepth", "camsim3"), 2, 2,
                                       _p2c_invdepth_sim3_g_angle)
EDGE_P2C_XYZ_SIM3_LS_ANGLE = _edge("edge_p2c_xyz_sim3_ls_angle", ("xyz",), 2, 7,
                                   _p2c_xyz_sim3_ls_angle)
EDGE_P2C_INVDEPTH_SIM3_LS_ANGLE = _edge("edge_p2c_invdepth_sim3_ls_angle", ("invdepth",), 2, 7,
                                        _p2c_invdepth_sim3_ls_angle)
EDGE_P2C_INVDIST_SIM3_LS_ANGLE = _edge("edge_p2c_invdist_sim3_ls_angle", ("invdist",), 2, 7,
                                       _p2c_invdist_sim3_ls_angle)
EDGE_P2C_XYZ_SIM3_LO_ANGLE = _edge("edge_p2c_xyz_sim3_lo_angle", ("xyz",) + _LO, 2, 2,
                                   _p2c_xyz_sim3_lo_angle)
EDGE_P2C_INVDEPTH_SIM3_LO_ANGLE = _edge("edge_p2c_invdepth_sim3_lo_angle",
                                        ("invdepth",) + _LO, 2, 2,
                                        _p2c_invdepth_sim3_lo_angle)
EDGE_P2C_INVDIST_SIM3_LO_ANGLE = _edge("edge_p2c_invdist_sim3_lo_angle", ("invdist",) + _LO,
                                       2, 2, _p2c_invdist_sim3_lo_angle)


def embed_ba_system_sim3(ba_system):
    """Re-express a mono-BA system (cam / xyz, ``edge_p2c``) in Sim(3), as
    the reference's 3DV'17 app does with standard BA datasets
    (src/incremental_ba_3dv/Main.cpp:236-259): each world-to-camera pose
    with scale 1 is inverted to camera-to-world and stored as its log,
    landmarks stay world XYZ, observations become edge_p2c_xyz_sim3_g.
    Returns a new GraphSystem over camsim3 / xyz."""
    from slampp_tpu_torch.graph.system import GraphSystem

    out = GraphSystem()
    for vid in ba_system._vorder:
        t, _ = ba_system.vertex_index[vid]
        st = ba_system.vertex_state(vid)
        const = ba_system._vconst.get(vid, False)
        if t == "cam":
            w2c = torch.as_tensor(np.concatenate([st[0:6], [1.0]]), dtype=torch.float64)
            log = sim3.sim3_log(sim3.inverse_tRs(w2c)).numpy()
            out.add_vertex("camsim3", vid, np.concatenate([log, st[6:11]]), const=const)
        elif t == "xyz":
            out.add_vertex("xyz", vid, st, const=const)
        else:
            raise ValueError(f"embed_ba_system_sim3: unsupported type {t}")
    rec = ba_system._edges.get("edge_p2c", {"vids": []})
    for e, vids in enumerate(rec["vids"]):
        out.add_edge("edge_p2c_xyz_sim3_g", tuple(vids), rec["meas"][e], rec["sigma_inv"][e])
    return out
