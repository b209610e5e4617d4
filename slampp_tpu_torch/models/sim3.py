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
path) and the inverse-distance LS and LO edges (the local-landmark path,
``embed_ba_system_sim3_invdist``) are analytic.  With the post-multiplied
retraction log(exp(x) exp(d)), a camera delta d = (u, w, sigma) moves the
local point x = R^T (X - t) / s by -(u + w x x + sigma x), and a landmark
delta (XYZ space for both parameterizations) by R^T d / s; an LO edge's
owner delta moves the owner-local point by +(u + w x x_o + sigma x_o); the
projection layer is differentiated elementwise.  The other edge types take
``graph.types.autodiff_jacobian`` (jacfwd through the retractions, as the
JAX package did for every type).

The xyz G edge (``edge_p2c_xyz_sim3_g``, the Sim(3) bundle adjustment of
world points) and the inverse-distance LO and LS edges (the local-landmark
path) also have fused forms (``ops/sim3_kernels.py``,
``ops/invdist_kernels.py``: hand-written float64 kernels) for their sparse
Schur terms, their chi2 and the LM damping scale, which CUDA operands
take; on the CPU they keep the plain path.  ``edge_p2c_invdepth_sim3_g``,
which shares ``_g_jacobians``, and every other type stay on the plain
path.
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
from slampp_tpu_torch.ops import invdist_kernels, sim3_kernels


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
def _distort_jacobian(x, intr):
    """(E, 2, 3) d h / d x of the camera-frame projection h =
    ``sim3._distort`` (pinhole and one radial term)."""
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
    return torch.stack([m11 * da + m12 * db, m12 * da + m22 * db], -2)


def _post_delta(x):
    """(E, 3, 7) [I, -[x]x, x]: how a post-multiplied delta (u, w, sigma)
    of a camera moves a point x of its local frame, exp(d) x - x to first
    order."""
    eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(x.shape[:-1] + (3, 3))
    return torch.cat([eye, -se3._skew(x), x[..., None]], -1)


def _g_jacobians(X, cam, z):
    """(r, (J_point (E, 2, 3), J_cam (E, 2, 7))) of z - h(x), x the world
    point X in the camera's local frame; J_point is per XYZ-space delta."""
    tRs = sim3.sim3_exp(cam[..., 0:7])
    x = sim3.inv_transform_tRs(tRs, X)
    intr = cam[..., 7:12]
    Jh = _distort_jacobian(x, intr)  # dh / dx
    Rt = se3.axis_angle_to_rot(tRs[..., 3:6]).transpose(-1, -2)
    j_point = -(Jh @ Rt) / tRs[..., 6, None, None]
    j_cam = Jh @ _post_delta(x)
    return z - sim3._distort(x, intr), (j_point, j_cam)


def _p2c_xyz_g_jacobians(xs, z):
    return _g_jacobians(xs[0], xs[1], z)


def _p2c_invdepth_g_jacobians(xs, z):
    """The invdepth retraction adds its delta in XYZ space, so the point
    Jacobian is the xyz edge's."""
    v, cam = xs
    return _g_jacobians(sim3.invdepth_to_xyz(v), cam, z)


# ------------------------------------- analytic inverse-distance Jacobians
# The owner-local point is x_o = ray / q and the delta moves q alone, so
# d x_o / d q = -x_o / q.  An LO edge carries x_o through the owner's
# similarity and the observer's inverse, x = M x_o + c with
# M = (s_o / s_c) R_c^T R_o; an owner delta moves x_o by [I, -[x_o]x, x_o] d,
# an observer delta moves x by -[I, -[x]x, x] d (the G edge's camera).
def _p2c_invdist_ls_jacobians(xs, z):
    """(r, (J_q (E, 2, 1),)) of CEdgeP2C_InvDist_Sim3_LS."""
    (v,) = xs
    x = invdist_to_xyz(v)
    intr = z[..., 2:7]
    j_q = _distort_jacobian(x, intr) @ x[..., None] / v[..., 0:1, None]
    return z[..., 0:2] - sim3._distort(x, intr), (j_q,)


def _p2c_invdist_lo_jacobians(xs, z):
    """(r, (J_q (E, 2, 1), J_owner (E, 2, 7), J_observer (E, 2, 7))) of
    CEdgeP2C_InvDist_Sim3_LO."""
    v, owner, obs = xs
    x_o = invdist_to_xyz(v)
    t_o, t_c = sim3.sim3_exp(owner[..., 0:7]), sim3.sim3_exp(obs[..., 0:7])
    x = sim3.inv_transform_tRs(t_c, sim3.transform_tRs(t_o, x_o))
    intr = obs[..., 7:12]
    Jh = _distort_jacobian(x, intr)
    Rc_t = se3.axis_angle_to_rot(t_c[..., 3:6]).transpose(-1, -2)
    scale = (t_o[..., 6] / t_c[..., 6])[..., None, None]
    M = (Rc_t @ se3.axis_angle_to_rot(t_o[..., 3:6])) * scale
    JhM = Jh @ M
    j_q = JhM @ x_o[..., None] / v[..., 0:1, None]
    return z - sim3._distort(x, intr), (j_q, -(JhM @ _post_delta(x_o)), Jh @ _post_delta(x))


def _xyz_g_operands(ea, states):
    """The fused forms' operands of the xyz G edges (slots xyz, camsim3)."""
    return (states["xyz"], states["camsim3"], ea.local_idx, ea.meas, ea.sigma_inv, ea.valid)


def _invdist_lo_operands(ea, states):
    """The fused forms' operands of the LO edges (slots invdist, camsim3,
    camsim3)."""
    return (states["invdist"], states["camsim3"], ea.local_idx, ea.meas, ea.sigma_inv, ea.valid)


def _invdist_ls_operands(ea, states):
    """The fused forms' operands of the LS edges (slot invdist)."""
    return (states["invdist"], ea.local_idx, ea.meas, ea.sigma_inv, ea.valid)


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
# the inverse-distance edges' terms come in the edge order (``order`` None)
EDGE_P2C_INVDIST_SIM3_LS = _edge(
    "edge_p2c_invdist_sim3_ls", ("invdist",), 2, 7, _p2c_invdist_ls, _p2c_invdist_ls_jacobians,
    fused_terms=lambda ea, st, order: invdist_kernels.invdist_ls_terms(
        *_invdist_ls_operands(ea, st)),
    fused_chi2=lambda ea, st: invdist_kernels.invdist_ls_chi2(*_invdist_ls_operands(ea, st)))
EDGE_P2C_INVDIST_SIM3_LO = _edge(
    "edge_p2c_invdist_sim3_lo", ("invdist",) + _LO, 2, 2, _p2c_invdist_lo,
    _p2c_invdist_lo_jacobians,
    fused_terms=lambda ea, st, order: invdist_kernels.invdist_lo_terms(
        *_invdist_lo_operands(ea, st)),
    fused_chi2=lambda ea, st: invdist_kernels.invdist_lo_chi2(*_invdist_lo_operands(ea, st)))
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


def embed_ba_system_sim3_invdist(ba_system):
    """Re-express a mono-BA system (cam / xyz, ``edge_p2c``) in Sim(3) with
    local inverse-distance landmarks, as SLAM++'s ACRA'15 parameterization
    study does (src/ba_parameter_acra; CVertexInvDist,
    CEdgeP2C_InvDist_Sim3_LS / _LO): the cameras as
    :func:`embed_ba_system_sim3` embeds them; each point an ``invdist``
    vertex owned by the camera of its first observation in the edges'
    order, its ray that observation back-projected in the owner's frame
    (``geometry/sim3.backproject_ray``), q one over the distance of the
    point from the owner's centre.  An observation by the owner becomes
    ``edge_p2c_invdist_sim3_ls`` (z = (u, v, the owner's intrinsics)), any
    other ``edge_p2c_invdist_sim3_lo`` (landmark, owner, observer).  The
    graph anchors its gauge on vertex 0, a camera: the first LO edge that
    holds it is added first, the rest in their order.  Returns a new
    GraphSystem over camsim3 / invdist."""
    from slampp_tpu_torch.graph.system import GraphSystem

    f64 = dict(dtype=torch.float64)
    rec = ba_system._edges.get("edge_p2c", {"vids": [], "meas": [], "sigma_inv": []})
    vids = np.asarray(rec["vids"], np.int64).reshape(-1, 2)
    uv = np.asarray(rec["meas"], np.float64).reshape(-1, 2)
    pt, cam = vids[:, 0], vids[:, 1]
    kinds = {vid: ba_system.vertex_index[vid][0] for vid in ba_system._vorder}
    if set(kinds.values()) - {"cam", "xyz"}:
        raise ValueError(f"embed_ba_system_sim3_invdist: unsupported types "
                         f"{sorted(set(kinds.values()) - {'cam', 'xyz'})}")
    cam_ids = np.array([v for v in ba_system._vorder if kinds[v] == "cam"], np.int64)
    pt_ids = np.array([v for v in ba_system._vorder if kinds[v] == "xyz"], np.int64)

    # cameras: the world-to-camera pose with scale 1, inverted and logged
    cst = torch.as_tensor(np.stack([ba_system.vertex_state(v) for v in cam_ids]), **f64)
    c2w = sim3.inverse_tRs(torch.cat([cst[:, 0:6], cst.new_ones(len(cam_ids), 1)], 1))
    cam_states = torch.cat([sim3.sim3_log(c2w), cst[:, 6:11]], 1).numpy()
    cam_row = {int(v): i for i, v in enumerate(cam_ids)}

    # points, in id order: owner, ray and inverse distance from each one's
    # first observation
    seen, first = np.unique(pt, return_index=True)
    missing = np.setdiff1d(pt_ids, seen)
    if len(missing):
        raise ValueError(f"embed_ba_system_sim3_invdist: point {int(missing[0])} has no "
                         f"observation to own it")
    orow = np.fromiter((cam_row[int(c)] for c in cam[first]), np.int64, len(first))
    X = torch.as_tensor(np.stack([ba_system.vertex_state(int(v)) for v in seen]), **f64)
    ray = sim3.backproject_ray(torch.as_tensor(uv[first], **f64), cst[orow, 6:11])
    q = 1.0 / torch.linalg.vector_norm(X - c2w[orow, 0:3], dim=-1)
    lm_states = torch.cat([q[:, None], ray], 1).numpy()

    out = GraphSystem()
    for vid in ba_system._vorder:
        const = ba_system._vconst.get(vid, False)
        if kinds[vid] == "cam":
            out.add_vertex("camsim3", vid, cam_states[cam_row[vid]], const=const)
        else:
            out.add_vertex("invdist", vid, lm_states[np.searchsorted(seen, vid)], const=const)

    own = cam[first][np.searchsorted(seen, pt)]  # each observation's owner
    lo = np.flatnonzero(own != cam)
    holds0 = lo[(own[lo] == 0) | (cam[lo] == 0)]
    if 0 not in cam_row or not len(holds0):
        raise ValueError("embed_ba_system_sim3_invdist: the gauge needs camera vertex 0 in an "
                         "observation of a point owned by another camera")
    order = np.concatenate([holds0[:1], np.delete(np.arange(len(pt)), holds0[0])])
    for e in order.tolist():
        p, c, o = int(pt[e]), int(cam[e]), int(own[e])
        if c == o:
            z = np.concatenate([uv[e], cam_states[cam_row[o], 7:12]])
            out.add_edge("edge_p2c_invdist_sim3_ls", (p,), z, rec["sigma_inv"][e])
        else:
            out.add_edge("edge_p2c_invdist_sim3_lo", (p, o, c), uv[e], rec["sigma_inv"][e])
    return out
