"""g2o / TORO / SLAM++ dataset parser and parse loop (counterpart of
``slampp_tpu/io/parser.py``).

``parse_tokens``, ``parse_file`` and ``detect_problem`` are NumPy copies of
the JAX package's (token-alias table and storage conversions of
ParsePrimitives.h); ``g2o_file`` hands generated g2o text to ``parse_file``.
The port's ``build_system`` takes every record kind the JAX package's
does: SE(2), SE(3), BA, Spheron and ROCV records, phase delimiters and
consistency markers, with the JAX package's incremental hooks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
from typing import Iterable, Iterator, List, Optional

import numpy as np


@dataclasses.dataclass
class ParsedRecord:
    kind: str  # canonical record kind, e.g. "edge2", "vertex_cam", "marker"
    ids: tuple
    values: np.ndarray  # measurement / state payload
    info: Optional[np.ndarray] = None  # information matrix (res_dim x res_dim)


def _upper_tri(vals, n):
    m = np.zeros((n, n))
    k = 0
    for i in range(n):
        for j in range(i, n):
            m[i, j] = vals[k]
            m[j, i] = vals[k]
            k += 1
    return m


def _np_rpy_to_rot(p3, p4, p5):
    """The reference's RPY convention (ParsePrimitives.h:520-531)."""
    cx, sx = np.cos(p5), np.sin(p5)
    cy, sy = np.cos(p4), np.sin(p4)
    cz, sz = np.cos(p3), np.sin(p3)
    return np.array(
        [
            [cy * cx, -cz * sx + sz * sy * cx, sz * sx + cz * sy * cx],
            [cy * sx, cz * cx + sz * sy * sx, -sz * cx + cz * sy * sx],
            [-sy, sz * cy, cz * cy],
        ]
    )


def _np_rot_to_aa(R):
    q = _np_rot_to_quat(R)
    return _np_quat_to_aa(q)


def _np_rot_to_quat(R):
    t = np.trace(R)
    qw = np.sqrt(max(0.0, 1.0 + t)) / 2.0
    qx = np.sqrt(max(0.0, 1.0 + R[0, 0] - R[1, 1] - R[2, 2])) / 2.0
    qy = np.sqrt(max(0.0, 1.0 - R[0, 0] + R[1, 1] - R[2, 2])) / 2.0
    qz = np.sqrt(max(0.0, 1.0 - R[0, 0] - R[1, 1] + R[2, 2])) / 2.0
    qx = np.copysign(qx, R[2, 1] - R[1, 2])
    qy = np.copysign(qy, R[0, 2] - R[2, 0])
    qz = np.copysign(qz, R[1, 0] - R[0, 1])
    q = np.array([qw, qx, qy, qz])
    return q / np.linalg.norm(q)


def _np_quat_to_aa(q):
    w, v = q[0], q[1:]
    vn = np.linalg.norm(v)
    if vn < 1e-12:
        return v * 2.0
    half = np.copysign(np.arctan2(vn, abs(w)), w if w != 0 else 1.0)
    return v * (2.0 * half / vn)


def _np_quat_conj(q):
    return np.array([q[0], -q[1], -q[2], -q[3]])


def _np_quat_rotate(q, v):
    uv = 2.0 * np.cross(q[1:], v)
    return v + q[0] * uv + np.cross(q[1:], uv)


# Token aliases -> canonical kind (ParsePrimitives.h EnumerateTokens calls).
_TOKENS_2D_EDGE = {"EDGE2", "EDGE_SE2", "EDGE", "ODOMETRY"}
_TOKENS_2D_VERTEX = {"VERTEX2", "VERTEX_SE2", "VERTEX"}
_TOKENS_2D_LANDMARK_XY = {"LANDMARK2:XY", "EDGE_SE2_XY", "EDGE_BEARING_SE2_XY", "LANDMARK"}
_TOKENS_2D_LANDMARK_RB = {"LANDMARK2:RB", "EDGE_SE2_RB", "EDGE_BEARING_SE2_RB"}
_TOKENS_3D_EDGE = {"EDGE3", "EDGE_SE3"}
_TOKENS_3D_EDGE_AA = {"EDGE3:AXISANGLE", "EDGE_SE3:AXISANGLE"}
_TOKENS_3D_VERTEX = {"VERTEX3", "VERTEX_SE3"}
_TOKENS_3D_LANDMARK = {"LANDMARK3:XYZ", "EDGE_SE3_XYZ"}
_TOKENS_P2C = {"EDGE_PROJECT_P2MC", "EDGE_P2MC", "EDGE_P2C"}
_TOKENS_P2CI = {"EDGE_PROJECT_P2MCI", "EDGE_P2MCI", "EDGE_P2CI"}
_TOKENS_P2SC = {"EDGE_PROJECT_P2SC", "EDGE_P2SC"}


def parse_tokens(token: str, f: List[float]) -> Optional[ParsedRecord]:
    """Parse one line's token + numeric fields into a canonical record."""
    if token in _TOKENS_2D_EDGE:
        i, j = int(f[0]), int(f[1])
        return ParsedRecord("edge2", (i, j), np.array(f[2:5]), _upper_tri(f[5:11], 3))
    if token in _TOKENS_2D_VERTEX:
        return ParsedRecord("vertex2", (int(f[0]),), np.array(f[1:4]))
    if token in _TOKENS_2D_LANDMARK_XY:
        return ParsedRecord(
            "landmark2_xy", (int(f[0]), int(f[1])), np.array(f[2:4]), _upper_tri(f[4:7], 2)
        )
    if token in _TOKENS_2D_LANDMARK_RB:
        return ParsedRecord(
            "landmark2_rb", (int(f[0]), int(f[1])), np.array(f[2:4]), _upper_tri(f[4:7], 2)
        )
    if token in _TOKENS_3D_EDGE:
        i, j = int(f[0]), int(f[1])
        aa = _np_rot_to_aa(_np_rpy_to_rot(f[5], f[6], f[7]))
        meas = np.concatenate([np.array(f[2:5]), aa])
        return ParsedRecord("edge3", (i, j), meas, _upper_tri(f[8:29], 6))
    if token in _TOKENS_3D_EDGE_AA:
        i, j = int(f[0]), int(f[1])
        return ParsedRecord("edge3", (i, j), np.array(f[2:8]), _upper_tri(f[8:29], 6))
    if token in _TOKENS_3D_VERTEX:
        aa = _np_rot_to_aa(_np_rpy_to_rot(f[4], f[5], f[6]))
        return ParsedRecord("vertex3", (int(f[0]),), np.concatenate([np.array(f[1:4]), aa]))
    if token == "VERTEX_SE3:AXISANGLE":
        return ParsedRecord("vertex3", (int(f[0]),), np.array(f[1:7]))
    if token in _TOKENS_3D_LANDMARK:
        return ParsedRecord(
            "landmark3_xyz", (int(f[0]), int(f[1])), np.array(f[2:5]), _upper_tri(f[5:11], 3)
        )
    if token == "VERTEX_XYZ":
        return ParsedRecord("vertex_xyz", (int(f[0]),), np.array(f[1:4]))
    if token in ("VERTEX_CAM", "VERTEX_SCAM"):
        # dataset: x y z qx qy qz qw fx fy cx cy d(/baseline); stored state is
        # the inverted (world-to-camera) pose (ParsePrimitives.h:902-915)
        t = np.array(f[1:4])
        q = np.array([f[7], f[4], f[5], f[6]])  # (w, x, y, z)
        q = q / np.linalg.norm(q)
        qi = _np_quat_conj(q)
        c = _np_quat_rotate(qi, -t)
        aa = _np_quat_to_aa(qi)
        state = np.concatenate([c, aa, np.array(f[8:13])])
        kind = "vertex_cam" if token == "VERTEX_CAM" else "vertex_scam"
        return ParsedRecord(kind, (int(f[0]),), state)
    if token == "VERTEX_INTRINSICS":
        return ParsedRecord("vertex_intrinsics", (int(f[0]),), np.array(f[1:6]))
    if token in _TOKENS_P2C:
        # (point_id, camera_id, ox, oy, XX XY YY)
        return ParsedRecord(
            "edge_p2c", (int(f[0]), int(f[1])), np.array(f[2:4]), _upper_tri(f[4:7], 2)
        )
    if token in _TOKENS_P2CI:
        return ParsedRecord(
            "edge_p2ci",
            (int(f[0]), int(f[1]), int(f[2])),
            np.array(f[3:5]),
            _upper_tri(f[5:8], 2),
        )
    if token in _TOKENS_P2SC:
        return ParsedRecord(
            "edge_p2sc", (int(f[0]), int(f[1])), np.array(f[2:5]), _upper_tri(f[5:11], 3)
        )
    if token == "VERTEX_SPHERON:QUAT":
        # id x y z qx qy qz qw -> position + axis-angle (ParsePrimitives.h:1065)
        q = np.array([f[7], f[4], f[5], f[6]])
        q = q / np.linalg.norm(q)
        aa = _np_quat_to_aa(q)
        return ParsedRecord(
            "vertex_spheron", (int(f[0]),), np.concatenate([np.array(f[1:4]), aa])
        )
    if token == "EDGE_SPHERON_XYZ":
        # pose_id lm_id mx my mz info6 (ParsePrimitives.h:696)
        return ParsedRecord(
            "edge_spheron_xyz", (int(f[0]), int(f[1])), np.array(f[2:5]),
            _upper_tri(f[5:11], 3),
        )
    if token in ("ROCV:RECEIVER", "ROCV:RECEIVER_GT", "ROCV:RECEIVER_GTFAKE"):
        # id x y z vx vy vz (ParsePrimitives.h:1495-1569)
        return ParsedRecord("vertex_posvel", (int(f[0]),), np.array(f[1:7]))
    if token == "ROCV:TRANSMITTER":
        # landmark3d-typed (the rocv edges couple posvel3d <-> landmark3d)
        return ParsedRecord("vertex_rocv_lm", (int(f[0]),), np.array(f[1:4]))
    if token == "ROCV:TRANSMITTER_UF":
        # id info6 (3x3 upper tri) — absolute position unary factor
        # (TUnaryFactor3D, ParsePrimitives.h:1443)
        return ParsedRecord(
            "rocv_transmitter_uf", (int(f[0]),), np.zeros(0), _upper_tri(f[1:7], 3)
        )
    if token == "ROCV:DELTA_TIME":
        # prev cur dt info21 (6x6 upper tri) (ParsePrimitives.h:1604)
        return ParsedRecord(
            "edge_rocv_dt", (int(f[0]), int(f[1])), np.array(f[2:3]),
            _upper_tri(f[3:24], 6),
        )
    if token == "ROCV:RANGE":
        # posvel_id lm_id range info1 (ParsePrimitives.h:1680+)
        return ParsedRecord(
            "edge_rocv_range", (int(f[0]), int(f[1])), np.array(f[2:3]),
            np.array([[f[3]]]),
        )
    if token == "PHASE":
        return ParsedRecord("phase", (), np.zeros(0))
    if token == "EQUIV":
        return ParsedRecord("equiv", (int(f[0]), int(f[1])), np.zeros(0))
    return None


def parse_file(path: str, max_lines: Optional[int] = None) -> List[ParsedRecord]:
    """Parse a dataset file into canonical records (file order preserved)."""
    out: List[ParsedRecord] = []
    with open(path, "r") as fh:
        for lineno, line in enumerate(fh):
            if max_lines is not None and lineno >= max_lines:
                break
            line = line.strip()
            if not line or line.startswith("#") or line.startswith("%"):
                continue
            parts = line.split()
            token = parts[0].upper()
            if token == "CONSISTENCY_MARKER":
                out.append(ParsedRecord("marker", (), np.zeros(0)))
                continue
            try:
                fields = [float(x) for x in parts[1:]]
            except ValueError:
                # non-numeric payload: hard error like the reference traits
                # "fail" entries (SE2_Types.h:629) — silent data loss is worse
                raise ValueError(
                    f"{path}:{lineno + 1}: unknown token {token!r} "
                    "(non-numeric payload)"
                ) from None
            try:
                rec = parse_tokens(token, fields)
            except IndexError:
                raise ValueError(
                    f"{path}:{lineno + 1}: line is truncated ({token})"
                ) from None
            if rec is None:
                raise ValueError(f"{path}:{lineno + 1}: unknown token {token!r}")
            out.append(rec)
    return out


@contextlib.contextmanager
def g2o_file(text: str) -> Iterator[str]:
    """The path of a temporary file holding ``text`` (generated g2o text),
    for ``parse_file``; the file is removed when the block ends."""
    with tempfile.NamedTemporaryFile("w", suffix=".g2o", delete=False) as f:
        f.write(text)
        path = f.name
    try:
        yield path
    finally:
        os.unlink(path)


def detect_problem(records: Iterable[ParsedRecord]) -> str:
    """Auto-detect the problem type from (peeked) records.

    Reference analog: TDatasetPeeker (slam_app/Main.h:830, Main.cpp:152-196)
    which peek-parses the first 1000 lines.
    """
    kinds = {r.kind for r in records}
    if kinds & {"edge_spheron_xyz", "vertex_spheron"}:
        return "spheron"
    if kinds & {"edge_rocv_range", "edge_rocv_dt", "vertex_posvel"}:
        return "rocv"
    if kinds & {"edge_p2sc"}:
        return "ba_stereo"
    if kinds & {"edge_p2ci", "vertex_intrinsics"}:
        return "ba_intrinsics"
    if kinds & {"edge_p2c", "vertex_cam"}:
        return "ba"
    if kinds & {"landmark3_xyz"}:
        return "se3_landmark"
    if kinds & {"edge3", "vertex3"}:
        return "se3"
    if kinds & {"landmark2_xy", "landmark2_rb"}:
        return "se2_landmark"
    return "se2"


# vertex record kind -> vertex type (the dataset's own states): BA, the
# spheron poses, the ROCV receivers and transmitters (landmark3d-typed: the
# ROCV edges couple posvel3d and landmark3d)
_VERTICES = {"vertex_xyz": "xyz", "vertex_cam": "cam", "vertex_scam": "scam",
             "vertex_intrinsics": "intrinsics", "vertex_spheron": "spheron",
             "vertex_posvel": "posvel3d", "vertex_rocv_lm": "landmark3d"}

# pose-graph record kind -> (model module, edge type, initializers attribute)
_EDGES = {
    "edge2": ("se2", "edge_pose2d", "POSE_POSE_INITIALIZERS"),
    "landmark2_xy": ("se2", "edge_pose_landmark2d_xy", "POSE_LANDMARK_XY_INITIALIZERS"),
    "landmark2_rb": ("se2", "edge_pose_landmark2d_rb", "POSE_LANDMARK_RB_INITIALIZERS"),
    "edge3": ("se3", "edge_pose3d", "POSE_POSE3D_INITIALIZERS"),
    "landmark3_xyz": ("se3", "edge_pose_landmark3d", "POSE_LANDMARK3D_INITIALIZERS"),
    "edge_p2c": ("ba", "edge_p2c", None),
    "edge_p2ci": ("ba", "edge_p2ci", None),
    "edge_p2sc": ("ba", "edge_p2sc", None),
    "edge_spheron_xyz": ("rocv", "edge_spheron_xyz", "SPHERON_XYZ_INITIALIZERS"),
    "edge_rocv_dt": ("rocv", "edge_rocv_const_vel", "ROCV_CONST_VEL_INITIALIZERS"),
    "edge_rocv_range": ("rocv", "edge_rocv_range", "ROCV_RANGE_INITIALIZERS"),
}


def build_system(
    records: Iterable[ParsedRecord],
    problem: Optional[str] = None,
    system=None,
    on_edge=None,
    on_marker=None,
):
    """Feed parsed records through the parse loop into a GraphSystem, in the
    JAX package's argument order.

    ``on_edge(system, n_edges)`` is the incremental-solve hook (the reference
    calls solver.Incremental_Step per appended edge, ParseLoop.h:188-199);
    ``on_marker(system)`` fires at CONSISTENCY_MARKER records.  ``problem``
    is accepted for the JAX package's signature: there it only tells BA
    vertex lines from pose-graph ones, which the record kinds already do.
    Pose-graph problems ignore VERTEX ground-truth lines
    (CIgnoreAllVertexTraits, Solve2DImpl.cpp:50) and initialize vertices by
    composing measurements; BA vertex lines (VERTEX_XYZ, VERTEX_CAM,
    VERTEX_SCAM, VERTEX_INTRINSICS), spheron poses and the ROCV receivers
    and transmitters carry the states the edges start from; a
    ROCV:TRANSMITTER_UF record adds a landmark prior at the transmitter's
    parse-time position.  Returns the populated system."""
    from slampp_tpu_torch.graph.system import GraphSystem
    from slampp_tpu_torch.models import ba, rocv, se2, se3

    models = {"se2": se2, "se3": se3, "ba": ba, "rocv": rocv}
    del problem
    if system is None:
        system = GraphSystem()
    for rec in records:
        k = rec.kind
        if k == "marker":
            if on_marker is not None:
                on_marker(system)
            continue
        if k in ("vertex2", "vertex3", "equiv", "phase"):
            # ground truth of pose problems, data-association hints and
            # ROCV phase delimiters: bookkeeping only, as in the JAX package
            continue
        if k in _VERTICES:
            system.add_vertex(_VERTICES[k], rec.ids[0], rec.values)
            continue
        if k == "rocv_transmitter_uf":
            # absolute position prior at the landmark's parse-time state
            z = system.vertex_state(rec.ids[0])[:3]
            system.add_edge("edge_landmark3d_prior", rec.ids, z, rec.info)
            if on_edge is not None:
                on_edge(system, system.n_edges)
            continue
        if k not in _EDGES:
            raise ValueError(f"unhandled record kind {k!r}")
        model, etype, inits = _EDGES[k]
        system.add_edge(etype, rec.ids, rec.values, rec.info,
                        getattr(models[model], inits) if inits else None)
        if on_edge is not None:
            on_edge(system, system.n_edges)
    return system
