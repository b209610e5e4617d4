"""Plain SE(3) arithmetic for the references, batched over leading axes,
in the dtype of its inputs (the references run it in float64).

A pose is (t, axis-angle): the rotation's axis times its angle, as SLAM++
stores it (``include/slam/3DSolverBase.h``).  Composition is
``compose(p, d) = (t_p + R_p t_d, aa(q_p q_d))``; a pose vertex moves by
right composition with its tangent delta (``CVertexPose3D::Operator_Plus``).
The quaternion of an axis-angle keeps w >= 0; the axis-angle of a
quaternion is the short rotation.  Both switch to their Taylor forms near
zero, so that forward-mode derivatives at a zero delta are finite.
"""

from __future__ import annotations

import torch


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], -1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q) v, as the product q (0, v) q*."""
    p = torch.cat([torch.zeros_like(v[..., :1]), v], -1)
    return quat_mul(quat_mul(q, p), quat_conj(q))[..., 1:]


def aa_to_quat(aa: torch.Tensor) -> torch.Tensor:
    """(cos(a / 2), sin(a / 2) axis), w made non-negative, normalized."""
    sq = (aa * aa).sum(-1)
    small = sq < 1e-16
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    c = torch.where(small, 1.0 - sq / 8.0, torch.cos(0.5 * angle))
    s = torch.where(small, 0.5 - sq / 48.0, torch.sin(0.5 * angle) / angle)
    s = torch.where(c < 0, -s, s)
    q = torch.cat([c.abs()[..., None], aa * s[..., None]], -1)
    return q / torch.sqrt((q * q).sum(-1, keepdim=True))


def quat_to_aa(q: torch.Tensor) -> torch.Tensor:
    """The short rotation's axis-angle: 2 atan2(|v|, |w|) v / |v|, signed
    by w; below |v|^2 = 1e-24 its series 2 v (1 / |w| - |v|^2 / (3 |w|^3))."""
    w, v = q[..., 0], q[..., 1:]
    sq = (v * v).sum(-1)
    small = sq < 1e-24
    vn = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    sgn = torch.where(w < 0, -1.0, 1.0).to(q.dtype)
    aw = w.abs()
    a = torch.clamp_min(aw, 1e-12)
    big = sgn * 2.0 * torch.atan2(vn, aw) / vn
    series = sgn * 2.0 * (1.0 / a - sq / (3.0 * a ** 3))
    return v * torch.where(small, series, big)[..., None]


def compose(p: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    qp = aa_to_quat(p[..., 3:6])
    t = p[..., 0:3] + quat_rotate(qp, d[..., 0:3])
    return torch.cat([t, quat_to_aa(quat_mul(qp, aa_to_quat(d[..., 3:6])))], -1)


def between(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """The pose of p2 in the frame of p1: compose(p1, between(p1, p2)) = p2."""
    q1i = quat_conj(aa_to_quat(p1[..., 3:6]))
    t = quat_rotate(q1i, p2[..., 0:3] - p1[..., 0:3])
    return torch.cat([t, quat_to_aa(quat_mul(q1i, aa_to_quat(p2[..., 3:6])))], -1)

