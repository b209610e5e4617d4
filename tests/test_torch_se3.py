"""SE(3) geometry and model of slampp_tpu_torch against the JAX package: every
``geometry/se3`` function on seeded batches (rotations near 0, below both
Taylor thresholds, and near pi; quaternions with w < 0), the two edge types'
residuals and analytic Jacobians against ``_edge_residual_and_jacobians``
(jax.jacfwd of the error through the retraction; float64 within 1e-10
absolute, float32 within 1e-4 relative), the retraction and local_diff
round trips, the NumPy initializers, and the torch kernel adapter that
FastL takes for SE(3) against the JAX package's adapter."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slampp_tpu.core.assembly import _edge_residual_and_jacobians
from slampp_tpu.geometry import se3 as jse3
from slampp_tpu.graph.types import get_edge_type as jax_edge_type
from slampp_tpu.graph.types import get_vertex_type as jax_vertex_type
from slampp_tpu.models import jax_kernel_adapter as jadapter
from slampp_tpu.models import se3 as jax_se3
from slampp_tpu_torch.geometry import se3
from slampp_tpu_torch.models import se3 as port_se3
from slampp_tpu_torch.models import torch_kernel_adapter as adapter

torch.set_num_threads(1)
F64_ATOL, F32_RTOL = 1e-10, 1e-4
N = 600


def _axis_angles(rng, n):
    """n rotation vectors: a sixth each of generic angles, angles within 1e-3
    of pi, |aa|^2 below 1e-24 (both Taylor branches), |aa|^2 between 1e-24
    and 1e-16 (the quaternion's branch only), exact zeros, and angles
    beyond pi (their quaternion w < 0 before the flip)."""
    ax = rng.normal(size=(n, 3))
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    k = n // 6
    ang = rng.uniform(0.0, np.pi, n)
    ang[k : 2 * k] = np.pi - rng.uniform(0, 1e-3, k)
    ang[2 * k : 3 * k] = rng.uniform(0, 9e-13, k)
    ang[3 * k : 4 * k] = rng.uniform(2e-12, 9e-9, k)
    ang[4 * k : 5 * k] = 0.0
    ang[5 * k :] = rng.uniform(np.pi, 2 * np.pi - 0.1, n - 5 * k)
    return ax * ang[:, None]


def _poses(rng, n):
    return np.concatenate([rng.uniform(-20, 20, (n, 3)), _axis_angles(rng, n)], 1)


def _quats(rng, n):
    """Unit quaternions, half with w < 0, a sixth with |v|^2 below 1e-24,
    and a few not normalized (quat_to_axis_angle must not renormalize)."""
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[: n // 2, 0] = -np.abs(q[: n // 2, 0])
    k = n // 6
    q[-k:, 1:] *= 1e-13
    q[-k:, 0] = rng.choice([-1.0, 1.0], k)
    q[: n // 10] *= 1.3
    return q


def _vmap(fn, *xs):
    return np.asarray(jax.vmap(fn)(*(jnp.asarray(x) for x in xs)))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("name", ["quat_mul", "quat_rotate", "quat_conj", "quat_normalize",
                                  "quat_to_axis_angle", "rot_to_quat"])
def test_quaternion_functions_match_jax(name):
    rng = np.random.default_rng(1)
    q1, q2 = _quats(rng, N), _quats(rng, N)
    v = rng.normal(size=(N, 3))
    R = _vmap(jse3.axis_angle_to_rot, _axis_angles(rng, N))
    args = {"quat_mul": (q1, q2), "quat_rotate": (q1, v), "quat_conj": (q1,),
            "quat_normalize": (q1,), "quat_to_axis_angle": (q1,), "rot_to_quat": (R,)}[name]
    want = _vmap(getattr(jse3, name), *args)
    got = getattr(se3, name)(*(_t(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["axis_angle_to_quat", "axis_angle_to_rot", "_skew",
                                  "rot_to_axis_angle", "rpy_to_rot"])
def test_rotation_functions_match_jax(name):
    rng = np.random.default_rng(2)
    aa = _axis_angles(rng, N)
    arg = _vmap(jse3.axis_angle_to_rot, aa) if name == "rot_to_axis_angle" else aa
    want = _vmap(getattr(jse3, name), arg)
    got = getattr(se3, name)(_t(arg)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    if name == "axis_angle_to_quat":
        assert (got[:, 0] >= 0).all()


@pytest.mark.parametrize("name", ["relative_to_absolute", "absolute_to_relative", "plus",
                                  "pose_inverse", "pose_pose_error", "pose_landmark_error"])
def test_pose_functions_match_jax(name):
    rng = np.random.default_rng(3)
    p1, p2, p3 = _poses(rng, N), _poses(rng, N), _poses(rng, N)
    args = {"pose_inverse": (p1,), "pose_pose_error": (p1, p2, p3),
            "pose_landmark_error": (p1, p2[:, :3], p3[:, :3])}.get(name, (p1, p2))
    want = _vmap(getattr(jse3, name), *args)
    got = getattr(se3, name)(*(_t(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-11)


def test_quat_to_axis_angle_jacobian_matches_jacfwd():
    """Both branches, both signs of w, unnormalized q."""
    q = _quats(np.random.default_rng(4), N)
    want = _vmap(jax.jacfwd(jse3.quat_to_axis_angle), q)
    got = se3.quat_to_axis_angle_jacobian(_t(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())


def _edge_inputs(name, seed):
    rng = np.random.default_rng(seed)
    x0, x1, z = _poses(rng, N), _poses(rng, N), _poses(rng, N)
    if name == "edge_pose3d":
        # a third of the edges near their optimum: small residual rotations
        # take the Taylor branch of quat_to_axis_angle
        k = N // 3
        z[:k] = _vmap(jse3.absolute_to_relative, x0[:k], x1[:k])
        z[:k, 3:] += rng.normal(scale=1e-13, size=(k, 3))
        return (x0, x1), z
    return (x0, x1[:, :3]), z[:, :3]


@pytest.mark.parametrize("name", ["edge_pose3d", "edge_pose_landmark3d"])
def test_edge_residual_and_jacobians_match_jacfwd(name):
    xs, z = _edge_inputs(name, 5)
    et = jax_edge_type(name)
    vts = tuple(jax_vertex_type(t) for t in et.vertex_types)
    port_et = {"edge_pose3d": port_se3.EDGE_POSE3D,
               "edge_pose_landmark3d": port_se3.EDGE_POSE_LANDMARK3D}[name]
    fn = jax.vmap(lambda a, b, m: _edge_residual_and_jacobians(et, vts, (a, b), m))
    for dtype, jdt in ((torch.float64, jnp.float64), (torch.float32, jnp.float32)):
        r_j, jacs_j = fn(*(jnp.asarray(x, jdt) for x in xs), jnp.asarray(z, jdt))
        r, jacs = port_et.jacobian_fn(tuple(_t(x).to(dtype) for x in xs), _t(z).to(dtype))
        assert r.dtype == dtype and all(j.dtype == dtype for j in jacs)
        for got, want in zip((r, *jacs), (r_j, *jacs_j)):
            want = np.asarray(want)
            if dtype == torch.float64:
                np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F64_ATOL)
            else:
                err = np.abs(got.numpy().astype(np.float64) - want).max()
                assert err <= F32_RTOL * np.abs(want).max()
    e = port_et.error_fn(tuple(_t(x) for x in xs), _t(z))
    np.testing.assert_allclose(e.numpy(), port_et.jacobian_fn(tuple(_t(x) for x in xs),
                                                              _t(z))[0].numpy(), rtol=0, atol=0)


def test_retract_and_local_diff_round_trip():
    rng = np.random.default_rng(6)
    x, ref = _poses(rng, N), _poses(rng, N)
    d = rng.normal(scale=0.3, size=(N, 6))
    vt = jax_vertex_type("pose3d")
    got = port_se3.POSE3D.retract(_t(x), _t(d))
    np.testing.assert_allclose(got.numpy(), _vmap(vt.retract, x, d), rtol=0, atol=1e-11)
    ld = port_se3.POSE3D.local_diff(_t(x), _t(ref))
    np.testing.assert_allclose(ld.numpy(), _vmap(vt.local_diff, x, ref), rtol=0, atol=1e-11)
    # plus(ref, local_diff(x, ref)) is x as a pose: the same translation and
    # the same rotation (its axis-angle may be the short one)
    back = port_se3.POSE3D.retract(_t(ref), ld)
    np.testing.assert_allclose(back[:, :3].numpy(), x[:, :3], rtol=0, atol=1e-10)
    Rb = se3.axis_angle_to_rot(back[:, 3:]).numpy()
    np.testing.assert_allclose(Rb, _vmap(jse3.axis_angle_to_rot, x[:, 3:]), rtol=0, atol=1e-10)
    lm = rng.normal(size=(N, 3))
    np.testing.assert_array_equal(port_se3.LANDMARK3D.retract(_t(lm), _t(d[:, :3])).numpy(),
                                  lm + d[:, :3])


def test_initializers_match_jax():
    rng = np.random.default_rng(7)
    for p, m in zip(_poses(rng, 50), _poses(rng, 50)):
        known = {0: p}
        np.testing.assert_allclose(port_se3.init_pose3d_from_pose(known, m),
                                   jax_se3.init_pose3d_from_pose(known, m), rtol=0, atol=0)
        np.testing.assert_allclose(port_se3.init_landmark3d(known, m[:3]),
                                   jax_se3.init_landmark3d(known, m[:3]), rtol=0, atol=0)
    np.testing.assert_array_equal(port_se3.init_pose3d_from_pose({}, m),
                                  jax_se3.init_pose3d_from_pose({}, m))


@pytest.mark.parametrize("name", ["edge_pose3d", "edge_pose_landmark3d"])
def test_kernel_adapter_matches_jax_adapter(name):
    """FastL's host kernels for SE(3): the torch adapter against the JAX
    package's jitted one, float64, an empty batch included."""
    xs, z = _edge_inputs(name, 8)
    r_j, jacs_j = jadapter.make_edge_lin(name)(xs, z)
    r, jacs = adapter.make_edge_lin(name)(xs, z)
    for got, want in zip((r, *jacs), (r_j, *jacs_j)):
        assert isinstance(got, np.ndarray)
        np.testing.assert_allclose(got, want, rtol=0, atol=F64_ATOL)
    r0, jacs0 = adapter.make_edge_lin(name)(tuple(x[:0] for x in xs), z[:0])
    assert r0.shape == (0, r.shape[1]) and [j.shape[0] for j in jacs0] == [0, 0]
    if name == "edge_pose3d":
        x, ref = xs
        d = np.random.default_rng(9).normal(scale=0.1, size=(N, 6))
        np.testing.assert_allclose(adapter.make_retract("pose3d")(x, d),
                                   jadapter.make_retract("pose3d")(x, d), rtol=0, atol=1e-11)
        np.testing.assert_allclose(adapter.make_local_diff("pose3d")(x, ref),
                                   jadapter.make_local_diff("pose3d")(x, ref), rtol=0, atol=1e-11)
        np.testing.assert_array_equal(adapter.make_local_diff("landmark3d")(x[:, :3], ref[:, :3]),
                                      jadapter.make_local_diff("landmark3d")(x[:, :3], ref[:, :3]))
