"""SE(2) geometry and model of slampp_tpu_torch against the JAX package:
residuals and analytic Jacobians against ``_edge_residual_and_jacobians``
(jax.jacfwd of the error), including angles within 1e-6 of +-pi."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slampp_tpu.core.assembly import _edge_residual_and_jacobians
from slampp_tpu.graph.types import get_edge_type as jax_edge_type
from slampp_tpu.graph.types import get_vertex_type as jax_vertex_type
from slampp_tpu.models import se2 as jax_se2  # noqa: F401  (registers the types)
from slampp_tpu_torch.graph.types import EdgeType, register_edge_type
from slampp_tpu_torch.models import se2 as port_se2

torch.set_num_threads(1)


def _pose_pairs(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-20, 20, size=(n, 3))
    x1 = rng.uniform(-20, 20, size=(n, 3))
    z = rng.normal(scale=2.0, size=(n, 3))
    x0[:, 2] = rng.uniform(-np.pi, np.pi, n)
    x1[:, 2] = rng.uniform(-np.pi, np.pi, n)
    z[:, 2] = rng.uniform(-np.pi, np.pi, n)
    # a quarter of the angles within 1e-6 of +-pi, where the angular fixup
    # chooses between nearly equal candidates
    k = n // 4
    for a in (x0, x1, z):
        a[:k, 2] = rng.choice([-1.0, 1.0], k) * (np.pi - rng.uniform(0, 1e-6, k))
    # residual angles landing right at +-pi: x1 = x0 + z + pi (+- 1e-7)
    m = n // 8
    x1[k : k + m, 2] = x0[k : k + m, 2] + z[k : k + m, 2] + np.pi + rng.uniform(-1e-7, 1e-7, m)
    return x0, x1, z


def test_edge_pose2d_residual_and_jacobians_match_jax():
    x0, x1, z = _pose_pairs()
    et = jax_edge_type("edge_pose2d")
    vts = tuple(jax_vertex_type(t) for t in et.vertex_types)
    r_j, (j0_j, j1_j) = jax.vmap(
        lambda a, b, m: _edge_residual_and_jacobians(et, vts, (a, b), m)
    )(jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(z))
    t = torch.from_numpy
    r, (j0, j1) = port_se2.EDGE_POSE2D.jacobian_fn((t(x0), t(x1)), t(z))
    np.testing.assert_allclose(r.numpy(), np.asarray(r_j), rtol=0, atol=1e-12)
    np.testing.assert_allclose(j0.numpy(), np.asarray(j0_j), rtol=0, atol=1e-12)
    np.testing.assert_allclose(j1.numpy(), np.asarray(j1_j), rtol=0, atol=1e-12)
    e = port_se2.EDGE_POSE2D.error_fn((t(x0), t(x1)), t(z))
    np.testing.assert_array_equal(e.numpy(), r.numpy())


def test_pose2d_retract_and_local_diff_match_jax():
    x0, x1, z = _pose_pairs(seed=1)
    vt = jax_vertex_type("pose2d")
    want = np.asarray(jax.vmap(vt.retract)(jnp.asarray(x0), jnp.asarray(z)))
    got = port_se2.POSE2D.retract(torch.from_numpy(x0), torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    want = np.asarray(jax.vmap(vt.local_diff)(jnp.asarray(x1), jnp.asarray(x0)))
    got = port_se2.POSE2D.local_diff(torch.from_numpy(x1), torch.from_numpy(x0)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_edge_type_without_jacobian_is_refused():
    """The port has no autodiff: the landmark edges wait until they bring
    analytic Jacobians."""
    with pytest.raises(ValueError, match="jacobian_fn"):
        register_edge_type(EdgeType(
            name="edge_pose_landmark2d_xy", vertex_types=("pose2d", "landmark2d"),
            res_dim=2, meas_dim=2, error_fn=lambda xs, z: z,
        ))
