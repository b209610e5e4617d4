"""The batch solvers on the SE(3) sphere graph, slampp_tpu_torch against the
JAX package: the native engines (5 chained float64 GN iterations, chi2
within 1e-8), GN, LM and dogleg as the CLI builds them (float64 within 1e-8
and the same iterations applied, mixed v3 within 5e-3) and LM on the sphere
with XYZ landmarks (1e-8).  On the CPU every dense kernel call takes its
plain PyTorch version."""

import contextlib

import pytest
import torch

from slampp_tpu_torch.apps import sphere

from _torch_jax_util import (
    jax_jacobians,
    jax_native_fused,
    jax_solver_reference,
    jax_sphere_system,
)

torch.set_num_threads(1)
N, RINGS = 200, 10  # sphere200, 10 rings of 20 poses
TOL_F64, TOL_MIXED = 1e-8, 5e-3


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("engine", ["v1", "v2"])
def test_native_gn_matches_jax(engine):
    """5 chained float64 GN iterations of the native engines."""
    _, chi0_j, chi2_j = jax_native_fused(jax_sphere_system(N, RINGS), engine, 1)
    res = sphere.run_native(N, "cpu", engine, n_rings=RINGS)
    assert _rel(res["chi2_init"], chi0_j) < 1e-12
    assert _rel(res["chi2_final"], chi2_j) < TOL_F64


@pytest.mark.parametrize("nls,engine", [("lambda", None), ("lambda-lm", None),
                                        ("lambda-dl", None), ("lambda-lm", "v3"),
                                        ("lambda-dl", "v3")])
def test_batch_solvers_match_jax(nls, engine):
    """One optimize with the CLI's defaults: GN (native v1), LM and dogleg
    on the dense engine in float64, and on the mixed v3 engine.  The mixed
    runs hold the port's analytic float32 Jacobians against the JAX
    package's rounded from float64 (``jax_jacobians``): its jacfwd
    in float32 moves dogleg's unconverged chi2 here by 6e-3, while rounding
    the port's Jacobians from float64 moves it by 4e-5."""
    with jax_jacobians() if engine else contextlib.nullcontext():
        want, applied = jax_solver_reference(N, nls, engine, system=jax_sphere_system(N, RINGS))
    res = sphere.run_solver(N, "cpu", nls, engine, n_rings=RINGS)
    if engine is None:
        assert res["applied"] == applied and _rel(res["chi2_final"], want) < TOL_F64
    else:
        assert _rel(res["chi2_final"], want) < TOL_MIXED


def test_sphere_landmarks_lm_matches_jax():
    """se3_landmark (6 x 6 poses and 3 x 3 points), LM on the dense engine."""
    want, applied = jax_solver_reference(
        120, "lambda-lm", system=jax_sphere_system(120, 6, landmarks=True))
    res = sphere.run_solver(120, "cpu", "lambda-lm", n_rings=6, landmarks=True)
    assert res["applied"] == applied and _rel(res["chi2_final"], want) < TOL_F64
    assert res["states"]["landmark3d"].shape[1] == 3
