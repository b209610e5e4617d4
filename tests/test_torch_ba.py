"""Bundle adjustment in slampp_tpu_torch against the JAX package: the camera
projections and residuals, the BA edges' analytic Jacobians against
``jax.jacfwd`` of the JAX error through its retractions (within 1e-12 of
the largest entry), the generators' g2o text and arrays byte for byte, the
parser's BA records and the dense system they give, the dense Schur solve
and the damped Schur step (dx within 1e-8), LM and GN with ``use_schur``
(chi2 within 1e-10 after 5 iterations, the same iterations applied), the
MIS elimination set of a pose-only graph, and the Schur marginals (blocks
within 1e-8)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slampp_tpu.core import assembly as jasm
from slampp_tpu.core.assembly import _edge_residual_and_jacobians
from slampp_tpu.geometry import camera as jcam
from slampp_tpu.graph.types import get_edge_type as jax_edge_type
from slampp_tpu.graph.types import get_vertex_type as jax_vertex_type
from slampp_tpu.io import datasets as jdata
from slampp_tpu.linear import schur as jschur
from slampp_tpu.marginals.ba_marginals import schur_marginals as jax_schur_marginals
from slampp_tpu.solvers.gauss_newton import GaussNewtonSolver as JGN
from slampp_tpu.solvers.lm import LevenbergMarquardtSolver as JLM
from slampp_tpu_torch.core import assembly
from slampp_tpu_torch.geometry import camera
from slampp_tpu_torch.graph.types import get_edge_type
from slampp_tpu_torch.io import datasets
from slampp_tpu_torch.io.parser import detect_problem, parse_file
from slampp_tpu_torch.linear import schur
from slampp_tpu_torch.marginals import schur_marginals
from slampp_tpu_torch.solvers import GaussNewtonSolver, LevenbergMarquardtSolver

from tests._torch_jax_util import (_with_text_file, ba_scene_text, city_text, jax_system,
                                   jax_text_system, port_system, port_text_system)

torch.set_num_threads(1)
N = 200


def _cams(rng, n, last=0.3):
    """(n, 11) camera states a few units in front of points near the origin:
    world-to-camera translation, axis-angle, (fx, fy, cx, cy, k)."""
    c = np.zeros((n, 11))
    c[:, :3] = rng.normal(scale=0.3, size=(n, 3)) + [0.0, 0.0, 6.0]
    c[:, 3:6] = rng.normal(scale=0.5, size=(n, 3))
    c[:, 6:11] = [500.0, 480.0, 320.0, 240.0, last] + rng.normal(size=(n, 5)) * [5, 5, 3, 3, 0.05]
    return c


def _edge_inputs(name, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, 3))
    if name == "edge_p2c":
        xs = (X, _cams(rng, N))
    elif name == "edge_p2ci":
        xs = (X, _cams(rng, N), _cams(rng, N)[:, 6:11])
    else:  # stereo: the last intrinsic is the baseline
        xs = (X, _cams(rng, N, last=0.12))
    z = rng.normal(scale=5.0, size=(N, 3 if name == "edge_p2sc" else 2)) + 300.0
    return xs, z


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_projections_match_jax():
    rng = np.random.default_rng(1)
    X, cams = rng.normal(size=(N, 3)), _cams(rng, N)
    for name in ("project_p2c", "project_p2sc"):
        want = np.stack([np.asarray(getattr(jcam, name)(jnp.asarray(c[:6]), jnp.asarray(c[6:]),
                                                        jnp.asarray(x)))
                         for c, x in zip(cams, X)])
        got = getattr(camera, name)(_t(cams[:, :6]), _t(cams[:, 6:]), _t(X)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-10)


@pytest.mark.parametrize("name", ["edge_p2c", "edge_p2ci", "edge_p2sc"])
def test_edge_residual_and_jacobians_match_jacfwd(name):
    """The analytic Jacobians against jacfwd of the JAX error through the
    retractions, within 1e-12 of each Jacobian's largest entry (the focal
    lengths make entries of ~1e4)."""
    xs, z = _edge_inputs(name, 5)
    et = jax_edge_type(name)
    vts = tuple(jax_vertex_type(t) for t in et.vertex_types)
    fn = jax.vmap(lambda *a: _edge_residual_and_jacobians(et, vts, a[:-1], a[-1]))
    r_j, jacs_j = fn(*(jnp.asarray(x) for x in xs), jnp.asarray(z))
    port = get_edge_type(name)
    r, jacs = port.jacobian_fn(tuple(_t(x) for x in xs), _t(z))
    assert len(jacs) == len(jacs_j) == et.arity
    for got, want in zip((r, *jacs), (r_j, *jacs_j)):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()
    np.testing.assert_array_equal(port.error_fn(tuple(_t(x) for x in xs), _t(z)).numpy(),
                                  r.numpy())


def test_generators_match_jax():
    for kw in ({"n_cams": 8, "n_points": 120}, {"n_cams": 5, "n_points": 60, "seed": 3,
                                                "obs_per_point": 4}):
        assert datasets.make_ba_scene(**kw)[0] == jdata.make_ba_scene(**kw)[0]
    assert (datasets.make_ba_scene_incremental(n_cams=6, n_points=50)[0]
            == jdata.make_ba_scene_incremental(n_cams=6, n_points=50)[0])
    a = datasets.make_venice_ba_arrays(n_cams=12, n_points=400, mean_track=5)
    b = jdata.make_venice_ba_arrays(n_cams=12, n_points=400, mean_track=5)
    assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def test_parser_ba_records_match_jax():
    """VERTEX_CAM / VERTEX_XYZ / EDGE_PROJECT_P2MC through both parsers: the
    problem kind, the vertex order and states, and the dense system."""
    text = ba_scene_text()
    records = _with_text_file(text, parse_file)
    assert detect_problem(records) == "ba"
    system, jsystem = port_text_system(text), jax_text_system(text)
    assert system._vorder == jsystem._vorder
    assert system.edge_type_names == jsystem.edge_type_names == ["edge_p2c"]
    for vid in system._vorder:
        np.testing.assert_array_equal(system.vertex_state(vid), jsystem.vertex_state(vid))
    H, g, chi2 = assembly.assemble_dense(system.snapshot("cpu"))
    Hj, gj, chi2_j = jax.jit(jasm.assemble_dense)(jsystem.snapshot())
    scale = float(np.abs(np.asarray(Hj)).max())
    assert np.abs(H.numpy() - np.asarray(Hj)).max() <= 1e-12 * scale
    assert np.abs(g.numpy() - np.asarray(gj)).max() <= 1e-12 * float(np.abs(np.asarray(gj)).max())
    assert abs(float(chi2) - float(chi2_j)) <= 1e-12 * float(chi2_j)


def _dense(text):
    system, jsystem = port_text_system(text), jax_text_system(text)
    H, g, _ = assembly.assemble_dense(system.snapshot("cpu"))
    Hj, gj, _ = jax.jit(jasm.assemble_dense)(jsystem.snapshot())
    return system, jsystem, H, g, Hj, gj


@pytest.mark.parametrize("case,alpha", [("city", 0.0), ("ba", 1e-2), ("ba", 0.5)])
def test_schur_solve_matches_jax(case, alpha):
    """The undamped Schur solve on a city-trees graph (anchored SE(2) poses
    and 2D landmarks: BA's own Hessian is singular along its gauge) and the
    damped one on make_ba_scene, with each package's plan: dx within 1e-8
    of JAX's (relative to its largest entry); the plans are equal."""
    text = city_text(120, 30) if case == "city" else ba_scene_text()
    system, jsystem, H, g, Hj, gj = _dense(text)
    plan, jplan = schur.build_schur_plan(system), jschur.build_schur_plan(jsystem)
    np.testing.assert_array_equal(plan.cam_idx.numpy(), np.asarray(jplan.cam_idx))
    np.testing.assert_array_equal(plan.lm_offsets.numpy(), np.asarray(jplan.lm_offsets))
    assert plan.lm_dim == jplan.lm_dim == (2 if case == "city" else 3)
    dx = schur.schur_solve(H, g, plan, alpha=alpha).numpy()
    dxj = np.asarray(jschur.schur_solve(Hj, gj, jplan, alpha=alpha))
    assert np.abs(dx - dxj).max() <= 1e-8 * np.abs(dxj).max()
    if alpha:
        graph = system.snapshot("cpu")
        new, _, denom, dxn = schur.schur_solve_dense_damped(graph, H, g, alpha, plan)
        jnew, _, jdenom, jdxn = jschur.schur_solve_dense_damped(jsystem.snapshot(), Hj, gj,
                                                                alpha, jplan)
        assert abs(float(denom) - float(jdenom)) <= 1e-8 * abs(float(jdenom))
        assert abs(float(dxn) - float(jdxn)) <= 1e-8 * float(jdxn)
        for t in jnew:
            np.testing.assert_allclose(new[t].numpy(), np.asarray(jnew[t]), rtol=0, atol=1e-8)


@pytest.mark.parametrize("solver", ["lm", "gn"])
def test_schur_solvers_match_jax(solver):
    """LM (LevenbergMarquardtSolver(use_schur=True)) on make_ba_scene(8, 120)
    and GN (GaussNewtonSolver(use_schur=True)) on a city-trees graph (GN
    needs a nonsingular H): the same iterations applied and chi2 within
    1e-10 after 5 iterations."""
    text = ba_scene_text() if solver == "lm" else city_text(120, 30)
    system, jsystem = port_text_system(text), jax_text_system(text)
    if solver == "lm":
        s, js = (LevenbergMarquardtSolver(system, use_schur=True, device="cpu"),
                 JLM(jsystem, use_schur=True))
    else:
        s, js = GaussNewtonSolver(system, use_schur=True, device="cpu"), JGN(jsystem,
                                                                               use_schur=True)
    applied, japplied = s.optimize(5), js.optimize(5)
    assert applied == japplied
    assert abs(s.chi2() - js.chi2()) <= 1e-10 * js.chi2()


def test_mis_elimination_set_matches_jax():
    """A pose-only graph has no landmark type: both packages eliminate the
    same greedy maximum independent set."""
    plan = schur.build_schur_plan(port_system(60))
    jplan = jschur.build_schur_plan(jax_system(60))
    np.testing.assert_array_equal(plan.lm_offsets.numpy(), np.asarray(jplan.lm_offsets))
    np.testing.assert_array_equal(plan.cam_idx.numpy(), np.asarray(jplan.cam_idx))
    with pytest.raises(ValueError, match="no landmark-like"):
        schur.build_schur_plan(port_system(20), allow_mis_fallback=False)


def test_schur_marginals_match_jax():
    """Sigma_cc and the landmark blocks of make_ba_scene's Hessian, lifted
    by 1e-2 I (BA's gauge leaves H singular), within 1e-8 of JAX's
    relative to each one's largest entry, and against the dense inverse."""
    system, jsystem, H, g, Hj, gj = _dense(ba_scene_text(n_cams=6, n_points=60))
    alpha = 1e-2
    cc, ll = schur_marginals(H, schur.build_schur_plan(system), alpha=alpha)
    jcc, jll = jax_schur_marginals(Hj, jschur.build_schur_plan(jsystem), alpha=alpha)
    for got, want in ((cc, jcc), (ll, jll)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-8 * np.abs(want).max()
    ref = np.linalg.inv(H.numpy() + alpha * np.eye(H.shape[0]))
    cam = schur.build_schur_plan(system).cam_idx.numpy()
    np.testing.assert_allclose(cc.numpy(), ref[np.ix_(cam, cam)], rtol=0, atol=1e-7)
