"""ROCV and Spheron in slampp_tpu_torch against the JAX package: the
generators' text byte for byte; parse, detect and build equal; H, g and
chi2 within 1e-10 (relative to H's largest entry); the four edge types'
residuals and Jacobians against ``jax.jacfwd``; the landmark prior's zero
error with nonzero Hessian; Gauss-Newton chi2 trajectories within 1e-9."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from slampp_tpu.core import assembly as jasm
from slampp_tpu.graph.types import get_edge_type as jax_edge_type
from slampp_tpu.graph.types import get_vertex_type as jax_vertex_type
from slampp_tpu.io import datasets as jds
from slampp_tpu.io import parser as jparser
from slampp_tpu.solvers import gauss_newton as jgn
from slampp_tpu_torch.apps import sim3 as app
from slampp_tpu_torch.core import assembly
from slampp_tpu_torch.graph.types import get_edge_type
from slampp_tpu_torch.io import datasets, parser
from slampp_tpu_torch.solvers import gauss_newton as pgn

torch.set_num_threads(1)
F64 = torch.float64

CASES = {"rocv": (datasets.make_rocv, jds.make_rocv, (40, 4)),
         "spheron": (datasets.make_spheron, jds.make_spheron, (8, 30))}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_generators_byte_equal(kind):
    make, jmake, args = CASES[kind]
    for seed in (0, 3):
        text, truth = make(*args, seed=seed)
        jtext, jtruth = jmake(*args, seed=seed)
        assert text == jtext
        np.testing.assert_array_equal(truth, jtruth)


def _both(kind, args=None, seed=0):
    make, _, default = CASES[kind]
    text = make(*(args or default), seed=seed)[0]
    with parser.g2o_file(text) as path:
        recs, jrecs = parser.parse_file(path), jparser.parse_file(path)
    return recs, jrecs


@pytest.mark.parametrize("kind", sorted(CASES))
def test_parse_detect_build_assemble(kind):
    recs, jrecs = _both(kind)
    assert [(r.kind, r.ids) for r in recs] == [(r.kind, r.ids) for r in jrecs]
    assert parser.detect_problem(recs) == jparser.detect_problem(jrecs) == kind
    system, jsystem = parser.build_system(recs), jparser.build_system(jrecs)
    assert system._vorder == jsystem._vorder
    assert system.edge_type_names == jsystem.edge_type_names
    for vid in jsystem._vorder:
        np.testing.assert_allclose(system.vertex_state(vid), np.asarray(jsystem.vertex_state(vid)),
                                   rtol=0, atol=1e-12)
    H, g, chi2 = assembly.assemble_dense(system.snapshot("cpu"))
    Hj, gj, chi2_j = jax.jit(jasm.assemble_dense)(jsystem.snapshot())
    scale = float(np.abs(np.asarray(Hj)).max())
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), rtol=0, atol=1e-10 * scale)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=0,
                               atol=1e-10 * float(np.abs(np.asarray(gj)).max()))
    assert abs(float(chi2) - float(chi2_j)) <= 1e-10 * float(chi2_j)


def _inputs(rng, name, n):
    if name == "edge_rocv_range":
        return ((rng.normal(0, 5, (n, 6)), rng.normal(0, 5, (n, 3))), rng.uniform(1, 10, (n, 1)))
    if name == "edge_rocv_const_vel":
        return ((rng.normal(0, 2, (n, 6)), rng.normal(0, 2, (n, 6))), rng.uniform(0.5, 2, (n, 1)))
    if name == "edge_landmark3d_prior":
        return ((rng.normal(0, 5, (n, 3)),), rng.normal(0, 5, (n, 3)))
    return ((rng.normal(0, 0.7, (n, 6)), rng.normal(0, 3, (n, 3))), rng.normal(0, 3, (n, 3)))


@pytest.mark.parametrize("name", ["edge_rocv_range", "edge_rocv_const_vel",
                                  "edge_landmark3d_prior", "edge_spheron_xyz"])
def test_edge_jacobians_match_jacfwd(name):
    rng = np.random.default_rng(7)
    states, meas = _inputs(rng, name, 24)
    et = get_edge_type(name)
    r, jacs = et.jacobian_fn(tuple(torch.tensor(s, dtype=F64) for s in states),
                             torch.tensor(meas, dtype=F64))
    jet = jax_edge_type(name)
    vts = tuple(jax_vertex_type(t) for t in jet.vertex_types)
    jr, jjacs = jax.vmap(lambda *a: jasm._edge_residual_and_jacobians(
        jet, vts, a[:-1], a[-1]))(*states, meas)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0, atol=1e-10)
    assert len(jacs) == len(jjacs) == et.arity
    for J, jJ in zip(jacs, jjacs):
        np.testing.assert_allclose(J.numpy(), np.asarray(jJ), rtol=0, atol=1e-10)


def test_landmark_prior_zero_error_nonzero_hessian():
    """CEdgeLandmark3DPrior: chi2 0, its information on the landmark's
    diagonal block of H."""
    recs, _ = _both("rocv")
    system = parser.build_system(recs)
    g = system.snapshot("cpu")
    ea = g.edges["edge_landmark3d_prior"]
    assert float(assembly.edge_chi2("edge_landmark3d_prior", ea, g.states)) == 0.0
    # the prior edges alone, without the automatic unary gauge factor
    only = dataclasses.replace(g, edges={"edge_landmark3d_prior": ea}, unary_dim=0)
    H, grad, chi2 = assembly.assemble_dense(only)
    assert float(chi2) == 0.0 and float(grad.abs().max()) == 0.0
    off = ea.offsets[:, 0]
    for e in range(ea.meas.shape[0]):
        idx = off[e] + torch.arange(3)
        np.testing.assert_allclose(H[idx][:, idx].numpy(), ea.sigma_inv[e].numpy(), rtol=0,
                                   atol=0)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_gauss_newton_trajectory_matches_jax(kind, monkeypatch):
    """Dense GN (ROCV: 30 receivers; Spheron: 8 poses, 30 points, below
    the sparse Schur engine's 1500 vertices): the chi2 at every step within
    1e-9 of the JAX package's, the same iterations applied."""
    recs, jrecs = _both(kind, (30, 4) if kind == "rocv" else None)
    system, jsystem = parser.build_system(recs), jparser.build_system(jrecs)
    gn = pgn.GaussNewtonSolver(system, linear_solver="dense", device="cpu")
    jsolver = jgn.GaussNewtonSolver(jsystem, linear_solver="dense")
    seen, jseen = [], []

    def wrap(fn, out):
        def inner(*a, **k):
            res = fn(*a, **k)
            out.append(float(res[2]))
            return res
        return inner

    monkeypatch.setattr(pgn, "_gn_step", wrap(pgn._gn_step, seen))
    monkeypatch.setattr(jgn, "_gn_step", wrap(jgn._gn_step, jseen))
    assert gn.optimize(8, 1e-9) == jsolver.optimize(8, 1e-9)
    assert len(seen) == len(jseen) >= 3
    np.testing.assert_allclose(seen, jseen, rtol=1e-9)
    assert abs(gn.chi2() - jsolver.chi2()) <= 1e-9 * max(jsolver.chi2(), 1e-12) + 1e-12


def test_apps_run_rocv_and_spheron_small():
    """apps/sim3.run_rocv and run_spheron on the CPU at small sizes against
    the JAX package's GN on the same text: the problem detected, the same
    iterations applied, chi2 within 1e-9, finite states.  (Range-only GN
    does not descend monotonically, in either package.)"""
    for res, (text, kw, it, mdx) in (
            (app.run_rocv(30, 4, "cpu", max_iters=5),
             (jds.make_rocv(30, 4, seed=0)[0], {"linear_solver": "dense"}, 5, 0.0)),
            (app.run_spheron(8, 40, "cpu", max_iters=3),
             (jds.make_spheron(8, 40, seed=0)[0], {"use_schur": True}, 3, 0.01))):
        with parser.g2o_file(text) as path:
            jsolver = jgn.GaussNewtonSolver(jparser.build_system(jparser.parse_file(path)), **kw)
        assert jsolver.optimize(it, mdx) == res["applied"]
        assert abs(res["chi2_final"] - jsolver.chi2()) <= 1e-9 * jsolver.chi2()
        assert res["problem"] in ("rocv", "spheron")
        assert all(bool(torch.isfinite(s).all()) for s in res["states"].values())
