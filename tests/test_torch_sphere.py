"""The SE(3) sphere graph through slampp_tpu_torch against the JAX package:
the generators' g2o text (identical, also as the apps' ``sphere_text``),
generated text through ``parse_file``'s checks, the parser's SE(3) records, the v3
``optimize_fused`` path at 6 x 6 blocks (mixed within 5e-3, float64 within
1e-8 of JAX's chi2), ``_small_inv`` at bs 6 (1e-12), FastL through the
torch kernel adapter on the 120-pose sphere of tests/test_fastl.py (the
same counters, chi2 within 1e-8) and the app's CLI; the batch solvers are
in tests/test_torch_sphere_solvers.py.  On the CPU every dense kernel call
takes its plain PyTorch version."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from slampp_tpu.graph.system import GraphSystem as JaxGraphSystem
from slampp_tpu.io import datasets as jax_datasets
from slampp_tpu.io import parser as jax_parser
from slampp_tpu.linear import partitioned as jax_partitioned
from slampp_tpu.solvers.fastl import FastLSolver as JaxFastL
from slampp_tpu_torch.apps import sphere
from slampp_tpu_torch.graph.system import GraphSystem
from slampp_tpu_torch.io import datasets, parser
from slampp_tpu_torch.linear.partitioned import _small_inv
from slampp_tpu_torch.solvers import FastLSolver

from _torch_jax_util import jax_sphere_system, jax_sphere_text, jax_v3_fused

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
N, RINGS = 200, 10  # sphere200: K = 4, M = 296, Ms = 360, dense frames
TOL_F64, TOL_MIXED = 1e-8, 5e-3


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("kw", [{}, {"n_poses": 200, "n_rings": 10},
                                {"n_poses": 500, "n_rings": 10, "seed": 3}])
def test_make_sphere_text_is_identical(kw):
    text, gt = datasets.make_sphere(**kw)
    text_j, gt_j = jax_datasets.make_sphere(**kw)
    assert text == text_j
    np.testing.assert_array_equal(gt, gt_j)


@pytest.mark.parametrize("kw", [{}, {"n_poses": 120, "n_rings": 6, "n_landmarks": 30,
                                     "seed": 2}])
def test_make_sphere_landmarks_text_is_identical(kw):
    text, (gt, lms) = datasets.make_sphere_landmarks(**kw)
    text_j, (gt_j, lms_j) = jax_datasets.make_sphere_landmarks(**kw)
    assert text == text_j and "LANDMARK3:XYZ" in text
    np.testing.assert_array_equal(lms, lms_j)


@pytest.mark.parametrize("n_poses,n_rings,landmarks", [(2500, None, False), (120, None, False),
                                                       (40, None, False), (120, 6, True)])
def test_sphere_text_matches_jax(n_poses, n_rings, landmarks):
    """The apps' sphere graph (one ring per 50 poses unless told) is the
    JAX package's generator on the same arguments."""
    want = jax_sphere_text(n_poses, n_rings, landmarks=landmarks)
    assert datasets.sphere_text(n_poses, n_rings, landmarks=landmarks) == want
    assert datasets.default_rings(2500) == 50 and datasets.default_rings(40) == 1


@pytest.mark.parametrize("bad,msg", [("FOO 1 2", "unknown token 'FOO'"),
                                     ("EDGE_SE3:AXISANGLE 0 1 0.5", "truncated"),
                                     ("EDGE_SE3:AXISANGLE 0 1 x", "non-numeric")])
def test_g2o_file_goes_through_parse_file_checks(bad, msg):
    """Generated text reaches the records through ``parse_file``, whose
    checks name the file and line of a bad record."""
    text = datasets.sphere_text(20, 2).splitlines()
    with parser.g2o_file("\n".join(text[:3] + [bad] + text[3:]) + "\n") as path:
        with pytest.raises(ValueError, match=f":4: .*{msg}"):
            parser.parse_file(path)
        assert path.endswith(".g2o")


@pytest.mark.parametrize("landmarks", [False, True])
def test_build_system_matches_jax(landmarks):
    """edge3 and landmark3_xyz records: the same vertices, initial states
    (NumPy initializers), edges, measurements and information."""
    jg = jax_sphere_system(120, 6, landmarks=landmarks).snapshot()
    g = sphere.sphere_system(120, 6, landmarks=landmarks).snapshot("cpu")
    types = {"pose3d", "landmark3d"} if landmarks else {"pose3d"}
    assert set(g.states) == set(jg.states) == types
    assert (g.state_dim, g.unary_offset, g.unary_dim) == (jg.state_dim, jg.unary_offset,
                                                          jg.unary_dim)
    for t in jg.states:
        np.testing.assert_array_equal(g.states[t].numpy(), np.asarray(jg.states[t]))
        np.testing.assert_array_equal(g.vertex_offsets[t].numpy(),
                                      np.asarray(jg.vertex_offsets[t]))
    assert g.edges.keys() == jg.edges.keys()
    for t, je in jg.edges.items():
        for f in ("local_idx", "offsets", "meas", "sigma_inv"):
            np.testing.assert_array_equal(getattr(g.edges[t], f).numpy(),
                                          np.asarray(getattr(je, f)), err_msg=f)


def test_small_inv_bs6_matches_jax():
    rng = np.random.default_rng(0)
    G = rng.normal(size=(9, 4, 6, 6))
    A = G @ np.swapaxes(G, -1, -2) + 0.5 * np.eye(6)
    want = np.asarray(jax_partitioned._small_inv(A))
    np.testing.assert_allclose(_small_inv(torch.from_numpy(A)).numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("mixed", [True, False])
def test_v3_optimize_fused_matches_jax(mixed):
    """sphere200 (dense frames, 6 x 6 blocks), 5 fused GN iterations."""
    _, chi0_j, chi2_j, plan_j = jax_v3_fused(jax_sphere_system(N, RINGS), mixed)
    res = sphere.run(N, "cpu", n_rings=RINGS, mixed_precision=mixed, n_rep=0)
    assert {k: res["plan"][k] for k in plan_j} == plan_j and not res["chain_mode"]
    assert _rel(res["chi2_init"], chi0_j) < 1e-12
    assert _rel(res["chi2_final"], chi2_j) < (TOL_MIXED if mixed else TOL_F64)
    assert res["states"]["pose3d"].shape == (N, 6)


def test_fastl_sphere_matches_jax():
    """FastL on SE(3) through the kernel adapters (tests/test_fastl.py's
    120-pose sphere, chunk 16, window 32): the same counters and chi2."""
    text, _ = datasets.make_sphere(n_poses=120, seed=1)
    kw = dict(solve_period=1, require_loop_closure=False, chunk=16, window=32)

    def stream(gs_cls, solver_cls, pkg_parser, extra):
        system = gs_cls()
        inc = solver_cls(system, **kw, **extra)
        with parser.g2o_file(text) as path:
            pkg_parser.build_system(pkg_parser.parse_file(path), system=system,
                                    on_edge=lambda s, n: inc.incremental_step())
        inc.refresh_frozen()
        return inc

    jinc = stream(JaxGraphSystem, JaxFastL, jax_parser, {})
    inc = stream(GraphSystem, FastLSolver, parser, {"device": "cpu"})
    counters = ("n_solves", "n_freezes", "n_refreezes", "n_relin", "n_full_factor",
                "n_resumed_factor")
    assert {k: getattr(inc, k) for k in counters} == {k: getattr(jinc, k) for k in counters}
    assert inc.n_freezes >= 1
    assert _rel(inc.chi2(), float(jinc.chi2())) < TOL_F64
    assert inc.optimize() == jinc.optimize()
    assert _rel(inc.chi2(), float(jinc.chi2())) < TOL_F64


def test_cli_prints_a_result():
    out = subprocess.run(
        [sys.executable, "-m", "slampp_tpu_torch.apps.sphere", "60", "cpu", "--rings", "6",
         "--solver", "lambda-lm", "--engine", "v3", "--robust", "huber"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["solver"] == "lambda-lm" and res["engine"] == "v3" and res["device"] == "cpu"
    assert res["robust"]["loss"] == "huber" and res["chi2_final"] < res["chi2_init"]
