"""The port's slam_plus_plus CLI against the JAX package's on the incremental
routes (-nsp), bundle adjustment (batch and the CONSISTENCY_MARKER path),
the sparse Schur route on a cityTrees graph of 1,600 vertices and the
big_ba autoselect.  Both CLIs read the same generated g2o file with --json
and must report the same problem, solver, iterations and incremental
solves.  Float64 routes hold chi2 within 1e-8 relative and solution.txt
within 1e-8 absolute; the sparse Schur route runs the v3 engine in mixed
precision and holds chip_smoke.py's mixed bound, 5e-3 (chi2, and the
states within 5e-3 of the largest state entry: mixed parity is held by
chi2 and residual, not raw dx); the big_ba route's float32 SC holds the
JAX package's own dense-against-big_ba bound (tests/test_ba_schur.py:157,
5e-2).  Each case runs each CLI once, in-process."""

import numpy as np
import pytest
import torch

from slampp_tpu_torch.apps import main as port_cli
from slampp_tpu_torch.io import datasets

from _torch_jax_util import assert_cli_match, cli_pair, city_text

torch.set_num_threads(1)

TOL_F64 = 1e-8
TOL_MIXED = 5e-3  # chip_smoke.TOL_3500, the mixed v3 routes


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _manhattan(tmp_path, n=300):
    return _write(tmp_path, f"manhattan{n}.g2o", datasets.make_manhattan(n_poses=n, seed=0)[0])


def _ba(tmp_path):
    return _write(tmp_path, "ba.g2o", datasets.make_ba_scene(n_cams=8, n_points=120, seed=0)[0])


def _ba_markers(tmp_path):
    text, _ = datasets.make_ba_scene_incremental(n_cams=6, n_points=50, obs_per_point=4, seed=1)
    assert "CONSISTENCY_MARKER" in text
    return _write(tmp_path, "inc_ba.g2o", text)


def _city(tmp_path):
    return _write(tmp_path, "city1600.g2o", city_text(1600, 60))


# (case, graph, flags, chi2 tolerance, solution tolerance)
CASES = [
    ("fastl", _manhattan, ["-nsp", "1", "-nls", "fastL"], TOL_F64, TOL_F64),
    ("windowed-huber", _manhattan, ["-nsp", "1", "-nls", "L", "--robust", "huber"],
     TOL_F64, TOL_F64),
    ("every-10", _manhattan, ["-nsp", "10"], TOL_F64, TOL_F64),
    ("ba-batch", _ba, [], TOL_F64, TOL_F64),
    ("ba-markers", _ba_markers, ["-nsp", "1", "-mnsi", "2"], TOL_F64, TOL_F64),
    ("city-dl", _city, ["-nls", "lambda-dl"], TOL_MIXED, TOL_MIXED),
    ("city-lm-schur", _city, ["-us", "-nls", "lambda-lm"], TOL_MIXED, TOL_MIXED),
]


@pytest.mark.parametrize("case,graph,flags,tol,tol_sol", CASES, ids=[c[0] for c in CASES])
def test_cli_matches_jax(tmp_path, case, graph, flags, tol, tol_sol):
    runs = cli_pair(["-i", graph(tmp_path), "--json", "-nb", *flags], tmp_path)
    mixed = case.startswith("city")
    assert_cli_match(runs, tol, tol_sol, solution_scaled=mixed)
    res = runs["port"][2]
    if mixed:
        # the route that reaches the three kernels: the sparse Schur engine
        assert any(k.startswith("schur_sparse") for k in res["phases"]), res["phases"]
    if case == "ba-markers":
        assert res["incremental_solves"] == 5


def test_big_ba_autoselect(tmp_path, monkeypatch):
    """LM on edge_p2c-only BA takes the observation-driven Schur engine
    from BIGBA_THRESHOLD observations on (the JAX CLI's
    SLAMPP_BIGBA_THRESHOLD), with no dense Hessian assembled on the way
    (tests/test_ba_schur.py:148): the threshold lowered to 10 in both CLIs,
    the port's dense assembly made to fail; chi2 within 5e-2 of the JAX
    CLI's (its dense-against-big_ba bound), the same route and problem."""
    from slampp_tpu_torch.core import assembly
    from slampp_tpu_torch.solvers import lm

    text, _ = datasets.make_ba_scene(n_cams=6, n_points=64, obs_per_point=4, seed=7)
    g2o = _write(tmp_path, "ba.g2o", text)
    monkeypatch.setenv("SLAMPP_BIGBA_THRESHOLD", "10")
    monkeypatch.setattr(port_cli, "BIGBA_THRESHOLD", 10)

    def boom(*a, **k):
        raise AssertionError("dense Hessian assembled on the big_ba CLI path")

    monkeypatch.setattr(assembly, "assemble_dense", boom)
    monkeypatch.setattr(lm, "assemble_dense", boom, raising=False)
    engines = []
    real_init = lm.LevenbergMarquardtSolver.__init__

    def spy(self, *a, **k):
        real_init(self, *a, **k)
        engines.append(self.engine)

    monkeypatch.setattr(lm.LevenbergMarquardtSolver, "__init__", spy)
    runs = cli_pair(["-i", g2o, "--json", "-ns", "-nb"], tmp_path)
    (rc_p, _, res_p, _), (rc_j, _, res_j, _) = runs["port"], runs["jax"]
    assert rc_p == rc_j == 0 and engines == ["big_ba"]
    assert (res_p["problem"], res_p["solver"]) == (res_j["problem"], res_j["solver"]) == (
        "ba", "lambda-lm")
    assert abs(res_p["chi2"] - res_j["chi2"]) <= 5e-2 * res_j["chi2"]
