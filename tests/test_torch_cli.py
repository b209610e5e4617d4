"""The port's slam_plus_plus CLI (slampp_tpu_torch/apps/main.py) against the
JAX package's, on the batch pose-graph routes: both CLIs read the same
generated g2o file with --json, each in its own directory, and must report
the same problem, solver, iterations and incremental solves.  Float64
routes hold chi2 within 1e-8 relative, solution.txt within 1e-8 absolute
and marginals.txt within 1e-8 relative per entry (sphere200's GN states
within 1e-7, TOL_SPHERE_STATES); SPCG holds the bound of
chip_smoke.py's spcg phase (1e-6: its CG counts at a 1e-8 tolerance follow
rounding at small sizes, in the JAX package too).  system.mtx equals the
JAX CLI's within 1e-12 of its largest entry.  Each case runs each CLI once
(the JAX CLI compiles per call), in-process."""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.io
import torch

from slampp_tpu_torch.apps import main as port_cli

from _torch_jax_util import assert_cli_match, cli_pair, jax_sphere_text

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_F64 = 1e-8
TOL_SPCG = 1e-6  # chip_smoke.TOL_SIM3["spcg"]
# GN on sphere200 ends with states that follow rounding along a weakly
# constrained direction: the JAX package's own final states move 1.6e-8 to
# 2.3e-8 when its start states are scaled by 1 + 1e-15 N(0, 1)
# (python tests/_torch_jax_util.py --cli-sensitivity); its chi2 and the
# marginals stay within 1e-8
TOL_SPHERE_STATES = 1e-7


def _manhattan(tmp_path, n=300):
    from slampp_tpu_torch.io.datasets import make_manhattan

    path = tmp_path / f"manhattan{n}.g2o"
    path.write_text(make_manhattan(n_poses=n, seed=0)[0])
    return str(path)


def _sphere(tmp_path, n=200):
    path = tmp_path / f"sphere{n}.g2o"
    path.write_text(jax_sphere_text(n, n_rings=10))
    return str(path)


# (case, graph, flags, chi2 tolerance, solution tolerance, marginals tolerance)
CASES = [
    ("lambda-manhattan", _manhattan, ["-dm"], TOL_F64, TOL_F64, TOL_F64),
    ("lambda-sphere", _sphere, ["-dm"], TOL_F64, TOL_SPHERE_STATES, TOL_F64),
    ("lm-manhattan", _manhattan, ["-nls", "lambda-lm"], TOL_F64, TOL_F64, None),
    ("dl-manhattan", _manhattan, ["-nls", "lambda-dl"], TOL_F64, TOL_F64, None),
    ("a-manhattan", _manhattan, ["-nls", "A"], TOL_F64, TOL_F64, None),
    ("spcg-manhattan", _manhattan, ["-nls", "spcg"], TOL_SPCG, TOL_SPCG, None),
    ("robust-cauchy", _manhattan, ["--robust", "cauchy"], TOL_F64, TOL_F64, None),
]


@pytest.mark.parametrize("case,graph,flags,tol,tol_sol,tol_marg", CASES,
                         ids=[c[0] for c in CASES])
def test_cli_matches_jax(tmp_path, case, graph, flags, tol, tol_sol, tol_marg):
    runs = cli_pair(["-i", graph(tmp_path), "--json", "-nb", *flags], tmp_path)
    assert_cli_match(runs, tol, tol_sol, tol_marg)
    res = runs["port"][2]
    assert res["device"] == "cpu" and res["t_parse"] >= 0 and res["t_build"] >= 0


def test_dump_system_matrix_matches_jax(tmp_path):
    """-dsm on sphere200 (6 x 6 blocks) with LM: system.mtx reads back with
    scipy.io.mmread to the JAX CLI's matrix within 1e-12 of its largest
    entry; the raster is written where matplotlib is installed, and the
    solve matches as on the other routes."""
    runs = cli_pair(["-i", _sphere(tmp_path), "--json", "-nls", "lambda-lm", "-dsm"], tmp_path)
    assert_cli_match(runs, TOL_F64, TOL_F64)
    Hp = scipy.io.mmread(os.path.join(runs["port"][3], "system.mtx")).toarray()
    Hj = scipy.io.mmread(os.path.join(runs["jax"][3], "system.mtx")).toarray()
    assert Hp.shape == Hj.shape == (1200, 1200)
    assert np.abs(Hp - Hj).max() <= 1e-12 * np.abs(Hj).max()
    assert "system matrix: 1200x1200" in runs["port"][1]
    assert os.path.exists(os.path.join(runs["port"][3], "system_matrix.png"))


def test_dump_system_matrix_without_raster(tmp_path, monkeypatch):
    """Where the raster fails (matplotlib missing, as on the card's
    machine), -dsm still writes system.mtx and prints one line saying the
    raster was skipped and why."""
    from slampp_tpu_torch.viz import plot

    def no_matplotlib():
        raise ImportError("plotting (-p, the -dsm raster) needs matplotlib, which is not installed")

    monkeypatch.setattr(plot, "_pyplot", no_matplotlib)
    d = tmp_path / "port"
    d.mkdir()
    from _torch_jax_util import run_cli

    rc, out, res = run_cli(port_cli.main, ["-i", _manhattan(tmp_path, 60), "--device", "cpu",
                                           "--json", "-dsm", "-ns"], str(d))
    assert rc == 0 and (d / "system.mtx").exists() and not (d / "system_matrix.png").exists()
    assert "system matrix raster skipped: ImportError: plotting" in out
    with pytest.raises(ImportError, match="matplotlib"):
        run_cli(port_cli.main, ["-i", _manhattan(tmp_path, 60), "--device", "cpu", "-ns",
                                "-p", "plot.png"], str(d))


def test_flags_and_device(tmp_path):
    """The port takes every flag of the JAX CLI except --platform, plus
    --device; without a card, the default device raises, before any
    parsing."""
    from slampp_tpu.apps.main import build_arg_parser as jax_parser

    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings}

    assert flags(port_cli.build_arg_parser()) == (
        flags(jax_parser()) - {"--platform"}) | {"--device"}
    with pytest.raises(SystemExit):
        port_cli.build_arg_parser().parse_args(["--platform", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_cli.main(["-i", str(tmp_path / "missing.g2o")])
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            port_cli.main(["-rmb"])


def test_rmut_runs_the_block_unit_tests():
    """-rmut runs tests/test_torch_block_unit.py in a subprocess (no JAX,
    no conftest) and returns its exit code."""
    out = subprocess.run([sys.executable, "-m", "slampp_tpu_torch.apps.main", "-rmut"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "15 passed" in out.stdout


def test_regression_goldens_pass_on_the_port():
    """apps/regression.py on the CPU: the five goldens of
    scripts/regression_goldens.json (read, never written), md5 of the
    generated text equal and chi2 within 1e-6 relative."""
    from slampp_tpu_torch.apps import regression

    res = regression.run("cpu")
    assert set(res) == {c[0] for c in regression.CONFIGS}
    for name, r in res.items():
        assert r["md5_ok"] and r["chi2_rel_err"] <= 1e-6 and r["ok"], (name, r)
        assert r["iterations"] == r["golden"]["iterations"], name
